"""fps_pipe (frames/s, host clock): frames that left the output pipe
inside the window, divided by the window."""

from portbench.readers import window_rate as read  # noqa: F401
