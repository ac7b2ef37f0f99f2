"""fps_resident (frames/s, host clock): frames whose step completed on
the device inside the window, divided by the window."""

from portbench.readers import window_rate as read  # noqa: F401
