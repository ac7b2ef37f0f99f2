"""device_idle_pct.gpu (%): share of the traced window in which no
operation ran on the device (one minus the union of its activity)."""

from portbench.readers import idle_pct as read  # noqa: F401
