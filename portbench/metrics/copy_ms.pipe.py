"""copy_ms.pipe (ms per frame): device time of the staging copies (pinned
host to device and back) in the traced window, per frame."""

from portbench.readers import copy_ms as read  # noqa: F401
