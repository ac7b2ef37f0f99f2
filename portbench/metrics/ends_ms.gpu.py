"""ends_ms.gpu (ms per frame): the device ends' share of the loop's thread
in ``run_device``: the program's ``read``, ``stage``, ``upload``,
``download``, ``wait`` and ``put`` spans (the source's lending, the
release of its frames, the pad and crop copies on the device, the wait
for a batch's copies and the sink's hand-off) over the traced run's
frames; nothing unless every frame came in on the device (the
``device_frames`` counter)."""

from portbench.device_spans import ends_ms as read  # noqa: F401
