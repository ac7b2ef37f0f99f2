"""k1_roofline.gpu (%): K1's least bytes a step (``roofline.step_bytes``
of the cell's geometry: padded planes in and out once, tables once) at
the peak 3.35 TB/s, over K1's device time a step (the trace's
``grain_plane`` kernels; copies and the lattice prep left out)."""

from portbench.device_spans import k1_roofline as read  # noqa: F401
