"""step_roofline.resident (%): the step's least bytes (padded planes
in and out once, tables once; roofline.py) at the peak 3.35 TB/s, over the
time a kernel ran on the device per step in the traced window (copies left
out)."""

from portbench.readers import step_roofline as read  # noqa: F401
