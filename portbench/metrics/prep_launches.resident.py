"""prep_launches.resident (launches per step): device kernels of a step
other than the grain kernel's (K1) launches, from the trace."""

from portbench.readers import prep_launches as read  # noqa: F401
