"""Probes of the grain kernel on the card: ``probe_budget`` (per-stage
budget, csrc/probe_budget.cu) and ``probe_ohpipe`` (prefetch pipeline,
csrc/probe_pipe.cu), the counterparts of the JAX package's
tools/probe_budget.py and tools/probe_ohpipe.py, on the shared helpers of
``_harness``.  Run each with ``python -m
versatilefilmgrain_tpu_torch.tools.<probe> [default sei_ar afgs1]``.
"""
