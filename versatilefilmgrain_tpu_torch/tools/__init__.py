"""Probes on the card, the counterparts of the JAX package's TPU probes in
tools/: ``probe_budget`` (per-stage budget, csrc/probe_budget.cu),
``probe_ohpipe`` (persistent pipeline, csrc/probe_pipe.cu), the one-hot dot
probes ``probe_dot``, ``probe_dot2`` and ``probe_dotscale``
(csrc/probe_dot.cu; K6's int8 and bf16 products and the dense product
csrc/probe_dotconst.cu; their shared parts in ``_dot``) and the relayout
probes
``probe_relayout`` and ``probe_relayout5d`` (csrc/probe_relayout.cu, their
shared parts in ``_relayout``), on the shared helpers of ``_harness``, and
the benches ``bench_tiled``, ``bench_pipe`` and ``bench_scaling``.  Run
each with ``python -m versatilefilmgrain_tpu_torch.tools.<probe>``.
"""
