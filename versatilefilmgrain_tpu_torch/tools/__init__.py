"""Probes of the grain kernel on the card, the counterparts of the JAX
package's TPU probes in tools/: ``probe_budget`` (per-stage budget,
csrc/probe_budget.cu), ``probe_ohpipe`` (prefetch pipeline,
csrc/probe_pipe.cu), and the one-hot dot probes ``probe_dot``,
``probe_dot2`` and ``probe_dotscale`` (csrc/probe_dot.cu, their shared
parts in ``_dot``), on the shared helpers of ``_harness``.  Run each with
``python -m versatilefilmgrain_tpu_torch.tools.<probe>``.
"""
