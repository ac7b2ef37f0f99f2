"""What the readers of the config switch path share: the program's spans
and counters of its switches, per switch and not per frame, so that a
faster program, which meets more switches in a window, reads the same.
Each reader returns None where ``program_spans`` would: no recorder (a
checkout from before it), an empty record, or a ``frames`` counter that is
not the run's; and where the program lacks the span or the counter (a
checkout from before they were added)."""

from __future__ import annotations

from portbench.program_spans import _totals


def per_span_ms(rec: dict, name: str):
    """Mean milliseconds of the program's spans ``name``."""
    got = _totals(rec)
    if got is None or name not in got[0]:
        return None
    count, total, _ = got[0][name]
    return 1e3 * total / count


def cut_pct(rec: dict):
    """The program's batches cut short at a config switch (its
    ``switch_cuts`` counter) over all its ``batches``, in percent; a
    program that has the counter but never counted reads 0."""
    if _totals(rec) is None:
        return None
    from versatilefilmgrain_tpu_torch.utils import tracing
    if "switch_cuts" not in tracing.COUNTERS:
        return None
    counters = tracing.record()["counters"]
    if not counters.get("batches"):
        return None
    return 100.0 * counters.get("switch_cuts", 0) / counters["batches"]
