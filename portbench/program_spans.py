"""What the readers of the program's own spans share.  The port's recorder
(``versatilefilmgrain_tpu_torch/utils/tracing.py``) keeps the spans and
counters of the latest stretch during which it was on: in a traced run,
the window, where the harness's profiler is on and ``run_file`` runs with
``verbose``.  Each reader returns None where the program has no recorder
(a checkout from before it), the record is empty or lacks the span, or its
``frames`` counter is not the run's frame count."""

from __future__ import annotations


def _totals(rec: dict):
    """``({name: [count, total s, self s]}, frames)`` of the recorder's
    record, or None."""
    try:
        from versatilefilmgrain_tpu_torch.utils import tracing
    except ImportError:
        return None
    got = tracing.record()
    frames = got["counters"].get("frames")
    if not got["spans"] or not frames or frames != rec.get("frames"):
        return None
    return tracing.summary(got["spans"]), frames


def per_frame_ms(rec: dict, name: str):
    """Milliseconds of the program's spans ``name`` per frame."""
    got = _totals(rec)
    if got is None or name not in got[0]:
        return None
    return 1e3 * got[0][name][1] / got[1]


def self_pct(rec: dict, name: str):
    """The share of the program's spans ``name`` that none of their child
    spans covers, in percent."""
    got = _totals(rec)
    if got is None or name not in got[0] or got[0][name][1] <= 0:
        return None
    _, total, own = got[0][name]
    return 100.0 * own / total
