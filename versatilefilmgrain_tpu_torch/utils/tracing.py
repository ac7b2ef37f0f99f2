"""Host spans and counters of the port's layers, on the profiler's clock.

A span records its name, its start and end (``time.time_ns()``, the Unix
clock on which ``torch.profiler`` stamps host and CUDA events, so a span
lines up with the device trace), the index of its parent span (spans of
one thread nest) and the batch it serves: the global index of the batch's
first frame, as last named by :func:`set_batch` on its thread.  Counters
are named integers.

The recorder records while a ``torch.profiler`` session is active or
while a caller holds :func:`forced` (``run_file`` does for ``verbose`` and
``profile_dir``).  Off, :func:`span` returns one shared null context after
one check, and :func:`count` and :func:`set_batch` do nothing.  It keeps
the spans and counters of the latest stretch during which it was on: the
first span or count after a stretch off starts a fresh record.  Spans are
not ``record_function`` ranges, which would put shadow events on the
device timeline.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time

from torch.autograd import profiler as _profiler

NULL = contextlib.nullcontext()
# The counters: frames and batches through the frame loop, the batches it
# cut short at a config switch, config pops that succeeded, device tables
# built, LFSR jump tables built (one per bit of the exponent,
# ops/lfsr.py), the loop's staging buffers (its two host rings and its
# device buffers, made once a call whatever the number of frames), and the
# frames that left through the native writer's ring by reference, having
# come in through the native reader's.
COUNTERS = ("frames", "batches", "switch_cuts", "config_pops",
            "table_uploads", "lfsr_tables", "staging_allocs", "ring_frames")


class _Thread(threading.local):
    """A thread's stack of open spans and the batch its spans serve."""

    def __init__(self):
        self.stack: list[_Span] = []
        self.batch: int | None = None


class Recorder:
    def __init__(self):
        self.forced = 0
        self.fresh = True
        self.spans: list[list] = []     # [name, start_ns, end_ns, parent, batch]
        self.counters: dict[str, int] = {}
        self.thread = _Thread()

    def restart(self) -> None:
        self.fresh = False
        self.spans, self.counters = [], {}


_R = Recorder()


class _Span:
    __slots__ = ("spans", "i", "thread")

    def __init__(self, name: str):
        if _R.fresh:
            _R.restart()
        self.spans, self.thread = _R.spans, _R.thread
        top = self.thread.stack[-1] if self.thread.stack else None
        # a span left open across a restart is no parent in the new record
        parent = top.i if top is not None and top.spans is self.spans \
            else None
        self.i = len(self.spans)
        self.spans.append([name, 0, 0, parent, self.thread.batch])

    def __enter__(self):
        self.thread.stack.append(self)
        self.spans[self.i][1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.spans[self.i][2] = time.time_ns()
        self.thread.stack.pop()
        if not self.thread.stack:
            self.thread.batch = None
        return False


def span(name: str):
    """A context that records the span ``name`` while the recorder is on."""
    if _R.forced or _profiler._is_profiler_enabled:
        return _Span(name)
    _R.fresh = True
    return NULL


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the counter ``name`` while the recorder is on."""
    if _R.forced or _profiler._is_profiler_enabled:
        if _R.fresh:
            _R.restart()
        _R.counters[name] = _R.counters.get(name, 0) + k


def set_batch(n0: int) -> None:
    """The batch (its first frame's index) that this thread's next spans
    serve, until its outermost open span ends."""
    if _R.forced or _profiler._is_profiler_enabled:
        _R.thread.batch = n0


@contextlib.contextmanager
def forced(keep: bool = True):
    """Record inside the block even with no profiler session (if ``keep``)."""
    _R.forced += bool(keep)
    try:
        yield
    finally:
        _R.forced -= bool(keep)


def record() -> dict:
    """The latest stretch's spans (tuples of the fields above) and
    counters."""
    return dict(spans=[tuple(s) for s in _R.spans],
                counters=dict(_R.counters))


def counters() -> dict[str, int]:
    """A copy of the latest stretch's counters."""
    return dict(_R.counters)


def summary(spans, root: int | None = None) -> dict[str, list]:
    """``{name: [count, total s, self s]}`` over ``spans`` (the spans of
    ``record()``), or over span ``root`` and its descendants.  Self time
    is a span's duration less the durations of its children."""
    keep = set(range(len(spans))) if root is None else {root}
    child_ns = [0] * len(spans)
    for i in range(0 if root is None else root + 1, len(spans)):
        _, s, e, parent, _ = spans[i]
        if root is not None and parent in keep:
            keep.add(i)
        if parent is not None:
            child_ns[parent] += e - s
    out: dict[str, list] = {}
    for i in sorted(keep):
        name, s, e = spans[i][:3]
        ent = out.setdefault(name, [0, 0.0, 0.0])
        ent[0] += 1
        ent[1] += (e - s) / 1e9
        ent[2] += (e - s - child_ns[i]) / 1e9
    return out


def add_to_chrome_trace(path: str, spans) -> None:
    """Add ``spans`` to the Chrome trace that ``torch.profiler`` exported
    to ``path``, on a track of their own, on the trace's time base."""
    with open(path) as f:
        trace = json.load(f)
    base = trace.get("baseTimeNanoseconds", 0)
    trace["traceEvents"] += [
        dict(ph="X", cat="vfg_span", name=name, pid="vfg-torch spans",
             tid="host", ts=(s - base) / 1e3, dur=(e - s) / 1e3,
             args=dict(batch=batch, parent=parent))
        for name, s, e, parent, batch in spans]
    with open(path, "w") as f:
        json.dump(trace, f)
