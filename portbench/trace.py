"""The device trace of a traced run's window, reduced to what the per-layer
metrics and the breakdown read.

``torch.profiler`` records the host's ops and the card's kernels and copies
(CUPTI) on one timeline.  The window is the ``portbench.window`` range
around the timed call.  Reduced:

* ``busy_s``: the union of the device's operations inside the window;
  ``window_s``: the window's length;
* ``ops``: device time and count by operation name (kernels by their
  unmangled names, copies as ``Memcpy HtoD`` and the like);
* ``copy_s``: the device time of every copy;
* ``kernel_busy_s``: the union of the device's kernels inside the window,
  copies and memsets left out;
* ``idle``: the device's idle time inside the window, each gap split
  over the harness's host spans that cover it (the spans of one thread,
  which do not nest), and ``other`` for what no span covers;
* ``device_ops`` and ``idle_gaps``: the ten largest of each, as
  ``[name, seconds]``.

Off in a run with ``--trace 0``.
"""

from __future__ import annotations

from portbench.spans import PREFIX

WINDOW = PREFIX + "window"


def op_name(name: str) -> str:
    """A device op's name without template arguments and parameters."""
    return (name.replace("(anonymous namespace)::", "")
            .split("(")[0].split("<")[0].strip())


def union(intervals):
    """Merged, sorted copy of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_events(window, device_ops, spans) -> dict:
    """Reduce ``device_ops`` ``(start_us, end_us, name)`` and host
    ``spans`` ``(start_us, end_us, name)`` over ``window`` ``(start_us,
    end_us)``."""
    w0, w1 = window
    ops: dict[str, list] = {}
    inside, kernels = [], []
    copy_us = 0.0
    for s, e, name in device_ops:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        inside.append((s, e))
        key = op_name(name)
        ent = ops.setdefault(key, [0, 0.0])
        ent[0] += 1
        ent[1] += (e - s) / 1e6
        if key.startswith("Memcpy"):
            copy_us += e - s
        if not key.startswith("Mem"):
            kernels.append((s, e))
    busy = union(inside)
    busy_us = sum(e - s for s, e in busy)
    spans = sorted(spans)
    idle: dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    j = 0
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        while j < len(spans) and spans[j][1] <= g0:
            j += 1
        covered = 0.0
        k = j
        while k < len(spans) and spans[k][0] < g1:
            part = min(spans[k][1], g1) - max(spans[k][0], g0)
            if part > 0:
                idle[spans[k][2]] = idle.get(spans[k][2], 0.0) + part / 1e6
                covered += part
            k += 1
        if g1 - g0 > covered:
            idle["other"] = idle.get("other", 0.0) + (g1 - g0 - covered) / 1e6
    top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:10]
    return dict(busy_s=busy_us / 1e6, window_s=(w1 - w0) / 1e6,
                copy_s=copy_us / 1e6,
                kernel_busy_s=sum(e - s for s, e in union(kernels)) / 1e6,
                ops=ops, idle=idle,
                device_ops=[[k, v[1]] for k, v in top],
                idle_gaps=[[k, v] for k, v in
                           sorted(idle.items(), key=lambda kv: -kv[1])[:10]])


class DeviceTrace:
    """A context over the window: torch.profiler when on, else nothing.
    ``result`` holds the reduction after exit."""

    def __init__(self, on: bool, device: str):
        self.on, self.cuda = on, device.startswith("cuda")
        self.result = None

    def __enter__(self):
        if self.on:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.cuda else [])
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._range = record_function(WINDOW)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if not self.on:
            return False
        import torch
        if self.cuda:
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.result = self._reduce()
        del self._prof
        return False

    def _reduce(self) -> dict:
        """Read the profiler's raw events (building its event tree takes
        minutes for a window of a million ops) and reduce them."""
        from torch.autograd import DeviceType
        window, device_ops, spans = None, [], []
        for e in self._prof.profiler.kineto_results.events():
            name = e.name()
            s, t = e.start_ns() / 1e3, e.end_ns() / 1e3
            cuda = e.device_type() == DeviceType.CUDA
            if name.startswith(PREFIX):
                if cuda:
                    continue    # the range's shadow on the device timeline
                if name == WINDOW:
                    window = (s, t)
                else:
                    spans.append((s, t, name[len(PREFIX):]))
            elif cuda:
                device_ops.append((s, t, name))
        if window is None:
            raise RuntimeError("the trace holds no window range")
        return reduce_events(window, device_ops, spans)
