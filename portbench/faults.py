"""Faults planted under the timed path, and the control, to show that the
check fails them.  Used by the CPU tests and by ``control.py`` on the card;
the benchmark's own runs plant nothing.

Each patches the program's classes and modules in this process for the
duration of a ``with`` block, under every driver: the pipe drivers reach
the step through ``GrainPipeline._step``, the resident and paced drivers
through ``grain_natural.add_grain_batch_natural``, and all of them take
the frame bases from ``GrainPipeline.frame_bases``, and every one pops the
configuration's cfgs through ``GrainPipeline.maybe_switch_config``.

* ``control``: breaks the configuration's guarantee that frames come out
  in order: frame n is grained with frame n+1's grain (the LFSR sequence
  shifted by one frame), every pixel of it computed right;
* ``unchanged``: the step returns its input planes unchanged;
* ``half_batch``: the step grains the first half of its batch and hands
  back the second half unchanged (a batch of one has no half to leave);
* ``altered``: one sample of each frame's luma plane is altered (its low
  bit flipped) where the step produces it;
* ``dropped`` (pipe driver): the program's frame writer drops one frame in
  ten, so fewer frames come out than went in;
* ``late_switch`` (pipe driver, a configuration that pops a cfg past
  frame 0): each cfg pop takes effect one frame late, so ``run_file``
  grains the frame at each switch's POC, alone in its batch, with the
  config before it.
"""

from __future__ import annotations

import contextlib

KINDS = ("control", "unchanged", "half_batch", "altered", "dropped",
         "late_switch")


def kinds_for(traffic: dict, schedule) -> list[str]:
    """The kinds a cell of the mix ``traffic`` whose configuration pops
    ``schedule`` (``[(poc, cfg), ...]``) can have: ``half_batch`` where a
    step holds more than one frame, ``dropped`` where the frames leave
    through the program's writer (the ``pipe`` driver), ``late_switch``
    where they do and the schedule pops past frame 0."""
    pipe = traffic["driver"] == "pipe"
    switches = any(poc > 0 for poc, _ in schedule)
    return [k for k in KINDS
            if not (k == "half_batch" and traffic.get("batch", 1) <= 1)
            and not (k == "dropped" and not pipe)
            and not (k == "late_switch" and not (pipe and switches))]


def _broken(step, kind: str):
    """``step(y, u, v, *rest, **kw)`` broken as ``kind``."""
    import torch

    def broken(y, u, v, *rest, **kw):
        if kind == "unchanged":
            return y, u, v
        out = step(y, u, v, *rest, **kw)
        if kind == "half_batch":
            keep = y.shape[0] - y.shape[0] // 2
            return tuple(torch.cat([o[:keep], p[keep:]])
                         for o, p in zip(out, (y, u, v)))
        y0 = out[0][:, 0, 0]           # uint16 has no xor on the card
        out[0][:, 0, 0] = (y0.to(torch.int32) ^ 1).to(y0.dtype)
        return out
    return broken


@contextlib.contextmanager
def planted(kind: str):
    """Plant ``kind`` (one of ``KINDS``) for the block's duration."""
    from versatilefilmgrain_tpu_torch import pipeline
    from versatilefilmgrain_tpu_torch.ops import grain_natural as gn
    from versatilefilmgrain_tpu_torch.utils import native_io
    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r}: one of {KINDS}")
    GP, FW = pipeline.GrainPipeline, native_io.FrameWriter
    saved = (GP.frame_bases, GP._step, gn.add_grain_batch_natural, FW.put,
             GP.maybe_switch_config)
    if kind == "control":
        GP.frame_bases = lambda self, n: saved[0](self, n + 1)
    elif kind == "late_switch":
        GP.maybe_switch_config = lambda self, n: saved[4](self, n - 1)
    elif kind == "dropped":
        puts = iter(range(1 << 62))

        def put(self, frame):
            if next(puts) % 10 != 7:
                saved[3](self, frame)
        FW.put = put
    else:
        GP._step = _step_of(saved[1], kind)
        gn.add_grain_batch_natural = _broken(saved[2], kind)
    try:
        yield
    finally:
        (GP.frame_bases, GP._step, gn.add_grain_batch_natural, FW.put,
         GP.maybe_switch_config) = saved


def _step_of(step, kind: str):
    """``GrainPipeline._step`` broken as ``kind``."""
    def broken(self, y, u, v, *rest):
        return _broken(lambda y_, u_, v_, *r: step(self, y_, u_, v_, *r),
                       kind)(y, u, v, *rest)
    return broken
