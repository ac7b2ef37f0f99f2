"""Closed loop on device-resident frames, as a GPU transcoder holds them.

The pool is ``pool_batches`` batches of ``batch`` distinct padded frames on
the device, made from the seed; step ``k`` grains pool batch ``k % pool_batches``
as frames ``k * batch ..`` of the stream.  Per step it calls, as the
program's README documents:

* ``pipe.maybe_switch_config(n0)``;
* ``pipe.frame_bases(n)`` for each frame of the batch;
* ``add_grain_batch_natural(y, u, v, bases, bases_up, tables, ...)`` with
  ``tables = natural_tables(pipe.regs, device)``, built once.

One step is in flight while the host prepares the next, as ``run_file``
does: after enqueuing step k the loop waits for step k-1.  No step is issued
after the window closes, and the window ends in a synchronize.  A frame
counts for ``fps_resident`` when its step completed on the device inside
the window.  Spans: ``frame_bases``, ``step``, ``drain`` (the wait for the
step before).  A configuration that pops a cfg past frame 0 is refused.
"""

from __future__ import annotations

import time

from portbench.drivers import _common
from portbench.sample import Sampler


def run(ctx) -> dict:
    import torch
    from versatilefilmgrain_tpu_torch.ops import grain_natural as gn

    t = ctx.traffic
    batch, nbatches = t["batch"], t["pool_batches"]
    _common.pops_at_frame_0_only(ctx, "resident")
    pipe = _common.make_pipeline(ctx)
    pipe.maybe_switch_config(0)       # the configuration's pop at frame 0
    tables = gn.natural_tables(pipe.regs, ctx.device)
    ctx.mark("pipeline")
    kw = _common.step_kwargs(pipe)
    Y, U, V = _common.pool_planes(ctx, batch * nbatches)
    sampler = Sampler(ctx.seed, batch, t["check_per_position"])
    slots = [torch.empty((sampler.slots, *p.shape[1:]), dtype=p.dtype,
                         device=p.device) for p in (Y, U, V)]
    spans = ctx.spans
    frame_bases = spans.wrap(pipe.frame_bases, "frame_bases")

    def step(k):
        n0 = k * batch
        pipe.maybe_switch_config(n0)
        bases, bases_up = zip(*(frame_bases(n0 + i) for i in range(batch)))
        b = (k % nbatches) * batch
        with spans("step"):
            return gn.add_grain_batch_natural(
                Y[b:b + batch], U[b:b + batch], V[b:b + batch], list(bases),
                list(bases_up), tables, **kw)

    ctx.mark("pool")
    step(0)                           # warm-up: builds and loads K1
    _common.settle(ctx.device)
    ctx.mark("warm-up")
    spans.seconds.clear()

    done = _common.Completions(ctx.device)
    k = 0
    pending = last = None
    with ctx.trace:
        t0 = done.open()
        end = t0 + ctx.seconds
        while time.monotonic() < end:
            out = step(k)
            mark = done.mark()
            for i in range(batch):
                slot = sampler.offer(k * batch + i, i)
                if slot is not None:
                    for s, o in zip(slots, out):
                        s[slot].copy_(o[i])
            if pending is not None:
                with spans("drain"):
                    pending.synchronize()
            pending, last = mark, out
            k += 1
        _common.sync(ctx.device)
    setup_s = t0 - ctx.t_start
    per_step = done.seconds()
    n_last = k * batch - 1
    samples = [(n, n % (batch * nbatches), [s[slot] for s in slots])
               for slot, n in sorted(sampler.kept.items())]
    samples.append((n_last, n_last % (batch * nbatches),
                    [o[batch - 1] for o in last]))
    rec = dict(setup_s=setup_s, seconds=ctx.seconds,
               attempted=k * batch, missing=0, samples=samples, crop=False,
               check_target=min(sampler.slots, k * batch) + 1,
               done=[c for c in per_step for _ in range(batch)],
               steps=k, frames=k * batch, batch=batch,
               geometry=_common.geometry(ctx.config),
               spans=spans.seconds, trace=ctx.trace.result,
               memory_peak_bytes=_common.memory_peak(ctx.device))
    del pipe, tables, Y, U, V, out, last, pending
    _common.release(ctx.device)
    return rec
