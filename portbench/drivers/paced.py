"""Open loop at a fixed frame rate, one frame a step, as a GPU player
presents a stream.

Frame ``k`` is due at ``t0 + k / rate_fps``; the frames due inside the
window are the run's.  The loop waits until a frame is due (sleeping, then
spinning for the last millisecond), then calls the same entry as the
resident mix with a batch of one (``maybe_switch_config``, ``frame_bases``,
``add_grain_batch_natural`` on pool frame ``k % pool_frames``) and
synchronizes on the step's completion.  A frame's latency runs from
its due time to that synchronize's return on the host clock, so a stall
charges every frame behind it; how late each frame's step started is kept
as the generator's lateness.  Spans: ``wait`` (the paced wait),
``frame_bases``, ``step``, ``drain`` (the synchronize).  A configuration
that pops a cfg past frame 0 is refused.
"""

from __future__ import annotations

import time

from portbench.drivers import _common
from portbench.sample import Sampler


def run(ctx) -> dict:
    import torch
    from versatilefilmgrain_tpu_torch.ops import grain_natural as gn

    t = ctx.traffic
    rate, npool = float(t["rate_fps"]), t["pool_frames"]
    _common.pops_at_frame_0_only(ctx, "paced")
    pipe = _common.make_pipeline(ctx)
    pipe.maybe_switch_config(0)
    tables = gn.natural_tables(pipe.regs, ctx.device)
    ctx.mark("pipeline")
    kw = _common.step_kwargs(pipe)
    Y, U, V = _common.pool_planes(ctx, npool)
    sampler = Sampler(ctx.seed, 1, t["check_frames"])
    slots = [torch.empty((sampler.slots, *p.shape[1:]), dtype=p.dtype,
                         device=p.device) for p in (Y, U, V)]
    spans = ctx.spans

    def step(k):
        pipe.maybe_switch_config(k)
        with spans("frame_bases"):
            base, base_up = pipe.frame_bases(k)
        i = k % npool
        with spans("step"):
            return gn.add_grain_batch_natural(
                Y[i:i + 1], U[i:i + 1], V[i:i + 1], [base], [base_up],
                tables, **kw)

    ctx.mark("pool")
    step(0)                           # warm-up: builds and loads K1
    _common.settle(ctx.device)
    ctx.mark("warm-up")
    spans.seconds.clear()

    frames_due = max(1, round(rate * ctx.seconds))
    latency, lateness = [], []
    done = _common.Completions(ctx.device)
    with ctx.trace:
        t0 = done.open()
        for k in range(frames_due):
            due = t0 + k / rate
            if due > time.monotonic():
                with spans("wait"):
                    _common.wait_until(due)
            lateness.append(time.monotonic() - due)
            out = step(k)
            mark = done.mark()
            slot = sampler.offer(k, 0)
            if slot is not None:
                for s, o in zip(slots, out):
                    s[slot].copy_(o[0])
            with spans("drain"):
                mark.synchronize()
            latency.append(time.monotonic() - due)
        _common.sync(ctx.device)
    k = frames_due - 1
    samples = [(n, n % npool, [s[slot] for s in slots])
               for slot, n in sorted(sampler.kept.items())]
    samples.append((k, k % npool, [o[0] for o in out]))
    rec = dict(setup_s=t0 - ctx.t_start, seconds=ctx.seconds,
               attempted=frames_due, missing=0, samples=samples, crop=False,
               check_target=min(sampler.slots, frames_due) + 1,
               latency_s=latency, lateness_s=lateness, rate_fps=rate,
               steps=frames_due, frames=frames_due, batch=1,
               geometry=_common.geometry(ctx.config),
               spans=spans.seconds, trace=ctx.trace.result,
               memory_peak_bytes=_common.memory_peak(ctx.device))
    lat = sorted(latency)
    rec["notes"] = [
        f"{frames_due} frames due at {rate:g} fps; latency median "
        f"{1e3 * lat[len(lat) // 2]:.4f} ms, max {1e3 * lat[-1]:.4f} ms; "
        f"the generator started a step late by at most "
        f"{1e3 * max(lateness):.4f} ms (median "
        f"{1e3 * sorted(lateness)[len(lateness) // 2]:.4f} ms)"]
    del pipe, tables, Y, U, V, out
    _common.release(ctx.device)
    return rec
