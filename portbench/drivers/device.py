"""Closed loop on frames decoded into device memory, as a GPU transcoder
holds them (FFmpeg's ``-hwaccel cuda -hwaccel_output_format cuda``,
GStreamer's nvcodec elements): ``GrainPipeline.run_device(src, dst,
batch=...)`` with the program's device ends (``utils/device_io.py``).

The decoder's surface pool is ``pool_frames`` distinct seeded frames on
the device, laid out as the CLI's files are (planar, 16-bit
little-endian samples above 8 bits); frame n of the stream is pool frame
n % ``pool_frames``.  The source lends them in order until the window
closes, as the pipe feeder's ``until`` does; the program then drains what
it holds.  The sink is the program's ``DeviceSink`` of ``sink_frames``
frames.  Its callback, the encoder's hand-off, stamps each frame on the
host clock from the window's opening into ``done`` (the frame's copy is
complete on the device by then) and keeps the sampled frames (one per
batch position) and the last frame by a device copy.  ``fps_pipe`` counts
the frames handed on inside the window.

Set-up makes the pool and runs one short stream end to end
(``warm_frames``), which builds and loads K1 and pops the configuration's
cfg.  A configuration that pops a cfg past frame 0 is refused, and so is a
program without ``run_device``.  The notes give the window's CPU
seconds of the loop's thread and of the others.  In a traced run
``run_device`` runs with ``verbose`` under the profiler, the harness's
spans wrap ``frame_bases``, the step and the ends' calls (``read``,
``drain``) as the pipe driver's do, and the record carries the
program's ``batches`` and ``device_frames`` counters of the window.
"""

from __future__ import annotations

import contextlib
import io
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench import frames
from portbench.drivers import _common
from portbench.sample import Sampler


def _pool(ctx, count: int):
    """``count`` seeded frames (pool indices 0..count-1) as the rows of a
    (count, frame bytes) uint8 tensor on the device."""
    import torch
    W, H, D, fmt = _common.geometry(ctx.config)
    with ThreadPoolExecutor(4) as ex:
        raw = list(ex.map(lambda i: frames.raw_frame(frames.frame_planes(
            W, H, D, fmt, ctx.seed, i)), range(count)))
    return torch.from_numpy(np.stack(raw)).to(ctx.device)


def _thread_cpu() -> dict:
    """CPU seconds of each of this process's threads, by thread id, from
    ``/proc/self/task`` (empty where there is none)."""
    out = {}
    with contextlib.suppress(OSError):
        for tid in os.listdir("/proc/self/task"):
            with contextlib.suppress(OSError, ValueError, IndexError):
                with open(f"/proc/self/task/{tid}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
                out[int(tid)] = ((int(fields[11]) + int(fields[12]))
                                 / os.sysconf("SC_CLK_TCK"))
    return out


def _cpu_note(before: dict, after: dict, seconds: float) -> str:
    """The window's CPU seconds of the loop's thread and of the others."""
    main = os.getpid()
    used = {t: after[t] - before.get(t, 0.0) for t in after}
    rest = sorted((v for t, v in used.items() if t != main), reverse=True)
    return (f"CPU seconds in the {seconds:g} s window: the loop's thread "
            f"{used.get(main, 0.0):.2f}, the {len(rest)} others "
            f"{sum(rest):.2f}, the busiest of them "
            + " ".join(f"{v:.2f}" for v in rest[:3]))


class _Lender:
    """The decoder: pool frames in stream order, until ``deadline`` (host
    clock) or ``count`` frames; ``lent`` once it has ended."""

    def __init__(self, pool, deadline=None, count=None):
        self.pool, self.deadline, self.count = pool, deadline, count
        self.lent = None

    def __iter__(self):
        n = 0
        while (n != self.count and (self.deadline is None
                                    or time.monotonic() < self.deadline)):
            yield self.pool[n % len(self.pool)]
            n += 1
        self.lent = n


def run(ctx) -> dict:
    import torch
    from versatilefilmgrain_tpu_torch import GrainPipeline
    from portbench.run import Refused
    if not hasattr(GrainPipeline, "run_device"):
        raise Refused("the program has no GrainPipeline.run_device")
    from versatilefilmgrain_tpu_torch.utils import device_io, tracing

    t = ctx.traffic
    W, H, D, fmt = _common.geometry(ctx.config)
    batch, npool = t["batch"], t["pool_frames"]
    fb = frames.frame_bytes(W, H, D, fmt)
    _common.pops_at_frame_0_only(ctx, "device")
    pipe = _common.make_pipeline(ctx)
    ctx.mark("pipeline")
    pool = _pool(ctx, npool)
    ctx.mark("pool")

    # warm-up: one short stream end to end
    warm = device_io.DeviceSink(fb, t["sink_frames"], ctx.device,
                                lambda frame: None)
    pipe.run_device(device_io.DeviceSource(_Lender(pool, count=t[
        "warm_frames"])), warm, batch=batch)
    del warm
    sampler = Sampler(ctx.seed, batch, t["check_per_position"])
    keep = torch.empty((sampler.slots + 1, fb), dtype=torch.uint8,
                       device=ctx.device)
    done, kept_last = [], []
    lender = _Lender(pool)

    def hand(frame):
        n = len(done)
        done.append(time.monotonic() - t0)
        slot = sampler.offer(n, n % batch)
        if slot is not None:
            keep[slot].copy_(frame)
        if lender.lent is not None and n == lender.lent - 1:
            keep[-1].copy_(frame)
            kept_last.append(n)

    sink = device_io.DeviceSink(fb, t["sink_frames"], ctx.device, hand)
    _common.settle(ctx.device)
    ctx.mark("warm-up")

    src = device_io.DeviceSource(lender)
    if ctx.traced:
        # the harness's spans, as the pipe driver's: the idle gaps by call
        pipe.frame_bases = ctx.spans.wrap(pipe.frame_bases, "frame_bases")
        pipe._step = ctx.spans.wrap(pipe._step, "step")
        src.next = ctx.spans.wrap(src.next, "read")
        sink.put = ctx.spans.wrap(sink.put, "drain")
    err = io.StringIO()
    with ctx.trace, contextlib.redirect_stderr(err):
        cpu0 = _thread_cpu()
        t0 = time.monotonic()
        lender.deadline = t0 + ctx.seconds
        out_frames = pipe.run_device(src, sink, batch=batch,
                                     verbose=ctx.traced)
        cpu1 = _thread_cpu()
    counters = tracing.record()["counters"] if ctx.traced else {}
    peak = _common.memory_peak(ctx.device)
    sys.stderr.write(err.getvalue())
    lent, handed = lender.lent, len(done)
    host = keep.cpu().numpy()
    samples = [(n, n % npool, frames.split_raw(host[slot], W, H, D, fmt))
               for slot, n in sorted(sampler.kept.items())]
    samples += [(n, n % npool, frames.split_raw(host[-1], W, H, D, fmt))
                for n in kept_last]
    del pipe, sink, src, pool, keep, host
    _common.release(ctx.device)
    return dict(
        setup_s=t0 - ctx.t_start, seconds=ctx.seconds, attempted=lent,
        missing=abs(lent - handed) + (out_frames != handed),
        samples=samples, crop=True,
        check_target=min(sampler.slots, handed) + (handed > 0),
        done=done, frames=out_frames, batch=batch,
        steps=counters.get("batches"),
        device_frames=counters.get("device_frames"),
        geometry=_common.geometry(ctx.config), spans=ctx.spans.seconds,
        trace=ctx.trace.result, memory_peak_bytes=peak,
        notes=[f"{lent} frames lent from a pool of {npool} on the device, "
               f"{handed} handed on ({sum(d <= ctx.seconds for d in done)} "
               f"inside the {ctx.seconds:g} s window); frames a tenth of "
               f"the window: " + " ".join(map(str, np.histogram(
                   done, 10, (0.0, ctx.seconds))[0])),
               _cpu_note(cpu0, cpu1, ctx.seconds)])
