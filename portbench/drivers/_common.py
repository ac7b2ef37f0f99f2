"""What the drivers share: the program's pipeline for a configuration, a
seeded pool of padded frames on the device, the device's completion times,
the memory peak and the release of the program's state."""

from __future__ import annotations

import gc
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from portbench import frames


def geometry(config: dict):
    return (config["width"], config["height"], config["depth"],
            config["chroma_format"])


def make_pipeline(ctx, schedule=None):
    """The program's ``GrainPipeline`` for the cell's configuration: the
    CLI's built-in config, then the configuration's cfg schedule
    (``schedule``, default the cell's: ``[(poc, cfg path), ...]``) as
    ``-c POC:<cfg>``; grain seed and gain the CLI's defaults."""
    from versatilefilmgrain_tpu_torch import GrainPipeline
    if schedule is None:
        schedule = ctx.cell.schedule()
    return GrainPipeline(*geometry(ctx.config),
                         configs=[f"{poc}:{cfg}" for poc, cfg in schedule],
                         device=ctx.device)


def switches(ctx) -> list[int]:
    """The POCs past frame 0 at which the cell's configuration pops a cfg,
    each once."""
    return sorted({poc for poc, _ in ctx.cell.schedule() if poc > 0})


def pops_at_frame_0_only(ctx, driver: str) -> None:
    """Refuse a configuration that pops a cfg past frame 0: ``driver``
    pops only at a step's first frame and builds its tables once, so it
    would grain the frames after a switch with stale tables."""
    from portbench.run import Refused
    late = switches(ctx)
    if late:
        raise Refused(f"the {driver} driver pops cfgs only at frame 0; "
                      f"the configuration switches at frames {late}")


def pool_planes(ctx, count: int):
    """``count`` seeded padded frames (pool indices 0..count-1) as three
    (count, rows, columns) tensors on the device, made on the host by a
    few threads and uploaded."""
    import torch
    W, H, D, fmt = geometry(ctx.config)
    with ThreadPoolExecutor(4) as ex:
        pool = list(ex.map(lambda i: frames.padded_frame(W, H, D, fmt,
                                                         ctx.seed, i),
                           range(count)))
    return tuple(torch.from_numpy(np.stack([f[c] for f in pool])).to(
        ctx.device) for c in range(3))


def step_kwargs(pipe) -> dict:
    """The keyword arguments of ``add_grain_batch_natural`` for ``pipe``."""
    r = pipe.regs
    return dict(height=pipe.height, width=pipe.width, bs=r.bs,
                csubx=r.csubx, csuby=r.csuby)


def sync(device: str) -> None:
    import torch
    if device.startswith("cuda"):
        torch.cuda.synchronize()


class Completions:
    """When each step's work finished on the device, in host seconds from
    the window's opening: CUDA events measured from an event recorded as
    the window opens (the device is idle then), or the host clock after a
    CPU step, which is synchronous."""

    def __init__(self, device: str):
        self.cuda = device.startswith("cuda")
        self.marks = []

    def open(self) -> float:
        """Open the window; returns its host time."""
        import torch
        t0 = time.monotonic()
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = t0
        return t0

    def mark(self):
        """Mark the end of the work enqueued so far; returns a handle
        whose ``synchronize()`` waits for it."""
        import torch
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
        else:
            ev = _Done(time.monotonic() - self.t0)
        self.marks.append(ev)
        return ev

    def seconds(self) -> list[float]:
        """Each mark's completion, in seconds from the window's opening
        (after a synchronize)."""
        if not self.cuda:
            return [m.t for m in self.marks]
        return [self.start.elapsed_time(m) / 1e3 for m in self.marks]


class _Done:
    def __init__(self, t: float):
        self.t = t

    def synchronize(self) -> None:
        pass


def settle(device: str) -> None:
    """Before the window opens: wait for the device, and collect the
    set-up's garbage so that no collection of it falls in the window."""
    sync(device)
    gc.collect()


def wait_until(due: float) -> None:
    """Return at host time ``due``: sleep to about a millisecond before
    it, then spin, so the wake-up's own jitter does not move the start."""
    rest = due - time.monotonic()
    if rest > 2e-3:
        time.sleep(rest - 1e-3)
    while time.monotonic() < due:
        pass


def memory_peak(device: str) -> int:
    import torch
    return (torch.cuda.max_memory_allocated() if device.startswith("cuda")
            else 0)


def release(device: str) -> None:
    """Free what the program left on the device (call once its objects
    are dropped)."""
    import torch
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
