"""Closed loop through the CLI's library entry, pipe to pipe:
``GrainPipeline.run_file(src, dst, batch=...)`` with ``src`` and ``dst``
FIFOs in a fresh directory under ``TMPDIR``, as in
``dec | vfgs-torch | enc``.

A feeder process (``_feed``) cycles a seeded pool of raw frames into
``src`` as fast as the pipe takes them; a sink process (``_sink``) reads
``dst``, stamps each frame's arrival and keeps only what the check needs.
Set-up runs one short stream end to end (``warm_frames``), which builds and
loads every kernel and library and pops the configuration's cfg.  The
window opens as the timed ``run_file`` is called; the feeder writes whole
frames until the window closes, then the program drains what it holds.
``fps_pipe`` counts the frames that left ``dst`` inside the window.

A configuration whose cfg schedule pops past frame 0 warms up on a
pipeline of its own that pops every cfg of the schedule at frame 0, so
that nothing the switches build is built in the window; the timed pipeline
is made after the warm-up and pops only its frame-0 entries in set-up, so
the timed stream meets every switch.  The sink then also keeps the frames
at up to ``SWITCH_SLOTS`` switches and the frames before them.

In a traced run the pipeline's ``frame_bases`` and ``_step`` and the
native reader's and writer's calls are wrapped in spans (``frame_bases``,
``step``, ``read``, ``drain``), and ``run_file`` runs with ``verbose`` so
that its own read+stage and drain+write timers are read.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from portbench import affinity, frames
from portbench.drivers import _common
from portbench.drivers._sink import SWITCH_SLOTS

VERBOSE = re.compile(r"read\+stage ([0-9.]+)s step ([0-9.]+)s "
                     r"drain\+write ([0-9.]+)s")


# The helpers do numpy work and copies alone: one OpenMP, MKL and OpenBLAS
# thread each, so no idle pool thread spins beside the program's.
ONE_THREAD = {v: "1" for v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                               "OPENBLAS_NUM_THREADS")}


def _helper(ctx, name: str, index: int, args) -> subprocess.Popen:
    """Start helper ``name`` on the CPU kept for helper ``index``."""
    cpu = affinity.helper_cpu(index)
    return subprocess.Popen(
        [sys.executable, "-m", f"portbench.drivers.{name}", *map(str, args),
         "--cpu", str(-1 if cpu is None else cpu)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=ctx.root,
        env=dict(os.environ, **ONE_THREAD))


def _send(proc, line: str) -> None:
    proc.stdin.write((line + "\n").encode())
    proc.stdin.flush()


def _sink_result(sink, frame_bytes: int) -> tuple[dict, list]:
    head = json.loads(sink.stdout.readline())
    kept = []
    for n in head["kept"]:
        data = sink.stdout.read(frame_bytes)
        if len(data) != frame_bytes:
            raise RuntimeError("the sink ended before its kept frames")
        kept.append((n, np.frombuffer(data, np.uint8)))
    return head, kept


def _fed(feed) -> tuple[int, int]:
    words = feed.stdout.readline().split()
    if not words or words[0] != b"wrote":
        raise RuntimeError("the feeder ended early")
    return int(words[1]), int(words[2])


@contextlib.contextmanager
def _spanned(ctx, pipe):
    """The pipeline's bases and step and the native reader's and
    writer's calls inside spans (traced runs only)."""
    from versatilefilmgrain_tpu_torch.utils import native_io
    if not ctx.traced:
        yield
        return
    saved = (native_io.FrameReader.next, native_io.FrameWriter.put)
    pipe.frame_bases = ctx.spans.wrap(pipe.frame_bases, "frame_bases")
    pipe._step = ctx.spans.wrap(pipe._step, "step")
    native_io.FrameReader.next = ctx.spans.wrap(saved[0], "read")
    native_io.FrameWriter.put = ctx.spans.wrap(saved[1], "drain")
    try:
        yield
    finally:
        native_io.FrameReader.next, native_io.FrameWriter.put = saved
        del pipe.frame_bases, pipe._step


def run(ctx) -> dict:
    t = ctx.traffic
    W, H, D, fmt = _common.geometry(ctx.config)
    batch, npool = t["batch"], t["pool_frames"]
    fb = frames.frame_bytes(W, H, D, fmt)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    src, dst = os.path.join(tmp, "src.yuv"), os.path.join(tmp, "dst.yuv")
    os.mkfifo(src)
    os.mkfifo(dst)
    feed = _helper(ctx, "_feed", 0, [
        "--fifo", src, "--width", W, "--height", H, "--depth", D, "--fmt",
        fmt, "--seed", ctx.seed, "--pool", npool, "--pipe-bytes",
        t["pipe_bytes"]])
    switches = _common.switches(ctx)
    sink = _helper(ctx, "_sink", 1, [
        "--fifo", dst, "--frame-bytes", fb, "--seed", ctx.seed,
        "--positions", batch, "--per-position", t["check_per_position"],
        "--pipe-bytes", t["pipe_bytes"],
        "--switches", ",".join(map(str, switches))])
    try:
        pipe = _common.make_pipeline(ctx, [
            (0, cfg) for _, cfg in ctx.cell.schedule()] if switches else None)
        ctx.mark("pipeline")
        if feed.stdout.readline().strip() != b"ready":
            raise RuntimeError("the feeder did not start")
        ctx.mark("pool")
        # warm-up: one short stream end to end
        _send(feed, f"count {t['warm_frames']}")
        _send(sink, "stream 0")
        pipe.run_file(src, dst, batch=batch)
        _fed(feed)
        _sink_result(sink, fb)
        if switches:
            del pipe
            pipe = _common.make_pipeline(ctx)
            pipe.maybe_switch_config(0)
        _common.settle(ctx.device)
        ctx.mark("warm-up")

        err = io.StringIO()
        with _spanned(ctx, pipe), ctx.trace, \
                contextlib.redirect_stderr(err):
            t0 = time.monotonic()
            _send(feed, f"until {t0 + ctx.seconds!r}")
            _send(sink, "stream 1")
            out_frames = pipe.run_file(src, dst, batch=batch,
                                       verbose=ctx.traced)
        offered, pipe_bytes = _fed(feed)
        head, kept = _sink_result(sink, fb)
        peak = _common.memory_peak(ctx.device)
        del pipe
    except BaseException:
        for proc in (feed, sink):
            proc.kill()
        raise
    finally:
        for proc in (feed, sink):
            with contextlib.suppress(OSError):
                proc.stdin.close()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    _common.release(ctx.device)
    sys.stderr.write(err.getvalue())
    received = head["frames"]
    runfile = None
    m = VERBOSE.search(err.getvalue())
    if m:
        runfile = dict(frames=out_frames, read_stage_s=float(m.group(1)),
                       step_s=float(m.group(2)),
                       drain_write_s=float(m.group(3)))
    samples = [(n, n % npool, frames.split_raw(raw, W, H, D, fmt))
               for n, raw in kept]
    slots = batch * t["check_per_position"]
    at_switches = min(SWITCH_SLOTS, sum(p < received for p in switches))
    done = [a - t0 for a in head["arrivals"]]
    return dict(
        setup_s=t0 - ctx.t_start, seconds=ctx.seconds, attempted=offered,
        missing=abs(offered - received) + (head["partial_bytes"] > 0),
        samples=samples, crop=True,
        check_target=min(slots, received) + (received > 0)
        + 2 * at_switches,
        done=done, frames=out_frames, batch=batch,
        geometry=_common.geometry(ctx.config), spans=ctx.spans.seconds,
        trace=ctx.trace.result, runfile=runfile,
        memory_peak_bytes=peak,
        notes=[f"{offered} frames offered, {received} came out "
               f"({sum(d <= ctx.seconds for d in done)} inside the "
               f"{ctx.seconds:g} s window); pipes of {pipe_bytes} and "
               f"{head['pipe_bytes']} bytes"] + ([
                   f"{at_switches} of the {len(switches)} config switches "
                   f"reached, frames kept at POCs "
                   + " ".join(map(str, head["at_switches"]))
                   + " and the frames before them"] if switches else []))
