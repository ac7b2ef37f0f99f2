"""Two measurements made once, on the card, to size the cells (not part
of a benchmark run).

    python -m portbench.sweep ceiling --config <config> [--seconds 5]
    python -m portbench.sweep knee --workload <paced cell> --rates 60,120,...

``ceiling``: the pipe drivers' feeder writes straight into their sink
through one FIFO, with no program between, at the pipe size of the mix
(``--pipe-bytes``, default the pipe_b8 mix's) and at the kernel's default
of 64 KiB: the frames/s the harness itself could carry, so that
``fps_pipe`` is known to measure the program and not the pipes.

``knee``: the paced driver at each rate in turn (``--rates``) for
``--seconds`` each: frames due, latency median and 95th percentile,
lateness median and at the end of the window, frames completed per
second, and whether a backlog grew (the last tenth's lateness more than a
period above the first tenth's).  The highest rate without a growing
backlog is the knee.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from portbench import frames, run

ROOT = os.path.dirname(run.PKG)


def ceiling(config: str, seconds: float, pipe_bytes: int) -> dict:
    with open(os.path.join(run.PKG, "configs", config + ".json")) as f:
        c = json.load(f)
    W, H, D, fmt = c["width"], c["height"], c["depth"], c["chroma_format"]
    fb = frames.frame_bytes(W, H, D, fmt)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    fifo = os.path.join(tmp, "pipe.yuv")
    os.mkfifo(fifo)
    args = dict(stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=ROOT)
    feed = subprocess.Popen([
        sys.executable, "-m", "portbench.drivers._feed", "--fifo", fifo,
        "--width", str(W), "--height", str(H), "--depth", str(D), "--fmt",
        str(fmt), "--seed", "1", "--pool", "16", "--pipe-bytes",
        str(pipe_bytes)], **args)
    sink = subprocess.Popen([
        sys.executable, "-m", "portbench.drivers._sink", "--fifo", fifo,
        "--frame-bytes", str(fb), "--seed", "1", "--positions", "8",
        "--per-position", "1", "--pipe-bytes", str(pipe_bytes)], **args)
    try:
        feed.stdout.readline()
        t0 = time.monotonic()
        feed.stdin.write(f"until {t0 + seconds!r}\n".encode())
        feed.stdin.flush()
        sink.stdin.write(b"stream 0\n")
        sink.stdin.flush()
        head = json.loads(sink.stdout.readline())
        wrote = feed.stdout.readline().split()
    finally:
        for p in (feed, sink):
            p.stdin.close()
            p.wait(timeout=60)
        os.remove(fifo)
        os.rmdir(tmp)
    done = [a - t0 for a in head["arrivals"]]
    fps = sum(d <= seconds for d in done) / seconds
    return dict(config=config, pipe_bytes=head["pipe_bytes"],
                frames=head["frames"], written=int(wrote[1]), fps=fps,
                gbytes_s=fps * fb / 1e9)


def knee(workload: str, rates, seconds: float, seed: int) -> list:
    rows = []
    for rate in rates:
        cell = run.Cell(ROOT, workload)
        cell.traffic = dict(cell.traffic, rate_fps=rate)
        args = argparse.Namespace(seed=seed, seconds=seconds, trace=0)
        ctx = run.Context(cell, args, "cuda", time.monotonic(), ROOT)
        driver = run.load_file(cell.driver_file, "portbench_knee_driver")
        rec = driver.run(ctx)
        lat = np.array(rec["latency_s"]) * 1e3
        late = np.array(rec["lateness_s"]) * 1e3
        tenth = max(1, len(late) // 10)
        grew = (np.median(late[-tenth:]) - np.median(late[:tenth])
                > 1e3 / rate)
        done = len(lat) / ((len(lat) - 1) / rate + lat[-1] / 1e3)
        rows.append(dict(rate=rate, frames=len(lat),
                         latency_median_ms=float(np.median(lat)),
                         latency_p95_ms=float(np.percentile(lat, 95)),
                         lateness_median_ms=float(np.median(late)),
                         lateness_last_ms=float(late[-1]),
                         backlog_grew=bool(grew), frames_per_s=done))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("ceiling", "knee"))
    ap.add_argument("--config", action="append")
    ap.add_argument("--workload")
    ap.add_argument("--rates", default="60,120,180,240")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--pipe-bytes", type=int, default=1 << 20)
    a = ap.parse_args(argv)
    if a.what == "ceiling":
        for config in a.config:
            for size in (a.pipe_bytes, 65536):
                print(json.dumps(ceiling(config, a.seconds, size)),
                      flush=True)
        return 0
    problem = run.card_problem(1)
    if problem:
        print(f"portbench.sweep: {problem}", file=sys.stderr)
        return 2
    for row in knee(a.workload, [float(r) for r in a.rates.split(",")],
                    a.seconds, a.seed):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
