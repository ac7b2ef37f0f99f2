"""The pipe drivers' feeder process: a decoder's stand-in.

Makes a pool of seeded raw frames (``portbench.frames``), prints ``ready``,
then for each command line on its standard input opens the FIFO for
writing (which waits for the program to open it), sets the pipe's size,
writes pool frame ``n % pool`` as frame ``n`` of the stream as fast as the
pipe takes them, closes the FIFO and prints ``wrote <frames> <pipe bytes>``:

* ``count <n>``: n frames;
* ``until <t>``: whole frames until the host's monotonic clock reaches t.

Imports numpy and the harness's frame module only.

    python -m portbench.drivers._feed --fifo PATH --width W --height H
        --depth D --fmt F --seed S --pool N --pipe-bytes B [--cpu C]

With ``--cpu`` it runs on that CPU alone once the pool is made.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from portbench import affinity, frames
from portbench.drivers._fifo import set_pipe_size


def write_all(fd: int, buf) -> None:
    mv = memoryview(buf).cast("B")
    while mv:
        mv = mv[os.write(fd, mv):]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    for k in ("width", "height", "depth", "fmt", "seed", "pool",
              "pipe-bytes"):
        ap.add_argument(f"--{k}", type=int, required=True)
    ap.add_argument("--fifo", required=True)
    ap.add_argument("--cpu", type=int, default=-1)
    a = ap.parse_args(argv)
    with ThreadPoolExecutor(4) as ex:
        pool = list(ex.map(lambda i: frames.raw_frame(frames.frame_planes(
            a.width, a.height, a.depth, a.fmt, a.seed, i)), range(a.pool)))
    if a.cpu >= 0:      # the pool is made on the program's CPUs, in set-up
        affinity.pin(a.cpu)
    print("ready", flush=True)
    for line in sys.stdin:
        cmd, arg = line.split()
        limit, deadline = ((int(arg), float("inf")) if cmd == "count"
                           else (float("inf"), float(arg)))
        fd = os.open(a.fifo, os.O_WRONLY)
        size = set_pipe_size(fd, a.pipe_bytes)
        n = 0
        try:
            while n < limit and time.monotonic() < deadline:
                write_all(fd, pool[n % a.pool])
                n += 1
        except BrokenPipeError:
            pass
        finally:
            os.close(fd)
        print(f"wrote {n} {size}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
