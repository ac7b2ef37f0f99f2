"""The pipe drivers' sink process: an encoder's stand-in.

For each command line ``stream <keep>`` on its standard input it opens the
FIFO for reading (which waits for the program to open it), sets the pipe's
size and reads whole frames until the end of the stream, stamping each
frame's arrival on the host's monotonic clock.  With ``keep`` 1 it keeps
the frames the seeded ``Sampler`` draws at each batch position, the frame
at each config switch ``--switches`` names and the frame before it, for
up to ``SWITCH_SLOTS`` switches drawn from the seed as the stream reaches
them, and the last frame; the rest are dropped.  Then it writes one JSON
line (``frames``, ``partial_bytes`` of a cut last frame, ``arrivals``,
``pipe_bytes``, ``kept``: the frame indices in the order their bytes
follow, ``at_switches``: the POCs of the switches kept) and the kept
frames' bytes to its standard output.  Writes nothing to disk.

    python -m portbench.drivers._sink --fifo PATH --frame-bytes B --seed S
        --positions P --per-position K --pipe-bytes B
        [--switches POC,POC,...] [--cpu C]

With ``--cpu`` it runs on that CPU alone.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from portbench import affinity
from portbench.drivers._fifo import set_pipe_size
from portbench.sample import Sampler

# Config switches whose two frames a stream keeps at most: 16 frames, 50 MB
# at 1080p 8-bit.
SWITCH_SLOTS = 8


def read_frame(fd: int, mv) -> int:
    """Fill ``mv`` from ``fd``; returns the bytes read (fewer at the end
    of the stream)."""
    got = 0
    while got < len(mv):
        n = os.readv(fd, [mv[got:]])
        if n == 0:
            break
        got += n
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fifo", required=True)
    for k in ("frame-bytes", "seed", "positions", "per-position",
              "pipe-bytes"):
        ap.add_argument(f"--{k}", type=int, required=True)
    ap.add_argument("--switches", default="")
    ap.add_argument("--cpu", type=int, default=-1)
    a = ap.parse_args(argv)
    pocs = {int(p) for p in a.switches.split(",") if p}
    if a.cpu >= 0:
        affinity.pin(a.cpu)
    fb = a.frame_bytes
    bufs = [np.empty(fb, np.uint8) for _ in range(2)]
    views = [memoryview(b) for b in bufs]
    kept_bytes = switch_bytes = None
    out = sys.stdout.buffer
    for line in sys.stdin:
        keep = line.split()[1] == "1"
        sampler = Sampler(a.seed, a.positions, a.per_position)
        at_switch = Sampler(a.seed, 1, SWITCH_SLOTS, key=0x5C4)
        if keep and kept_bytes is None:
            kept_bytes = np.empty((sampler.slots, fb), np.uint8)
            if pocs:
                switch_bytes = np.empty((2 * SWITCH_SLOTS, fb), np.uint8)
        fd = os.open(a.fifo, os.O_RDONLY)
        size = set_pipe_size(fd, a.pipe_bytes)
        n, partial, arrivals = 0, 0, []
        try:
            while True:
                got = read_frame(fd, views[n % 2])
                if got < fb:
                    partial = got
                    break
                arrivals.append(time.monotonic())
                if keep:
                    slot = sampler.offer(n, n % a.positions)
                    if slot is not None:
                        kept_bytes[slot] = bufs[n % 2]
                    if n in pocs:
                        slot = at_switch.offer(n, 0)
                        if slot is not None:   # frames n - 1 and n
                            switch_bytes[2 * slot] = bufs[(n - 1) % 2]
                            switch_bytes[2 * slot + 1] = bufs[n % 2]
                n += 1
        finally:
            os.close(fd)
        kept = sorted(sampler.kept.items()) if keep else []
        at = sorted(at_switch.kept.items()) if keep else []
        tail = [n - 1] if keep and n else []
        out.write((json.dumps(dict(
            frames=n, partial_bytes=partial, arrivals=arrivals,
            pipe_bytes=size, kept=[f for _, f in kept] + [
                f for _, p in at for f in (p - 1, p)] + tail,
            at_switches=[p for _, p in at])) + "\n")
            .encode())
        for slot, _ in kept:
            out.write(kept_bytes[slot].data)
        for slot, _ in at:
            out.write(switch_bytes[2 * slot].data)
            out.write(switch_bytes[2 * slot + 1].data)
        if tail:
            out.write(bufs[(n - 1) % 2].data)
        out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
