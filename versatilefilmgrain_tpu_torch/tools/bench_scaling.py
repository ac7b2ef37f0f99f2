"""Multi-device scaling benchmark: frames/s at 1..N devices.

Port of the repo's tools/bench_scaling.py.  Times the sharded grain step
(``parallel/mesh.make_grain_step``, natural engine: K1 on each shard) at
each device count, frames split over the mesh's ``data`` axis, and reports
scaling efficiency against one device.  The steady-state step has no
collectives (zero-halo design), so on separate cards efficiency should
track the hardware.

    python -m versatilefilmgrain_tpu_torch.tools.bench_scaling [--repeat N]

Timing is ``_harness.chain_ms``: CUDA events around a chain of 20 steps,
each consuming the previous step's output, median of 3 chains after one
warm-up chain.

With no ``--repeat``, the mesh takes this process's CUDA devices.
``--repeat N`` builds meshes of up to N entries of ``cuda:0`` instead: the
shards of one card run in turn, so it exercises the path and its overhead
and its numbers are not scaling claims (the counterpart of the JAX tool's
``--cpu N``).  Prints one JSON line per device count (``devices``, ``fps``,
``mesh``, ``efficiency``, the card's name and power limit), then one line
``{"metric": "scaling", ...}``.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import _harness as hz


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m versatilefilmgrain_tpu_torch.tools.bench_scaling")
    ap.add_argument("--repeat", type=int, default=0,
                    help="mesh N entries of cuda:0 (exercises the path; "
                         "not a scaling claim)")
    ap.add_argument("--height", type=int, default=hz.H)
    ap.add_argument("--width", type=int, default=hz.W)
    ap.add_argument("--frames-per-device", type=int, default=4)
    args = ap.parse_args(argv)
    if hz.no_card("bench_scaling"):
        return 2

    from ..ops.grain_natural import natural_tables
    from ..parallel import mesh as pmesh

    H, W = args.height, args.width
    R, C = -(-H // 16), -(-W // 16)
    regs = hz.default_regs()
    if args.repeat:
        devices = [torch.device("cuda", 0)] * args.repeat
    else:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    card = hz.card()
    note = ("repeat: every shard on cuda:0, run in turn; not a scaling claim"
            if args.repeat else "one shard per card")
    results = {}
    base_fps = None
    for n in [n for n in (1, 2, 4, 8, 16, 32) if n <= len(devices)]:
        nd, nt = n, 1   # throughput scaling: pure frame parallelism
        F = nd * args.frames_per_device
        m = pmesh.make_mesh(nd, nt, devices[:n])
        step = pmesh.make_grain_step(
            m, height=H, width=W, bs=regs.bs, csubx=regs.csubx,
            csuby=regs.csuby, engine="natural",
            tables=natural_tables(regs, devices[0]))
        bases, bases_up = hz.frame_bases(regs, F, R, C)
        state = hz.random_state(F, 0, R * 16, C * 16, device=devices[0])
        fps = F / (hz.chain_ms(step, state, (bases, bases_up)) * 1e-3)
        if base_fps is None:
            base_fps = fps
        results[str(n)] = dict(fps=fps, mesh=f"data={nd},tile={nt}",
                               efficiency=fps / (base_fps * n))
        print(json.dumps({"devices": n, **results[str(n)], "card": card,
                          "note": note}), flush=True)
    print(json.dumps({"metric": "scaling", "engine": "natural",
                      "card": card, "note": note, "results": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
