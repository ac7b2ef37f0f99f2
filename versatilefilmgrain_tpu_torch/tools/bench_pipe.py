"""Time the persistent pipeline probe K4 and the lane-word kernel K2 on the
card beside K1, at the headline shape: 8 frames of 3840x2160 10-bit 4:2:0,
the CLI's built-in config, seeded planes.

    python -m versatilefilmgrain_tpu_torch.tools.bench_pipe

It drives the kernels through wrappers whose signatures every version of
the port shares (``grain_plane_cuda``, ``grain_plane_pipe_cuda``,
``expand_words_cuda``, ``add_grain_batch_natural``), so it also times
another checkout of the package: copy this file and ``_harness.py`` into
that checkout's ``tools/`` and run it there.

Prints one JSON line: the card and its power limit; for K1 and for K4 at
each grid (:data:`GRIDS` and the checkout's default, at most N thread
blocks per SM) the step's ms (``_harness.chain_ms``, CUDA events around a
chain of 20 three-plane steps) and each plane's device ms per launch
(``_harness.profile``, a profiled chain of 20 launches of that plane), and
whether K4 equals K1; K2 on the three planes' block words, ms per launch
over chains of 200 (``_harness.calls_ms``) and its device ms per launch
(profiled); the ``word_expand="pallas"`` step's ms (chained) and its
kernels' device ms by name; K1's main instance's registers, shared and
local memory and blocks per SM and its SASS counts.  Exits 2 without a
CUDA device.
"""

from __future__ import annotations

import json
import sys

import torch

from . import _harness as hz

GRIDS = (1, 2)   # blocks per SM timed for K4, with the checkout's default
ITERS = 20       # steps in a timed or profiled chain
K2_ITERS = 200   # launches in a K2 chain
SEED = 5


def main() -> int:
    if hz.no_card("bench_pipe"):
        return 2
    from ..ops import grain_natural as gn
    from . import probe_ohpipe
    regs = hz.default_regs()
    F, R, C = hz.FRAMES_BATCH, hz.H // 16, hz.W // 16
    planes = hz.random_state(F, SEED, device="cuda")
    bases, bases_up = hz.frame_bases(regs, F, R, C)
    tables = gn.natural_tables(regs, "cuda")
    words = gn._as_int32_words(gn._lattice(bases, planes[0]))
    geo = dict(bs=regs.bs, csubx=regs.csubx, csuby=regs.csuby)

    def k1(c):
        return lambda p, w: (gn.grain_plane_cuda(p, w, tables, c=c, **geo),)

    def k4(bps):
        return lambda c: lambda p, w: (probe_ohpipe.grain_plane_pipe_cuda(
            p, w, tables, c=c, blocks_per_sm=bps, **geo),)

    def step(per_plane):
        fns = [per_plane(c) for c in range(3)]
        return lambda y, u, v, w: tuple(f(p, w)[0] for f, p in
                                        zip(fns, (y, u, v)))

    grids = sorted(set(GRIDS) | {probe_ohpipe.BLOCKS_PER_SM})
    kernels = {"K1": k1, **{f"K4/{n}": k4(n) for n in grids}}
    want = step(k1)(*planes, words)
    res = {}
    for name, per_plane in kernels.items():
        out = step(per_plane)(*planes, words)
        res[name] = dict(
            exact=all(torch.equal(a, b) for a, b in zip(out, want)),
            step_ms=hz.chain_ms(step(per_plane), planes, (words,), n=ITERS),
            plane_ms=[hz.profile(lambda c=c, p=p: per_plane(c)(p, words),
                                 ITERS)["kernels_ms"]
                      for c, p in enumerate(planes)])

    lat = gn._lattice(bases, planes[0])
    blk = [gn._block_words(lat, c, regs.csubx, regs.csuby) for c in range(3)]
    wblks, bws = [b for b, _ in blk], [bw for _, bw in blk]
    lanes = gn.expand_words_cuda(wblks, bws)
    k2_exact = all(torch.equal(a, b) for a, b in
                   zip(lanes, gn.expand_words_plain(wblks, bws)))

    def k2():
        return gn.expand_words_cuda(wblks, bws)

    k2_prof = hz.profile(k2, K2_ITERS)

    def pallas_step():
        return gn.add_grain_batch_natural(*planes, bases, bases_up, tables,
                                          height=hz.H, width=hz.W,
                                          word_expand="pallas", **geo)

    print(json.dumps({
        "card": hz.card(),
        "shape": f"{F}x{hz.W}x{hz.H} 10-bit 4:2:0", "iters": ITERS,
        **res,
        "K2": dict(exact=k2_exact, launch_ms=hz.calls_ms(k2, K2_ITERS),
                   device_ms=k2_prof["kernels_ms"],
                   bytes=sum(t.numel() * 4 for t in lanes + wblks)),
        "pallas_step": dict(step_ms=hz.calls_ms(pallas_step, ITERS),
                            **hz.profile(pallas_step, ITERS)),
        "K1_info": gn.grain_plane_info(2, False),
        "K1_sass": hz.sass_counts("grain_natural", hz.K1_MAIN,
                                  keys=hz.K1_SASS_KEYS),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
