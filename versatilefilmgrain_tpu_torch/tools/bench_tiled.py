"""Time the tiled engine's step (``--engine pallas``) and its kernel K3 on
the card, beside the natural step, at the headline shape: 8 frames of
3840x2160 10-bit 4:2:0, the CLI's built-in config, seeded planes.

    python -m versatilefilmgrain_tpu_torch.tools.bench_tiled

It drives only the engines' batched steps (``add_grain_batch_pallas``,
``add_grain_batch_natural``), whose signatures every version of the port
shares, so it also times another checkout of the package: copy this file
and ``_harness.py`` into that checkout's ``tools/`` and run it there.

Prints one JSON line: the card and its power limit; per engine, the step's
device ms (``_harness.chain_ms``: CUDA events around a chain of 20 steps,
median of 3 chains after one warm-up chain); and from one profiled chain of
20 steps (``_harness.profile``), each kernel's device ms per step by name,
the kernels and the copies launched per step, and the kernels' device ms
per step.  Exits 2 without a CUDA device.
"""

from __future__ import annotations

import functools
import json
import sys

from . import _harness as hz

ITERS = 20  # steps in a timed or profiled chain
SEED = 5


def main() -> int:
    if hz.no_card("bench_tiled"):
        return 2
    from ..ops.grain_natural import add_grain_batch_natural, natural_tables
    from ..ops.grain_pallas import add_grain_batch_pallas, pallas_tables
    regs = hz.default_regs()
    R, C = hz.H // 16, hz.W // 16
    planes = hz.random_state(hz.FRAMES_BATCH, SEED, device="cuda")
    bases, bases_up = hz.frame_bases(regs, hz.FRAMES_BATCH, R, C)
    geo = dict(height=hz.H, width=hz.W, bs=regs.bs, csubx=regs.csubx,
               csuby=regs.csuby)
    steps = {
        "tiled": (add_grain_batch_pallas, pallas_tables(regs, "cuda")),
        "natural": (add_grain_batch_natural, natural_tables(regs, "cuda")),
    }
    res = {}
    for name, (fn, tables) in steps.items():
        step = functools.partial(fn, **geo)
        cargs = (bases, bases_up, tables)
        res[name] = dict(
            step_ms=hz.chain_ms(step, planes, cargs, n=ITERS),
            **hz.profile(lambda: step(*planes, *cargs), ITERS))
    print(json.dumps({"card": hz.card(),
                      "shape": f"{hz.FRAMES_BATCH}x{hz.W}x{hz.H} 10-bit 4:2:0",
                      "iters": ITERS, **res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
