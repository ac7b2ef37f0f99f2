"""What holds K3 (csrc/grain_tiled.cu) at its time: variants and ablations
of the kernel, built from its own source with its probe hooks (``-D``, see
the source's header), timed on the card at the headline shape.

    python -m versatilefilmgrain_tpu_torch.tools.probe_tiled

8 frames of 3840x2160 10-bit 4:2:0 seeded planes, the CLI's built-in
config (its luma LUT selects all 8 window candidates, its chroma LUTs 1).

  kernel   K3 as built for the engine (4 thread blocks per SM asked)
  min5     5 thread blocks per SM asked: a 48-register cap
  stage8   all 8 candidates of every window staged, not only the LUT's
  nostage  ablation: no window staged from L2
  cand0    ablation: every pixel reads candidate 0 of its window
  copy     ablation: the samples stored unchanged (no LUT, staging, grain)

The first three must give K3's output (checked on the seeded planes); the
ablations are wrong on purpose.  Each variant's three plane launches are
timed in turns, the list and then the list reversed (``_harness.chain_ms``:
a step's output planes are the next step's input, median of 3 chains of
20), whole and per plane, beside a torch copy of the planes and the byte
bound.  Prints each variant's uint16 instances' registers, local memory
and thread blocks per SM, and one line per variant and turn.  Exits 2
without a CUDA device.
"""

from __future__ import annotations

import sys

import torch

from . import _harness as hz

VARIANTS = {
    "kernel": (),
    "min5": ("VFG_TILED_MIN_BLOCKS=5",),
    "stage8": ("VFG_TILED_PROBE=1",),
    "nostage": ("VFG_TILED_PROBE=2",),
    "cand0": ("VFG_TILED_PROBE=4",),
    "copy": ("VFG_TILED_PROBE=8",),
}
EXACT = ("kernel", "min5", "stage8")
SEED = 5


def plane_args(planes, regs, tables):
    """K3's arguments for each of the three planes: (args, keywords)."""
    from ..ops import grain_natural, grain_pallas, lfsr
    R, C = hz.H // 16, hz.W // 16
    bases, _ = hz.frame_bases(regs, planes[0].shape[0], R, C)
    lat = lfsr.state_lattice_torch(bases, R, C, planes[0].device)
    lat_up = grain_natural._rows_above(lat)
    return [grain_pallas._plane_args(p, c, lat, lat_up, tables, bs=regs.bs,
                                     csubx=regs.csubx, csuby=regs.csuby)
            for c, p in enumerate(planes)]


def main() -> int:
    if hz.no_card("probe_tiled"):
        return 2
    from ..ops import _kernels, grain_pallas
    regs = hz.default_regs()
    planes = hz.random_state(hz.FRAMES_BATCH, SEED, device="cuda")
    pargs = plane_args(planes, regs, grain_pallas.pallas_tables(regs, "cuda"))

    def launch(defines, p, args, kw):
        return grain_pallas._launch_tiled(p, *args[1:], defines=defines, **kw)

    def step(defines):
        return lambda *ps: tuple(launch(defines, p, a, kw)
                                 for p, (a, kw) in zip(ps, pargs))

    for defines in VARIANTS.values():
        _kernels.build(["grain_tiled"], defines)
    want = step(())(*planes)
    nbytes = sum(2 * a[0].numel() * a[0].element_size()
                 + sum(t.numel() * t.element_size() for t in a[1:])
                 for a, _ in pargs)
    copy_ms = hz.chain_ms(lambda *ps: tuple(p.clone() for p in ps), planes,
                          ())
    print(f"card: {hz.card()}; probe_tiled: K3's three plane launches, "
          f"{hz.FRAMES_BATCH} frames {hz.W}x{hz.H} 10-bit 4:2:0, ms per "
          f"step (CUDA events, median of 3 chains of 20); bound "
          f"{1e3 * nbytes / hz.HBM_BYTES_S:.4f} ms ({nbytes} bytes at the "
          f"H100 SXM data sheet's rate); a torch copy of the three planes "
          f"{copy_ms:.4f} ms", flush=True)
    for name, defines in VARIANTS.items():
        lib = _kernels.load("grain_tiled", defines)
        infos = ", ".join(
            "{}x{} {registers} / {local_bytes} / {blocks_per_sm}".format(
                bh, bw, **_kernels.kernel_info(lib.vfg_grain_tiled_info, 2,
                                               bh, bw))
            for bh, bw, _ in grain_pallas._GEOMETRIES)
        exact = (all(map(torch.equal, step(defines)(*planes), want))
                 if name in EXACT else "ablation")
        print(f"  {name:8s} uint16 instances, registers / local bytes / "
              f"blocks per SM: {infos}; == K3: {exact}", flush=True)
        if name in EXACT and not exact:
            raise RuntimeError(f"probe_tiled: variant {name} differs from "
                               f"K3")
    order = list(VARIANTS) + list(reversed(VARIANTS))
    for turn, name in enumerate(order):
        d = VARIANTS[name]
        ms = hz.chain_ms(step(d), planes, ())
        per = [hz.chain_ms(lambda p, a=a, kw=kw: (launch(d, p, a, kw),),
                           (a[0],), ()) for a, kw in pargs]
        print(f"  turn {turn:2d} {name:8s} {ms:.4f} ms (Y, U, V "
              f"{per[0]:.4f}, {per[1]:.4f}, {per[2]:.4f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
