"""Per-stage budget of the grain kernel K1 on the card.

Port of the JAX package's tools/probe_budget.py.  The kernel
(csrc/probe_budget.cu) is K1's own device code with one stage removed at a
time; each variant is timed at the headline shape (3840x2160 10-bit 4:2:0,
8 frames per step) against the whole kernel, and the differences are the
budget.  A variant's pixels are wrong on purpose but deterministic, and
each is held exactly against a plain torch version of the same ablation
(:func:`budget_batch_plain`, which the tests and chip_smoke.py use).

Variants (csrc/grain_natural_body.cuh's stage mask):
  full          K1 (mask 0)
  no-lut        scale = intensity, pattern = intensity & (n_pat - 1)
  no-select     pattern 0 for every pixel
  no-fetch      no shared-memory pattern read (a stand-in from its address)
  no-blend      overlap rows unblended
  no-deblock    no 3-tap at block edges
  no-epilogue   out = pix + P, wrapping
  no-stage      bank and LUTs read from device memory, not staged in shared
                memory (same pixels as full)
  no-chroma     chroma planes copied, no chroma launch
  prep-lattice  the state lattice alone (no kernel)
  prep-words    lattice, block words and the lane-word kernel K2 (no K1)
The kernel variants run on a lattice made once, so that the lattice's
launches (about a hundred) do not blur the kernel's budget; the prep
variants time what that leaves out.  The TPU probe's "reorder" variant
overlaps matrix-unit and vector work; K1 has no matrix unit, so it has no
counterpart.

Run on the card from the repo root:
  python -m versatilefilmgrain_tpu_torch.tools.probe_budget [default sei_ar afgs1]
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..ops import _kernels
from ..ops.grain_natural import (_as_int32_words, _check_plane, _lane_words3,
                                 _lattice, _rows_above,
                                 add_grain_batch_natural, grain_plane_cuda,
                                 natural_tables)
from ..ops.grain_ref import lane_offsets, plane_grain_lanes
from . import _harness as hz

# Stage name -> bit of the kernel's stage mask (grain_natural_body.cuh).
SKIP_BITS = {"lut": 1, "blend": 2, "deblock": 4, "epilogue": 8,
             "select": 16, "fetch": 32, "stage": 64}

# Kernel variants: name -> skip set ("chroma": no chroma launch).
VARIANTS = {
    "full": frozenset(),
    "no-lut": frozenset({"lut"}),
    "no-select": frozenset({"select"}),
    "no-fetch": frozenset({"fetch"}),
    "no-blend": frozenset({"blend"}),
    "no-deblock": frozenset({"deblock"}),
    "no-epilogue": frozenset({"epilogue"}),
    "no-stage": frozenset({"stage"}),
    "no-chroma": frozenset({"chroma"}),
}
PREP = ("prep-lattice", "prep-words")


def pattern_masks(tables: dict) -> tuple[int, int]:
    """``n_pat - 1`` of the luma and the chroma bank: no-lut's pattern index
    mask, with n_pat = the largest pattern index of the class's LUTs + 1
    (as the JAX package's natural_tables counts them)."""
    plut = tables["plut"].cpu()
    return (int(plut[0].max()) >> 4,
            max(int(plut[1].max()), int(plut[2].max())) >> 4)


def _skip_mask(skip) -> int:
    unknown = set(skip) - set(SKIP_BITS)
    if unknown or len(skip) > 1:
        raise ValueError(f"the kernel removes at most one stage of "
                         f"{sorted(SKIP_BITS)}, got {sorted(skip)}")
    return sum(SKIP_BITS[s] for s in skip)


def grain_plane_budget_cuda(pix, words, tables: dict, *, c: int, csubx: int,
                            csuby: int, bs: int, skip=frozenset(),
                            pat_mask: int = 0) -> torch.Tensor:
    """Launch csrc/probe_budget.cu with one stage removed (``skip``: empty
    or one name of :data:`SKIP_BITS`) on one plane of F frames; returns the
    new plane.  ``pix``: (F, R*bh, C*bw) uint16 on a CUDA device;
    ``words``: (F, R, C) int32 lattice words; ``pat_mask``: no-lut's
    pattern index mask (:func:`pattern_masks`).  Adds one to
    ``grain_plane_budget_cuda.launches`` per launch."""
    mask = _skip_mask(skip)
    dev = pix.device
    if dev.type != "cuda":
        raise ValueError(f"grain_plane_budget_cuda needs CUDA tensors, got "
                         f"{dev}")
    bh, bw = 16 // (csuby if c else 1), 16 // (csubx if c else 1)
    F, R, C = words.shape
    _check_plane(f"plane {c}", pix, (F, R * bh, C * bw), torch.uint16, dev)
    _check_plane("words", words, (F, R, C), torch.int32, dev)
    for k in ("pattern", "slut", "plut", "scalars"):
        if tables[k].device != dev or not tables[k].is_contiguous():
            raise ValueError(f"tables[{k!r}] must be contiguous on {dev}")
    pattern = tables["pattern"][1 if c else 0]
    if pix.data_ptr() % 16:
        raise ValueError("plane must be 16-byte aligned")
    lib = _kernels.load("probe_budget")
    out = torch.empty_like(pix)
    rc = lib.vfg_probe_budget(
        pix.data_ptr(), out.data_ptr(), words.data_ptr(), pattern.data_ptr(),
        tables["slut"][c].data_ptr(), tables["plut"][c].data_ptr(),
        tables["scalars"].data_ptr(), F, R, C, c, csubx, csuby, bs,
        int(tables["zero_scale"][c]), pat_mask, mask,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"probe_budget kernel launch failed: CUDA error "
                           f"{rc}")
    grain_plane_budget_cuda.launches += 1
    return out


grain_plane_budget_cuda.launches = 0


def grain_plane_budget_plain(pix, lat, tables: dict, *, c: int, csubx: int,
                             csuby: int, bs: int, skip=frozenset(),
                             pat_mask: int = 0) -> torch.Tensor:
    """Plain version of :func:`grain_plane_budget_cuda`, on any device;
    ``lat``: the (F, R, C) int64 lattice.  A plane whose scale LUT is
    identically zero is clipped only, whatever the skip set (as the kernel
    and the JAX probe do)."""
    sc = tables["scalars"]
    lo, hi = (sc[1], sc[2]) if c == 0 else (sc[3], sc[4])
    if tables["zero_scale"][c]:
        return torch.clamp(pix.to(torch.int32), lo << bs, hi << bs).to(
            pix.dtype)
    geo = dict(c=c, csubx=csubx, csuby=csuby)
    return plane_grain_lanes(
        pix, lane_offsets(lat, **geo), lane_offsets(_rows_above(lat), **geo),
        tables["pattern"][1 if c else 0], tables["slut"][c],
        tables["plut"][c], sc[0], lo, hi, bs=bs, skip=frozenset(skip),
        pat_mask=pat_mask, **geo)


def budget_batch_plain(y, u, v, lat, tables: dict, *, skip=frozenset(),
                       bs: int = 2, csubx: int = 2, csuby: int = 2):
    """Plain version of one kernel variant's step on (Y, U, V), on any
    device: ``skip`` is a value of :data:`VARIANTS`, ``lat`` the (F, R, C)
    int64 lattice."""
    return _variant_step(grain_plane_budget_plain, (y, u, v), lat, tables,
                         skip, pattern_masks(tables), bs=bs, csubx=csubx,
                         csuby=csuby)


def _variant_step(plane_fn, planes, words, tables, skip, masks, **geo):
    """``plane_fn`` on each plane ("chroma" in ``skip``: luma only, chroma
    copied) with the rest of ``skip`` removed from the kernel; ``masks``:
    :func:`pattern_masks`."""
    kernel_skip = frozenset(skip) - {"chroma"}
    grained = planes[:1] if "chroma" in skip else planes
    out = [plane_fn(p, words, tables, c=c, skip=kernel_skip,
                    pat_mask=masks[c > 0], **geo)
           for c, p in enumerate(grained)]
    return tuple(out + [p.clone() for p in planes[len(grained):]])


def make_step(tables: dict, *, skip=frozenset(), bs: int = 2, csubx: int = 2,
              csuby: int = 2):
    """One kernel variant as a step ``(y, u, v, lat, words) -> (y, u, v)``
    on a lattice made beforehand (``lat``: (F, R, C) int64; ``words``: the
    same as int32, what the kernel reads): the kernel on CUDA tensors,
    :func:`budget_batch_plain` on CPU tensors."""
    geo = dict(bs=bs, csubx=csubx, csuby=csuby)
    masks = pattern_masks(tables)

    def step(y, u, v, lat, words):
        if y.device.type == "cpu":
            return budget_batch_plain(y, u, v, lat, tables, skip=skip, **geo)
        return _variant_step(grain_plane_budget_cuda, (y, u, v), words,
                             tables, skip, masks, **geo)

    return step


def make_prep_step(kind: str, *, csubx: int = 2, csuby: int = 2):
    """The prep the kernel variants leave out, as a step ``(y, u, v, bases)
    -> (y, u, v)`` that returns the planes unchanged: "prep-lattice" builds
    the lattice, "prep-words" also the block words and their lane words
    (K2 on the card)."""
    if kind not in PREP:
        raise ValueError(f"prep step is one of {PREP}, got {kind!r}")

    def step(y, u, v, bases):
        lat = _lattice(bases, y)
        if kind == "prep-words":
            _lane_words3(lat, csubx, csuby, expand="pallas")
        return y, u, v

    return step


def run_config(kind: str, state0, F: int) -> dict:
    """Time every variant and the production step for config ``kind`` on
    the card; prints the budget and returns {name: ms per step}."""
    regs = hz.config_regs(kind)
    dev = state0[0].device
    tables = natural_tables(regs, dev)
    y = state0[0]
    R, C = y.shape[1] // 16, y.shape[2] // 16
    bases, bases_up = hz.frame_bases(regs, F, R, C)
    lat = _lattice(bases, y)
    words = _as_int32_words(lat)
    geo = dict(bs=regs.bs, csubx=regs.csubx, csuby=regs.csuby)
    masks = pattern_masks(tables)
    print(f"\n=== config {kind}: n_pat luma {masks[0] + 1}, chroma "
          f"{masks[1] + 1}; zero-scale planes {tables['zero_scale']} ===",
          flush=True)
    results = {}
    for name, skip in VARIANTS.items():
        results[name] = hz.chain_ms(make_step(tables, skip=skip, **geo),
                                    state0, (lat, words))
    for name in PREP:
        results[name] = hz.chain_ms(make_prep_step(name, csubx=regs.csubx,
                                                   csuby=regs.csuby),
                                    state0, (bases,))

    def production(y, u, v, bases):
        return add_grain_batch_natural(y, u, v, bases, bases_up, tables,
                                       height=y.shape[1], width=y.shape[2],
                                       **geo)

    def k1(y, u, v, words):
        return tuple(grain_plane_cuda(p, words, tables, c=c, **geo)
                     for c, p in enumerate((y, u, v)))

    results["K1 alone"] = hz.chain_ms(k1, state0, (words,))
    results["production step"] = hz.chain_ms(production, state0, (bases,))
    full = results["full"]
    print(f"budget [{kind}] (ms per step of {F} frames; delta = full - "
          f"variant):", flush=True)
    for name, ms in results.items():
        print(f"  {name:16s} {ms:8.4f} ms  {full - ms:+8.4f} ms", flush=True)
    return results


def main(argv=None) -> int:
    kinds = [a for a in (sys.argv[1:] if argv is None else argv)
             if not a.startswith("--")] or ["default", "sei_ar", "afgs1"]
    if not torch.cuda.is_available():
        print("probe_budget: no CUDA device; the probe times the kernel on "
              "the card only", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    F = hz.FRAMES_BATCH
    state0 = hz.random_state(F, 0, device=dev)
    print(f"card: {hz.card()}; {hz.W}x{hz.H} 10-bit 4:2:0, {F} frames per "
          f"step; CUDA events, median of 3 chains of 20", flush=True)
    for kind in kinds:
        run_config(kind, state0, F)
    return 0


if __name__ == "__main__":
    sys.exit(main())
