"""Prefetch-pipeline probe of the grain kernel K1 on the card.

Port of the JAX package's tools/probe_ohpipe.py, which asks whether the
one-hot build of the next strip can hide under the current strip's matrix
product.  The Hopper kernel (csrc/probe_pipe.cu) asks the card's form of
that question: a persistent grid whose thread blocks each walk a run of
block rows, stage the pattern bank once, and prefetch the next tile's
pixels and words with cp.async while they compute the current one.  It
computes exactly what K1 computes, so its plain version is the grain step's
own (``add_grain_batch_plain``), and it must equal K1 byte for byte.

Run on the card from the repo root:
  python -m versatilefilmgrain_tpu_torch.tools.probe_ohpipe [default sei_ar afgs1]
For each config it prints K1's and the probe's device time per 8-frame 4K
step (kernels alone, on one lattice), for several grid sizes, and whether
the outputs are bit-exact.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..ops import _kernels
from ..ops.grain_natural import (_as_int32_words, _check_batch, _check_plane,
                                 _lattice, add_grain_batch_plain,
                                 grain_plane_cuda, natural_tables)
from . import _harness as hz

BLOCKS_PER_SM = 4   # default grid: at most this many thread blocks per SM
GRIDS = (1, 2, BLOCKS_PER_SM)   # the grids run_config times


def grain_plane_pipe_cuda(pix, words, tables: dict, *, c: int, csubx: int,
                          csuby: int, bs: int,
                          blocks_per_sm: int = BLOCKS_PER_SM) -> torch.Tensor:
    """Launch csrc/probe_pipe.cu on one plane of F frames; returns the new
    plane, equal to :func:`grain_plane_cuda`'s.  ``pix``: (F, R*bh, C*bw)
    uint16 on a CUDA device, 4-byte aligned; ``words``: (F, R, C) int32
    lattice words.  Adds one to ``grain_plane_pipe_cuda.launches`` per
    launch."""
    dev = pix.device
    if dev.type != "cuda":
        raise ValueError(f"grain_plane_pipe_cuda needs CUDA tensors, got "
                         f"{dev}")
    bh, bw = 16 // (csuby if c else 1), 16 // (csubx if c else 1)
    F, R, C = words.shape
    _check_plane(f"plane {c}", pix, (F, R * bh, C * bw), torch.uint16, dev)
    _check_plane("words", words, (F, R, C), torch.int32, dev)
    if pix.data_ptr() % 4:
        raise ValueError("plane must be 4-byte aligned")
    for k in ("pattern", "slut", "plut", "scalars"):
        if tables[k].device != dev or not tables[k].is_contiguous():
            raise ValueError(f"tables[{k!r}] must be contiguous on {dev}")
    pattern = tables["pattern"][1 if c else 0]
    lib = _kernels.load("probe_pipe")
    out = torch.empty_like(pix)
    rc = lib.vfg_probe_pipe(
        pix.data_ptr(), out.data_ptr(), words.data_ptr(), pattern.data_ptr(),
        tables["slut"][c].data_ptr(), tables["plut"][c].data_ptr(),
        tables["scalars"].data_ptr(), F, R, C, c, csubx, csuby, bs,
        int(tables["zero_scale"][c]), blocks_per_sm,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"probe_pipe kernel launch failed: CUDA error {rc}")
    grain_plane_pipe_cuda.launches += 1
    return out


grain_plane_pipe_cuda.launches = 0


def make_pipe_step(tables: dict, *, height: int, width: int, bs: int = 2,
                   csubx: int = 2, csuby: int = 2,
                   blocks_per_sm: int = BLOCKS_PER_SM):
    """The probe as a batched step ``(y, u, v, bases, bases_up) -> (y, u,
    v)`` (signature of the JAX probe's step): the lattice, then the probe
    kernel on each plane; on CPU tensors the plain grain step."""
    geo = dict(bs=bs, csubx=csubx, csuby=csuby)

    def step(y, u, v, bases, bases_up):
        del bases_up   # a frame's first block row never blends
        _check_batch(y, u, v, bases, tables, height, width)
        if y.device.type == "cpu":
            return add_grain_batch_plain(y, u, v, bases, tables, **geo)
        words = _as_int32_words(_lattice(bases, y))
        return tuple(grain_plane_pipe_cuda(p, words, tables, c=c,
                                           blocks_per_sm=blocks_per_sm, **geo)
                     for c, p in enumerate((y, u, v)))

    return step


def run_config(kind: str, state0, F: int):
    """Time K1 and the probe (at each of :data:`GRIDS` blocks per SM) on
    config ``kind`` on the card, kernels alone on one lattice; check
    bit-exactness.  Prints one line; returns ({name: ms per step}, exact)."""
    regs = hz.config_regs(kind)
    dev = state0[0].device
    tables = natural_tables(regs, dev)
    y = state0[0]
    R, C = y.shape[1] // 16, y.shape[2] // 16
    bases, _ = hz.frame_bases(regs, F, R, C)
    words = _as_int32_words(_lattice(bases, y))
    geo = dict(bs=regs.bs, csubx=regs.csubx, csuby=regs.csuby)

    def k1(y, u, v, words):
        return tuple(grain_plane_cuda(p, words, tables, c=c, **geo)
                     for c, p in enumerate((y, u, v)))

    def pipe(bps):
        return lambda y, u, v, words: tuple(
            grain_plane_pipe_cuda(p, words, tables, c=c, blocks_per_sm=bps,
                                  **geo) for c, p in enumerate((y, u, v)))

    want = k1(*state0, words)
    exact = all(all(torch.equal(a, b) for a, b in
                    zip(pipe(bps)(*state0, words), want)) for bps in GRIDS)
    times = {"K1": hz.chain_ms(k1, state0, (words,))}
    for bps in GRIDS:
        times[f"pipe/{bps}"] = hz.chain_ms(pipe(bps), state0, (words,))
    print(f"{kind:8s} " + "  ".join(f"{n}={ms:.4f} ms" for n, ms in
                                    times.items())
          + f"  {'bit-exact' if exact else '*** DIVERGES ***'}", flush=True)
    return times, exact


def main(argv=None) -> int:
    kinds = [a for a in (sys.argv[1:] if argv is None else argv)
             if not a.startswith("--")] or ["default", "sei_ar", "afgs1"]
    if not torch.cuda.is_available():
        print("probe_ohpipe: no CUDA device; the probe times the kernel on "
              "the card only", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    F = hz.FRAMES_BATCH
    state0 = hz.random_state(F, 0, device=dev)
    print(f"card: {hz.card()}; {hz.W}x{hz.H} 10-bit 4:2:0, {F} frames per "
          f"step; kernels alone, CUDA events, median of 3 chains of 20; "
          f"pipe/N: at most N thread blocks per SM", flush=True)
    ok = True
    for kind in kinds:
        ok &= run_config(kind, state0, F)[1]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
