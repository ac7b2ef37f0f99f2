"""Plain torch grain engine: the reference "HW layer" as tensor code.

Port of the JAX package's ops/grain_jnp.py, the whole-frame form of
vfgs_hw.c:140-312.  Every serial dependency of the reference's block pipeline
has a closed form:

* the LFSR schedule (vfgs_hw.c:288-312) is a per-(block-row, block-col)
  state lattice computed by GF(2) jump-ahead (ops/lfsr.py);
* vertical overlap (vfgs_hw.c:199-229) blends *pattern samples of the upper
  block*, whose offsets come from the ``rnd_up`` lattice -- not neighbouring
  pixel data -- so it is a per-pixel expression;
* the horizontal deblock (vfgs_hw.c:243-283) only mixes grain values within
  one line, so it is a masked 3-tap stencil over the grain line.

So every output pixel is an independent integer expression of (input pixel,
lattice state, config registers).  This module is the plain version of
csrc/grain_natural.cu: direct gathers, int32 arithmetic, arithmetic ``>>``
(C-style rounding ``round(a,s) = (a+(1<<(s-1)))>>s``, vfgs_hw.c:43).

Planes are padded to whole 16x16-luma-block multiples; padded samples get
grain like the reference's stride region (vfgs_hw.c:209-211 reads beyond
``width``) and are cropped by the caller.
"""

from __future__ import annotations

import torch

from . import lfsr
from .offsets import block_offsets


def _round_shift(a, s):
    """C round(a,s) for a positive shift."""
    return (a + (1 << (s - 1))) >> s


def plane_grain(pix, states, states_up, pattern, slut, plut, scale_shift,
                imin, imax, *, c: int, csubx: int, csuby: int, bs: int):
    """Add grain to one plane of F frames.

    pix: (F, Hp, Wp) uint8/uint16, padded to (R*bh, C*bw).
    states/states_up: (F, R, C) int64 block lattices (current / upper block
    row; row 0 of ``states_up`` is never read, a frame's first block row
    does not blend).
    pattern: (8, 64, 64) int8 -- this plane class's patterns.
    slut/plut: (256,) integer tensors -- scale / pattern LUTs of component c.
    scale_shift/imin/imax: ints or 0-d integer tensors (config registers).
    Returns (F, Hp, Wp) tensors of pix's dtype.
    """
    F, Hp, Wp = pix.shape
    dev = pix.device
    subx = csubx if c else 1
    suby = csuby if c else 1
    bh, bw = 16 // suby, 16 // subx
    R, C = Hp // bh, Wp // bw
    # Vertical-overlap lines per block: luma-lines j==0 and j==1
    # (vfgs_hw.c:175-188); for suby==2 the j==1 line is skipped entirely.
    n_ov = 1 if suby == 2 else 2
    oc1 = torch.tensor([20] if suby == 2 else [12, 24], dtype=torch.int32,
                       device=dev).view(1, 1, n_ov, 1, 1)
    oc2 = torch.tensor([20] if suby == 2 else [24, 12], dtype=torch.int32,
                       device=dev).view(1, 1, n_ov, 1, 1)

    s, ox, oy = block_offsets(states, c, csubx, csuby)
    su, oxu, oyu = block_offsets(states_up, c, csubx, csuby)

    x = pix.to(torch.int32)
    intensity = ((x >> bs) & 0xFF).long()
    pi = plut.long()[intensity] >> 4          # pattern index (vfgs_hw.c:212)
    sc = slut.to(torch.int32)[intensity]      # scale (vfgs_hw.c:239)

    pat = pattern.reshape(-1)
    pi5 = pi.view(F, R, bh, C, bw)
    jj = torch.arange(bh, device=dev).view(1, 1, bh, 1, 1)
    ii = torch.arange(bw, device=dev).view(1, 1, 1, 1, bw)

    def window(p, sgn, ox_, oy_, rows):
        """s * pattern[p, oy + rows, ox + x%bw] per pixel of the strip."""
        idx = ((p * 64 + oy_[:, :, None, :, None] + rows) * 64
               + ox_[:, :, None, :, None] + ii)
        return pat[idx].to(torch.int32) * sgn[:, :, None, :, None]

    P = window(pi5, s, ox, oy, jj)            # oy += j/suby (vfgs_hw.c:197)
    # Vertical overlap (vfgs_hw.c:223-229): oy_up += (16+j)/suby = bh + j.
    Pup = window(pi5[:, :, :n_ov], su, oxu, oyu, jj[:, :, :n_ov] + bh)
    blend = _round_shift(P[:, :, :n_ov] * oc1 + Pup * oc2, 5)
    rmask = (torch.arange(R, device=dev) > 0).view(1, R, 1, 1, 1)
    top = torch.where(rmask, blend, P[:, :, :n_ov])
    P = torch.cat([top, P[:, :, n_ov:]], dim=2).reshape(F, Hp, Wp)

    # Horizontal deblock (vfgs_hw.c:250-258): both samples adjacent to an
    # interior block boundary become round(prev + 3*self + next, 2).
    Pm = torch.cat([P[..., :1], P[..., :-1]], dim=-1)
    Pp = torch.cat([P[..., 1:], P[..., -1:]], dim=-1)
    sm = _round_shift(Pm + 3 * P + Pp, 2)
    xs = torch.arange(Wp, device=dev)
    mask = (((xs % bw) == 0) & (xs > 0)) | \
           (((xs % bw) == bw - 1) & (xs < Wp - 1))
    P = torch.where(mask, sm, P)

    # Scale, add, clamp (vfgs_hw.c:263-267).
    g = (sc * P + (1 << (scale_shift - 1))) >> scale_shift
    return torch.clamp(x + g, imin << bs, imax << bs).to(pix.dtype)


def add_grain_frame(y, u, v, base, base_up, pattern, sluts, pluts,
                    scale_shift, y_min, y_max, c_min, c_max, *,
                    height: int, width: int, bs: int, csubx: int, csuby: int):
    """Add grain to one padded YUV frame (the JAX ``add_grain_frame``).

    y: (R*16, C*16); u, v: (R*(16//csuby), C*(16//csubx)) -- uint8/uint16
    planes padded from the real height x width (R = ceil(height/16), C
    likewise).  base / base_up: uint32 lattice bases A^(f(R-1)C).S0 and its
    one-block-row-earlier sibling (ops/lfsr.py).  pattern: (2, 8, 64, 64)
    int8; sluts/pluts: (3, 256) integer tensors.
    """
    R = -(-height // 16)
    C = -(-width // 16)
    dev = y.device
    states = lfsr.state_lattice_torch([base], R, C, dev)
    row0u = lfsr.state_lattice_torch([base_up], 1, C, dev)
    states_up = torch.cat([row0u, states[:, :-1]], dim=1)
    out = []
    for c, plane in ((0, y), (1, u), (2, v)):
        imin = y_min if c == 0 else c_min
        imax = y_max if c == 0 else c_max
        out.append(plane_grain(
            plane[None], states, states_up, pattern[1 if c else 0],
            sluts[c], pluts[c], scale_shift, imin, imax,
            c=c, csubx=csubx, csuby=csuby, bs=bs)[0])
    return tuple(out)
