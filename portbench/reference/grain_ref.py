"""Plain torch grain engine: the reference "HW layer" as tensor code.

The whole-frame form of vfgs_hw.c:140-312.  Every serial dependency of the
reference's block pipeline has a closed form:

* the LFSR schedule (vfgs_hw.c:288-312) is a per-(block-row, block-col)
  state lattice computed by GF(2) jump-ahead (lfsr.py);
* vertical overlap (vfgs_hw.c:199-229) blends *pattern samples of the upper
  block*, whose offsets come from the ``rnd_up`` lattice -- not neighbouring
  pixel data -- so it is a per-pixel expression;
* the horizontal deblock (vfgs_hw.c:243-283) only mixes grain values within
  one line, so it is a masked 3-tap stencil over the grain line.

So every output pixel is an independent integer expression of (input pixel,
lattice state, config registers).  Direct gathers, int32 arithmetic,
arithmetic ``>>`` (C-style rounding ``round(a,s) = (a+(1<<(s-1)))>>s``,
vfgs_hw.c:43).

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


def lane_offsets(states, c: int, csubx: int, csuby: int):
    """Per-lane ``(sign, col, oy)`` from (..., C) lattice words: each block's
    offsets repeated over its bw lanes, ``col = ox + x % bw`` (the pattern
    column of lane x).  All int32 tensors of shape (..., C*bw)."""
    bw = 16 // (csubx if c else 1)
    s, ox, oy = block_offsets(states, c, csubx, csuby)
    col = ox[..., None] + torch.arange(bw, dtype=torch.int32,
                                       device=states.device)
    return (s.repeat_interleave(bw, dim=-1), col.flatten(-2),
            oy.repeat_interleave(bw, dim=-1))


def plane_grain(pix, states, states_up, pattern, slut, plut, scale_shift,
                imin, imax, ov_mask=None, *, c: int, csubx: int, csuby: int,
                bs: int):
    """Add grain to one plane of F frames.

    pix: (F, Hp, Wp) uint8/uint16, padded to (R*bh, C*bw).
    states/states_up: (F, R, C) int64 block lattices (current / upper block
    row; row r of ``states_up`` is read only where ``ov_mask[r]``).
    pattern: (8, 64, 64) int8 -- this plane class's patterns.
    slut/plut: (256,) integer tensors -- scale / pattern LUTs of component c.
    scale_shift/imin/imax: ints or 0-d integer tensors (config registers).
    ov_mask: (R,) bool -- which block rows blend with the row above;
    ``None`` is ``arange(R) > 0`` (a frame's first block row does not
    blend, vfgs_hw.c overlap applies for y > 15 only).  A tile shard's
    first row passes True.
    Returns (F, Hp, Wp) tensors of pix's dtype.
    """
    geo = dict(c=c, csubx=csubx, csuby=csuby)
    return plane_grain_lanes(pix, lane_offsets(states, **geo),
                             lane_offsets(states_up, **geo), pattern, slut,
                             plut, scale_shift, imin, imax, ov_mask, bs=bs,
                             **geo)


def plane_grain_lanes(pix, lanes, lanes_up, pattern, slut, plut, scale_shift,
                      imin, imax, ov_mask=None, *, c: int, csubx: int,
                      csuby: int, bs: int):
    """:func:`plane_grain` on offsets already decoded per lane.

    ``lanes``/``lanes_up``: ``(sign, col, oy)`` triples of (F, R, Wp)
    tensors for the current and the upper block row, from
    :func:`lane_offsets`.
    """
    F, Hp, Wp = pix.shape
    dev = pix.device
    suby = csuby if c else 1
    bh = 16 // suby
    R = Hp // bh
    # Vertical-overlap lines per block: luma-lines j==0 and j==1
    # (vfgs_hw.c:175-188); for suby==2 the j==1 line is skipped entirely.
    n_ov = 1 if suby == 2 else 2
    oc1 = torch.tensor([20] if suby == 2 else [12, 24], dtype=torch.int32,
                       device=dev).view(1, 1, n_ov, 1)
    oc2 = torch.tensor([20] if suby == 2 else [24, 12], dtype=torch.int32,
                       device=dev).view(1, 1, n_ov, 1)

    x = pix.to(torch.int32)
    intensity = ((x >> bs) & 0xFF).long()
    pi = plut.long()[intensity] >> 4      # pattern index (vfgs_hw.c:212)
    sc = slut.to(torch.int32)[intensity]  # scale (vfgs_hw.c:239)

    pat = pattern.reshape(-1)
    pi4 = pi.view(F, R, bh, Wp)
    jj = torch.arange(bh, device=dev).view(1, 1, bh, 1)

    def window(p, lanes_, rows):
        """s * pattern[p, oy + rows, col] per pixel of the strip."""
        sgn, col, oy = (t[:, :, None, :] for t in lanes_)
        return pat[(p * 64 + oy + rows) * 64 + col].to(torch.int32) * sgn

    P = window(pi4, lanes, jj)                # oy += j/suby (vfgs_hw.c:197)
    # Vertical overlap (vfgs_hw.c:223-229): oy_up += (16+j)/suby = bh + j.
    Pup = window(pi4[:, :, :n_ov], lanes_up, jj[:, :, :n_ov] + bh)
    blend = _round_shift(P[:, :, :n_ov] * oc1 + Pup * oc2, 5)
    if ov_mask is None:
        rmask = torch.arange(R, device=dev) > 0
    else:
        rmask = torch.as_tensor(ov_mask, dtype=torch.bool, device=dev)
        if tuple(rmask.shape) != (R,):
            raise ValueError(f"ov_mask: expected ({R},), got "
                             f"{tuple(rmask.shape)}")
    top = torch.where(rmask.view(1, R, 1, 1), blend, P[:, :, :n_ov])
    P = torch.cat([top, P[:, :, n_ov:]], dim=2)
    P = P.reshape(F, Hp, Wp)

    # Horizontal deblock (vfgs_hw.c:250-258): both samples adjacent to
    # an interior block boundary become round(prev + 3*self + next, 2).
    bw = 16 // (csubx if c else 1)
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
    """Add grain to one padded YUV frame (vfgs_hw.c:140-312).

    y: (R*16, C*16); u, v: (R*(16//csuby), C*(16//csubx)) -- uint8/uint16
    planes padded from the real height x width (R = ceil(height/16), C
    likewise).  base / base_up: uint32 lattice bases A^(f(R-1)C).S0 and its
    one-block-row-earlier sibling (lfsr.py).  pattern: (2, 8, 64, 64)
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
