"""Derive per-block pattern offsets + sign from LFSR state words.

Replicates vfgs_hw.c:99-138 (get_offset_y/u/v): each color component extracts
disjoint bit fields from the same 32-bit state to decorrelate Y/U/V.  X offsets
fall in {0,4,...,48} (13 bins x 4) and Y offsets in {0,4,...,44} (12 bins x 4),
scaled by 4/csub for chroma.

Works on int64 tensors holding uint32 state words (lfsr.py), any shape;
csrc/grain_natural.cu decodes the same fields per block.
"""

from __future__ import annotations

import torch


def block_offsets(val: torch.Tensor, c: int, csubx: int, csuby: int):
    """Return ``(sign, ox, oy)`` for component ``c`` from state word(s) ``val``.

    ``sign`` is +1/-1, ``ox``/``oy`` are pattern offsets; all int32 tensors
    of ``val``'s shape.
    """
    if c == 0:
        sign_bit = (val >> 31) & 1
        xbf = val & 0x3FF
        ybf = (val >> 14) & 0x3FF
        xmul, ymul = 4, 4
    elif c == 1:
        sign_bit = (val >> 2) & 1
        xbf = (val >> 10) & 0x3FF
        ybf = ((val >> 24) & 0x0FF) | ((val << 8) & 0x300)
        xmul, ymul = 4 // csubx, 4 // csuby
    else:
        sign_bit = (val >> 15) & 1
        xbf = (val >> 20) & 0x3FF
        ybf = (val >> 4) & 0x3FF
        xmul, ymul = 4 // csubx, 4 // csuby

    s = (1 - 2 * sign_bit).to(torch.int32)
    ox = (((xbf * 13) >> 10) * xmul).to(torch.int32)
    oy = (((ybf * 12) >> 10) * ymul).to(torch.int32)
    return s, ox, oy
