"""The least bytes a grain step must move, and the card's peak, for the
roofline shares.

A step over ``frames`` frames must read each padded input plane once,
write each output plane once and read the config tables once; the LFSR
lattice is derived on the device from a few bases, so its bytes are the
implementation's and not counted.  This counts the same work whatever
kernels carry it, so a lattice fused into the grain kernel does not move
the bound.  Peak: the H100 SXM data sheet's 3.35 TB/s of HBM3 bandwidth,
at its full 700 W power limit.
"""

from __future__ import annotations

from portbench.frames import padded_shapes

HBM_BYTES_S = 3.35e12
# What the grain kernel reads of the register file: two pattern banks of
# 8 int8 64x64 patterns, the (3, 256) uint8 scale and pattern LUTs, and
# five int32 scalars (scale shift and the clip range).
TABLE_BYTES = 2 * 8 * 64 * 64 + 2 * 3 * 256 + 5 * 4


def step_bytes(width: int, height: int, depth: int, fmt: int,
               frames: int) -> int:
    """Least bytes of one step over ``frames`` padded frames."""
    sample = 1 if depth == 8 else 2
    planes = sum(h * w for h, w in padded_shapes(width, height, fmt))
    return 2 * planes * sample * frames + TABLE_BYTES


def step_bound_s(width: int, height: int, depth: int, fmt: int,
                 frames: int) -> float:
    """Least seconds of one step at the card's peak bandwidth."""
    return step_bytes(width, height, depth, fmt, frames) / HBM_BYTES_S
