"""Grain pattern generation (the reference "FW layer" compute, vfgs_fw.c).

Patterns are generated at config time (at most 8 per plane class), so this
runs on the host in exact integer numpy/python arithmetic; the resulting
64x64/32x32 int8 patterns are uploaded to the device register file.

Two generators:

* frequency-filtering -- LFSR-seeded Gaussian coefficient block, band-limited
  by an integer iDCT (vfgs_fw.c:296-408);
* auto-regressive -- raster 2-D AR recurrence with optional cross-component
  luma injection (vfgs_fw.c:410-502).

All rounding/truncation matches C semantics: ``round(a,s)=(a+(1<<(s-1)))>>s``
with arithmetic shift, int16 wraparound where the C stores into int16.
"""

from __future__ import annotations

import numpy as np

from .lfsr import lfsr_step
from .tables import DCT2_64, GAUSSIAN_LUT, SEED_LUT

_D64 = DCT2_64.astype(np.int64)
_D32 = DCT2_64[::2, :32].astype(np.int64)  # 32-point basis (vfgs_fw.c:342)


def _wrap_i16(v: int) -> int:
    return ((int(v) + 0x8000) & 0xFFFF) - 0x8000


def idct2_64(b: np.ndarray) -> np.ndarray:
    """Integer 64x64 iDCT2 + clip to +-127 (vfgs_fw.c:296-327)."""
    x = (256 + _D64.T @ b.astype(np.int64)) >> 9
    out = (256 + x @ _D64) >> 9
    return np.clip(out, -127, 127).astype(np.int8)


def idct2_32(b: np.ndarray) -> np.ndarray:
    """Integer 32x32 iDCT2 + clip to +-127 (vfgs_fw.c:329-360)."""
    x = (128 + _D32.T @ b.astype(np.int64)) >> 8
    out = (256 + x @ _D32) >> 9
    return np.clip(out, -127, 127).astype(np.int8)


def make_sei_ff_pattern64(fh: int, fv: int) -> np.ndarray:
    """64x64 frequency-filtering pattern (vfgs_fw.c:362-385).

    The LFSR advances once per 4-coefficient group *including masked groups*,
    so each group's sequence position depends only on its (l, k) index.
    """
    fh, fv = 4 * (fh + 1), 4 * (fv + 1)
    b = np.zeros((64, 64), dtype=np.int64)
    n = int(SEED_LUT[0])
    for l in range(64):
        for k in range(0, 64, 4):
            if k < fh and l < fv:
                for q in range(4):
                    b[l, k + q] = GAUSSIAN_LUT[(n + q) & 2047]
            n = lfsr_step(n)
    b[0, 0] = 0
    return idct2_64(b)


def make_sei_ff_pattern32(fh: int, fv: int) -> np.ndarray:
    """32x32 chroma frequency-filtering pattern (vfgs_fw.c:387-408)."""
    fh, fv = 2 * (fh + 1), 2 * (fv + 1)
    b = np.zeros((32, 32), dtype=np.int64)
    n = int(SEED_LUT[1])
    for l in range(32):
        for k in range(0, 32, 2):
            if k < fh and l < fv:
                b[l, k] = GAUSSIAN_LUT[n & 2047]
                b[l, k + 1] = GAUSSIAN_LUT[(n + 1) & 2047]
            n = lfsr_step(n)
    b[0, 0] = 0
    return idct2_32(b)


def make_ar_pattern(buf0, size: int, ar_coef, nb_coef: int, shift: int,
                    scale: int, seed: int):
    """Auto-regressive pattern generation (vfgs_fw.c:410-502).

    Returns ``(p_flat, buf)``: ``p_flat`` is the flat 64*64 staging buffer
    (only the top-left size x size area written, rest zero -- the C model
    leaves it uninitialized, which is unreachable for output with valid
    configs), ``buf`` the 82x73 / 44x38 work buffer (flat) for luma injection.

    ``buf0`` is the luma work buffer for cross-component injection (only
    reachable with an odd ``nb_coef``, which no valid SEI/AFGS1 config
    produces; implemented for completeness with the reference's flat-index
    arithmetic, vfgs_fw.c:477-485).
    """
    coef = [[0] * 7 for _ in range(4)]
    subx = suby = 2 if size == 32 else 1
    width = 44 if subx > 1 else 82
    height = 38 if suby > 1 else 73
    rnd = int(seed)
    cx = 0
    lag = 0

    ar = [int(v) for v in ar_coef]
    if nb_coef == 6:
        # SEI.AR mode: 6-value mapping with int16-wrapped products
        # (vfgs_fw.c:427-436).
        coef[3][2] = ar[1]
        coef[2][3] = _wrap_i16((ar[1] * ar[4]) >> scale)
        coef[2][2] = _wrap_i16((ar[3] * ar[4]) >> scale)
        coef[2][4] = _wrap_i16((ar[3] * ar[4]) >> scale)
        coef[3][1] = ar[5]
        coef[1][3] = _wrap_i16((ar[5] * ar[4] * ar[4]) >> (2 * scale))
        lag = 2
    elif nb_coef in (4, 5):
        if nb_coef == 5:
            cx = ar[4]
        lag = 1
    elif nb_coef in (12, 13):
        if nb_coef == 13:
            cx = ar[12]
        lag = 2
    elif nb_coef in (24, 25):
        if nb_coef == 25:
            cx = ar[24]
        lag = 3
    else:
        raise ValueError(f"unsupported AR coefficient count {nb_coef}")

    if nb_coef != 6:
        k = 0
        for j in range(-lag, 1):
            for i in range(-lag, lag + 1):
                if not (i < 0 or j < 0):
                    break
                coef[3 + j][3 + i] = ar[k]
                k += 1

    buf = _ar_fill(coef, rnd, width, height, scale, shift, cx, buf0,
                   subx, suby)

    p = np.zeros(64 * 64, dtype=np.int8)
    for y in range(64 // suby):
        row = width * (3 + 6 // suby + y) + 3 + 6 // subx
        p[size * y:size * y + 64 // subx] = buf[row:row + 64 // subx]
    return p, buf


def _ar_fill(coef, seed, width, height, scale, shift, cx, buf0, subx, suby):
    """Run the raster AR recurrence in plain Python (vfgs_fw.c:455-497)."""
    gauss = GAUSSIAN_LUT.astype(np.int64)
    # scale/shift of 0 is UB in the C model; deterministic zero bias here,
    # matching native/argen.c.
    rbias = (1 << (shift - 1)) if shift >= 1 else 0
    sbias = (1 << (scale - 1)) if scale >= 1 else 0
    rnd = seed
    buf = [0] * (width * height)
    for y in range(height):
        for x in range(width):
            g = 0
            if y >= 3 and 3 <= x < width - 3:
                for j in range(-3, 1):
                    for i in range(-3, 4):
                        if i < 0 or j < 0:
                            g += coef[3 + j][3 + i] * buf[width * (y + j) + x + i]
                if cx and buf0 is not None:
                    i = (x - 3) * subx + 3
                    j = (y - 3) * suby + 3
                    stride0 = width * subx  # reference quirk: chroma stride,
                    # not the luma buffer's own stride (vfgs_fw.c:481-483)
                    def b0(idx):
                        return int(buf0[idx]) if 0 <= idx < len(buf0) else 0
                    z = b0(stride0 * j + i)
                    if subx > 1:
                        z += b0(stride0 * j + i + 1)
                    if suby > 1:
                        z += b0(stride0 * (j + 1) + i) + b0(stride0 * (j + 1) + i + 1)
                    g += cx * ((z + (1 << (subx + suby - 3))) >> (subx + suby - 2))
                g = (g + sbias) >> scale
            g += (int(gauss[rnd & 2047]) + rbias) >> shift
            rnd = lfsr_step(rnd)
            buf[width * y + x] = max(-127, min(127, g))
    return np.array(buf, dtype=np.int8)

