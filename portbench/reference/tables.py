"""Constant tables for film grain synthesis.

Three tables drive every bit of the grain pipeline (reference: vfgs_fw.c:46-281):

* ``GAUSSIAN_LUT`` -- 2048 pre-quantized int8 samples of N(0, sigma~=63), the only
  entropy source for pattern generation (vfgs_fw.c:46-175).  Stored as binary data
  (``data/gaussian_lut.npy``) since the values have no generative structure.
* ``SEED_LUT`` -- 256 fixed 32-bit LFSR seeds (vfgs_fw.c:177-210); entry 0 seeds
  luma patterns, 1 seeds Cb/chroma, 2 seeds Cr.  Stored as binary data.
* ``DCT2_64`` -- the VVC-style 64x64 integer DCT-II basis (vfgs_fw.c:212-281).
  Rather than transcribing the 64x64 butterfly macro, we *generate* the matrix
  from its underlying cosine structure: ``DCT2_64[k][n] = CS[(k*(2n+1)) % 256]``
  where ``CS`` is the quarter-wave integer cosine table built from the 63
  distinct VVC transform constants, extended by the cosine symmetries
  ``CS[128-t] = CS[128+t] = -CS[t]`` and ``CS[256-t] = CS[t]``.  Bit-exactness
  of this construction is locked in by the golden frequency-filtering pattern
  tests (every FF pattern byte depends on every DCT2 entry).

Even-index rows of DCT2_64 double as the 32-point basis (vfgs_fw.c:342,353).
"""

from __future__ import annotations

import os

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

GAUSSIAN_LUT: np.ndarray = np.load(os.path.join(_DATA_DIR, "gaussian_lut.npy"))
SEED_LUT: np.ndarray = np.load(os.path.join(_DATA_DIR, "seed_lut.npy"))

assert GAUSSIAN_LUT.shape == (2048,) and GAUSSIAN_LUT.dtype == np.int8
assert SEED_LUT.shape == (256,) and SEED_LUT.dtype == np.uint32

# The 63 distinct VVC DCT-II transform constants, in the order they appear in
# the reference macro instantiation (vfgs_fw.c:280-281): one 1-pt value, then
# the 2/4/8/16/32-point odd-frequency groups.
_VVC_DCT2_CONSTANTS = (
    64,
    83, 36,
    89, 75, 50, 18,
    90, 87, 80, 70, 57, 43, 25, 9,
    90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4,
    91, 90, 90, 90, 88, 87, 86, 84, 83, 81, 79, 77, 73, 71, 69, 65,
    62, 59, 56, 52, 48, 44, 41, 37, 33, 28, 24, 20, 15, 11, 7, 2,
)


def _build_dct2_64() -> np.ndarray:
    c = _VVC_DCT2_CONSTANTS
    # Quarter-wave table CS[0..64]: phase t (in units of pi/128) -> integer
    # amplitude.  Group g holds phases t = 2^g * (2m+1) for the (64 >> g)-point
    # odd frequencies; CS[0] = CS[32] = 64 (the DC / Nyquist-diagonal value).
    cs = np.zeros(257, dtype=np.int64)
    cs[0] = c[0]
    groups = [(32, [c[0]]), (16, c[1:3]), (8, c[3:7]), (4, c[7:15]),
              (2, c[15:31]), (1, c[31:63])]
    for step, vals in groups:
        for m, v in enumerate(vals):
            cs[step * (2 * m + 1)] = v
    # Extend by cosine symmetries to a full period of 256.
    for t in range(65, 129):
        cs[t] = -cs[128 - t]
    for t in range(129, 257):
        cs[t] = -cs[t - 128]
    k = np.arange(64)[:, None]
    n = np.arange(64)[None, :]
    mat = cs[(k * (2 * n + 1)) % 256]
    assert mat.min() >= -91 and mat.max() <= 91
    return mat.astype(np.int8)


DCT2_64: np.ndarray = _build_dct2_64()
