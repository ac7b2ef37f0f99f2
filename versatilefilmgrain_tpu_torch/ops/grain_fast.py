"""Host-side tables of the tiled engine (numpy, no device code).

Copied from the JAX package's ops/grain_fast.py: the two config-time table
builders that the tiled engine (ops/grain_pallas.py) packages for its
kernel.  The rest of that module, the XLA "fast" engine, is not ported: it
exists to avoid slow per-element gathers on the TPU, and ``--engine fast``
maps to the plain torch engine (ops/grain_ref.py).

1. **Pattern windows.**  Block offsets are quantized to 12 vertical x 13
   horizontal positions (vfgs_hw.c:99-138), so each pattern has only 156
   possible (block + overlap)-row windows; :func:`build_window_table`
   extracts them all at config time.
2. **LUT run-length code.**  sLUT/pLUT are piecewise constant over <=256
   intensity intervals (vfgs_fw.c:597-639); :func:`build_segments`
   decomposes the packed (scale, pattern-index) pair into its runs so that
   ``sum_k (i >= starts[k]) * deltas[k]`` reproduces it exactly.
"""

from __future__ import annotations

import numpy as np

_PACK_SHIFT = 9  # scale in bits 0..8, pattern index in bits 9..12


def build_window_table(pattern_class: np.ndarray, bh: int, bw: int,
                       n_ov: int, ymul: int, xmul: int):
    """All possible offset windows per pattern, split into two tables:

    * ``cur`` (156, 8, bh, bw): rows serving the block itself (pattern rows
      oy+j, vfgs_hw.c:218);
    * ``up`` (156, 8, n_ov, bw): rows serving the *next* block row's vertical
      overlap (pattern rows oy+16/suby+j, vfgs_hw.c:206,225).
    """
    rows = bh + n_ov
    win = np.zeros((12 * 13, 8, rows, bw), dtype=np.int8)
    for a in range(12):
        oy = a * ymul
        for b in range(13):
            ox = b * xmul
            win[a * 13 + b] = pattern_class[:, oy:oy + rows, ox:ox + bw]
    return np.ascontiguousarray(win[:, :, :bh]), \
        np.ascontiguousarray(win[:, :, bh:])


def build_segments(slut: np.ndarray, plut: np.ndarray):
    """Run-length decomposition of the packed (scale, pattern-index) LUT.

    Returns (starts, deltas) int32 arrays of equal length such that for any
    intensity i:
        acc = sum_k (i >= starts[k]) * deltas[k]
        slut[i] == acc & 511;  (plut[i] >> 4) == acc >> 9
    """
    pairs = slut.astype(np.int32) | ((plut.astype(np.int32) >> 4) << _PACK_SHIFT)
    starts, deltas = [], []
    prev = 0
    for i in range(256):
        if pairs[i] != prev:
            starts.append(i)
            deltas.append(int(pairs[i]) - prev)
            prev = int(pairs[i])
    if not starts:
        starts, deltas = [0], [0]
    return np.array(starts, np.int32), np.array(deltas, np.int32)
