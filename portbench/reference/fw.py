"""FW layer: convert parsed metadata (FGC SEI / AFGS1) into register writes.

Faithful port of vfgs_fw.c:504-708 (``vfgs_init_sei`` / ``vfgs_init_afgs1``),
including its quirks, which are load-bearing for bit-exactness:

* the "empty" pattern-slot sentinel is ~0 read as int32 -1, so an empty slot
  compares the flattened model values at offset -1 (i.e. row [0][0] values
  0..4) against candidates (vfgs_fw.c:537,504-514);
* the chroma pattern list is the union of Cb and Cr rows (``np`` is not reset
  when moving to component 2, vfgs_fw.c:533-538);
* the scale LUT buffer is *not* cleared between Cb and Cr fills (only at the
  top of the component loop), so Cr's sLUT inherits Cb values in intensity
  holes, and a component with ``comp_model_present_flag==0`` re-registers the
  previous component's scale LUT (vfgs_fw.c:530-639);
* AFGS1 sets Cr's pattern LUT to all-ones, which still selects pattern index
  1>>4 == 0, i.e. the Cb pattern (vfgs_fw.c:700-701);
* ``cb_mult``/``cb_luma_mult``/``cb_offset`` (+cr) and ``overlap_flag`` are
  parsed but unimplemented, as in the reference (vfgs_fw.c:706-707).
"""

from __future__ import annotations

import numpy as np

from .tables import SEED_LUT
from .hw import HwRegs
from .patterns import make_ar_pattern, make_sei_ff_pattern32, make_sei_ff_pattern64

SEI_MAX_MODEL_VALUES = 6
MAX_PATTERNS = 8


def _same_pattern(flat_values: np.ndarray, a: int, b: int) -> bool:
    """Compare model values at flat offsets a/b, fields 1..5 (vfgs_fw.c:504-514).

    ``a`` may be the -1 empty-slot sentinel; offsets a+i stay >= 0 for i >= 1,
    matching the C pointer arithmetic exactly.
    """
    for i in range(1, SEI_MAX_MODEL_VALUES):
        if flat_values[a + i] != flat_values[b + i]:
            return False
    return True


def init_sei(cfg, regs: HwRegs) -> None:
    """Initialize the register file from an FGC SEI config (vfgs_fw.c:516-644)."""
    flat = cfg.comp_model_value.reshape(-1)
    slut = np.zeros(256, dtype=np.uint8)
    intensities = np.zeros(MAX_PATTERNS, dtype=np.uint8)
    patterns = np.full(MAX_PATTERNS, -1, dtype=np.int64)
    np_count = 0
    lbuf = None

    for c in range(3):
        slut[:] = 0
        if c < 2:
            np_count = 0
            intensities[:] = 0
            patterns[:] = -1
        # 1. Collect distinct patterns, kept sorted by interval lower bound.
        if cfg.comp_model_present_flag[c]:
            for k in range(int(cfg.num_intensity_intervals[c])):
                a = int(cfg.intensity_interval_lower_bound[c][k])
                pid = SEI_MAX_MODEL_VALUES * (k + 256 * c)
                for i in range(MAX_PATTERNS):
                    if _same_pattern(flat, int(patterns[i]), pid):
                        break
                else:
                    i = MAX_PATTERNS
                if i == MAX_PATTERNS and np_count < MAX_PATTERNS:
                    i = np_count
                    while i > 0 and intensities[i - 1] > a:
                        intensities[i] = intensities[i - 1]
                        patterns[i] = patterns[i - 1]
                        i -= 1
                    intensities[i] = a
                    patterns[i] = pid
                    np_count += 1

        if c in (0, 2):
            # 2. Register the patterns.
            for i in range(np_count):
                coef = flat[int(patterns[i]):int(patterns[i]) + SEI_MAX_MODEL_VALUES]
                if c == 0:
                    if cfg.model_id:
                        p, lbuf = make_ar_pattern(
                            None, 64, coef, 6, 1, cfg.log2_scale_factor,
                            int(SEED_LUT[0]))
                    else:
                        p = make_sei_ff_pattern64(int(coef[1]), int(coef[2]))
                    regs.set_luma_pattern(i, np.asarray(p).reshape(-1)[:64 * 64])
                else:
                    if cfg.model_id:
                        p, _ = make_ar_pattern(
                            lbuf, 32, coef, 6, 1, cfg.log2_scale_factor,
                            int(SEED_LUT[1]))
                    else:
                        p = _pack32(make_sei_ff_pattern32(int(coef[1]), int(coef[2])))
                    regs.set_chroma_pattern(i, p)
            # 3. Fill LUTs for the component(s) this pass covers.
            for cc in range(min(c, 1), c + 1):
                plut = np.full(256, 255, dtype=np.int32)
                if cfg.comp_model_present_flag[cc]:
                    for k in range(int(cfg.num_intensity_intervals[cc])):
                        a = int(cfg.intensity_interval_lower_bound[cc][k])
                        b = int(cfg.intensity_interval_upper_bound[cc][k])
                        pid = SEI_MAX_MODEL_VALUES * (k + 256 * cc)
                        for i in range(MAX_PATTERNS):
                            if _same_pattern(flat, int(patterns[i]), pid):
                                break
                        else:
                            i = MAX_PATTERNS
                        for l in range(a, b + 1):
                            slut[l] = np.uint8(cfg.comp_model_value[cc][k][0] & 0xFF)
                            if i < MAX_PATTERNS:
                                plut[l] = i << 4
                    # 3b. Fill holes by repeating the last value downward.
                    i = 0
                    for k in range(256):
                        if plut[k] == 255:
                            plut[k] = i
                        else:
                            i = plut[k]
                else:
                    plut[:] = 0
                regs.set_scale_lut(cc, slut)
                regs.set_pattern_lut(cc, plut.astype(np.uint8))

    regs.set_scale_shift(cfg.log2_scale_factor - (1 if cfg.model_id else 0))


def _pack32(p32: np.ndarray) -> np.ndarray:
    """Lay a 32x32 pattern into the flat 64*64 staging buffer with stride 32,
    as vfgs_make_sei_ff_pattern32 writes into ``int8 P[64*64]``."""
    p = np.zeros(64 * 64, np.int8)
    p[:32 * 32] = np.asarray(p32, np.int8).reshape(-1)
    return p


def make_lut_piecewise_linear(in_vals, out_vals, n: int) -> np.ndarray:
    """256-entry LUT from a piecewise-linear point list (vfgs_fw.c:648-660).

    Integer lerp with C truncating division; stores wrap to uint8.
    """
    lut = np.zeros(256, dtype=np.uint8)
    for k in range(1, n):
        din = int(in_vals[k]) - int(in_vals[k - 1])
        dout = int(out_vals[k]) - int(out_vals[k - 1])
        if din <= 0:
            raise ValueError("piecewise-linear input values must increase")
        for i in range(din + 1):
            num = dout * i + din // 2
            q = abs(num) // din
            if num < 0:
                q = -q
            lut[int(in_vals[k - 1]) + i] = np.uint8((int(out_vals[k - 1]) + q) & 0xFF)
    return lut


def init_afgs1(cfg, regs: HwRegs) -> None:
    """Initialize the register file from AFGS1 metadata (vfgs_fw.c:662-708)."""
    regs.set_seed(int(cfg.grain_seed) | (int(cfg.grain_seed) << 16))

    lut = make_lut_piecewise_linear(
        cfg.point_y_values, cfg.point_y_scaling, int(cfg.num_y_points))
    regs.set_scale_lut(0, lut)
    if not cfg.chroma_scaling_from_luma:
        lut = make_lut_piecewise_linear(
            cfg.point_cb_values, cfg.point_cb_scaling, int(cfg.num_cb_points))
    regs.set_scale_lut(1, lut)
    if not cfg.chroma_scaling_from_luma:
        lut = make_lut_piecewise_linear(
            cfg.point_cr_values, cfg.point_cr_scaling, int(cfg.num_cr_points))
    regs.set_scale_lut(2, lut)

    # Our Gaussian table has sigma=63 vs AOM's 512, hence shift+1 rather than
    # the spec's +4 (vfgs_fw.c:684-688).
    n = 2 * int(cfg.ar_coeff_lag) * (int(cfg.ar_coeff_lag) + 1)
    shift = int(cfg.grain_scale_shift) + 1

    p, lbuf = make_ar_pattern(None, 64, cfg.ar_coeffs_y, n, shift,
                              int(cfg.ar_coeff_shift), int(SEED_LUT[0]))
    regs.set_luma_pattern(0, p)
    regs.set_pattern_lut(0, np.zeros(256, np.uint8))

    p, _ = make_ar_pattern(lbuf, 32, cfg.ar_coeffs_cb, n, shift,
                           int(cfg.ar_coeff_shift), int(SEED_LUT[1]))
    regs.set_chroma_pattern(0, p)
    regs.set_pattern_lut(1, np.zeros(256, np.uint8))

    p, _ = make_ar_pattern(lbuf, 32, cfg.ar_coeffs_cr, n, shift,
                           int(cfg.ar_coeff_shift), int(SEED_LUT[2]))
    regs.set_chroma_pattern(1, p)
    # Cr quirk: all-ones pattern LUT still selects pattern 0 (vfgs_fw.c:700).
    regs.set_pattern_lut(2, np.ones(256, np.uint8))

    regs.set_scale_shift(int(cfg.grain_scaling) - 6)
    regs.set_legal_range(int(cfg.clip_to_restricted_range))
