"""Config file parsers: VTM-style SEI keys, VTM/HM SEI dumps, AFGS1 keys, and
AOM grain-table (.tbl) files.

Faithful port of vfgs_main.c:134-191 (array readers), 309-434 (.tbl reader)
and 436-559 (read_cfg), replicating C tokenization quirks: ``atoi`` semantics,
``read_array_i16``'s sign-char skipping (so ``5-3`` parses as 5, 3),
the dump format's implicit c/i/j counters, stopping at the first
``fg_characteristics_persistence_flag``, and integer wrap on narrow fields.
Parsing *overlays* onto the persistent sei/afgs1 structs.
"""

from __future__ import annotations

import numpy as np


class ConfigError(Exception):
    """Equivalent of the reference's CHECK failures (vfgs_main.c:54)."""


def _check(cond, msg):
    if not cond:
        raise ConfigError(msg)


def _isdig(ch: str) -> bool:
    """ASCII digit test (str.isdigit also accepts Unicode digits that int()
    rejects; C isdigit is ASCII-only)."""
    return "0" <= ch <= "9"


def atoi(s: str) -> int:
    """C atoi: skip whitespace, optional sign, leading digits; 0 otherwise."""
    i, n = 0, len(s)
    while i < n and s[i] in " \t\n\r\v\f":
        i += 1
    j = i
    if j < n and s[j] in "+-":
        j += 1
    k = j
    while k < n and _isdig(s[k]):
        k += 1
    if k == j:
        return 0
    return int(s[i:k])


def _isblank(ch: str) -> bool:
    return ch in " \t"


def read_array_u8(dst, s: str) -> None:
    """vfgs_main.c:147-158: space-separated unsigned ints; stops at any
    non-digit (including a sign)."""
    i, k, n = 0, 0, len(s)
    while i < n and _isdig(s[i]):
        dst[k] = np.uint8(atoi(s[i:]) & 0xFF)
        k += 1
        while i < n and _isdig(s[i]):
            i += 1
        while i < n and _isblank(s[i]):
            i += 1


def read_array_i16(dst, s: str) -> None:
    """vfgs_main.c:134-145: signed ints; sign chars also act as separators."""
    i, k, n = 0, 0, len(s)
    while i < n and (_isdig(s[i]) or s[i] in "+-"):
        v = atoi(s[i:])
        dst[k] = np.int16(((v + 0x8000) & 0xFFFF) - 0x8000)
        k += 1
        while i < n and (_isdig(s[i]) or s[i] in "+-"):
            i += 1
        while i < n and _isblank(s[i]):
            i += 1


DEFAULT_FREQ = 8


def fill_model_array(row, n: int, model_id: int, log2_scale_factor: int) -> None:
    """Default-fill unspecified model values (vfgs_main.c:160-169)."""
    def wrap16(v):
        return np.int16(((int(v) + 0x8000) & 0xFFFF) - 0x8000)
    if n < 2:
        row[1] = wrap16(0 if model_id else DEFAULT_FREQ)
    if n < 3:
        row[2] = wrap16(0 if model_id else int(row[1]))
    if n < 4:
        row[3] = 0
    if n < 5:
        row[4] = wrap16(model_id << log2_scale_factor)
    if n < 6:
        row[5] = 0


def read_model_array(rows, s: str, n: int, model_id: int,
                     log2_scale_factor: int) -> None:
    """vfgs_main.c:171-191: read groups of n values per intensity interval."""
    i, r, slen = 0, 0, len(s)
    while i < slen and (_isdig(s[i]) or s[i] in "+-"):
        for m in range(n):
            v = atoi(s[i:])
            rows[r][m] = np.int16(((v + 0x8000) & 0xFFFF) - 0x8000)
            while i < slen and (_isdig(s[i]) or s[i] in "+-"):
                i += 1
            while i < slen and _isblank(s[i]):
                i += 1
        fill_model_array(rows[r], n, model_id, log2_scale_factor)
        r += 1


def read_afgs1_tbl(lines, afgs1) -> None:
    """AOM grain-table format reader (vfgs_main.c:309-434): first config only."""
    it = iter(lines)

    def next_tokens(expect_first, err):
        line = next(it, "")
        toks = line.split()
        _check(toks and toks[0] == expect_first, "AFGS1 table entry: " + err)
        return toks[1:]

    t = next_tokens("E", "expecting header (E)")
    _check(len(t) >= 4, "AFGS1 table entry: missing grain_seed")
    afgs1.grain_seed = atoi(t[3]) & 0xFFFF

    t = next_tokens("p", "expecting parameters (p)")
    _check(len(t) >= 12, "AFGS1 table entry: missing parameters")
    afgs1.ar_coeff_lag = atoi(t[0]) & 0xFF
    _check(afgs1.ar_coeff_lag <= 3, "ar_coeff_lag higher than 3")
    afgs1.ar_coeff_shift = atoi(t[1]) & 0xFF
    _check(6 <= afgs1.ar_coeff_shift <= 9, "ar_coeff_shift out of 6..9 range")
    afgs1.grain_scale_shift = atoi(t[2]) & 0xFF
    _check(afgs1.grain_scale_shift <= 3, "grain_scale_shift higher than 3")
    afgs1.grain_scaling = atoi(t[3]) & 0xFF
    _check(8 <= afgs1.grain_scaling <= 11, "grain_scaling out of 8..11 range")
    afgs1.chroma_scaling_from_luma = atoi(t[4]) & 0xFF
    afgs1.overlap_flag = atoi(t[5]) & 0xFF
    afgs1.cb_mult = atoi(t[6]) & 0xFF
    afgs1.cb_luma_mult = atoi(t[7]) & 0xFF
    afgs1.cb_offset = atoi(t[8]) & 0x1FF
    afgs1.cr_mult = atoi(t[9]) & 0xFF
    afgs1.cr_luma_mult = atoi(t[10]) & 0xFF
    afgs1.cr_offset = atoi(t[11]) & 0x1FF

    for name, attr_n, attr_v, attr_s, maxn in (
            ("sY", "num_y_points", "point_y_values", "point_y_scaling", 14),
            ("sCb", "num_cb_points", "point_cb_values", "point_cb_scaling", 10),
            ("sCr", "num_cr_points", "point_cr_values", "point_cr_scaling", 10)):
        t = next_tokens(name, f"expecting scaling function ({name})")
        _check(len(t) >= 1, "AFGS1 table entry: missing num points")
        npts = atoi(t[0]) & 0xFF
        _check(npts <= maxn, f"{attr_n} higher than {maxn}")
        setattr(afgs1, attr_n, npts)
        _check(len(t) >= 1 + 2 * npts, "AFGS1 table entry: missing scaling point")
        vals, scal = getattr(afgs1, attr_v), getattr(afgs1, attr_s)
        for k in range(npts):
            vals[k] = atoi(t[1 + 2 * k]) & 0xFF
            scal[k] = atoi(t[2 + 2 * k]) & 0xFF

    ncoef = 2 * afgs1.ar_coeff_lag * (afgs1.ar_coeff_lag + 1)
    for name, attr, cnt in (("cY", "ar_coeffs_y", ncoef),
                            ("cCb", "ar_coeffs_cb", ncoef + 1),
                            ("cCr", "ar_coeffs_cr", ncoef + 1)):
        t = next_tokens(name, f"expecting {name} coefficients")
        _check(len(t) >= cnt, "AFGS1 table entry: missing AR coefficient")
        arr = getattr(afgs1, attr)
        for k in range(cnt):
            v = atoi(t[k])
            arr[k] = np.int16(((v + 0x8000) & 0xFFFF) - 0x8000)
    # Note: clip_to_restricted_range is absent from .tbl files and left
    # unchanged, as in the reference (vfgs_main.c:431).


def read_cfg(path: str, sei, afgs1) -> None:
    """Read a config file, overlaying onto sei/afgs1 (vfgs_main.c:436-559)."""
    try:
        with open(path, "rt", encoding="latin-1") as f:
            lines = f.readlines()
    except OSError:
        raise ConfigError(f"Can not open file {path}")

    afgs1.num_y_points = 0  # reset afgs1/sei detection
    afgs1.num_cb_points = 0
    afgs1.num_cr_points = 0

    c = i = j = 0
    cnt1 = cnt2 = 0

    def wrap16(v):
        return np.int16(((int(v) + 0x8000) & 0xFFFF) - 0x8000)

    for lineno, raw in enumerate(lines):
        if raw.startswith("#"):
            continue
        s = raw.split("#")[0]
        s = s.lstrip(" \t")
        if ":" not in s:
            if s[:8].lower() == "filmgrn1":
                read_afgs1_tbl(lines[lineno + 1:], afgs1)
                return
            continue
        name, _, v = s.partition(":")
        v = v.split(":")[0]
        v = v.lstrip(" \t")
        name = name.split()[0] if name.split() else ""
        cnt1 += 1
        key = name.lower()

        # SEI (VTM-style keys)
        if key == "seifgcmodelid":
            sei.model_id = atoi(v) & 0xFF
        elif key == "seifgclog2scalefactor":
            sei.log2_scale_factor = atoi(v) & 0xFF
        elif key in ("seifgccompmodelpresentcomp0", "seifgccompmodelpresentcomp1",
                     "seifgccompmodelpresentcomp2"):
            sei.comp_model_present_flag[int(key[-1])] = atoi(v) & 0xFF
        elif key in ("seifgcnumintensityintervalminus1comp0",
                     "seifgcnumintensityintervalminus1comp1",
                     "seifgcnumintensityintervalminus1comp2"):
            sei.num_intensity_intervals[int(key[-1])] = (atoi(v) + 1) & 0xFFFF
        elif key in ("seifgcnummodelvaluesminus1comp0",
                     "seifgcnummodelvaluesminus1comp1",
                     "seifgcnummodelvaluesminus1comp2"):
            sei.num_model_values[int(key[-1])] = (atoi(v) + 1) & 0xFF
        elif key in ("seifgcintensityintervallowerboundcomp0",
                     "seifgcintensityintervallowerboundcomp1",
                     "seifgcintensityintervallowerboundcomp2"):
            read_array_u8(sei.intensity_interval_lower_bound[int(key[-1])], v)
        elif key in ("seifgcintensityintervalupperboundcomp0",
                     "seifgcintensityintervalupperboundcomp1",
                     "seifgcintensityintervalupperboundcomp2"):
            read_array_u8(sei.intensity_interval_upper_bound[int(key[-1])], v)
        elif key in ("seifgccompmodelvaluescomp0", "seifgccompmodelvaluescomp1",
                     "seifgccompmodelvaluescomp2"):
            cc = int(key[-1])
            read_model_array(sei.comp_model_value[cc], v,
                             sei.num_model_values[cc], sei.model_id,
                             sei.log2_scale_factor)

        # SEI, dump style (implicit c/i/j counters)
        elif key == "fg_model_id":
            sei.model_id = atoi(v) & 0xFF
        elif key == "fg_log2_scale_factor":
            sei.log2_scale_factor = atoi(v) & 0xFF
        elif key == "fg_comp_model_present_flag[c]":
            sei.comp_model_present_flag[c] = atoi(v) & 0xFF
            c = c + 1 if c < 2 else 0
        elif key == "fg_num_intensity_intervals_minus1[c]":
            sei.num_intensity_intervals[c] = (atoi(v) + 1) & 0xFFFF
        elif key == "fg_num_model_values_minus1[c]":
            sei.num_model_values[c] = (atoi(v) + 1) & 0xFF
        elif key == "fg_intensity_interval_lower_bound[c][i]":
            sei.intensity_interval_lower_bound[c][i] = atoi(v) & 0xFF
        elif key == "fg_intensity_interval_upper_bound[c][i]":
            sei.intensity_interval_upper_bound[c][i] = atoi(v) & 0xFF
        elif key == "fg_comp_model_value[c][i]":
            sei.comp_model_value[c][i][j] = wrap16(atoi(v))
            j += 1
            if j == sei.num_model_values[c]:
                fill_model_array(sei.comp_model_value[c][i],
                                 sei.num_model_values[c], sei.model_id,
                                 sei.log2_scale_factor)
                i += 1
                j = 0
                if i == sei.num_intensity_intervals[c]:
                    c += 1
                    i = 0
        elif key == "fg_characteristics_persistence_flag":
            break  # stop at the end of the first FGS SEI

        # AFGS1
        elif key == "afgs1grainseed":
            afgs1.grain_seed = atoi(v) & 0xFFFF
        elif key == "afgs1numypoints":
            afgs1.num_y_points = atoi(v) & 0xFF
            _check(afgs1.num_y_points <= 14, "AFGS1NumYPoints higher than 14")
        elif key == "afgs1pointyvalues":
            read_array_u8(afgs1.point_y_values, v)
        elif key == "afgs1pointyscaling":
            read_array_u8(afgs1.point_y_scaling, v)
        elif key == "afgs1chromascalingfromluma":
            afgs1.chroma_scaling_from_luma = atoi(v) & 0xFF
        elif key == "afgs1numcbpoints":
            afgs1.num_cb_points = atoi(v) & 0xFF
            _check(afgs1.num_cb_points <= 10, "AFGS1NumCbPoints higher than 10")
        elif key == "afgs1pointcbvalues":
            read_array_u8(afgs1.point_cb_values, v)
        elif key == "afgs1pointcbscaling":
            read_array_u8(afgs1.point_cb_scaling, v)
        elif key == "afgs1numcrpoints":
            afgs1.num_cr_points = atoi(v) & 0xFF
            _check(afgs1.num_cr_points <= 10, "AFGS1NumCrPoints higher than 10")
        elif key == "afgs1pointcrvalues":
            read_array_u8(afgs1.point_cr_values, v)
        elif key == "afgs1pointcrscaling":
            read_array_u8(afgs1.point_cr_scaling, v)
        elif key == "afgs1grainscaling":
            afgs1.grain_scaling = atoi(v) & 0xFF
            _check(8 <= afgs1.grain_scaling <= 11,
                   "AFGS1GrainScaling out of 8..11 range")
        elif key == "afgs1arcoefflag":
            afgs1.ar_coeff_lag = atoi(v) & 0xFF
            _check(afgs1.ar_coeff_lag <= 3, "AFGS1ARCoeffLag higher than 3")
        elif key == "afgs1arcoeffsy":
            read_array_i16(afgs1.ar_coeffs_y, v)
        elif key == "afgs1arcoeffscb":
            read_array_i16(afgs1.ar_coeffs_cb, v)
        elif key == "afgs1arcoeffscr":
            read_array_i16(afgs1.ar_coeffs_cr, v)
        elif key == "afgs1arcoeffshift":
            afgs1.ar_coeff_shift = atoi(v) & 0xFF
            _check(6 <= afgs1.ar_coeff_shift <= 9,
                   "AFGS1ARCoeffShift out of 6..9 range")
        elif key == "afgs1grainscaleshift":
            afgs1.grain_scale_shift = atoi(v) & 0xFF
            _check(afgs1.grain_scale_shift <= 3,
                   "AFGS1GrainScaleShift higher than 3")
        elif key == "afgs1cbmult":
            afgs1.cb_mult = atoi(v) & 0xFF
        elif key == "afgs1cblumamult":
            afgs1.cb_luma_mult = atoi(v) & 0xFF
        elif key == "afgs1cboffset":
            afgs1.cb_offset = atoi(v) & 0x1FF
        elif key == "afgs1crmult":
            afgs1.cr_mult = atoi(v) & 0xFF
        elif key == "afgs1crlumamult":
            afgs1.cr_luma_mult = atoi(v) & 0xFF
        elif key == "afgs1croffset":
            afgs1.cr_offset = atoi(v) & 0x1FF
        elif key == "afgs1overlapflag":
            afgs1.overlap_flag = atoi(v) & 0xFF
        elif key == "afgs1cliptorestrictedrange":
            afgs1.clip_to_restricted_range = atoi(v) & 0xFF

        else:
            cnt2 += 1

    _check(cnt1 > cnt2, "could not ready anything from configuration file")
