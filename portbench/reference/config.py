"""Metadata structs: FGC SEI and AFGS1 configs (vfgs_fw.h:49-92).

Mutable objects sized exactly like the C structs -- config files *overlay*
onto the persistent state (the reference re-reads into the same statics on
every mid-stream config pop, so unspecified keys keep their previous values,
vfgs_main.c:436-559, 635-644).
"""

from __future__ import annotations

import numpy as np

SEI_MAX_MODEL_VALUES = 6


class FgsSei:
    def __init__(self):
        self.model_id = 0
        self.log2_scale_factor = 0
        self.comp_model_present_flag = [0, 0, 0]
        self.num_intensity_intervals = [0, 0, 0]
        self.num_model_values = [0, 0, 0]
        self.intensity_interval_lower_bound = np.zeros((3, 256), np.uint8)
        self.intensity_interval_upper_bound = np.zeros((3, 256), np.uint8)
        self.comp_model_value = np.zeros((3, 256, SEI_MAX_MODEL_VALUES), np.int16)


class FgsAfgs1:
    def __init__(self):
        self.grain_seed = 0
        self.num_y_points = 0
        self.point_y_values = np.zeros(14, np.uint8)
        self.point_y_scaling = np.zeros(14, np.uint8)
        self.chroma_scaling_from_luma = 0
        self.num_cb_points = 0
        self.point_cb_values = np.zeros(10, np.uint8)
        self.point_cb_scaling = np.zeros(10, np.uint8)
        self.num_cr_points = 0
        self.point_cr_values = np.zeros(10, np.uint8)
        self.point_cr_scaling = np.zeros(10, np.uint8)
        self.grain_scaling = 0
        self.ar_coeff_lag = 0
        self.ar_coeffs_y = np.zeros(24, np.int16)
        self.ar_coeffs_cb = np.zeros(25, np.int16)  # last = luma injection
        self.ar_coeffs_cr = np.zeros(25, np.int16)
        self.ar_coeff_shift = 0
        self.grain_scale_shift = 0
        self.cb_mult = 0
        self.cb_luma_mult = 0
        self.cb_offset = 0
        self.cr_mult = 0
        self.cr_luma_mult = 0
        self.cr_offset = 0
        self.overlap_flag = 0
        self.clip_to_restricted_range = 0


def default_sei() -> FgsSei:
    """The built-in default FGC SEI config (vfgs_main.c:69-120)."""
    sei = FgsSei()
    sei.model_id = 0
    sei.log2_scale_factor = 5
    sei.comp_model_present_flag = [1, 1, 1]
    sei.num_intensity_intervals = [8, 8, 8]
    sei.num_model_values = [3, 3, 3]
    sei.intensity_interval_lower_bound[0, :8] = [0, 40, 60, 80, 100, 120, 140, 160]
    sei.intensity_interval_upper_bound[0, :8] = [39, 59, 79, 99, 119, 139, 159, 255]
    for c in (1, 2):
        sei.intensity_interval_lower_bound[c, :8] = [0, 64, 96, 112, 128, 144, 160, 192]
        sei.intensity_interval_upper_bound[c, :8] = [63, 95, 111, 127, 143, 159, 191, 255]
    sei.comp_model_value[0, :8, :3] = [
        [100, 7, 7], [100, 8, 8], [100, 9, 9], [110, 10, 10],
        [120, 11, 11], [135, 12, 12], [145, 13, 13], [180, 14, 14]]
    for c in (1, 2):
        sei.comp_model_value[c, :8, :3] = [
            [128, 8, 8], [96, 8, 8], [64, 8, 8], [64, 8, 8],
            [64, 8, 8], [64, 8, 8], [96, 8, 8], [128, 8, 8]]
    return sei


def default_afgs1() -> FgsAfgs1:
    """Default AFGS1 config: num_y_points == 0 selects SEI mode
    (vfgs_main.c:122-125)."""
    return FgsAfgs1()
