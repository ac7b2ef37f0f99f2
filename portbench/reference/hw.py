"""Host-side model of the grain engine's register file.

Mirrors the static state + setters of vfgs_hw.c:49-63,314-388 exactly, but as
a plain object whose arrays and scalars the grain engine reads.  The
registers persist across config
re-initialization (mid-stream ``-c`` switching) just like the C statics --
e.g. a pattern slot written by an earlier config remains visible if a later
config registers fewer patterns.
"""

from __future__ import annotations

import numpy as np


class HwRegs:
    """The "hardware" register file (vfgs_hw.c:49-63)."""

    def __init__(self):
        self.pattern = np.zeros((2, 8, 64, 64), dtype=np.int8)
        self.slut = np.zeros((3, 256), dtype=np.uint8)
        self.plut = np.zeros((3, 256), dtype=np.uint8)
        # Value loaded into all four LFSR registers; the C model boots with
        # 0xdeadbeef un-shifted (vfgs_hw.c:52-55) -- only set_seed() shifts.
        self.seed_state = 0xDEADBEEF
        self.scale_shift = 5 + 6
        self.bs = 0
        self.y_min, self.y_max = 0, 255
        self.c_min, self.c_max = 0, 255
        self.csubx, self.csuby = 2, 2

    def copy(self) -> "HwRegs":
        """A copy that shares no array with this register file."""
        new = HwRegs.__new__(HwRegs)
        new.__dict__ = {k: v.copy() if isinstance(v, np.ndarray) else v
                        for k, v in vars(self).items()}
        return new

    # -- setters (vfgs_hw.c:314-388) ------------------------------------

    def set_luma_pattern(self, index: int, p: np.ndarray) -> None:
        assert 0 <= index < 8
        self.pattern[0, index] = np.asarray(p, np.int8).reshape(64, 64)

    def set_chroma_pattern(self, index: int, p: np.ndarray) -> None:
        """Copy 64/csuby rows x 64/csubx cols with source stride 64/csuby.

        Matches vfgs_hw.c:320-325 including the source-stride quirk (stride is
        64/csuby even when the row length is 64/csubx).  ``p`` is the flat
        64*64 staging buffer (the C model's ``int8 P[64*64]``).
        """
        assert 0 <= index < 8
        p = np.asarray(p, np.int8).reshape(-1)
        h, w, stride = 64 // self.csuby, 64 // self.csubx, 64 // self.csuby
        for i in range(h):
            self.pattern[1, index, i, :w] = p[stride * i:stride * i + w]

    def set_scale_lut(self, c: int, lut: np.ndarray) -> None:
        assert 0 <= c < 3
        self.slut[c] = np.asarray(lut, np.uint8)

    def set_pattern_lut(self, c: int, lut: np.ndarray) -> None:
        assert 0 <= c < 3
        self.plut[c] = np.asarray(lut, np.uint8)

    def set_seed(self, seed: int) -> None:
        # LFSR loops on the 31 MSBs; seed is MSB-aligned (vfgs_hw.c:339-344).
        self.seed_state = (int(seed) << 1) & 0xFFFFFFFF

    def set_scale_shift(self, shift: int) -> None:
        if not (2 <= shift < 8):
            raise ValueError(f"scale shift {shift} out of [2,8) range")
        self.scale_shift = shift + 6 - self.bs

    def set_depth(self, depth: int) -> None:
        assert depth in (8, 10)
        if self.bs == 0 and depth > 8:
            self.scale_shift -= 2
        if self.bs == 2 and depth == 8:
            self.scale_shift += 2
        self.bs = depth - 8

    def set_legal_range(self, legal: int) -> None:
        if legal:
            self.y_min, self.y_max, self.c_min, self.c_max = 16, 235, 16, 240
        else:
            self.y_min, self.y_max, self.c_min, self.c_max = 0, 255, 0, 255

    def set_chroma_subsampling(self, subx: int, suby: int) -> None:
        assert subx in (1, 2) and suby in (1, 2)
        self.csubx, self.csuby = subx, suby
