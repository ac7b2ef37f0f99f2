"""The plain reference of one benchmark configuration: the host path of
the C model (config parse, chroma adjustment, FW init, per-frame LFSR
bases) and its plain torch grain engine, frozen here so that the program
under test can change without moving the yardstick.

It imports nothing of the program.  Given a configuration's geometry and
cfg schedule and the same input planes, it works out the register file,
the patterns, the LUTs and every frame's lattice bases for itself
(vfgs_main.c:69-125, 208-298, 762-796).
"""

from __future__ import annotations

import numpy as np
import torch

from . import config as cfgmod
from . import fw, lfsr, parsers
from .grain_ref import add_grain_frame
from .hw import HwRegs
from .parsers import _check

YUV_420 = 0
YUV_422 = 1
YUV_444 = 2


def adjust_chroma_cfg(sei, fmt: int) -> None:
    """Chroma model-value conversion for 4:2:2/4:2:0 (vfgs_main.c:208-230).

    Mutates in place; applied on every config pop, so values re-read from a
    config file get adjusted once but inherited values get re-adjusted (this
    matches the reference, whose statics persist across pops)."""
    if sei.model_id == 0:
        for c in (1, 2):
            if sei.comp_model_present_flag[c]:
                for k in range(sei.num_intensity_intervals[c]):
                    v = sei.comp_model_value[c][k]
                    if fmt < YUV_444:
                        v[1] = max(2, min(14, int(v[1]) << 1))
                    if fmt < YUV_422:
                        v[2] = max(2, min(14, int(v[2]) << 1))
                    if fmt == YUV_420:
                        v[0] = int(v[0]) >> 1
                    elif fmt == YUV_422:
                        v[0] = (int(v[0]) * 181 + 128) >> 8


def check_cfg_sei(sei, fmt: int, depth: int) -> None:
    """vfgs_main.c:232-267, including the index typo in the vertical-cutoff
    check (the lower bound is tested on value[1], vfgs_main.c:254)."""
    _check(fmt == YUV_420 or (not sei.comp_model_present_flag[1]
                                  and not sei.comp_model_present_flag[2]),
           "color grain currently not supported on yuv422 and yuv444 formats")
    _check(sei.model_id == 0 or (not sei.comp_model_present_flag[1]
                                 and not sei.comp_model_present_flag[2]),
           "color grain currently not supported in SEI.AR mode")
    _check(sei.model_id <= 1, "SEIFGCModelId shall be 0 or 1")
    rng = 1 << depth
    for c in range(3):
        if sei.comp_model_present_flag[c]:
            _check(1 <= sei.num_model_values[c] <= 6,
                   f"SEIFGCNumModelValuesMinus1Comp{c} out of 0..5 range")
            for i in range(sei.num_intensity_intervals[c]):
                v = sei.comp_model_value[c][i]
                _check(sei.intensity_interval_lower_bound[c][i]
                       <= sei.intensity_interval_upper_bound[c][i],
                       f"inconsistent interval {i} for component {c}")
                _check(v[0] < rng,
                       f"scaling factor for component {c} and interval {i} is too large")
                if sei.model_id == 0:
                    _check(2 <= v[1] <= 14,
                           f"horizontal cutoff frequency for component {c} and "
                           f"interval {i} out of 2..14 range")
                    _check(v[1] >= 2 and v[2] <= 14,
                           f"vertical cutoff frequency for component {c} and "
                           f"interval {i} out of 2..14 range")
                else:
                    for mv in (1, 3, 5):
                        _check(-rng // 2 <= v[mv] < rng // 2,
                               f"AR coefficient for component {c} and interval "
                               f"{i} is out of range")


def check_cfg_afgs1(afgs1, fmt: int) -> None:
    """vfgs_main.c:269-298."""
    _check(fmt == YUV_420 or (not afgs1.num_cb_points
                                  and not afgs1.num_cr_points),
           "color grain currently not supported on yuv422 and yuv444 formats")
    for name, vals, n in (("y", afgs1.point_y_values, afgs1.num_y_points),
                          ("cb", afgs1.point_cb_values, afgs1.num_cb_points),
                          ("cr", afgs1.point_cr_values, afgs1.num_cr_points)):
        for i in range(1, n):
            _check(vals[i] > vals[i - 1],
                   f"afgs1.point_{name}_values shall be in increasing order")


def check_cfg(sei, afgs1, fmt: int, depth: int) -> None:
    if afgs1.num_y_points:
        check_cfg_afgs1(afgs1, fmt)
    else:
        check_cfg_sei(sei, fmt, depth)


class _State:
    """The register file and reseed epoch in force from frame ``start``
    on, with its tables by device, built once."""

    def __init__(self, start: int, regs: HwRegs, epoch: int):
        self.start, self.regs, self.epoch = start, regs, epoch
        self.tables = {}


class Reference:
    """The C model's state for one stream: the built-in FGC SEI config,
    then each ``(poc, cfg path)`` of ``schedule`` popped at its POC, in
    order, as the frame loop's ``-c POC:file`` list (vfgs_main.c:762-796).
    A pop reads the cfg over the parsed state, checks it, adjusts the
    chroma values and re-inits the FW over the register file, so what it
    does not overwrite stays in force; an AFGS1 pop reseeds at its frame.
    A pop that fails to read or check raises: the C model would go on
    with the previous config, which is a fault of the configuration and
    no path to hold a program to.  Grain seed and gain are the CLI's
    defaults (``-r 0``, ``-g 100``)."""

    def __init__(self, width: int, height: int, depth: int, fmt: int,
                 schedule=()):
        self.width, self.height, self.depth, self.fmt = (width, height,
                                                         depth, fmt)
        self.sei, self.afgs1 = cfgmod.default_sei(), cfgmod.default_afgs1()
        self.regs = HwRegs()
        self.epoch = 0
        check_cfg(self.sei, self.afgs1, fmt, depth)
        self.regs.set_depth(depth)
        self.regs.set_chroma_subsampling(2 if fmt < YUV_444 else 1,
                                         2 if fmt < YUV_422 else 1)
        adjust_chroma_cfg(self.sei, fmt)
        self._init_fw(0)
        self.states = [_State(0, self.regs.copy(), self.epoch)]
        for poc, cfg in schedule:
            parsers.read_cfg(cfg, self.sei, self.afgs1)
            check_cfg(self.sei, self.afgs1, fmt, depth)
            adjust_chroma_cfg(self.sei, fmt)
            self._init_fw(poc)
            if self.states[-1].start == poc:
                self.states.pop()
            self.states.append(_State(poc, self.regs.copy(), self.epoch))

    def _init_fw(self, frame: int) -> None:
        if self.afgs1.num_y_points:
            fw.init_afgs1(self.afgs1, self.regs)
            self.epoch = frame  # init_afgs1 reseeds (vfgs_fw.c:672)
        else:
            fw.init_sei(self.sei, self.regs)

    def state(self, n: int) -> _State:
        """The state in force at frame ``n``."""
        return [s for s in self.states if s.start <= n][-1]

    def frame_bases(self, n: int) -> tuple[int, int]:
        """LFSR lattice base of frame ``n`` and of the block row above its
        first (lfsr.py)."""
        st = self.state(n)
        R, C = -(-self.height // 16), -(-self.width // 16)
        e0 = lfsr.frame_base_exponent(n - st.epoch, R, C)
        seed = np.uint32(st.regs.seed_state)
        base = int(lfsr.advance(seed, e0))
        return base, (int(lfsr.advance(seed, e0 - C)) if e0 > 0 else base)

    def tables(self, n: int, device) -> dict:
        """The patterns, LUTs and clip range in force at frame ``n``, on
        ``device``."""
        st, key = self.state(n), str(device)
        if key not in st.tables:
            r = st.regs
            st.tables[key] = dict(
                pattern=torch.tensor(r.pattern, device=device),
                sluts=torch.tensor(r.slut, device=device),
                pluts=torch.tensor(r.plut, device=device),
                scale_shift=int(r.scale_shift), y_min=int(r.y_min),
                y_max=int(r.y_max), c_min=int(r.c_min), c_max=int(r.c_max))
        return st.tables[key]

    def grain(self, y, u, v, n: int):
        """Frame ``n`` of the stream grained from its padded input planes
        (2-D torch tensors, uint8 or uint16); returns the padded outputs on
        the planes' device."""
        r = self.state(n).regs
        base, base_up = self.frame_bases(n)
        return add_grain_frame(y, u, v, base, base_up,
                               **self.tables(n, y.device), height=self.height,
                               width=self.width, bs=r.bs, csubx=r.csubx,
                               csuby=r.csuby)
