"""Editable FGC SEI model for the designer (reference: fgc-designer.py:71-226).

Wraps the frequency-filtering SEI parameter set as an editable object with
per-interval enable masks, interval split/remove, and VTM-style ``.cfg``
round-tripping compatible with both our parser and the reference binary.
Port of the JAX package's designer/model.py: the same design object, with
previews grained by the port's ``GrainPipeline`` on ``device`` (``None``
means ``cuda``, which raises without a card; pass ``"cpu"`` for the CPU).
"""

from __future__ import annotations

from ..models import config as cfgmod
from ..utils import parsers


class FgcSeiDesign:
    """Designer-facing FGC SEI config: lists per component, editable."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        sei = cfgmod.default_sei()
        self.model_id = sei.model_id
        self.log2_scale_factor = sei.log2_scale_factor
        self.comp_model_present_flag = list(sei.comp_model_present_flag)
        self.num_model_values = list(sei.num_model_values)
        self.lower = [list(map(int, sei.intensity_interval_lower_bound[c][:8]))
                      for c in range(3)]
        self.upper = [list(map(int, sei.intensity_interval_upper_bound[c][:8]))
                      for c in range(3)]
        self.values = [[list(map(int, sei.comp_model_value[c][k][:3]))
                        for k in range(8)] for c in range(3)]
        self.enable = [[True] * 8 for _ in range(3)]
        self.gain = 100

    # -- intervals ------------------------------------------------------

    def num_intervals(self, c: int) -> int:
        return len(self.lower[c])

    def split(self, c: int, k: int, i: int) -> bool:
        """Split interval k of component c at intensity i (new interval
        [i, old_upper] inherits the model values)."""
        if not (self.comp_model_present_flag[c] and k < self.num_intervals(c)):
            return False
        if not (self.lower[c][k] < i <= self.upper[c][k]):
            return False
        self.lower[c].insert(k + 1, i)
        self.upper[c].insert(k, i - 1)
        self.values[c].insert(k + 1, list(self.values[c][k]))
        self.enable[c].insert(k + 1, self.enable[c][k])
        return True

    def remove(self, c: int, k: int) -> bool:
        if self.num_intervals(c) <= 1 or k >= self.num_intervals(c):
            return False
        del self.lower[c][k], self.upper[c][k]
        del self.values[c][k], self.enable[c][k]
        return True

    def toggle(self, c: int, k: int) -> None:
        self.enable[c][k] = not self.enable[c][k]

    # -- I/O ------------------------------------------------------------

    def load(self, filename: str) -> None:
        """Load a VTM-style cfg through the same parser as the pipeline."""
        sei = cfgmod.default_sei()
        afgs1 = cfgmod.default_afgs1()
        parsers.read_cfg(filename, sei, afgs1)
        if afgs1.num_y_points:
            raise parsers.ConfigError(
                "designer edits FGC SEI configs (AFGS1 file given)")
        self.model_id = sei.model_id
        self.log2_scale_factor = sei.log2_scale_factor
        self.comp_model_present_flag = list(sei.comp_model_present_flag)
        self.num_model_values = list(sei.num_model_values)
        self.lower, self.upper, self.values, self.enable = [], [], [], []
        for c in range(3):
            n = sei.num_intensity_intervals[c] if self.comp_model_present_flag[c] else 0
            self.lower.append(list(map(int, sei.intensity_interval_lower_bound[c][:n])))
            self.upper.append(list(map(int, sei.intensity_interval_upper_bound[c][:n])))
            nv = max(1, self.num_model_values[c])
            self.values.append([list(map(int, sei.comp_model_value[c][k][:nv]))
                                for k in range(n)])
            self.enable.append([True] * n)

    def save(self, filename: str, mask: bool = False) -> None:
        """Write a VTM-style cfg; with ``mask``, disabled intervals get scale 0."""
        def row(vals):
            return " ".join(str(int(v)) for v in vals)

        with open(filename, "w") as f:
            f.write("SEIFGCEnabled                          : 1\n")
            f.write("SEIFGCCancelFlag                       : 0\n")
            f.write("SEIFGCPersistenceFlag                  : 1\n")
            f.write(f"SEIFGCModelID                          : {self.model_id}\n")
            f.write("SEIFGCSepColourDescPresentFlag         : 0\n")
            f.write("SEIFGCBlendingModeID                   : 0\n")
            f.write(f"SEIFGCLog2ScaleFactor                  : {self.log2_scale_factor}\n")
            for c in range(3):
                f.write(f"SEIFGCCompModelPresentComp{c}            : "
                        f"{self.comp_model_present_flag[c]}\n")
            for c in range(3):
                if self.comp_model_present_flag[c]:
                    f.write(f"SEIFGCNumIntensityIntervalMinus1Comp{c}  : "
                            f"{self.num_intervals(c) - 1}\n")
            for c in range(3):
                if self.comp_model_present_flag[c]:
                    f.write(f"SEIFGCNumModelValuesMinus1Comp{c}        : "
                            f"{self.num_model_values[c] - 1}\n")
            for c in range(3):
                if self.comp_model_present_flag[c]:
                    f.write(f"SEIFGCIntensityIntervalLowerBoundComp{c} : "
                            f"{row(self.lower[c])}\n")
            for c in range(3):
                if self.comp_model_present_flag[c]:
                    f.write(f"SEIFGCIntensityIntervalUpperBoundComp{c} : "
                            f"{row(self.upper[c])}\n")
            for c in range(3):
                if self.comp_model_present_flag[c]:
                    vals = []
                    for k in range(self.num_intervals(c)):
                        v = list(self.values[c][k])
                        if mask and not self.enable[c][k]:
                            v[0] = 0
                        vals.extend(v[:self.num_model_values[c]])
                    f.write(f"SEIFGCCompModelValuesComp{c}             : "
                            f"{row(vals)}\n")

    # -- preview rendering ---------------------------------------------

    def make_pipeline(self, width: int, height: int, depth: int, fmt: int,
                      seed: int = 0, device=None):
        """Build a GrainPipeline on ``device`` applying this design (via a
        temp cfg file)."""
        import os
        import tempfile

        from ..pipeline import GrainPipeline

        fd, path = tempfile.mkstemp(suffix=".cfg")
        os.close(fd)
        try:
            self.save(path, mask=True)
            pipe = GrainPipeline(width, height, depth, fmt, gain=self.gain,
                                 seed=seed, configs=[path], device=device)
            pipe.maybe_switch_config(0)  # pop now, before the file goes away
            return pipe
        finally:
            os.unlink(path)

    def apply_to_frame(self, planes, width: int, height: int, depth: int,
                       fmt: int, seed: int = 0, frame_index: int = 0,
                       device=None):
        """Grain one (Y, U, V) frame with the current design (in-process,
        on ``device``)."""
        pipe = self.make_pipeline(width, height, depth, fmt, seed, device)
        return pipe.process_frame(planes, frame_index)
