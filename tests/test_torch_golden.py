"""Golden bit-exactness of the torch port: every recorded reference case
through the port's CLI (tests/golden/checksums.json), and the 4:2:2 / 4:4:4
format goldens (tests/golden/format_checksums.json) through the port's
library API, as tests/test_golden.py and tests/test_format_golden.py do for
the JAX package.  The CLI runs with ``--device cpu``, where ``--engine
auto`` is the plain torch engine, and the step runs the kernel's plain
version on CPU tensors."""

import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

from torch_port_cases import REPO, golden_output

sys.path.insert(0, os.path.join(REPO, "tools"))
from gen_input import make_input_yuv  # noqa: E402

GOLDEN = json.load(open(os.path.join(REPO, "tests", "golden",
                                     "checksums.json")))
FORMAT_GOLDEN = json.load(open(os.path.join(REPO, "tests", "golden",
                                            "format_checksums.json")))


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_cli(name, tmp_path_factory):
    from versatilefilmgrain_tpu_torch.cli import main

    tmpdir = str(tmp_path_factory.getbasetemp() / "torch_inputs")
    os.makedirs(tmpdir, exist_ok=True)
    entry = GOLDEN[name]
    data = golden_output(main, entry, "auto", tmpdir)
    assert len(data) == entry["bytes"]
    assert hashlib.sha256(data).hexdigest() == entry["sha256"], \
        f"output differs from reference for {name}"


def _sei_cfg():
    """Must match the harness config (tools/gen_golden_formats.c)."""
    from versatilefilmgrain_tpu_torch.models import config as cfgmod
    sei = cfgmod.FgsSei()
    sei.model_id = 0
    sei.log2_scale_factor = 5
    sei.comp_model_present_flag = [1, 0, 0]
    sei.num_intensity_intervals = [4, 0, 0]
    sei.num_model_values = [3, 0, 0]
    sei.intensity_interval_lower_bound[0, :4] = [0, 60, 120, 180]
    sei.intensity_interval_upper_bound[0, :4] = [59, 119, 179, 255]
    sei.comp_model_value[0, :4, :3] = [[90, 4, 6], [120, 8, 8],
                                       [140, 11, 9], [160, 14, 14]]
    return sei


def _afgs1_cfg():
    from versatilefilmgrain_tpu_torch.models import config as cfgmod
    a = cfgmod.FgsAfgs1()
    a.grain_seed = 7391
    a.num_y_points = 3
    a.point_y_values[:3] = [0, 100, 255]
    a.point_y_scaling[:3] = [60, 100, 30]
    a.grain_scaling = 9
    a.ar_coeff_lag = 2
    a.ar_coeffs_y[:12] = [4, -3, 2, 1, -2, 8, 40, 10, -5, 2, 1, 0]
    a.ar_coeff_shift = 7
    a.grain_scale_shift = 1
    a.clip_to_restricted_range = 1
    return a


@pytest.mark.parametrize("name", sorted(FORMAT_GOLDEN))
def test_format_golden(name, tmp_path):
    from versatilefilmgrain_tpu_torch.models import fw
    from versatilefilmgrain_tpu_torch.models.hw import HwRegs
    from versatilefilmgrain_tpu_torch.ops import lfsr
    from versatilefilmgrain_tpu_torch.ops.grain_natural import (
        add_grain_batch_natural, natural_tables)
    from versatilefilmgrain_tpu_torch.utils import yuv as yuvio

    e = FORMAT_GOLDEN[name]
    w, h, depth = e["w"], e["h"], e["depth"]
    subx, suby = e["subx"], e["suby"]
    fmt = 0 if suby == 2 else (1 if subx == 2 else 2)
    R, C = -(-h // 16), -(-w // 16)
    bh, bw = 16 // suby, 16 // subx

    regs = HwRegs()
    regs.set_depth(depth)
    regs.set_chroma_subsampling(subx, suby)
    if e["mode"] == "sei":
        fw.init_sei(_sei_cfg(), regs)
    else:
        fw.init_afgs1(_afgs1_cfg(), regs)
    tables = natural_tables(regs, "cpu")

    inp = str(tmp_path / "in.yuv")
    make_input_yuv(inp, w, h, depth, fmt, e["frames"])
    out = bytearray()
    with open(inp, "rb") as f:
        for n in range(e["frames"]):
            y, u, v = yuvio.read_frame(f, w, h, depth, fmt)
            e0 = lfsr.frame_base_exponent(n, R, C)
            base = int(lfsr.advance(np.uint32(regs.seed_state), e0))
            padded = (yuvio.pad_plane(y, R * 16, C * 16),
                      yuvio.pad_plane(u, R * bh, C * bw),
                      yuvio.pad_plane(v, R * bh, C * bw))
            o = add_grain_batch_natural(
                *(torch.tensor(p)[None] for p in padded), [base], None,
                tables, height=h, width=w, bs=depth - 8, csubx=subx,
                csuby=suby)
            cw, ch = w // subx, h // suby
            out += o[0][0, :h, :w].numpy().tobytes()
            out += o[1][0, :ch, :cw].numpy().tobytes()
            out += o[2][0, :ch, :cw].numpy().tobytes()
    assert hashlib.sha256(bytes(out)).hexdigest() == e["sha256"], name
