"""The torch port's designer (versatilefilmgrain_tpu_torch/designer/) against
the JAX package's: interval editing, the saved cfg byte for byte, the
in-process regrain on the CPU (exact), the preview conversion (the same
numpy code, ``np.array_equal``) and the sinc upsampler against a scipy
transcription of the reference designer's, as tests/test_designer.py
holds the JAX one."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from versatilefilmgrain_tpu import designer as jdesigner
from versatilefilmgrain_tpu_torch import designer
from versatilefilmgrain_tpu_torch.designer import FgcSeiDesign
from versatilefilmgrain_tpu_torch.utils import yuv as yuvio

from torch_port_cases import REPO, edit_design

sys.path.insert(0, os.path.join(REPO, "tools"))

from gen_input import make_input_yuv  # noqa: E402

W, H = 256, 192


def test_split_toggle_remove():
    d = FgcSeiDesign()
    n0 = d.num_intervals(0)
    assert d.split(0, 0, 20)
    assert d.num_intervals(0) == n0 + 1
    assert d.lower[0][1] == 20 and d.upper[0][0] == 19
    assert d.values[0][1] == d.values[0][0]
    assert not d.split(0, 0, 0)              # not inside the interval
    d.toggle(0, 1)
    assert not d.enable[0][1]
    assert d.remove(0, 1)
    assert d.num_intervals(0) == n0
    assert not d.remove(0, n0)


def test_save_load_roundtrip(tmp_path):
    d = FgcSeiDesign()
    d.split(0, 2, 70)
    d.values[0][3][0] = 77
    d.log2_scale_factor = 6
    p = str(tmp_path / "design.cfg")
    d.save(p)
    d2 = FgcSeiDesign()
    d2.load(p)
    assert d2.log2_scale_factor == 6
    assert d2.lower == d.lower and d2.upper == d.upper
    assert d2.values == d.values
    assert d2.enable == [[True] * d.num_intervals(c) for c in range(3)]


@pytest.mark.parametrize("mask", [False, True])
def test_saved_cfg_equals_jax(tmp_path, mask):
    paths = []
    for pkg, d in (("jax", jdesigner.FgcSeiDesign()),
                   ("torch", FgcSeiDesign())):
        edit_design(d)
        paths.append(str(tmp_path / f"{pkg}.cfg"))
        d.save(paths[-1], mask=mask)
    want, got = (open(p, "rb").read() for p in paths)
    assert got == want
    row = next(line for line in got.decode().splitlines()
               if line.startswith("SEIFGCCompModelValuesComp0"))
    scales = [int(v) for v in row.split(":")[1].split()][::3]
    assert scales[:4] == [200, 100, 100, 0 if mask else 100]


def test_load_rejects_afgs1():
    from versatilefilmgrain_tpu_torch.utils.parsers import ConfigError
    with pytest.raises(ConfigError, match="AFGS1"):
        FgcSeiDesign().load(os.path.join(REPO, "tests", "golden", "cfg",
                                         "fgs_afgs1_test1.cfg"))


def _frame(tmp_path, depth, fmt, frames=4, frame=0):
    inp = str(tmp_path / f"in_{depth}_{fmt}.yuv")
    make_input_yuv(inp, W, H, depth, fmt, frames)
    got = designer.read_yuv_frame(inp, frame, W, H, depth, fmt)
    want = jdesigner.read_yuv_frame(inp, frame, W, H, depth, fmt)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    return got


@pytest.mark.parametrize("edited", [False, True])
@pytest.mark.parametrize("depth", [10, 8])
def test_apply_to_frame_equals_jax(tmp_path, edited, depth):
    """The design's regrain on the CPU equals the JAX designer's, byte for
    byte, at 4:2:0 (the designer's format: see the 4:2:2 case below)."""
    planes = _frame(tmp_path, depth, yuvio.YUV_420, frame=2)
    outs = []
    for d, kw in ((jdesigner.FgcSeiDesign(), {}),
                  (FgcSeiDesign(), {"device": "cpu"})):
        if edited:
            edit_design(d)
        outs.append(d.apply_to_frame(planes, W, H, depth, yuvio.YUV_420,
                                     seed=3, frame_index=2, **kw))
    for c, (want, got) in enumerate(zip(*outs)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert np.array_equal(got, want), f"plane {c}"
    assert not np.array_equal(outs[1][0], planes[0])   # grain was added


@pytest.mark.parametrize("edited", [False, True])
def test_apply_to_frame_422_refused_as_jax(tmp_path, edited):
    """At 8-bit 4:2:2 both designers refuse, with the same error: a
    GrainPipeline starts from the chroma-bearing default SEI, which fails
    validation there before the design's cfg is read (as the reference
    does)."""
    from versatilefilmgrain_tpu.utils.parsers import \
        ConfigError as JaxConfigError
    from versatilefilmgrain_tpu_torch.utils.parsers import ConfigError
    planes = _frame(tmp_path, 8, yuvio.YUV_422)
    errors = []
    for d, kw, err in ((jdesigner.FgcSeiDesign(), {}, JaxConfigError),
                       (FgcSeiDesign(), {"device": "cpu"}, ConfigError)):
        if edited:
            edit_design(d)
        with pytest.raises(err, match="not supported on yuv422") as e:
            d.apply_to_frame(planes, W, H, 8, yuvio.YUV_422, **kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_make_pipeline_needs_a_card(monkeypatch, tmp_path):
    """No device means the card: without one the designer raises and names
    the CPU; it never carries on there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = FgcSeiDesign()
    with pytest.raises(RuntimeError, match="CUDA.*device=\"cpu\""):
        d.make_pipeline(W, H, 10, yuvio.YUV_420)
    planes = _frame(tmp_path, 10, yuvio.YUV_420, frames=1)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        d.apply_to_frame(planes, W, H, 10, yuvio.YUV_420)
    assert d.make_pipeline(W, H, 10, yuvio.YUV_420,
                           device="cpu").device.type == "cpu"


@pytest.mark.parametrize("fmt", [yuvio.YUV_420, yuvio.YUV_422,
                                 yuvio.YUV_444])
def test_preview_equals_jax(tmp_path, fmt):
    y, u, v = _frame(tmp_path, 10, fmt, frames=1)
    for a, b in zip(designer.upsample_chroma(y, u, v, fmt),
                    jdesigner.upsample_chroma(y, u, v, fmt)):
        assert a.shape == y.shape and np.array_equal(a, b)
    for method in ("sinc", "halfband"):
        got = designer.yuv_to_rgb(y, u, v, 10, fmt, method=method)
        want = jdesigner.yuv_to_rgb(y, u, v, 10, fmt, method=method)
        assert got.shape == (H, W, 3) and np.array_equal(got, want)
    y8, u8, v8 = (p >> 2 for p in (y, u, v))
    assert np.array_equal(designer.yuv_to_rgb(y8, u8, v8, 8, fmt),
                          jdesigner.yuv_to_rgb(y8, u8, v8, 8, fmt))


def test_sinc_upsampler_matches_reference_transcription():
    """The port's windowed-sinc chroma upsample against a direct scipy
    transcription of the reference designer's yuv444 (fgc-designer.py:
    253-272): horizontal co-sited, vertical midpoint."""
    scipy_ndimage = pytest.importorskip("scipy.ndimage")
    from versatilefilmgrain_tpu_torch.designer.preview import \
        upsample_chroma_sinc

    rng = np.random.default_rng(7)
    yf = rng.normal(size=(24, 40)).astype(np.float64)
    uf = rng.normal(size=(12, 20)).astype(np.float64)
    vf = rng.normal(size=(12, 20)).astype(np.float64)

    def ref_yuv444(Y, U, V):
        if 2 * np.shape(U)[1] == np.shape(Y)[1]:
            f = np.sinc(np.arange(-1.5, 1.6))
            f /= np.sum(f)
            sz = list(U.shape)
            sz[1] *= 2
            U, V = (np.reshape(np.vstack(
                (P, scipy_ndimage.convolve1d(P, f, axis=1, mode="nearest"))),
                sz, order="F") for P in (U, V))
        if 2 * np.shape(U)[0] == np.shape(Y)[0]:
            f = np.append(0, np.sinc(np.arange(-1.25, 1.76)))
            f /= np.sum(f)
            sz = list(U.shape)
            sz[0] *= 2
            U, V = (np.reshape(np.hstack(
                (scipy_ndimage.convolve1d(P, f, axis=0, mode="nearest"),
                 scipy_ndimage.convolve1d(P, np.flip(f), axis=0,
                                          mode="nearest"))), sz, order="C")
                for P in (U, V))
        return U, V

    want_u, want_v = ref_yuv444(yf, uf, vf)
    got_u, got_v = upsample_chroma_sinc(yf, uf, vf)
    assert np.allclose(got_u, want_u, atol=1e-12)
    assert np.allclose(got_v, want_v, atol=1e-12)

    # 4:2:2 (horizontal only) and 4:4:4 (no-op) paths
    uf2 = rng.normal(size=(24, 20))
    got_u2, _ = upsample_chroma_sinc(yf, uf2, uf2.copy())
    want_u2, _ = ref_yuv444(yf, uf2, uf2.copy())
    assert np.allclose(got_u2, want_u2, atol=1e-12)
    got_u3, _ = upsample_chroma_sinc(yf, yf.copy(), yf.copy())
    assert np.array_equal(got_u3, yf)


def test_package_import_is_headless():
    """Importing the designer package pulls in neither matplotlib nor Tk."""
    code = ("import sys, versatilefilmgrain_tpu_torch.designer; "
            "print([m for m in ('matplotlib', 'tkinter') if m in sys.modules])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"
