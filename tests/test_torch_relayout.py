"""The port's relayout probes (K9, K10) against the JAX probes, bit for bit.

The JAX package's tools/probe_relayout.py and probe_relayout5d.py are loaded
by path; their module shape (F, H, W, R, C) is set to the test's, and each
of their six kernels runs with ``interpret=True`` in the BlockSpecs of their
``main``, at 2 frames of 240 lines (15 block rows: a multiple of 5 and 15)
and widths 256 and 160 (not a multiple of 128).  On CPU tensors the port's
probe steps run their plain versions, which must equal the JAX kernels
exactly (tolerance 0: every value is an integer) and ``y ^ 1``.  The kernel
itself (csrc/probe_relayout.cu) runs only on the card: tests/test_torch_cuda.py
and chip_smoke.py hold it against the same plain versions.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from versatilefilmgrain_tpu_torch.tools import (_relayout, probe_relayout,
                                                probe_relayout5d)

from torch_port_cases import REPO

FR, HT = 2, 240
WIDTHS = [256, 160]


@pytest.fixture(scope="module")
def jax_probes():
    """The two JAX probe modules, loaded by path."""
    mods = {}
    for name in ("probe_relayout", "probe_relayout5d"):
        spec = importlib.util.spec_from_file_location(
            f"_jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
        m = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(m)
        mods[name] = m
    return mods


def _shape(m, y, monkeypatch):
    """Set the module's shape to ``y``'s, as its main reads it."""
    Fy, Hy, Wy = y.shape
    for k, v in dict(F=Fy, H=Hy, W=Wy, R=Hy // 16, C=Wy // 16).items():
        monkeypatch.setattr(m, k, v)


def _jax_k9(m, case, y, monkeypatch):
    """K9's kernel for ``case`` in main's BlockSpec and grid."""
    _shape(m, y, monkeypatch)
    mode, rchunk = probe_relayout.CASES[case]
    if mode == "passthrough":
        kern = m._passthrough_kernel
    elif rchunk == 1:
        kern = functools.partial(m._relayout_kernel, bh=16, bw=16, c=m.C)
    else:
        kern = functools.partial(m._relayout_rows_kernel, bh=16, bw=16,
                                 c=m.C, rchunk=rchunk)
    spec = m.pl.BlockSpec((1, 16 * rchunk, m.W), lambda f, r: (f, r, 0),
                          memory_space=m.pltpu.VMEM)
    out = m.pl.pallas_call(
        kern, grid=(m.F, m.R // rchunk), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((m.F, m.H, m.W), jnp.uint16),
        interpret=True)(jnp.asarray(y.numpy()))
    return np.asarray(out)


def _jax_k10(m, form, y, monkeypatch):
    """K10's kernel for ``form`` on main's free 5-D view, BlockSpec and
    grid; returns the natural (F, H, W) plane."""
    _shape(m, y, monkeypatch)
    kern = functools.partial(m._kernel_5d if form == "5d_transpose"
                             else m._kernel_5d_notr, bh=16, bw=16, c=m.C)
    spec5 = m.pl.BlockSpec((1, 1, 16, m.C, 16), lambda f, r: (f, r, 0, 0, 0),
                           memory_space=m.pltpu.VMEM)
    y5 = jnp.asarray(y.numpy()).reshape(m.F, m.R, 16, m.C, 16)
    out = m.pl.pallas_call(
        kern, grid=(m.F, m.R), in_specs=[spec5], out_specs=spec5,
        out_shape=jax.ShapeDtypeStruct(y5.shape, y5.dtype),
        interpret=True)(y5)
    return np.asarray(out.reshape(m.F, m.H, m.W))


def _xor1(y):
    return y.numpy() ^ np.uint16(1)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("case", list(probe_relayout.CASES))
def test_k9_plain_matches_jax(case, width, jax_probes, monkeypatch):
    y = _relayout.relayout_inputs(3, FR, HT, width)
    want = _jax_k9(jax_probes["probe_relayout"], case, y, monkeypatch)
    mode, rchunk = probe_relayout.CASES[case]
    got = _relayout.make_step(mode, rchunk)(y)[0]
    assert got.dtype == torch.uint16 and got.shape == y.shape
    assert np.array_equal(got.numpy(), want), f"{case} W={width}"
    assert np.array_equal(want, _xor1(y))
    assert not np.array_equal(want, y.numpy())


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("form", list(_relayout.MODES_5D))
def test_k10_plain_matches_jax(form, width, jax_probes, monkeypatch):
    y = _relayout.relayout_inputs(5, FR, HT, width)
    want = _jax_k10(jax_probes["probe_relayout5d"], form, y, monkeypatch)
    y5 = _relayout.view5d(y)
    got = _relayout.make_step(form)(y5)[0]
    assert got.dtype == torch.uint16 and got.shape == y5.shape
    assert np.array_equal(got.reshape(y.shape).numpy(), want), \
        f"{form} W={width}"
    assert np.array_equal(want, _xor1(y))
    assert not np.array_equal(want, y.numpy())


@pytest.mark.parametrize("width", WIDTHS)
def test_5d_plain_equals_k9_rchunk1(width):
    """K10's transpose on the view is K9's rchunk-1 relayout, element for
    element: what lets K10 run K9's instance on the card."""
    y = _relayout.relayout_inputs(7, FR, HT, width)
    got = _relayout.relayout5d_plain(_relayout.view5d(y))
    assert torch.equal(got.reshape(y.shape), _relayout.relayout_plain(y, 1))
    assert torch.equal(got.reshape(y.shape),
                       _relayout.relayout_plain(y, 15))


def test_plain_relayout_goes_through_the_tiled_layout(monkeypatch):
    """The plain relayout XORs the tiled (16 rchunk * 16, C) array: natural
    (line, 16c + x) at tiled row 16 line + x, column c."""
    seen = []
    xor1 = _relayout._xor1

    def spy(t):
        seen.append(t.clone())
        return xor1(t)

    monkeypatch.setattr(_relayout, "_xor1", spy)
    y = _relayout.relayout_inputs(9, 1, 80, 160)
    _relayout.relayout_plain(y, 5)
    (t,) = seen
    assert t.shape == (1, 1, 80 * 16, 10)
    line, c, x = 37, 6, 11
    assert t[0, 0, 16 * line + x, c] == y[0, line, 16 * c + x]


def test_inputs_draw_in_jax_main_order():
    rng = np.random.default_rng(0)
    want = rng.integers(0, 1024, (FR, HT, 160), np.uint16)
    got = _relayout.relayout_inputs(0, FR, HT, 160)
    assert got.dtype == torch.uint16 and np.array_equal(got.numpy(), want)


def test_cpu_path_never_launches():
    y = _relayout.relayout_inputs(1, FR, HT, 160)
    before = (_relayout.relayout_probe_cuda.launches,
              _relayout.relayout5d_probe_cuda.launches)
    for mode, rchunk in probe_relayout.CASES.values():
        _relayout.make_step(mode, rchunk)(y)
    for form in _relayout.MODES_5D:
        _relayout.make_step(form)(_relayout.view5d(y))
    assert (_relayout.relayout_probe_cuda.launches,
            _relayout.relayout5d_probe_cuda.launches) == before


@pytest.mark.parametrize("case", list(probe_relayout.CASES))
def test_wrapper_raises_on_cpu(case):
    y = _relayout.relayout_inputs(1, FR, HT, 160)
    mode, rchunk = probe_relayout.CASES[case]
    launches = _relayout.relayout_probe_cuda.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _relayout.relayout_probe_cuda(y, mode=mode, rchunk=rchunk)
    assert _relayout.relayout_probe_cuda.launches == launches


@pytest.mark.parametrize("form", list(_relayout.MODES_5D))
def test_5d_wrapper_raises_on_cpu(form):
    y5 = _relayout.view5d(_relayout.relayout_inputs(1, FR, HT, 160))
    launches = _relayout.relayout5d_probe_cuda.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _relayout.relayout5d_probe_cuda(y5, mode=form)
    assert _relayout.relayout5d_probe_cuda.launches == launches


@pytest.mark.parametrize("rchunk", [5, 15])
def test_wrapper_raises_on_height_not_whole_chunks(rchunk):
    """H must be a multiple of 16 rchunk (here 224 = 14 block rows)."""
    y = _relayout.relayout_inputs(1, FR, 224, 160)
    with pytest.raises(ValueError, match=r"\(F, 16 rchunk R, 16 C\)"):
        _relayout.relayout_probe_cuda(y, mode="relayout", rchunk=rchunk)


@pytest.mark.parametrize("case,match", [
    ("y int16", "y: expected"), ("width 150", r"\(F, 16 rchunk R, 16 C\)"),
    ("mode", "unknown mode"), ("rchunk 3", "no relayout instance"),
    ("passthrough rchunk 5", "no passthrough instance"),
    ("5d shape", r"\(F, R, 16, C, 16\)"), ("5d mode", "unknown mode")])
def test_wrapper_checks_inputs(case, match):
    y = _relayout.relayout_inputs(1, FR, HT, 160)
    kw = dict(mode="relayout", rchunk=1)
    fn = _relayout.relayout_probe_cuda
    if case == "y int16":
        y = y.view(torch.int16)
    elif case == "width 150":
        y = y[:, :, :150].contiguous()
    elif case == "mode":
        kw["mode"] = "transpose"
    elif case == "rchunk 3":
        kw["rchunk"] = 3
    elif case == "passthrough rchunk 5":
        kw = dict(mode="passthrough", rchunk=5)
    elif case == "5d shape":
        fn, kw, y = (_relayout.relayout5d_probe_cuda,
                     dict(mode="5d_transpose"), y.view(FR, 15, 16, 160))
    elif case == "5d mode":
        fn, kw, y = (_relayout.relayout5d_probe_cuda,
                     dict(mode="relayout"), _relayout.view5d(y))
    with pytest.raises(ValueError, match=match):
        fn(y, **kw)


def test_bound_at_4k():
    """One 8-frame 3840x2160 step: 265.4 MB in and out at 3.35 TB/s (meta
    tensor: no memory is allocated)."""
    y = torch.empty(8, 2160, 3840, dtype=torch.uint16, device="meta")
    ms, by = _relayout.bound(y)
    assert by == "bytes" and ms == pytest.approx(0.0792, abs=1e-4)


def test_tile_round_trip_is_xor():
    """The library yardstick computes the probes' function."""
    y = _relayout.relayout_inputs(2, FR, HT, 160)
    assert torch.equal(_relayout.tile_round_trip(y),
                       _relayout.passthrough_plain(y))
    assert _relayout.tile_only(y).shape == (FR, HT // 16, 256, 10)


@pytest.mark.parametrize("probe", [probe_relayout, probe_relayout5d])
def test_probe_main_refuses_cpu(probe, monkeypatch, capsys):
    """Without a card the probes time nothing and exit 2."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
