"""The port's one-hot dot probes (K6, K7, K8) against the JAX probes, bit
for bit.

The JAX package's tools/probe_dot.py, probe_dot2.py and probe_dotscale.py
are loaded by path; their module ``W`` is set to the test's width and their
own ``kernel`` runs in the BlockSpecs of their ``main`` with
``interpret=True``, at 2 frames of 32 lines and widths 256 and 160 (not a
multiple of 128).  On CPU tensors the port's probe steps run their plain
versions, which must equal the JAX kernels exactly (tolerance 0: every
value is an integer).  The kernels themselves (csrc/probe_dot.cu, and
csrc/probe_dotconst.cu for the tensor-core products) run only on the card:
tests/test_torch_cuda.py and chip_smoke.py hold them against the same plain
versions.  Here the persistent kernel's wrapper checks, its work schedule
and the row groups of its TF32 instance are tested too.
"""

import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from versatilefilmgrain_tpu_torch.tools import (_dot, probe_dot, probe_dot2,
                                                probe_dotscale)

from torch_port_cases import REPO

FR, HT = 2, 32
WIDTHS = [256, 160]
K, M = _dot.K, _dot.M


@pytest.fixture(scope="module")
def jax_probes():
    """The three JAX probe modules, loaded by path."""
    mods = {}
    for name in ("probe_dot", "probe_dot2", "probe_dotscale"):
        spec = importlib.util.spec_from_file_location(
            f"_jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
        m = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(m)
        mods[name] = m
    return mods


def _specs(m, width, consts):
    """main()'s strip, per-lane and constant BlockSpecs at ``width``."""
    vmem = dict(memory_space=m.pltpu.VMEM)
    strip = m.pl.BlockSpec((1, 16, width), lambda f, r: (f, r, 0), **vmem)
    perlane = m.pl.BlockSpec((1, 1, 1, width), lambda f, r: (f, r, 0, 0),
                             **vmem)
    const = [m.pl.BlockSpec(shape, lambda f, r: (0, 0), **vmem)
             for shape in consts]
    return strip, perlane, const


def _jax_call(m, kern, y, ins, in_specs, strip):
    out = m.pl.pallas_call(
        kern, grid=(y.shape[0], y.shape[1] // 16), in_specs=in_specs,
        out_specs=strip,
        out_shape=jax.ShapeDtypeStruct(tuple(y.shape), jnp.uint16),
        interpret=True)(*(jnp.asarray(a.numpy()) for a in ins))
    return np.asarray(out)


def _jax_k6(m, mode, y, t, pat, monkeypatch):
    width = y.shape[2]
    monkeypatch.setattr(m, "W", width)
    strip, perlane, (const2,) = _specs(m, width, [(M, K)])
    return _jax_call(m, functools.partial(m.kernel, mode=mode), y,
                     (y, t, pat), [strip, perlane, const2], strip)


def _jax_k7(m, mode, y, t, pat, constoh, monkeypatch):
    width = y.shape[2]
    monkeypatch.setattr(m, "W", width)
    strip, perlane, (const2, constspec) = _specs(m, width,
                                                 [(M, K), (K, width)])
    return _jax_call(m, functools.partial(m.kernel, mode=mode), y,
                     (y, t, pat, constoh),
                     [strip, perlane, const2, constspec], strip)


def _jax_k8(m, mm, y, oh, pat, monkeypatch):
    width = y.shape[2]
    monkeypatch.setattr(m, "W", width)
    strip, _, (patspec, ohspec) = _specs(m, width, [(mm, K), (K, width)])
    return _jax_call(m, functools.partial(m.kernel, M=mm), y, (y, pat, oh),
                     [strip, patspec, ohspec], strip)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("mode", probe_dot.MODES[:4])
def test_k6_plain_matches_jax(mode, width, jax_probes, monkeypatch):
    y, t, pat = _dot.dot_inputs(3, FR, HT, width)
    want = _jax_k6(jax_probes["probe_dot"], mode, y, t, pat, monkeypatch)
    got = _dot.make_step(mode, t, pat)(y)[0]
    assert got.dtype == torch.uint16 and got.shape == y.shape
    assert np.array_equal(got.numpy(), want), f"{mode} W={width}"
    if mode != "none":   # the product reached the output
        assert not np.array_equal(want, y.numpy())


@pytest.mark.parametrize("width", WIDTHS)
def test_gather_equals_jax_int8(width, jax_probes, monkeypatch):
    """gather (not a TPU mode) == the TPU int8 one-hot dot."""
    y, t, pat = _dot.dot_inputs(5, FR, HT, width)
    want = _jax_k6(jax_probes["probe_dot"], "int8", y, t, pat, monkeypatch)
    got = _dot.make_step("gather", t, pat)(y)[0]
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("mode", probe_dot2.MODES)
def test_k7_plain_matches_jax(mode, width, jax_probes, monkeypatch):
    y, t, pat, constoh = _dot.dot2_inputs(7, FR, HT, width)
    want = _jax_k7(jax_probes["probe_dot2"], mode, y, t, pat, constoh,
                   monkeypatch)
    got = _dot.make_step(mode, t, pat, constoh)(y)[0]
    assert np.array_equal(got.numpy(), want), f"{mode} W={width}"


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("mm", _dot.SCALE_MS)
def test_k8_plain_matches_jax(mm, width, jax_probes, monkeypatch):
    y, oh, pats = _dot.dotscale_inputs(11, FR, HT, width, ms=(mm,))
    want = _jax_k8(jax_probes["probe_dotscale"], mm, y, oh, pats[mm],
                   monkeypatch)
    got = _dot.make_step("dotconst", None, pats[mm], oh,
                         clip_hi=_dot.CLIP_HI_SCALE,
                         rows=_dot.scale_rows(mm))(y)[0]
    assert np.array_equal(got.numpy(), want), f"M={mm} W={width}"


@pytest.mark.parametrize("mode", ["int8", "build"])
def test_out_of_range_indices_match_no_row(mode, jax_probes, monkeypatch):
    """An index outside [0, K) adds nothing, as in the JAX kernels."""
    y, t, pat, constoh = _dot.dot2_inputs(9, FR, HT, 160)
    t[0, 0, 0, :4] = torch.tensor([-1, K, 5000, -300])
    want = _jax_k7(jax_probes["probe_dot2"], mode, y, t, pat, constoh,
                   monkeypatch)
    got = _dot.make_step(mode, t, pat)(y)[0]
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want[0, :16, :4], y.numpy()[0, :16, :4])


def test_inputs_draw_in_jax_main_order():
    """Each input function replays its JAX main's numpy draws."""
    rng = np.random.default_rng(0)
    y = rng.integers(0, 1024, (FR, HT, 160), np.uint16)
    t = rng.integers(0, K, (FR, HT // 16, 1, 160), np.int32)
    pat = rng.integers(-128, 128, (M, K), np.int8)
    const = (rng.integers(0, 2, (K, 160))
             * rng.integers(0, 2, (K, 160))).astype(np.int8)
    for got, want in zip(_dot.dot2_inputs(0, FR, HT, 160),
                         (y, t, pat, const)):
        assert got.numpy().dtype == want.dtype
        assert np.array_equal(got.numpy(), want)
    for got, want in zip(_dot.dot_inputs(0, FR, HT, 160), (y, t, pat)):
        assert np.array_equal(got.numpy(), want)
    rng = np.random.default_rng(0)
    y = rng.integers(0, 1024, (FR, HT, 160), np.uint16)
    oh = rng.integers(0, 2, (K, 160)).astype(np.int8)
    pats = [rng.integers(-128, 128, (mm, K), np.int8) for mm in _dot.SCALE_MS]
    gy, goh, gpats = _dot.dotscale_inputs(0, FR, HT, 160)
    assert np.array_equal(gy.numpy(), y) and np.array_equal(goh.numpy(), oh)
    assert list(gpats) == list(_dot.SCALE_MS)
    for g, w in zip(gpats.values(), pats):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("mode,want_ms,by", [
    ("int8", 0.4635, "operations"), ("dotconst", 0.4635, "operations"),
    ("bf16", 0.9273, "operations"), ("f32", 1.8530, "operations"),
    ("gather", 0.0842, "bytes"), ("build", 0.0842, "bytes"),
    ("none", 0.0792, "bytes")])
def test_bounds_at_4k(mode, want_ms, by):
    """The computed bounds of one 8-frame 3840x2160 step (meta tensors: no
    memory is allocated)."""
    meta = dict(device="meta")
    y = torch.empty(8, 2160, 3840, dtype=torch.uint16, **meta)
    t = torch.empty(8, 135, 1, 3840, dtype=torch.int32, **meta)
    pat = torch.empty(M, K, dtype=torch.int8, **meta)
    oh = torch.empty(K, 3840, dtype=torch.int8, **meta)
    ms, got_by = _dot.bound(mode, y, t, pat, oh)
    assert got_by == by and ms == pytest.approx(want_ms, abs=2e-4)


@pytest.mark.parametrize("mm,want_ms,by", [
    (16, 0.0801, "bytes"), (64, 0.2060, "operations"),
    (256, 0.8241, "operations")])
def test_dotscale_bounds_at_4k(mm, want_ms, by):
    meta = dict(device="meta")
    y = torch.empty(8, 2160, 3840, dtype=torch.uint16, **meta)
    pat = torch.empty(mm, K, dtype=torch.int8, **meta)
    oh = torch.empty(K, 3840, dtype=torch.int8, **meta)
    ms, got_by = _dot.bound("dotconst", y, None, pat, oh)
    assert got_by == by and ms == pytest.approx(want_ms, abs=2e-4)


@pytest.mark.parametrize("mode", list(_dot.MODES))
def test_wrapper_raises_on_cpu(mode):
    y, t, pat, constoh = _dot.dot2_inputs(1, FR, HT, 160)
    launches = _dot.dot_probe_cuda.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        _dot.dot_probe_cuda(y, t, pat, constoh.t().contiguous(), mode=mode)
    assert _dot.dot_probe_cuda.launches == launches


@pytest.mark.parametrize("case,match", [
    ("y int16", "y: expected"), ("y ragged height", r"\(F, 16R, W\)"),
    ("t int64", "t: expected"), ("t missing", "needs t"),
    ("pat 128 rows", "no int8 instance"), ("oh_t (K, W)", "oh_t: expected"),
    ("rows of K8", "no dotconst instance"), ("mode", "unknown mode"),
    ("strips 0", "strips 0")])
def test_wrapper_checks_inputs(case, match):
    y, t, pat, constoh = _dot.dot2_inputs(1, FR, HT, 160)
    oh_t = constoh.t().contiguous()
    kw = dict(mode="int8")
    if case == "y int16":
        y = y.to(torch.int16)
    elif case == "y ragged height":
        y = y[:, :20]
    elif case == "t int64":
        t = t.long()
    elif case == "t missing":
        t = None
    elif case == "pat 128 rows":
        pat = pat[:128].contiguous()
    elif case == "oh_t (K, W)":
        oh_t, kw = constoh, dict(mode="dotconst")
    elif case == "rows of K8":
        kw = dict(mode="dotconst", rows=_dot.scale_rows(M))
        pat = torch.cat([pat, pat[:16]])
    elif case == "mode":
        kw = dict(mode="int4")
    elif case == "strips 0":
        kw = dict(mode="int8", strips=0)
    with pytest.raises(ValueError, match=match):
        _dot.dot_probe_cuda(y, t, pat, oh_t, **kw)


@pytest.mark.parametrize("probe", [probe_dot, probe_dot2, probe_dotscale])
def test_probe_main_refuses_cpu(probe, monkeypatch, capsys):
    """Without a card the probes time nothing and exit 2."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_plain_products_restore_tf32():
    """The plain products leave TF32 as they found it."""
    before = torch.backends.cuda.matmul.allow_tf32
    y, t, pat, constoh = _dot.dot2_inputs(2, FR, HT, 160)
    _dot.onehot_plain(y, t, pat)
    _dot.dotconst_plain(y, pat, constoh)
    assert torch.backends.cuda.matmul.allow_tf32 == before


@pytest.mark.parametrize("seed", range(6))
def test_dotconst_schedule_covers_every_item(seed):
    """The dense kernel's work ranges (csrc/probe_dotconst.cu, mirrored by
    ``_dot.dotconst_schedule``) cover every (column tile, strip) exactly
    once, in order, for random frames, block rows, widths and grids."""
    rng = np.random.default_rng(seed)
    frames, rows = int(rng.integers(1, 9)), int(rng.integers(1, 140))
    width = 8 * int(rng.integers(1, 500))
    ctas = int(rng.integers(1, 300))
    ranges = _dot.dotconst_schedule(frames, rows, width, ctas)
    tiles = -(-width // _dot.DOTCONST_COLS)
    assert len(ranges) == ctas and ranges[0][0] == 0
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    seen = [divmod(i, frames * rows)   # (column tile, strip)
            for lo, hi in ranges for i in range(lo, hi)]
    assert len(seen) == len(set(seen)) == tiles * frames * rows
    assert set(seen) == {(c, s) for c in range(tiles)
                         for s in range(frames * rows)}
    assert seen == sorted(seen)   # column tile first


def _misaligned(x):
    """A contiguous copy of ``x`` whose data pointer is off the 16-byte
    grid."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    assert out.data_ptr() % 16
    return out


@pytest.mark.parametrize("case,match", [
    ("strips 2", "strips 2: dotconst"), ("width 164", "multiple of 8"),
    ("pat misaligned", "pat must be 16-byte aligned"),
    ("oh_t misaligned", "oh_t must be 16-byte aligned"),
    ("y misaligned", "y must be 16-byte aligned"),
    ("M=32", "no dotconst instance"),
    ("K7 rows at M=160", "no dotconst instance"),
    ("cpu", "needs CUDA tensors")])
def test_dotconst_wrapper_checks(case, match):
    """The dense kernel's wrapper: strips 1 only, widths of 8, 16-byte
    aligned operands, its instance list, and CUDA tensors; nothing is
    launched."""
    width = 164 if case == "width 164" else 160
    y, oh, pats = _dot.dotscale_inputs(1, FR, HT, width, ms=(16, 160))
    pat, rows = pats[16], _dot.scale_rows(16)
    oh_t = oh.t().contiguous()
    kw = {}
    if case == "strips 2":
        kw = dict(strips=2)
    elif case == "pat misaligned":
        pat = _misaligned(pat)
    elif case == "oh_t misaligned":
        oh_t = _misaligned(oh_t)
    elif case == "y misaligned":
        y = _misaligned(y)
    elif case == "M=32":
        pat, rows = torch.cat([pat, pat]), (16, 2)
    elif case == "K7 rows at M=160":
        pat, rows = pats[160], _dot.ROWS_K6
    launches = _dot.dot_probe_cuda.launches
    with pytest.raises(ValueError, match=match):
        _dot.dot_probe_cuda(y, None, pat, oh_t, mode="dotconst",
                            clip_hi=_dot.CLIP_HI_SCALE, rows=rows, **kw)
    assert _dot.dot_probe_cuda.launches == launches


@pytest.mark.parametrize("case,match", [
    ("strips 2", "schedules its strips"), ("width 164", "multiple of 8"),
    ("y misaligned", "y must be 16-byte aligned"),
    ("cpu", "needs CUDA tensors")])
@pytest.mark.parametrize("mode", ["int8", "bf16", "f32"])
def test_onehot_wgmma_wrapper_checks(mode, case, match):
    """K6's int8, bf16 and f32 (TF32) products run on
    csrc/probe_dotconst.cu's persistent grid: their wrapper takes strips 1
    only, widths of 8, a 16-byte aligned y, and CUDA tensors; nothing is
    launched."""
    width = 164 if case == "width 164" else 160
    y, t, pat = _dot.dot_inputs(1, FR, HT, width)
    kw = {}
    if case == "strips 2":
        kw = dict(strips=2)
        match = f"strips 2: {mode} {match}"
    elif case == "y misaligned":
        y = _misaligned(y)
    launches = _dot.dot_probe_cuda.launches
    with pytest.raises(ValueError, match=match):
        _dot.dot_probe_cuda(y, t, pat, mode=mode, **kw)
    assert _dot.dot_probe_cuda.launches == launches


@pytest.mark.parametrize("mode", ["none", "gather", "build", "int4"])
def test_wgmma_info_refuses_other_modes(mode):
    """Only dotconst, int8, bf16 and f32 have a csrc/probe_dotconst.cu
    instance to report on; the refusal comes before any build."""
    with pytest.raises(ValueError, match="does not run csrc/probe_dotconst"):
        _dot.dotconst_info(M, _dot.ROWS_K6, mode)


def test_tf32_row_groups_cover_whole_lines():
    """The TF32 instance's two banks hold every pattern row exactly once,
    72 each, and each line's 8 slices lie in one bank: group g's row
    [i', p] is slice p of line 9 g + i' (lines 16 and 17, past the strip,
    are group 1's i' 7 and 8)."""
    groups = _dot.tf32_row_groups()
    assert groups.shape == (2, 9, 8)
    assert sorted(groups.flatten().tolist()) == list(range(M))
    stride, slices = _dot.ROWS_K6
    for line in range(stride):
        g, i = divmod(line, 9)
        assert groups[g, i].tolist() == [stride * p + line
                                         for p in range(slices)]


@pytest.mark.parametrize("seed,width", [(0, 64), (1, 160), (2, 200),
                                        (3, 256), (4, 296), (5, 8)])
def test_tf32_row_groups_fold_to_onehot_plain(seed, width):
    """The TF32 instance's arithmetic in plain torch: each group's float32
    product of its 72 staged rows with the one-hot, summed line by line over
    the 8 slices of each bank row's line, gives every line of s once; with
    y added and clipped that equals ``onehot_plain`` exactly, at indices
    outside [0, 768) too (tolerance 0: every value is an integer)."""
    frames, R = 2, 3
    y, t, pat = _dot.dot_inputs(seed, frames, 16 * R, width)
    rng = np.random.default_rng(seed)
    far = torch.from_numpy(rng.random(t.shape) < 0.1)
    t[far] = torch.from_numpy(rng.integers(-3000, 5000, t.shape,
                                           np.int32))[far]
    t[0, 0, 0, :2] = torch.tensor([-1, K], dtype=torch.int32)
    s = torch.full((frames, R, 16, width), -(1 << 20), dtype=torch.int32)
    onehot = (torch.arange(K).view(1, 1, K, 1) == t).to(torch.float32)
    for g, rows in enumerate(_dot.tf32_row_groups()):
        bank = pat[rows.flatten()].to(torch.float32)      # (72, K)
        cand = torch.matmul(bank, onehot)                 # (F, R, 72, W)
        lines = cand.view(frames, R, 9, 8, width).sum(3).to(torch.int32)
        for i in range(9):
            if 9 * g + i < 16:
                s[:, :, 9 * g + i] = lines[:, :, i]
    assert bool((s > -(1 << 20)).all())   # every line written
    got = torch.clamp(y.view(frames, R, 16, width).to(torch.int32) + s, 0,
                      _dot.CLIP_HI).to(torch.uint16).view(y.shape)
    assert torch.equal(got, _dot.onehot_plain(y, t, pat))
