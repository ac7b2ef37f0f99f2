"""The torch port's host layers against the JAX package: cfg parsing,
validation, chroma adjustment and FW init must leave identical register
files, and the port must import without JAX."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from torch_port_cases import (CFG_DIR, CFG_FILES, JAX_PKG, REPO, TORCH_PKG,
                              mod)

FORMATS = (0, 1, 2)   # 4:2:0, 4:2:2, 4:4:4


def _fw_regs(pkg, path, fmt, depth):
    """Register file after reading ``path`` the way the CLI pops a config,
    or None when the config is rejected for this format."""
    cfgmod, fw = mod(pkg, "models.config"), mod(pkg, "models.fw")
    parsers, pipeline = mod(pkg, "utils.parsers"), mod(pkg, "pipeline")
    sei, afgs1 = cfgmod.default_sei(), cfgmod.default_afgs1()
    parsers.read_cfg(path, sei, afgs1)
    try:
        pipeline.check_cfg(sei, afgs1, fmt, depth)
    except parsers.ConfigError:
        return None
    regs = mod(pkg, "models.hw").HwRegs()
    regs.set_depth(depth)
    regs.set_chroma_subsampling(2 if fmt < 2 else 1, 2 if fmt < 1 else 1)
    pipeline.adjust_chroma_cfg(sei, fmt)
    pipeline.apply_gain(100, sei, afgs1)
    if afgs1.num_y_points:
        fw.init_afgs1(afgs1, regs)
    else:
        fw.init_sei(sei, regs)
    return regs


def test_all_vendored_cfgs_are_covered():
    assert len(CFG_FILES) == 26


@pytest.mark.parametrize("cfg", CFG_FILES)
def test_hwregs_match_jax(cfg):
    path = os.path.join(CFG_DIR, cfg)
    accepted = 0
    for fmt in FORMATS:
        for depth in (10, 8):
            ref = _fw_regs(JAX_PKG, path, fmt, depth)
            got = _fw_regs(TORCH_PKG, path, fmt, depth)
            assert (ref is None) == (got is None), (cfg, fmt, depth)
            if ref is None:
                continue
            accepted += 1
            where = f"{cfg} fmt {fmt} depth {depth}"
            for field in ("pattern", "slut", "plut"):
                a, b = getattr(ref, field), getattr(got, field)
                assert a.dtype == b.dtype and np.array_equal(a, b), \
                    f"{where}: {field}"
            for field in ("seed_state", "scale_shift", "bs", "y_min",
                          "y_max", "c_min", "c_max", "csubx", "csuby"):
                assert getattr(ref, field) == getattr(got, field), \
                    f"{where}: {field}"
    assert accepted >= 1   # every vendored cfg is legal at 10-bit 4:2:0


def test_pipeline_regs_match_jax_with_gain_and_seed():
    """The constructor's own path (default config, gain, seed) too."""
    path = os.path.join(CFG_DIR, "fgs_sei_ff_test3.cfg")
    kw = dict(gain=73, seed=987654321, configs=[f"0:{path}"])
    ref = mod(JAX_PKG, "pipeline").GrainPipeline(256, 192, 10, 0,
                                                 engine="fast", **kw)
    got = mod(TORCH_PKG, "pipeline").GrainPipeline(256, 192, 10, 0,
                                                   engine="ref",
                                                   device="cpu", **kw)
    for p in (ref, got):
        p.maybe_switch_config(0)
    for field in ("pattern", "slut", "plut"):
        assert np.array_equal(getattr(ref.regs, field),
                              getattr(got.regs, field)), field
    assert ref.regs.seed_state == got.regs.seed_state
    assert ref.regs.scale_shift == got.regs.scale_shift
    assert ref.frame_bases(5) == got.frame_bases(5)


BASES_FRAMES = list(range(41)) + [10 ** 4, 10 ** 6]


def _bases_pair(case, width, height):
    """The JAX package's and the port's pipelines at ``width`` x
    ``height``: as built (``default``), with a grain offset (``offset``),
    or after an AFGS1 reseed at frame 3 (``afgs1_epoch``, epoch 3)."""
    path = os.path.join(CFG_DIR, "fgs_afgs1_test1.cfg")
    kw = dict(offset=dict(grain_offset=777, seed=4242),
              afgs1_epoch=dict(configs=[f"3:{path}"]),
              default={})[case]
    pipes = (mod(JAX_PKG, "pipeline").GrainPipeline(
                 width, height, 10, 0, engine="fast", **kw),
             mod(TORCH_PKG, "pipeline").GrainPipeline(
                 width, height, 10, 0, engine="ref", device="cpu", **kw))
    for p in pipes:
        p.maybe_switch_config(3)
    assert pipes[1].epoch == (3 if case == "afgs1_epoch" else 0)
    return pipes


@pytest.mark.parametrize("case", ["default", "offset", "afgs1_epoch"])
@pytest.mark.parametrize("width,height", [(1920, 1080), (3840, 2160)],
                         ids=["1080p", "4k"])
def test_frame_bases_match_advance_and_jax(case, width, height):
    """``frame_bases`` (the byte-table jump) gives the two-``advance``
    formula's bits and the JAX pipeline's, at frames 0-40, 10^4 and 10^6
    past the epoch."""
    ref, got = _bases_pair(case, width, height)
    lfsr = mod(TORCH_PKG, "ops.lfsr")
    R, C = got._R, got._C
    assert (R, C) == (-(-height // 16), width // 16)
    seed = np.uint32(got.regs.seed_state)
    for n in (got.epoch + f for f in BASES_FRAMES):
        e0 = lfsr.frame_base_exponent(n + got.grain_offset - got.epoch, R, C)
        base = int(lfsr.advance(seed, e0))
        want = (base, int(lfsr.advance(seed, e0 - C)) if e0 else base)
        bases = got.frame_bases(n)
        assert all(type(b) is int for b in bases)
        assert bases == want == ref.frame_bases(n), n


def test_frame_bases_before_the_epoch_fail_in_both():
    """A frame before an AFGS1 reseed's epoch has a negative exponent:
    both packages stop on the jump's assert."""
    for pipe in _bases_pair("afgs1_epoch", 256, 192):
        with pytest.raises(AssertionError):
            pipe.frame_bases(0)


def test_frame_bases_build_no_tables_after_the_first_call(monkeypatch):
    """The jump tables are built by a process's first call at most: the
    ``lfsr_tables`` counter stays put across 100 more."""
    tracing = mod(TORCH_PKG, "utils.tracing")
    monkeypatch.setattr(tracing, "_R", tracing.Recorder())
    _, pipe = _bases_pair("default", 1920, 1080)
    with tracing.forced():
        pipe.frame_bases(1)
        built = tracing.counters().get("lfsr_tables", 0)
        for n in range(100):
            pipe.frame_bases(37 * n ** 3)
        assert tracing.counters().get("lfsr_tables", 0) == built
        assert tracing.summary(tracing.record()["spans"])[
            "frame_bases"][0] == 101


def test_import_leaves_jax_out():
    code = ("import sys, versatilefilmgrain_tpu_torch, "
            "versatilefilmgrain_tpu_torch.cli, "
            "versatilefilmgrain_tpu_torch.ops.grain_natural; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'versatilefilmgrain_tpu.'))"
            " or m == 'versatilefilmgrain_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_sources_import_no_jax():
    pkg_dir = os.path.join(REPO, TORCH_PKG)
    pat = re.compile(r"^\s*(import|from)\s+(jax\b|versatilefilmgrain_tpu\b"
                     r"(?!_torch))", re.M)
    for root, _, files in os.walk(pkg_dir):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                assert not pat.search(text), os.path.join(root, f)
