"""The port's grain-kernel probes against the JAX probes, bit for bit.

The JAX package's tools/probe_budget.py and tools/probe_ohpipe.py are loaded
by path, with their module's ``pl`` replaced by a shim whose
``pallas_call`` runs in interpret mode, so their Pallas kernels run on the
CPU unchanged.  On CPU tensors the port's probe steps run their plain
versions: the per-stage budget's ablations (``budget_batch_plain``) must
equal ``_fused_abl`` for every ablation the two kernels share, and the
persistent pipeline probe's step must equal ``_fused_pipe``.  Every
comparison is
exact, at 2 frames of 48x160 10-bit 4:2:0.
"""

import importlib.util
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from versatilefilmgrain_tpu_torch.ops import _kernels
from versatilefilmgrain_tpu_torch.ops.grain_natural import (_as_int32_words,
                                                            _lattice,
                                                            natural_tables)
from versatilefilmgrain_tpu_torch.tools import _harness as hz
from versatilefilmgrain_tpu_torch.tools import probe_budget, probe_ohpipe

from torch_port_cases import REPO

F, HT, WD = 2, 48, 160
R, C = HT // 16, WD // 16
KINDS = ["default", "sei_ar", "afgs1"]
# The ablations both probes have, by the names of both skip sets.
SHARED = ["full", "no-lut", "no-blend", "no-deblock", "no-epilogue",
          "no-chroma"]


class _InterpretPallas:
    """A probe module's ``pl`` whose ``pallas_call`` runs in interpret
    mode; every other name is the real module's."""

    def __init__(self, pl):
        self._pl = pl

    def __getattr__(self, name):
        return getattr(self._pl, name)

    def pallas_call(self, *args, **kwargs):
        return self._pl.pallas_call(*args, interpret=True, **kwargs)


@pytest.fixture(scope="module")
def jax_probes():
    """The two JAX probe modules, loaded by path, ``pl`` patched."""
    mods = {}
    with pytest.MonkeyPatch.context() as mp:
        for name in ("probe_budget", "probe_ohpipe"):
            spec = importlib.util.spec_from_file_location(
                f"_jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
            m = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(m)
            mp.setattr(m, "pl", _InterpretPallas(m.pl))
            mods[name] = m
        yield mods


def _jax_regs(m, kind):
    if kind == "default":
        return m._default_regs()
    return m._regs_from_cfg(os.path.join(m.CFGDIR, hz.CFG_FILES[kind]))


def _inputs(kind, seed):
    """Port tables, planes, bases and lattice for ``kind`` on the CPU."""
    regs = hz.config_regs(kind)
    tables = natural_tables(regs, "cpu")
    planes = hz.random_state(F, seed, HT, WD)
    bases, bases_up = hz.frame_bases(regs, F, R, C)
    return tables, planes, bases, bases_up, _lattice(bases, planes[0])


def _jax_run(m, make, kind, planes, **kw):
    """The JAX probe's step for ``kind`` on ``planes``, as numpy."""
    regs = _jax_regs(m, kind)
    bases, bases_up = m._frame_bases(regs, F, R, C)
    step = make(m.natural_tables(regs), **kw)
    out = step(*(jnp.asarray(p.numpy()) for p in planes),
               jnp.asarray(bases), jnp.asarray(bases_up))
    return [np.asarray(o) for o in out]


def _budget(kind, variant, seed=7):
    tables, planes, _, _, lat = _inputs(kind, seed)
    step = probe_budget.make_step(tables, skip=probe_budget.VARIANTS[variant])
    return planes, step(*planes, lat, _as_int32_words(lat))


@pytest.mark.parametrize("variant", SHARED)
@pytest.mark.parametrize("kind", KINDS)
def test_budget_plain_matches_jax(kind, variant, jax_probes):
    """Each shared ablation's plain version == the JAX ``_fused_abl``
    (interpret mode) with the same skip set."""
    planes, got = _budget(kind, variant)
    want = _jax_run(jax_probes["probe_budget"],
                    jax_probes["probe_budget"].make_step, kind, planes,
                    skip=probe_budget.VARIANTS[variant])
    for c in range(3):
        assert got[c].dtype == torch.uint16
        assert np.array_equal(got[c].numpy(), want[c]), \
            f"{kind} {variant} plane {c}"
    if variant == "no-epilogue":
        # pix + P below 0 wraps to the top of uint16, as JAX's astype does
        assert int(got[0].numpy().max()) > 0xFF00


@pytest.mark.parametrize("kind", KINDS)
def test_budget_nostage_equals_full(kind):
    _, full = _budget(kind, "full")
    _, nostage = _budget(kind, "no-stage")
    for a, b in zip(full, nostage):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", ["no-select", "no-fetch"])
@pytest.mark.parametrize("kind", KINDS)
def test_budget_hopper_variants_deterministic_and_differ(kind, variant):
    """The two Hopper-only ablations give the same pixels twice, and on
    luma (which every config grains) other pixels than the full kernel --
    except no-select where the luma LUT selects pattern 0 only."""
    _, full = _budget(kind, "full")
    _, a = _budget(kind, variant)
    _, b = _budget(kind, variant)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    tables = natural_tables(hz.config_regs(kind), "cpu")
    one_pattern = probe_budget.pattern_masks(tables)[0] == 0
    same = variant == "no-select" and one_pattern
    assert torch.equal(a[0], full[0]) == same


def test_budget_fetch_standin():
    """no-fetch's sample is the signed low byte of row * 64 + col + pi."""
    tables, planes, _, _, lat = _inputs("default", 9)
    zero = dict(tables, pattern=torch.zeros_like(tables["pattern"]))
    # with an all-zero bank, only no-fetch produces grain
    full = probe_budget.budget_batch_plain(*planes, lat, zero)
    nofetch = probe_budget.budget_batch_plain(
        *planes, lat, zero, skip=probe_budget.VARIANTS["no-fetch"])
    sc = tables["scalars"]
    clip = torch.clamp(planes[0].int(), int(sc[1]) << 2, int(sc[2]) << 2)
    assert torch.equal(full[0], clip.to(torch.uint16))
    assert not torch.equal(nofetch[0], full[0])


@pytest.mark.parametrize("variant", ["war", "dual"])
@pytest.mark.parametrize("kind", KINDS)
def test_pipe_step_matches_jax(kind, variant, jax_probes, monkeypatch):
    """The pipeline probe's step on the CPU == the JAX ``_fused_pipe``
    (interpret mode) for the probe's two default schedules."""
    m = jax_probes["probe_ohpipe"]
    monkeypatch.setattr(m, "VARIANT", variant, raising=False)
    tables, planes, bases, bases_up, _ = _inputs(kind, 13)
    got = probe_ohpipe.make_pipe_step(tables, height=HT, width=WD)(
        *planes, bases, bases_up)
    want = _jax_run(m, m.make_pipe_step, kind, planes, height=HT, width=WD)
    for c in range(3):
        assert np.array_equal(got[c].numpy(), want[c]), \
            f"{kind} {variant} plane {c}"


def _regs_equal(a, b):
    va, vb = vars(a), vars(b)
    assert va.keys() == vb.keys()
    for k in va:
        assert np.array_equal(np.asarray(va[k]), np.asarray(vb[k])), k


@pytest.mark.parametrize("kind", KINDS)
def test_harness_regs_match_jax(kind, jax_probes):
    """default_regs / regs_from_cfg == the JAX helpers' register files."""
    _regs_equal(hz.config_regs(kind),
                _jax_regs(jax_probes["probe_budget"], kind))


@pytest.mark.parametrize("offset", [0, 3])
def test_harness_frame_bases_match_jax(offset, jax_probes):
    m = jax_probes["probe_budget"]
    regs = hz.default_regs()
    got = hz.frame_bases(regs, 4, 135, 240, offset)
    want = m._frame_bases(m._default_regs(), 4, 135, 240, offset)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_harness_random_state_matches_jax_probe():
    """random_state draws the JAX probes' (y, u, v) state."""
    rng = np.random.default_rng(0)
    want = [rng.integers(0, 1024, (F, h, w), dtype=np.uint16)
            for h, w in ((HT, WD), (HT // 2, WD // 2), (HT // 2, WD // 2))]
    got = hz.random_state(F, 0, HT, WD)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def test_kernel_build_follows_headers(tmp_path):
    """A library is stale when its source or any shared header is newer;
    nvcc is not run."""
    csrc = tmp_path / "csrc"
    shutil.copytree(os.path.join(os.path.dirname(_kernels.__file__), "..",
                                 "csrc"), csrc)
    src = str(csrc / "grain_natural.cu")
    so = str(tmp_path / "libgrain_natural.so")
    assert _kernels.stale(src, so)            # missing
    open(so, "wb").close()
    # after the newest file of the copy, whichever was edited last
    t = max(os.path.getmtime(p) for p in csrc.iterdir()) + 100
    os.utime(so, (t, t))
    assert not _kernels.stale(src, so)        # newer than source and headers
    header = csrc / "grain_natural_body.cuh"
    os.utime(header, (t + 10, t + 10))
    assert _kernels.stale(src, so)            # a header was edited
    os.utime(header, (t - 10, t - 10))
    os.utime(src, (t + 10, t + 10))
    assert _kernels.stale(src, so)            # the source was edited


@pytest.mark.parametrize("probe", [probe_budget, probe_ohpipe])
def test_probe_main_refuses_cpu(probe, monkeypatch, capsys):
    """Without a card the probes time nothing and exit non-zero."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.main(["default"]) != 0
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("wrapper", [
    probe_budget.grain_plane_budget_cuda, probe_ohpipe.grain_plane_pipe_cuda])
def test_probe_kernels_raise_on_cpu(wrapper):
    tables, planes, _, _, lat = _inputs("default", 3)
    launches = wrapper.launches
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        wrapper(planes[0], _as_int32_words(lat), tables, c=0, csubx=2,
                csuby=2, bs=2)
    assert wrapper.launches == launches


def test_budget_kernel_refuses_two_stages():
    tables, planes, _, _, lat = _inputs("default", 3)
    with pytest.raises(ValueError, match="at most one stage"):
        probe_budget.grain_plane_budget_cuda(
            planes[0], _as_int32_words(lat), tables, c=0, csubx=2, csuby=2,
            bs=2, skip={"lut", "blend"})


# K4's launch plan (probe_ohpipe.pipe_plan), pure Python: (frames, block
# rows, block columns, component, (csubx, csuby)) at 4K and at the pad-leak
# (17 block columns, 257 wide) and odd widths (33, 49, 300 block columns).
PLAN_CASES = [(8, 135, 240, 0, (2, 2)), (8, 135, 240, 1, (2, 2)),
              (8, 135, 240, 1, (2, 1)), (8, 135, 240, 1, (1, 1)),
              (3, 12, 17, 0, (2, 2)), (3, 12, 17, 1, (2, 2)),
              (2, 3, 33, 0, (2, 2)), (2, 3, 33, 1, (1, 1)),
              (2, 3, 49, 1, (2, 1)), (1, 2, 300, 0, (2, 2)),
              (1, 1, 1, 1, (2, 2))]


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("bps", probe_ohpipe.GRIDS)
@pytest.mark.parametrize("case", PLAN_CASES)
def test_pipe_plan_covers_every_line_once(case, bps, sms):
    """Every (tile, strip, line) of the plane goes to exactly one thread
    block, the blocks' work (columns x lines) is even to within one line,
    the ring and tables fit the card's shared memory at ``bps`` blocks per
    SM, and every bulk copy is 16-byte aligned with a size a multiple of
    16, covering its tile and the halo that lies in the row."""
    F, R, C, c, (csubx, csuby) = case
    plan = probe_ohpipe.pipe_plan(F, R, C, c=c, csubx=csubx, csuby=csuby,
                                  blocks_per_sm=bps, sms=sms)
    bh, W, tile, nt = plan["bh"], plan["width"], plan["tile"], plan["tiles"]
    assert plan["total_lines"] == nt * F * R * bh
    assert 1 <= plan["blocks"] <= bps * sms
    assert tile % 8 == 0 and tile <= probe_ohpipe.MAX_TILE
    assert nt == -(-W // tile) and (nt == 1 or tile % 256 == 0)
    assert plan["smem"] <= probe_ohpipe.SMEM_BLOCK
    assert bps * (plan["smem"] + probe_ohpipe.SMEM_RESERVED) \
        <= probe_ohpipe.SMEM_SM
    assert 2 <= plan["stages"] <= probe_ohpipe.MAX_STAGES
    assert plan["lines"] <= bh and bh % plan["lines"] == 0
    assert plan["line_bytes"] % 16 == 0
    bounds = [probe_ohpipe.block_lines(plan, b)
              for b in range(plan["blocks"])]
    assert bounds[0][0] == 0 and bounds[-1][1] == plan["total_lines"]
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    width = [min(tile, W - t * tile) for t in range(nt)]
    work = [sum(width[l // (F * R * bh)] for l in range(a, b))
            for a, b in bounds]
    assert max(work) - min(work) <= 2 * tile
    seen = set()
    for line in range(plan["total_lines"]):
        t, s, j, src, nbytes, dst = probe_ohpipe.line_copy(plan, line)
        seen.add((t, s, j))
        x_t = t * tile
        xa, xb = max(x_t - probe_ohpipe.HALO, 0), min(
            x_t + width[t] + probe_ohpipe.HALO, W)
        assert (src * 2) % 16 == 0 and nbytes % 16 == 0 and dst % 16 == 0
        assert src == (s * bh + j) * W + xa and nbytes == (xb - xa) * 2
        assert dst + nbytes <= plan["line_bytes"]
    assert len(seen) == plan["total_lines"]


@pytest.mark.parametrize("bps", [0, 3, 4])
def test_pipe_plan_refuses_grids_without_an_instance(bps):
    with pytest.raises(ValueError, match="blocks_per_sm"):
        probe_ohpipe.pipe_plan(8, 135, 240, c=0, csubx=2, csuby=2,
                               blocks_per_sm=bps)


@pytest.mark.parametrize("bps", probe_ohpipe.GRIDS)
def test_pipe_plan_ring_options(bps):
    """Lines per stage given: as many stages as fit; a count that is not a
    power of two up to bh raises.  Without the ring the plan holds only
    the mbarriers and tables, and its loop takes bh lines a group."""
    for c, bh in ((0, 16), (1, 8)):
        geo = dict(c=c, csubx=2, csuby=2, blocks_per_sm=bps)
        for lines in (1, 2, 4, 8):
            plan = probe_ohpipe.pipe_plan(8, 135, 240, lines=lines, **geo)
            room = (probe_ohpipe.SMEM_SM // bps - probe_ohpipe.SMEM_RESERVED
                    - probe_ohpipe.BAR_BYTES - probe_ohpipe.TABLE_BYTES)
            assert plan["lines"] == lines and plan["stages"] == min(
                probe_ohpipe.MAX_STAGES,
                min(room, probe_ohpipe.SMEM_BLOCK) // plan["line_bytes"]
                // lines)
        for lines in (0, 3, 2 * bh):
            with pytest.raises(ValueError, match="lines per stage"):
                probe_ohpipe.pipe_plan(8, 135, 240, lines=lines, **geo)
        plan = probe_ohpipe.pipe_plan(8, 135, 240, ring=False, **geo)
        assert plan["smem"] == (probe_ohpipe.BAR_BYTES
                                + probe_ohpipe.TABLE_BYTES)
        assert plan["lines"] == bh and not plan["ring"]


def test_pipe_wrapper_refusals():
    """Without a launch: a grid without an instance, a wrong plane shape,
    a plane that is not uint16 and words that are not int32 raise."""
    tables, planes, _, _, lat = _inputs("default", 3)
    words = _as_int32_words(lat)
    wrapper = probe_ohpipe.grain_plane_pipe_cuda
    launches = wrapper.launches
    geo = dict(c=0, csubx=2, csuby=2, bs=2)
    with pytest.raises(ValueError, match="blocks_per_sm"):
        wrapper(planes[0], words, tables, blocks_per_sm=3, **geo)
    with pytest.raises(ValueError, match="expected"):
        wrapper(planes[0][:, :16], words, tables, **geo)
    with pytest.raises(ValueError, match="expected"):
        wrapper(planes[0].to(torch.int32), words, tables, **geo)
    with pytest.raises(ValueError, match="expected"):
        wrapper(planes[0], lat, tables, **geo)
    assert wrapper.launches == launches
