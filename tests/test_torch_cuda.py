"""The torch port's CUDA kernels against their plain versions, on the card:
K1 (lattice and lane-word input, shard boot), K2, K3, the two probes of K1
(K5, csrc/probe_budget.cu; K4, csrc/probe_pipe.cu), the one-hot dot probes
(K6-K8, csrc/probe_dot.cu) and the relayout probes (K9, K10,
csrc/probe_relayout.cu).

Marked ``cuda``: each test asks the ``cuda_device`` fixture for a card and
skips without one (the kernel has no CPU mode; the CPU tests hold the plain
version against the JAX package).  Run on a GPU machine with
``python -m pytest --noconftest tests/test_torch_cuda.py`` (tests/conftest.py
sets up JAX, which a GPU machine need not have); ``chip_smoke.py`` covers
the same ground at full size.
"""

import numpy as np
import pytest
import torch

from versatilefilmgrain_tpu_torch.ops import grain_natural, grain_pallas

from torch_port_cases import (TORCH_PKG, frame_bases, random_planes,
                              regs_for)

pytestmark = pytest.mark.cuda

H, W = 192, 256
R, C = H // 16, W // 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_and_plain(kind, depth, csub, dev):
    regs = regs_for(TORCH_PKG, kind, depth, csub)
    tables = grain_natural.natural_tables(regs, dev)
    frames = (0, 1, 3)
    bases, _ = frame_bases(TORCH_PKG, regs.seed_state, R, C, frames)
    planes = [torch.from_numpy(p).to(dev) for p in
              random_planes(41, depth, R, C, csub, frames=len(frames))]
    geo = dict(bs=depth - 8, csubx=csub[0], csuby=csub[1])
    k = grain_natural.add_grain_batch_natural(*planes, bases, None, tables,
                                              height=H, width=W, **geo)
    p = grain_natural.add_grain_batch_plain(*planes, bases, tables, **geo)
    torch.cuda.synchronize()
    return k, p


@pytest.mark.parametrize("kind,depth,csub", [
    ("sei_ff", 10, (2, 2)), ("sei_ar", 8, (2, 1)), ("afgs1", 10, (1, 1))])
def test_kernel_matches_plain(kind, depth, csub, cuda_device):
    k, p = _kernel_and_plain(kind, depth, csub, cuda_device)
    for c in range(3):
        assert k[c].device.type == "cuda" and k[c].dtype == p[c].dtype
        assert np.array_equal(k[c].cpu().numpy(), p[c].cpu().numpy()), \
            f"{kind} d{depth} csub{csub} plane {c}"


def test_launch_counter(cuda_device):
    before = grain_natural.grain_plane_cuda.launches
    _kernel_and_plain("sei_ff", 10, (2, 2), cuda_device)
    assert grain_natural.grain_plane_cuda.launches == before + 3


def _tiled_kernel_plain_natural(kind, depth, csub, dev):
    """The tiled engine on the card, its plain strip function on the card
    and the natural kernel, on the same planes."""
    regs = regs_for(TORCH_PKG, kind, depth, csub)
    frames = (0, 1, 3)
    bases, bases_up = frame_bases(TORCH_PKG, regs.seed_state, R, C, frames)
    planes = [torch.from_numpy(p).to(dev) for p in
              random_planes(43, depth, R, C, csub, frames=len(frames))]
    geo = dict(bs=depth - 8, csubx=csub[0], csuby=csub[1])
    ptab = grain_pallas.pallas_tables(regs, dev)
    k = grain_pallas.add_grain_batch_pallas(*planes, bases, bases_up, ptab,
                                            height=H, width=W, **geo)
    p = grain_pallas._tiled_batch(*planes, bases, bases_up, ptab, R=R, C=C,
                                  strip_fn=grain_pallas.plane_tiled_plain,
                                  **geo)
    n = grain_natural.add_grain_batch_natural(
        *planes, bases, bases_up, grain_natural.natural_tables(regs, dev),
        height=H, width=W, **geo)
    torch.cuda.synchronize()
    return k, p, n


@pytest.mark.parametrize("kind,depth,csub", [
    ("sei_ff", 10, (2, 2)), ("sei_ar", 8, (2, 1)), ("afgs1", 10, (1, 1))])
def test_tiled_kernel_matches_plain_and_natural(kind, depth, csub,
                                                cuda_device):
    k, p, n = _tiled_kernel_plain_natural(kind, depth, csub, cuda_device)
    for c in range(3):
        where = f"{kind} d{depth} csub{csub} plane {c}"
        assert k[c].device.type == "cuda" and k[c].dtype == p[c].dtype, where
        got = k[c].cpu().numpy()
        assert np.array_equal(got, p[c].cpu().numpy()), where
        assert np.array_equal(got, n[c].cpu().numpy()), where


def test_tiled_launch_counter(cuda_device):
    before = grain_pallas.plane_tiled_cuda.launches
    _tiled_kernel_plain_natural("sei_ff", 10, (2, 2), cuda_device)
    assert grain_pallas.plane_tiled_cuda.launches == before + 3


def test_expand_words_matches_plain(cuda_device):
    """K2 (csrc/expand_words.cu) == its plain version, one launch for every
    plane: 4:2:0 (bw 16, 8, 8) and a 4:4:4 pair (bw 16, 16)."""
    rng = np.random.default_rng(5)
    for bws in ((16, 8, 8), (16, 16)):
        blk = [torch.from_numpy(rng.integers(0, 2048, (3, R, W // bw))
                                .astype(np.int32)).to(cuda_device)
               for bw in bws]
        before = grain_natural.expand_words_cuda.launches
        got = grain_natural.expand_words_cuda(blk, list(bws))
        want = grain_natural.expand_words_plain(blk, list(bws))
        torch.cuda.synchronize()
        assert grain_natural.expand_words_cuda.launches == before + 1
        for g, w in zip(got, want):
            assert g.shape == w.shape and torch.equal(g, w), bws


@pytest.mark.parametrize("kind,depth,csub", [
    ("sei_ff", 10, (2, 2)), ("sei_ar", 8, (2, 1)), ("afgs1", 10, (1, 1))])
def test_stream_matches_lattice(kind, depth, csub, cuda_device):
    """K1 fed lane words ("xla": plain expansion, "pallas": K2) == K1 fed
    the lattice == the plain version."""
    regs = regs_for(TORCH_PKG, kind, depth, csub)
    tables = grain_natural.natural_tables(regs, cuda_device)
    bases, _ = frame_bases(TORCH_PKG, regs.seed_state, R, C, (0, 1, 3))
    planes = [torch.from_numpy(p).to(cuda_device) for p in
              random_planes(47, depth, R, C, csub, frames=3)]
    geo = dict(bs=depth - 8, csubx=csub[0], csuby=csub[1])
    want = grain_natural.add_grain_batch_plain(*planes, bases, tables, **geo)
    for mode in (None, "xla", "pallas"):
        k2 = grain_natural.expand_words_cuda.launches
        got = grain_natural.add_grain_batch_natural(
            *planes, bases, None, tables, height=H, width=W,
            word_expand=mode, **geo)
        torch.cuda.synchronize()
        assert grain_natural.expand_words_cuda.launches == \
            k2 + (mode == "pallas")
        for c in range(3):
            assert torch.equal(got[c], want[c]), f"{kind} {mode} plane {c}"


@pytest.mark.parametrize("mode", ["kernel", "xla", "pallas"])
@pytest.mark.parametrize("csub", [(2, 2), (2, 1)])
def test_shard_boot_matches_unsharded(mode, csub, cuda_device):
    """The sharded step on one card, (2, 3) mesh: tile shards below the
    frame top boot K1 from their upper lattice row, and the output equals
    the unsharded K1 output."""
    from versatilefilmgrain_tpu_torch.parallel import mesh as pmesh
    regs = regs_for(TORCH_PKG, "sei_ff", 10, csub)
    tables = grain_natural.natural_tables(regs, cuda_device)
    bases, bases_up = frame_bases(TORCH_PKG, regs.seed_state, R, C,
                                  (0, 1, 2, 5))
    planes = [torch.from_numpy(p).to(cuda_device) for p in
              random_planes(53, 10, R, C, csub, frames=4)]
    geo = dict(bs=2, csubx=csub[0], csuby=csub[1])
    want = grain_natural.add_grain_batch_natural(
        *planes, bases, bases_up, tables, height=H, width=W, **geo)
    step = pmesh.make_grain_step(
        pmesh.make_mesh(2, 3, [cuda_device] * 6), height=H, width=W,
        engine="natural", tables=tables, word_expand=mode, **geo)
    boots = grain_natural.grain_plane_cuda.boot_launches
    got = step(*planes, bases, bases_up)
    torch.cuda.synchronize()
    # 2 data x 2 lower tile shards x 3 planes booted
    assert grain_natural.grain_plane_cuda.boot_launches == boots + 12
    for c in range(3):
        assert torch.equal(got[c], want[c]), f"{mode} csub{csub} plane {c}"


@pytest.mark.parametrize("mode", ["kernel", "xla", "pallas"])
@pytest.mark.parametrize("blend0", [True, False])
def test_shard_body_matches_plain(mode, blend0, cuda_device):
    """add_grain_shard_natural on the card == on the CPU (its plain
    version), the shard's first row booted or not.  Rows of states_up below
    row 0 hold junk: neither path may read them."""
    regs = regs_for(TORCH_PKG, "afgs1", 10, (2, 2))
    rng = np.random.default_rng(59)
    states = torch.from_numpy(rng.integers(0, 1 << 32, (2, 4, C),
                                           dtype=np.int64))
    states_up = torch.from_numpy(rng.integers(0, 1 << 32, (2, 4, C),
                                              dtype=np.int64))
    planes = [torch.from_numpy(p) for p in
              random_planes(61, 10, 4, C, (2, 2), frames=2)]
    ov = [blend0, True, True, True]
    geo = dict(bs=2, csubx=2, csuby=2, word_expand=mode)
    want = grain_natural.add_grain_shard_natural(
        *planes, states, states_up, ov,
        grain_natural.natural_tables(regs, "cpu"), **geo)
    got = grain_natural.add_grain_shard_natural(
        *(p.to(cuda_device) for p in planes), states.to(cuda_device),
        states_up.to(cuda_device), ov,
        grain_natural.natural_tables(regs, cuda_device), **geo)
    torch.cuda.synchronize()
    for c in range(3):
        assert torch.equal(got[c].cpu(), want[c]), f"{mode} plane {c}"


@pytest.mark.parametrize("kind", ["default", "sei_ar", "afgs1"])
def test_budget_variants_match_plain(kind, cuda_device):
    """Every variant of the per-stage budget kernel (csrc/probe_budget.cu)
    == its plain version, at 256x192 10-bit 4:2:0."""
    from versatilefilmgrain_tpu_torch.tools import _harness as hz
    from versatilefilmgrain_tpu_torch.tools import probe_budget
    regs = hz.config_regs(kind)
    tables = grain_natural.natural_tables(regs, cuda_device)
    planes = hz.random_state(3, 67, H, W, device=cuda_device)
    bases, _ = hz.frame_bases(regs, 3, R, C)
    lat = grain_natural._lattice(bases, planes[0])
    words = grain_natural._as_int32_words(lat)
    counter = probe_budget.grain_plane_budget_cuda
    for name, skip in probe_budget.VARIANTS.items():
        before = counter.launches
        got = probe_budget.make_step(tables, skip=skip)(*planes, lat, words)
        want = probe_budget.budget_batch_plain(*planes, lat, tables,
                                               skip=skip)
        torch.cuda.synchronize()
        assert counter.launches == before + (1 if "chroma" in skip else 3)
        for c in range(3):
            assert torch.equal(got[c], want[c]), f"{kind} {name} plane {c}"


@pytest.mark.parametrize("kind", ["default", "sei_ar", "afgs1"])
def test_pipe_matches_k1(kind, cuda_device):
    """The prefetch probe kernel (csrc/probe_pipe.cu) == K1 == the plain
    version, at 256x192 10-bit 4:2:0, on grids of 1 and 4 blocks per SM,
    and from a plane that is 4-byte but not 16-byte aligned."""
    from versatilefilmgrain_tpu_torch.tools import _harness as hz
    from versatilefilmgrain_tpu_torch.tools import probe_ohpipe
    regs = hz.config_regs(kind)
    tables = grain_natural.natural_tables(regs, cuda_device)
    planes = hz.random_state(3, 71, H, W, device=cuda_device)
    bases, bases_up = hz.frame_bases(regs, 3, R, C)
    want = grain_natural.add_grain_batch_natural(
        *planes, bases, bases_up, tables, height=H, width=W, bs=2, csubx=2,
        csuby=2)
    plain = grain_natural.add_grain_batch_plain(*planes, bases, tables,
                                                bs=2, csubx=2, csuby=2)
    counter = probe_ohpipe.grain_plane_pipe_cuda
    for bps in (1, 4):
        before = counter.launches
        got = probe_ohpipe.make_pipe_step(tables, height=H, width=W,
                                          blocks_per_sm=bps)(
            *planes, bases, bases_up)
        torch.cuda.synchronize()
        assert counter.launches == before + 3
        for c in range(3):
            assert torch.equal(got[c], want[c]), f"{kind} {bps} plane {c}"
            assert torch.equal(got[c], plain[c]), f"{kind} {bps} plane {c}"
    buf = torch.empty(planes[0].numel() + 2, dtype=torch.uint16,
                      device=cuda_device)
    y = buf[2:].view(planes[0].shape)
    y.copy_(planes[0])
    assert y.data_ptr() % 16 != 0 and y.data_ptr() % 4 == 0
    words = grain_natural._as_int32_words(grain_natural._lattice(bases, y))
    got = probe_ohpipe.grain_plane_pipe_cuda(y, words, tables, c=0, bs=2,
                                             csubx=2, csuby=2)
    torch.cuda.synchronize()
    assert torch.equal(got, want[0])


@pytest.mark.parametrize("width", [256, 160])
@pytest.mark.parametrize("mode", ["none", "int8", "bf16", "f32", "gather",
                                  "build", "dotconst"])
def test_dot_probe_matches_plain(mode, width, cuda_device):
    """Every mode of the dot probe kernel (csrc/probe_dot.cu, K6 and K7) ==
    its plain version, one and two block rows per thread block, at a width
    that is a multiple of 128 and one that is not."""
    from versatilefilmgrain_tpu_torch.tools import _dot
    y, t, pat, constoh = _dot.dot2_inputs(13, 3, 48, width,
                                          device=cuda_device)
    want = _dot.plain(mode, y, t, pat, constoh)
    for strips in (1, 2):
        before = _dot.dot_probe_cuda.launches
        got = _dot.make_step(mode, t, pat, constoh, strips=strips)(y)[0]
        torch.cuda.synchronize()
        assert _dot.dot_probe_cuda.launches == before + 1
        assert torch.equal(got, want), f"{mode} W={width} strips {strips}"


@pytest.mark.parametrize("mm", [16, 64, 128, 144, 160, 256])
def test_dotscale_probe_matches_plain(mm, cuda_device):
    """K8's product at every M == its plain version."""
    from versatilefilmgrain_tpu_torch.tools import _dot
    y, oh, pats = _dot.dotscale_inputs(17, 3, 48, 160, ms=(mm,),
                                       device=cuda_device)
    kw = dict(clip_hi=_dot.CLIP_HI_SCALE, rows=_dot.scale_rows(mm))
    got = _dot.make_step("dotconst", None, pats[mm], oh, **kw)(y)[0]
    want = _dot.dotconst_plain(y, pats[mm], oh, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"M={mm}"


def test_dot_probe_out_of_range_indices(cuda_device):
    """An index outside [0, 768) matches no one-hot row in every mode that
    reads t, as in the plain versions (the gather reads no bank row)."""
    from versatilefilmgrain_tpu_torch.tools import _dot
    y, t, pat, _ = _dot.dot2_inputs(19, 2, 32, 160, device=cuda_device)
    t[0, 0, 0, :6] = torch.tensor([-1, 768, 5000, -300, 767, 0])
    for mode in ("int8", "bf16", "f32", "gather", "build"):
        got = _dot.make_step(mode, t, pat)(y)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, _dot.plain(mode, y, t, pat)), mode


def test_relayout_probe_matches_plain(cuda_device):
    """Every instance of csrc/probe_relayout.cu (K9's passthrough and
    relayout at 1, 5 and 15 block rows per thread block, K10's two forms on
    the 5-D view) == its plain version == y ^ 1, at 2 frames of 240x160 (a
    width that is not a multiple of 128)."""
    from versatilefilmgrain_tpu_torch.tools import _relayout, probe_relayout
    y = _relayout.relayout_inputs(29, 2, 240, 160, device=cuda_device)
    want = _relayout.passthrough_plain(y)
    for case, (mode, rchunk) in probe_relayout.CASES.items():
        got = _relayout.make_step(mode, rchunk)(y)[0]
        torch.cuda.synchronize()
        assert torch.equal(got, _relayout.plain(mode, y, rchunk)), case
        assert torch.equal(got, want), case
    y5 = _relayout.view5d(y)
    for form in _relayout.MODES_5D:
        got = _relayout.make_step(form)(y5)[0]
        torch.cuda.synchronize()
        assert got.shape == y5.shape, form
        assert torch.equal(got, _relayout.plain(form, y5)), form
        assert torch.equal(got.view(y.shape), want), form


def test_relayout_launch_counters(cuda_device):
    """Each wrapper counts its own launches, once per launch."""
    from versatilefilmgrain_tpu_torch.tools import _relayout
    y = _relayout.relayout_inputs(31, 1, 240, 256, device=cuda_device)
    k9 = _relayout.relayout_probe_cuda
    k10 = _relayout.relayout5d_probe_cuda
    before = (k9.launches, k10.launches)
    _relayout.make_step("relayout", 15)(y)
    _relayout.make_step("passthrough")(y)
    _relayout.make_step("5d_transpose")(_relayout.view5d(y))
    torch.cuda.synchronize()
    assert (k9.launches, k10.launches) == (before[0] + 2, before[1] + 1)
