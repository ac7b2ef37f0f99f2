"""The torch port's CUDA kernels against their plain versions, on the card:
K1 (lattice and lane-word input, shard boot), K2, K3 (on natural planes),
the two probes of K1 (K5, csrc/probe_budget.cu; K4, csrc/probe_pipe.cu),
the one-hot dot probes
(K6-K8, csrc/probe_dot.cu and, for K6's int8, bf16 and TF32 products and the
dense product, csrc/probe_dotconst.cu) and the relayout probes (K9, K10,
csrc/probe_relayout.cu); then the paths that reach K1 from outside the
CLI: two processes sharing the card over a gloo group, the global mesh,
and the designer's regrain (and, with matplotlib, its GUI) against the CPU;
and ``run_file`` on the card (traced, reusing its buffers, at pad-leak
widths, pipe to pipe through the native rings) against the CPU, and
``run_device`` at 4K against ``run_file``, with no frame crossing the
host.

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


# K1's threads own 8 columns each, a warp 256: with 17, 33 or 49 block
# columns a row ends in a partly filled warp, one lane of it live at 33 (luma
# widths 272, 528, 784; subsampled chroma 136, 264, 392, whose uint8 rows are
# not 16-byte multiples apart).
@pytest.mark.parametrize("cols", [17, 33, 49])
@pytest.mark.parametrize("depth", [8, 10])
@pytest.mark.parametrize("csub", [(2, 2), (2, 1), (1, 1)])
def test_kernel_widths_match_plain(cols, depth, csub, cuda_device):
    """K1 on lattice words and on lane words == the plain version, every
    plane, at widths that end a row inside a warp's run of columns."""
    regs = regs_for(TORCH_PKG, "sei_ff", depth, csub)
    tables = grain_natural.natural_tables(regs, cuda_device)
    rows, frames = 3, (0, 2)
    bases, _ = frame_bases(TORCH_PKG, regs.seed_state, rows, cols, frames)
    planes = [torch.from_numpy(p).to(cuda_device) for p in
              random_planes(cols + depth, depth, rows, cols, csub,
                            frames=len(frames))]
    geo = dict(bs=depth - 8, csubx=csub[0], csuby=csub[1])
    want = grain_natural.add_grain_batch_plain(*planes, bases, tables, **geo)
    for mode in (None, "xla"):
        got = grain_natural.add_grain_batch_natural(
            *planes, bases, None, tables, height=rows * 16, width=cols * 16,
            word_expand=mode, **geo)
        torch.cuda.synchronize()
        for c in range(3):
            assert torch.equal(got[c], want[c]), \
                f"C={cols} d{depth} csub{csub} {mode} plane {c}"


@pytest.mark.parametrize("depth", [8, 10])
@pytest.mark.parametrize("lane", [False, True])
def test_kernel_unaligned_planes(depth, lane, cuda_device):
    """A plane whose pointer is not aligned to a thread's 8 samples is
    copied into an aligned one before the launch; it gives the aligned
    plane's output.  The instance reports its registers, shared memory,
    local memory and blocks per SM."""
    regs = regs_for(TORCH_PKG, "afgs1", depth, (2, 2))
    tables = grain_natural.natural_tables(regs, cuda_device)
    rows, cols = 2, 33
    bases, _ = frame_bases(TORCH_PKG, regs.seed_state, rows, cols, (0, 1))
    y = torch.from_numpy(random_planes(71, depth, rows, cols, (2, 2),
                                       frames=2)[1]).to(cuda_device)
    lat = grain_natural._lattice(bases, torch.empty(
        2, rows * 16, cols * 16, device=cuda_device))
    words = (grain_natural._lane_words3(lat, 2, 2)[1] if lane
             else grain_natural._as_int32_words(lat))
    geo = dict(c=1, bs=depth - 8, csubx=2, csuby=2)
    want = grain_natural.grain_plane_cuda(y, words, tables, **geo)
    buf = torch.empty(y.numel() + 1, dtype=y.dtype, device=cuda_device)
    shifted = buf[1:].view(y.shape)
    shifted.copy_(y)
    assert shifted.data_ptr() % (8 * y.element_size()) != 0
    got = grain_natural.grain_plane_cuda(shifted, words, tables, **geo)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    info = grain_natural.grain_plane_info(y.element_size(), lane)
    assert info["registers"] > 0 and info["blocks_per_sm"] >= 1, info
    assert info["static_smem"] >= 8 * 64 * 64, info
    assert info["local_bytes"] >= 0, info


@pytest.mark.parametrize("depth", [8, 10])
@pytest.mark.parametrize("mode", ["kernel", "xla"])
def test_kernel_widths_shard_boot(depth, mode, cuda_device):
    """The shard boot (blend0: the first local row blends from the upper
    row passed in) at 33 block columns, where a row ends in a warp with one
    live lane, on lattice and lane words: card == CPU."""
    cols = 33
    regs = regs_for(TORCH_PKG, "sei_ff", depth, (2, 2))
    rng = np.random.default_rng(67)
    states = torch.from_numpy(rng.integers(0, 1 << 32, (2, 3, cols),
                                           dtype=np.int64))
    states_up = torch.from_numpy(rng.integers(0, 1 << 32, (2, 3, cols),
                                              dtype=np.int64))
    planes = [torch.from_numpy(p) for p in
              random_planes(71, depth, 3, cols, (2, 2), frames=2)]
    geo = dict(bs=depth - 8, csubx=2, csuby=2, word_expand=mode)
    want = grain_natural.add_grain_shard_natural(
        *planes, states, states_up, [True] * 3,
        grain_natural.natural_tables(regs, "cpu"), **geo)
    boots = grain_natural.grain_plane_cuda.boot_launches
    got = grain_natural.add_grain_shard_natural(
        *(p.to(cuda_device) for p in planes), states.to(cuda_device),
        states_up.to(cuda_device), [True] * 3,
        grain_natural.natural_tables(regs, cuda_device), **geo)
    torch.cuda.synchronize()
    assert grain_natural.grain_plane_cuda.boot_launches == boots + 3
    for c in range(3):
        assert torch.equal(got[c].cpu(), want[c]), f"d{depth} {mode} {c}"


@pytest.mark.parametrize("width,height,depth", [(145, 128, 8),
                                                (257, 144, 10)])
def test_pipeline_pad_leak_matches_plain(width, height, depth, cuda_device):
    """A pad-leak width (component width % block width == 1) through
    GrainPipeline on the card == the plain engine on the CPU, frame by
    frame (the padded buffer carries grain from one frame to the next)."""
    from versatilefilmgrain_tpu_torch import GrainPipeline
    from versatilefilmgrain_tpu_torch.utils import yuv
    card = GrainPipeline(width, height, depth, yuv.YUV_420,
                         device=cuda_device)
    ref = GrainPipeline(width, height, depth, yuv.YUV_420, device="cpu",
                        engine="ref")
    assert card._has_pad_leak()
    rng = np.random.default_rng(width)
    dt = np.uint8 if depth == 8 else np.uint16
    for n in range(3):
        frame = [rng.integers(0, 1 << depth, (h, w)).astype(dt)
                 for h, w in ((height, width),
                              ((height + 1) // 2, (width + 1) // 2),
                              ((height + 1) // 2, (width + 1) // 2))]
        for c, (a, b) in enumerate(zip(card.process_frame(frame, n),
                                       ref.process_frame(frame, n))):
            assert np.array_equal(np.asarray(a), np.asarray(b)), \
                f"{width}x{height} frame {n} plane {c}"


def _tiled_kernel_plain_natural(kind, depth, csub, dev):
    """The tiled engine on the card, its plain version on the card and the
    natural kernel, on the same planes."""
    regs = regs_for(TORCH_PKG, kind, depth, csub)
    frames = (0, 1, 3)
    bases, bases_up = frame_bases(TORCH_PKG, regs.seed_state, R, C, frames)
    planes = [torch.from_numpy(p).to(dev) for p in
              random_planes(43, depth, R, C, csub, frames=len(frames))]
    geo = dict(bs=depth - 8, csubx=csub[0], csuby=csub[1])
    ptab = grain_pallas.pallas_tables(regs, dev)
    k = grain_pallas.add_grain_batch_pallas(*planes, bases, bases_up, ptab,
                                            height=H, width=W, **geo)
    p = grain_pallas._tiled_batch(
        *planes, bases, ptab, R=R, C=C,
        plane_fn=grain_pallas.plane_tiled_natural_plain, **geo)
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


# K3's thread blocks hold 32 runs of 8 columns: with 17, 33 or 49 block
# columns a row ends inside a partly filled group (luma widths 272, 528, 784;
# subsampled chroma 136, 264, 392), one run of it live at 33 in chroma.
@pytest.mark.parametrize("cols", [17, 33, 49])
@pytest.mark.parametrize("depth", [8, 10])
@pytest.mark.parametrize("csub", [(2, 2), (2, 1), (1, 1)])
def test_tiled_kernel_widths_match_plain(cols, depth, csub, cuda_device):
    """K3 (the tiled step on the card) == plane_tiled_natural_plain and ==
    the natural kernel, every plane, at widths that end a row inside a
    thread block's group of runs."""
    regs = regs_for(TORCH_PKG, "sei_ff", depth, csub)
    ptab = grain_pallas.pallas_tables(regs, cuda_device)
    rows, frames = 3, (0, 2)
    bases, bases_up = frame_bases(TORCH_PKG, regs.seed_state, rows, cols,
                                  frames)
    planes = [torch.from_numpy(p).to(cuda_device) for p in
              random_planes(cols + depth, depth, rows, cols, csub,
                            frames=len(frames))]
    geo = dict(bs=depth - 8, csubx=csub[0], csuby=csub[1])
    want = grain_pallas._tiled_batch(
        *planes, bases, ptab, R=rows, C=cols,
        plane_fn=grain_pallas.plane_tiled_natural_plain, **geo)
    nat = grain_natural.add_grain_batch_natural(
        *planes, bases, None, grain_natural.natural_tables(regs, cuda_device),
        height=rows * 16, width=cols * 16, **geo)
    before = grain_pallas.plane_tiled_cuda.launches
    got = grain_pallas.add_grain_batch_pallas(
        *planes, bases, bases_up, ptab, height=rows * 16, width=cols * 16,
        **geo)
    torch.cuda.synchronize()
    assert grain_pallas.plane_tiled_cuda.launches == before + 3
    for c in range(3):
        where = f"C={cols} d{depth} csub{csub} plane {c}"
        assert torch.equal(got[c], want[c]), where
        assert torch.equal(got[c], nat[c]), where


@pytest.mark.parametrize("depth", [8, 10])
def test_tiled_kernel_unaligned_planes(depth, cuda_device):
    """A plane whose pointer is not aligned to a thread's 8 samples is
    copied into an aligned one before K3's launch; it gives the aligned
    plane's output.  Each instance reports its registers, shared memory
    and blocks per SM, and uses no local memory."""
    regs = regs_for(TORCH_PKG, "afgs1", depth, (2, 2))
    ptab = grain_pallas.pallas_tables(regs, cuda_device)
    rows, cols = 2, 33
    bases, _ = frame_bases(TORCH_PKG, regs.seed_state, rows, cols, (0, 1))
    lat = grain_natural._lattice(bases, torch.empty(
        2, rows * 16, cols * 16, device=cuda_device))
    u = torch.from_numpy(random_planes(73, depth, rows, cols, (2, 2),
                                       frames=2)[1]).to(cuda_device)
    args, kw = grain_pallas._plane_args(u, 1, lat,
                                        grain_natural._rows_above(lat), ptab,
                                        bs=depth - 8, csubx=2, csuby=2)
    want = grain_pallas.plane_tiled_cuda(*args, **kw)
    buf = torch.empty(u.numel() + 1, dtype=u.dtype, device=cuda_device)
    shifted = buf[1:].view(u.shape)
    shifted.copy_(u)
    assert shifted.data_ptr() % (8 * u.element_size()) != 0
    got = grain_pallas.plane_tiled_cuda(shifted, *args[1:], **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(want, grain_pallas.plane_tiled_natural_plain(*args,
                                                                    **kw))
    for bh, bw, _ in grain_pallas._GEOMETRIES:
        info = grain_pallas.grain_tiled_info(u.element_size(), bh, bw)
        assert info["registers"] > 0 and info["blocks_per_sm"] >= 1, info
        assert info["static_smem"] >= 16 * 8 * bh * bw, info
        assert info["local_bytes"] == 0, info


def test_tiled_step_never_tiles_on_the_card(cuda_device, monkeypatch):
    """The tiled step's CUDA route hands K3 natural planes: with _tile and
    _untile raising, it still runs and equals the plain version."""
    regs = regs_for(TORCH_PKG, "sei_ff", 10, (2, 2))
    ptab = grain_pallas.pallas_tables(regs, cuda_device)
    bases, bases_up = frame_bases(TORCH_PKG, regs.seed_state, R, C, (0, 1))
    planes = [torch.from_numpy(p).to(cuda_device) for p in
              random_planes(79, 10, R, C, (2, 2), frames=2)]
    geo = dict(bs=2, csubx=2, csuby=2)
    want = grain_pallas._tiled_batch(
        *planes, bases, ptab, R=R, C=C,
        plane_fn=grain_pallas.plane_tiled_natural_plain, **geo)

    def no_relayout(*args, **kwargs):
        raise AssertionError("the CUDA route tiled or untiled a plane")

    monkeypatch.setattr(grain_pallas, "_tile", no_relayout)
    monkeypatch.setattr(grain_pallas, "_untile", no_relayout)
    got = grain_pallas.add_grain_batch_pallas(
        *planes, bases, bases_up, ptab, height=H, width=W, **geo)
    torch.cuda.synchronize()
    for c in range(3):
        assert torch.equal(got[c], want[c]), f"plane {c}"


@pytest.mark.parametrize("frames,rows,width", [(3, R, W), (1, 7, W),
                                                (3, 5, 4800), (1, 1, 128)])
def test_expand_words_matches_plain(frames, rows, width, cuda_device):
    """K2 (csrc/expand_words.cu) == its plain version, one launch for every
    plane: 4:2:0 (bw 16, 8, 8), a 4:4:4 pair (bw 16, 16), luma alone and
    the two chroma planes of 4:2:0, at odd row counts and at a width of 300
    luma blocks (a row of two passes)."""
    rng = np.random.default_rng(5 + frames * rows)
    for bws in ((16, 8, 8), (16, 16), (16,), (8, 8)):
        blk = [torch.from_numpy(rng.integers(0, 2048, (frames, rows,
                                                       width // 16))
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


# K4 (csrc/probe_pipe.cu) at K1's geometries: 16 block columns (256 wide),
# and 17, 33, 49, where a row ends inside a warp's run of columns; 4:2:0,
# 4:2:2 and 4:4:4 (chroma bh 8 or 16, bw 8 or 16).
@pytest.mark.parametrize("cols", [16, 17, 33, 49])
@pytest.mark.parametrize("csub", [(2, 2), (2, 1), (1, 1)])
@pytest.mark.parametrize("kind", ["sei_ff", "sei_ar", "afgs1"])
def test_pipe_matches_k1(kind, csub, cols, cuda_device):
    """The persistent pipeline probe kernel (csrc/probe_pipe.cu) == K1 ==
    the plain version, 10-bit, on grids of 1 and 2 blocks per SM, with its
    ring and without (the ablation), and from a plane that is 4-byte but
    not 16-byte aligned (copied first); every instance reports no local
    memory and fits its blocks per SM."""
    from versatilefilmgrain_tpu_torch.tools import probe_ohpipe
    regs = regs_for(TORCH_PKG, kind, 10, csub)
    tables = grain_natural.natural_tables(regs, cuda_device)
    rows, frames = 3, (0, 2, 3)
    bases, _ = frame_bases(TORCH_PKG, regs.seed_state, rows, cols, frames)
    planes = [torch.from_numpy(p).to(cuda_device) for p in
              random_planes(cols + 71, 10, rows, cols, csub,
                            frames=len(frames))]
    geo = dict(bs=2, csubx=csub[0], csuby=csub[1])
    plain = grain_natural.add_grain_batch_plain(*planes, bases, tables, **geo)
    words = grain_natural._as_int32_words(
        grain_natural._lattice(bases, planes[0]))
    counter = probe_ohpipe.grain_plane_pipe_cuda
    for c, p in enumerate(planes):
        want = grain_natural.grain_plane_cuda(p, words, tables, c=c, **geo)
        for bps in probe_ohpipe.GRIDS:
            for ring in (True, False):
                before = counter.launches
                got = counter(p, words, tables, c=c, blocks_per_sm=bps,
                              ring=ring, **geo)
                torch.cuda.synchronize()
                assert counter.launches == before + 1
                case = f"{kind} {csub} {bps} ring {ring} plane {c}"
                assert torch.equal(got, want), case
                assert torch.equal(got, plain[c]), case
                plan = probe_ohpipe.pipe_plan(
                    len(frames), rows, cols, c=c, csubx=csub[0],
                    csuby=csub[1], blocks_per_sm=bps, ring=ring)
                info = probe_ohpipe.pipe_info(plan)
                assert info["local_bytes"] == 0, info
                assert info["blocks_per_sm"] >= bps, info
        buf = torch.empty(p.numel() + 2, dtype=torch.uint16,
                          device=cuda_device)
        shifted = buf[2:].view(p.shape)
        shifted.copy_(p)
        assert shifted.data_ptr() % 16 != 0
        got = counter(shifted, words, tables, c=c, **geo)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"{kind} {csub} unaligned plane {c}"


@pytest.mark.parametrize("kind", ["default", "sei_ar", "afgs1"])
def test_pipe_step_pad_leak_matches_k1(kind, cuda_device):
    """The probe's batched step at a pad-leak width (257 = 16 * 16 + 1,
    17 block columns) and height (193) == K1's step == the plain version,
    at every grid."""
    from versatilefilmgrain_tpu_torch.tools import _harness as hz
    from versatilefilmgrain_tpu_torch.tools import probe_ohpipe
    height, width = 193, 257
    rows, cols = -(-height // 16), -(-width // 16)
    regs = hz.config_regs(kind)
    tables = grain_natural.natural_tables(regs, cuda_device)
    planes = hz.random_state(2, 73, rows * 16, cols * 16, device=cuda_device)
    bases, bases_up = hz.frame_bases(regs, 2, rows, cols)
    want = grain_natural.add_grain_batch_natural(
        *planes, bases, bases_up, tables, height=height, width=width, bs=2,
        csubx=2, csuby=2)
    plain = grain_natural.add_grain_batch_plain(*planes, bases, tables,
                                                bs=2, csubx=2, csuby=2)
    for bps in probe_ohpipe.GRIDS:
        got = probe_ohpipe.make_pipe_step(tables, height=height, width=width,
                                          blocks_per_sm=bps)(
            *planes, bases, bases_up)
        torch.cuda.synchronize()
        for c in range(3):
            assert torch.equal(got[c], want[c]), f"{kind} {bps} plane {c}"
            assert torch.equal(got[c], plain[c]), f"{kind} {bps} plane {c}"


@pytest.mark.parametrize("width", [256, 160])
@pytest.mark.parametrize("mode", ["none", "int8", "bf16", "f32", "gather",
                                  "build", "dotconst"])
def test_dot_probe_matches_plain(mode, width, cuda_device):
    """Every mode of the dot probe kernels (csrc/probe_dot.cu, K6 and K7;
    int8, bf16, f32 and dotconst csrc/probe_dotconst.cu) == its plain
    version, at a width that is a multiple of 128 and one that is not; one
    and two block rows per thread block, except the modes of
    csrc/probe_dotconst.cu, whose persistent grid schedules the strips and
    refuses strips 2."""
    from versatilefilmgrain_tpu_torch.tools import _dot
    y, t, pat, constoh = _dot.dot2_inputs(13, 3, 48, width,
                                          device=cuda_device)
    want = _dot.plain(mode, y, t, pat, constoh)
    persistent = mode in _dot.WGMMA_SRC
    if persistent:
        with pytest.raises(ValueError, match=f"strips 2: {mode}"):
            _dot.make_step(mode, t, pat, constoh, strips=2)(y)
    for strips in (1,) if persistent else (1, 2):
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


DOTCONST_CASES = [(m, (16, m // 16)) for m in (16, 64, 128, 144, 160, 256)] \
    + [(144, (18, 8))]


def _dotconst_inputs(m, rows, frames, height, width, seed, dev):
    """(y, pat, oh, clip_hi) for one dense instance: K8's draws, or K7's
    at its (18, 8) rows."""
    from versatilefilmgrain_tpu_torch.tools import _dot
    if rows == _dot.ROWS_K6:
        y, _, pat, oh = _dot.dot2_inputs(seed, frames, height, width,
                                         device=dev)
        return y, pat, oh, _dot.CLIP_HI
    y, oh, pats = _dot.dotscale_inputs(seed, frames, height, width, ms=(m,),
                                       device=dev)
    return y, pats[m], oh, _dot.CLIP_HI_SCALE


@pytest.mark.parametrize("width", [64, 160, 200, 256, 296])
@pytest.mark.parametrize("m,rows", DOTCONST_CASES)
def test_dotconst_matches_plain(m, rows, width, cuda_device):
    """The dense kernel (csrc/probe_dotconst.cu) at every instance == its
    plain version, at widths of whole and partial 64-column tiles, on a
    plane of 4 frames x 50 block rows; y at 0 and at the clip limit on
    alternate lines, so both clip ends are hit.  At width 296 (5 tiles, the
    last one partial) thread blocks' work ranges cross a column-tile
    boundary on a 132-SM card, so a warpgroup reloads its A fragments
    mid-range; with 2-4 tiles the ranges of 132 blocks end on the
    boundaries."""
    from versatilefilmgrain_tpu_torch.tools import _dot
    frames, R = 4, 50
    y, pat, oh, hi = _dotconst_inputs(m, rows, frames, 16 * R, width, 27,
                                      cuda_device)
    y[:, 0::2] = 0
    y[:, 1::2] = hi
    info = _dot.dotconst_info(m, rows)
    ctas = min(-(-width // _dot.DOTCONST_COLS) * frames * R,
               torch.cuda.get_device_properties(0).multi_processor_count
               * info["blocks_per_sm"])
    ranges = _dot.dotconst_schedule(frames, R, width, ctas)
    crosses = any(lo // (frames * R) != (end - 1) // (frames * R)
                  for lo, end in ranges if end > lo)
    assert crosses or width != 296
    want = _dot.dotconst_plain(y, pat, oh, rows=rows, clip_hi=hi)
    got = _dot.make_step("dotconst", None, pat, oh, clip_hi=hi,
                         rows=rows)(y)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"M={m} rows {rows} W={width}"
    assert bool((want == 0).any()) and bool((want == hi).any())
    assert not bool(((want == 0) | (want == hi)).all())


@pytest.mark.parametrize("m,rows", DOTCONST_CASES)
def test_dotconst_launches_repeat_exactly(m, rows, cuda_device):
    """Two launches of the dense kernel give identical bytes (its fold has
    no atomics), each adds one to the launch counter, and an instance
    spills nothing."""
    from versatilefilmgrain_tpu_torch.tools import _dot
    y, pat, oh, hi = _dotconst_inputs(m, rows, 3, 48, 200, 33, cuda_device)
    step = _dot.make_step("dotconst", None, pat, oh, clip_hi=hi, rows=rows)
    before = _dot.dot_probe_cuda.launches
    first = step(y)[0]
    assert _dot.dot_probe_cuda.launches == before + 1
    second = step(y)[0]
    torch.cuda.synchronize()
    assert _dot.dot_probe_cuda.launches == before + 2
    assert torch.equal(first, second)
    assert torch.equal(first, _dot.dotconst_plain(y, pat, oh, rows=rows,
                                                  clip_hi=hi))
    assert _dot.dotconst_info(m, rows)["local_bytes"] == 0


ONEHOT_WGMMA_MODES = ["int8", "bf16", "f32"]


def _onehot_inputs(frames, height, width, seed, dev):
    """K6's (y, t, pat) with some indices outside [0, 768) in every frame:
    they must match no one-hot row."""
    from versatilefilmgrain_tpu_torch.tools import _dot
    y, t, pat = _dot.dot_inputs(seed, frames, height, width)
    rng = np.random.default_rng(seed)
    far = torch.from_numpy(rng.random(t.shape) < 0.05)
    t[far] = torch.from_numpy(rng.integers(768, 5000, t.shape, np.int32))[far]
    t[:, 0, 0, :4] = torch.tensor([-1, 768, -300, 767], dtype=torch.int32)
    return y.to(dev), t.to(dev), pat.to(dev)


@pytest.mark.parametrize("width", [64, 160, 200, 256, 296])
@pytest.mark.parametrize("mode", ONEHOT_WGMMA_MODES)
def test_onehot_wgmma_matches_plain(mode, width, cuda_device):
    """K6's int8, bf16 and f32 (TF32, in two row groups) products
    (csrc/probe_dotconst.cu, the one-hot built in registers) == the plain
    one-hot product, at widths of whole and partial 64-column tiles, on a
    plane of 4 frames x 50 block rows; y at 0 and at the clip limit on
    alternate lines, so both clip ends are hit, and t holding indices
    outside [0, 768).  At width 296 thread blocks' work ranges cross a
    column-tile boundary on a 132-SM card."""
    from versatilefilmgrain_tpu_torch.tools import _dot
    frames, R = 4, 50
    y, t, pat = _onehot_inputs(frames, 16 * R, width, 37, cuda_device)
    y[:, 0::2] = 0
    y[:, 1::2] = _dot.CLIP_HI
    info = _dot.dotconst_info(_dot.M, _dot.ROWS_K6, mode)
    ctas = min(-(-width // _dot.DOTCONST_COLS) * frames * R,
               torch.cuda.get_device_properties(0).multi_processor_count
               * info["blocks_per_sm"])
    ranges = _dot.dotconst_schedule(frames, R, width, ctas)
    crosses = any(lo // (frames * R) != (end - 1) // (frames * R)
                  for lo, end in ranges if end > lo)
    assert crosses or width != 296
    want = _dot.onehot_plain(y, t, pat)
    before = _dot.dot_probe_cuda.launches
    got = _dot.make_step(mode, t, pat)(y)[0]
    torch.cuda.synchronize()
    assert _dot.dot_probe_cuda.launches == before + 1
    assert torch.equal(got, want), f"{mode} W={width}"
    assert bool((want == 0).any()) and bool((want == _dot.CLIP_HI).any())
    assert not bool(((want == 0) | (want == _dot.CLIP_HI)).all())


@pytest.mark.parametrize("mode", ONEHOT_WGMMA_MODES)
def test_onehot_wgmma_launches_repeat_exactly(mode, cuda_device):
    """Two launches of K6's int8, bf16 or f32 product give identical bytes
    (the fold has no atomics), each adds one to the launch counter, and the
    instance spills nothing."""
    from versatilefilmgrain_tpu_torch.tools import _dot
    y, t, pat = _onehot_inputs(3, 48, 200, 41, cuda_device)
    step = _dot.make_step(mode, t, pat)
    before = _dot.dot_probe_cuda.launches
    before_mode = _dot.dot_probe_cuda.by_mode[mode]
    first = step(y)[0]
    assert _dot.dot_probe_cuda.launches == before + 1
    second = step(y)[0]
    torch.cuda.synchronize()
    assert _dot.dot_probe_cuda.launches == before + 2
    assert _dot.dot_probe_cuda.by_mode[mode] == before_mode + 2
    assert torch.equal(first, second)
    assert torch.equal(first, _dot.onehot_plain(y, t, pat))
    assert _dot.dotconst_info(_dot.M, _dot.ROWS_K6, mode)["local_bytes"] == 0


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


def _designer_input(tmp_path, width, height, frames):
    import os
    import sys
    from torch_port_cases import REPO
    sys.path.insert(0, os.path.join(REPO, "tools"))
    from gen_input import make_input_yuv
    inp = str(tmp_path / "in.yuv")
    make_input_yuv(inp, width, height, 10, 0, frames)
    return inp


def test_two_process_distributed_on_card(cuda_device, tmp_path):
    """Two processes share cuda:0 over a gloo group, each grains its shard
    through K1; the shards concatenate to a --device cpu run of the whole
    file, and each rank gathered both digests."""
    from torch_port_cases import run_workers
    from versatilefilmgrain_tpu_torch import GrainPipeline
    inp = _designer_input(tmp_path, W, H, 6)
    parts, recs, _ = run_workers(inp, str(tmp_path), W, H, 6, 2, "cuda:0")
    assert all(r["launches"] > 0 for r in recs)
    full = str(tmp_path / "full.yuv")
    assert GrainPipeline(W, H, 10, 0, device="cpu").run_file(
        inp, full, frames=6, batch=2) == 6
    assert parts == open(full, "rb").read()


def test_global_mesh_on_card(cuda_device):
    from versatilefilmgrain_tpu_torch.parallel import distributed
    m = distributed.make_global_mesh()
    assert m.shape == {"data": torch.cuda.device_count(), "tile": 1}
    assert all(d.type == "cuda" for row in m.devices for d in row)


@pytest.mark.parametrize("edited", [False, True])
def test_designer_on_card_matches_cpu(edited, cuda_device, tmp_path):
    """The designer's regrain on the card (K1) equals it on the CPU."""
    from torch_port_cases import edit_design
    from versatilefilmgrain_tpu_torch.designer import (FgcSeiDesign,
                                                       read_yuv_frame)
    planes = read_yuv_frame(_designer_input(tmp_path, W, H, 3), 2, W, H, 10,
                            0)
    d = FgcSeiDesign()
    if edited:
        edit_design(d)
    before = grain_natural.grain_plane_cuda.launches
    got = d.apply_to_frame(planes, W, H, 10, 0, frame_index=2,
                           device="cuda")
    assert grain_natural.grain_plane_cuda.launches > before
    want = d.apply_to_frame(planes, W, H, 10, 0, frame_index=2, device="cpu")
    for c, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and np.array_equal(a, b), c


def test_designer_app_on_card(cuda_device, tmp_path):
    """The GUI (Agg) regrains on the card: its grained frame after a drag
    equals the design's regrain on the CPU."""
    pytest.importorskip("matplotlib")
    import os
    import types
    os.environ["VFG_MPL_BACKEND"] = "Agg"
    import matplotlib.pyplot as plt
    from versatilefilmgrain_tpu_torch.designer.app import DesignerApp
    app = DesignerApp(_designer_input(tmp_path, W, H, 2), W, H, 10, 0)
    try:
        ev = [types.SimpleNamespace(inaxes=app.ax_edit, xdata=20, ydata=y,
                                    button=1, dblclick=False, key=None,
                                    x=0.0, y=0.0, step=0) for y in (200, 150)]
        app._on_press(ev[0])
        app._on_motion(ev[1])
        app._on_release(ev[1])
        assert app.design.values[0][0][0] == 150
        want = app.design.apply_to_frame(app.planes, W, H, 10, 0,
                                         device="cpu")
        for c, (a, b) in enumerate(zip(app.grained, want)):
            assert np.array_equal(a, b), c
    finally:
        plt.close(app.fig)


def test_traced_run_file_spans_stay_off_the_device_timeline(cuda_device,
                                                             tmp_path):
    """A profiled ``run_file`` on the card: the program's spans (utils/
    tracing.py) are no profiler ranges, so no CUDA event bears a span's
    name; the step's prep and kernel spans are recorded, and the output
    equals a --device cpu run's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from versatilefilmgrain_tpu_torch import GrainPipeline
    from versatilefilmgrain_tpu_torch.utils import tracing
    inp = _designer_input(tmp_path, W, H, 6)
    out, want = str(tmp_path / "out.yuv"), str(tmp_path / "cpu.yuv")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        n = GrainPipeline(W, H, 10, 0).run_file(inp, out, batch=4)
    got = tracing.record()
    names = set(tracing.summary(got["spans"]))
    assert n == 6 == got["counters"]["frames"]
    assert {"run_file", "grain.prep", "grain.kernels", "upload", "download",
            "wait"} <= names
    on_device = {e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == DeviceType.CUDA}
    assert on_device and not names & on_device
    GrainPipeline(W, H, 10, 0, device="cpu").run_file(inp, want, batch=4)
    assert open(out, "rb").read() == open(want, "rb").read()


@pytest.mark.parametrize("odepth", [0, 8])
def test_run_file_reuses_its_slots_on_card(odepth, cuda_device, tmp_path):
    """``run_file`` on the card at batch 2 over 64 frames: 32 batches
    through the native reader's and writer's pinned rings, each frame
    lent to the copies while others' copies may be in flight, byte-equal
    to a --device cpu run (10 bits out, and 8); its buffers (two host
    rings, five device buffers) are made once."""
    from versatilefilmgrain_tpu_torch import GrainPipeline
    from versatilefilmgrain_tpu_torch.utils import tracing
    inp = _designer_input(tmp_path, W, H, 64)
    out, want = str(tmp_path / "out.yuv"), str(tmp_path / "cpu.yuv")
    with tracing.forced():
        assert GrainPipeline(W, H, 10, 0).run_file(inp, out, odepth=odepth,
                                                   batch=2) == 64
        c = tracing.counters()
    assert c["batches"] == 32 and c["staging_allocs"] == 2 + 5
    GrainPipeline(W, H, 10, 0, device="cpu").run_file(inp, want,
                                                      odepth=odepth, batch=2)
    assert open(out, "rb").read() == open(want, "rb").read()


@pytest.mark.parametrize("width,height,depth,odepth", [(145, 128, 8, 0),
                                                       (146, 130, 10, 8)])
def test_run_file_pad_leak_on_card(width, height, depth, odepth, cuda_device,
                                   tmp_path):
    """``run_file`` at a pad-leak width on the card (luma 145 % 16 == 1;
    chroma 73 % 8 == 1): one frame a step whatever the batch, each frame's
    padding taken from the last step's output on the card, byte-equal to a
    --device cpu run."""
    from versatilefilmgrain_tpu_torch import GrainPipeline
    from versatilefilmgrain_tpu_torch.utils import tracing, yuv
    nfr = 6
    rng = np.random.default_rng(width)
    dt = np.uint8 if depth == 8 else np.uint16
    inp = tmp_path / "in.yuv"
    inp.write_bytes(rng.integers(
        0, 1 << depth, nfr * yuv.frame_bytes(width, height, depth, 0)
        // dt().itemsize).astype(dt).tobytes())
    out, want = str(tmp_path / "out.yuv"), str(tmp_path / "cpu.yuv")
    card = GrainPipeline(width, height, depth, 0)
    assert card._has_pad_leak()
    with tracing.forced():
        assert card.run_file(str(inp), out, odepth=odepth, batch=4) == nfr
        c = tracing.counters()
    assert c["batches"] == nfr
    GrainPipeline(width, height, depth, 0, device="cpu").run_file(
        str(inp), want, odepth=odepth, batch=4)
    assert open(out, "rb").read() == open(want, "rb").read()


@pytest.mark.parametrize("depth,odepth", [(8, 0), (10, 8)])
def test_run_file_pipe_to_pipe_through_pinned_rings_on_card(
        depth, odepth, cuda_device, tmp_path):
    """``run_file`` at batch 8 over 72 frames between two FIFOs, through
    the native reader and writer: every frame goes from the reader's
    pinned ring to the card and back into the writer's by reference
    (``ring_frames`` == ``frames``), byte-equal to the plain engine on
    the CPU (8 bits, and 10 bits written as 8)."""
    import os
    import threading
    from versatilefilmgrain_tpu_torch import GrainPipeline
    from versatilefilmgrain_tpu_torch.utils import native_io, tracing, yuv
    if not native_io.available():
        pytest.skip("native I/O toolchain unavailable")
    nfr, w, h = 72, 250, 140
    rng = np.random.default_rng(depth)
    dt = np.uint8 if depth == 8 else np.uint16
    data = rng.integers(0, 1 << depth, nfr * yuv.frame_bytes(w, h, depth, 0)
                        // dt().itemsize).astype(dt).tobytes()
    inp = tmp_path / "in.yuv"
    inp.write_bytes(data)
    src, dst = str(tmp_path / "src.fifo"), str(tmp_path / "dst.fifo")
    os.mkfifo(src)
    os.mkfifo(dst)
    got = []

    def feed():
        with open(src, "wb") as f:
            f.write(data)

    def drain():
        with open(dst, "rb") as f:
            got.append(f.read())
    helpers = [threading.Thread(target=t, daemon=True) for t in (feed, drain)]
    for t in helpers:
        t.start()
    try:
        with tracing.forced():
            assert GrainPipeline(w, h, depth, 0).run_file(
                src, dst, odepth=odepth, batch=8) == nfr
            c = tracing.counters()
    finally:
        for t in helpers:
            t.join(timeout=60)
    assert c["frames"] == c["ring_frames"] == nfr and c["batches"] == 9
    want = str(tmp_path / "cpu.yuv")
    GrainPipeline(w, h, depth, 0, device="cpu", engine="ref").run_file(
        str(inp), want, odepth=odepth, batch=8)
    assert got == [open(want, "rb").read()]


@pytest.mark.parametrize("switch", [False, True], ids=["sei", "afgs1_switch"])
def test_run_device_at_4k_on_card(switch, cuda_device, tmp_path):
    """``run_device`` at 3840x2160 10-bit over 24 frames on the card, at
    batch 8, with the built-in FGC SEI and across one AFGS1 switch (POC
    11, which cuts a batch): byte-equal to ``run_file`` on the card, and
    no host copy of a frame's size (``Memcpy HtoD``/``DtoH``) in the
    profiler's trace of the call."""
    import json
    import os
    from torch.profiler import ProfilerActivity, profile
    from versatilefilmgrain_tpu_torch import GrainPipeline
    from versatilefilmgrain_tpu_torch.utils import device_io, tracing, yuv
    from torch_port_cases import CFG_DIR
    w, h, nfr, batch = 3840, 2160, 24, 8
    fb = yuv.frame_bytes(w, h, 10, 0)
    data = np.random.default_rng(26).integers(
        0, 1 << 10, nfr * fb // 2).astype(np.uint16).view(np.uint8)
    inp, want = tmp_path / "in.yuv", tmp_path / "file.yuv"
    inp.write_bytes(data.tobytes())
    configs = ([f"11:{os.path.join(CFG_DIR, 'fgs_afgs1_test2.cfg')}"]
               if switch else [])
    assert GrainPipeline(w, h, 10, 0, configs=configs).run_file(
        str(inp), str(want), batch=batch) == nfr
    lent = torch.from_numpy(data).to(cuda_device).view(nfr, fb)
    got = torch.empty_like(lent)
    handed = []

    def hand(frame):
        got[len(handed)].copy_(frame)
        handed.append(frame)
    pipe = GrainPipeline(w, h, 10, 0, configs=configs)
    sink = device_io.DeviceSink(fb, 3 * batch, cuda_device, hand)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        n = pipe.run_device(device_io.DeviceSource(list(lent)), sink,
                            batch=batch)
        torch.cuda.synchronize()
        c = tracing.counters()
    assert n == len(handed) == nfr
    assert c["device_frames"] == nfr and c.get("ring_frames", 0) == 0
    assert c.get("switch_cuts", 0) == int(switch)
    assert got.cpu().numpy().tobytes() == want.read_bytes()
    trace = str(tmp_path / "trace.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    crossing = [e for e in events if e.get("cat") == "gpu_memcpy"
                and ("HtoD" in e["name"] or "DtoH" in e["name"])]
    assert all(e.get("args", {}).get("bytes", fb) < fb // 16
               for e in crossing), crossing[:4]
