"""The torch port's lane words against the JAX package, bit for bit.

The word builders (``_block_words``, ``_lane_words_xla``), the plain
version of K2 (``expand_words_plain``, against the JAX Pallas kernel
``_expand_words_pallas`` in interpret mode), the lane-word offset decode of
K1's stream input, ``_lane_words3`` and ``add_grain_batch_natural`` in every
``word_expand`` mode (against the JAX function in interpret mode, over the
grid of tests/test_natural_engine.py).  Every comparison is exact.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from versatilefilmgrain_tpu.ops import grain_natural as jgn
from versatilefilmgrain_tpu_torch.ops import grain_natural, grain_ref
from versatilefilmgrain_tpu_torch.ops.offsets import block_offsets

from torch_port_cases import (JAX_PKG, TORCH_PKG, frame_bases, mod,
                              random_planes, regs_for)

# (c, (csubx, csuby)): luma, then both chroma planes of 4:2:0, 4:2:2, 4:4:4.
PLANES = [(0, (2, 2))] + [(c, csub) for csub in ((2, 2), (2, 1), (1, 1))
                          for c in (1, 2)]
MODES = ["xla", "pallas", "kernel", "chunk"]


def _lattice(seed, shape=(2, 5, 12)):
    """Random uint32 lattice words: numpy for JAX, int64 torch for the port."""
    lat = np.random.default_rng(seed).integers(0, 1 << 32, shape,
                                               dtype=np.uint64)
    return lat.astype(np.uint32), torch.from_numpy(lat.astype(np.int64))


@pytest.mark.parametrize("c,csub", PLANES)
def test_block_and_lane_words_match_jax(c, csub):
    jlat, tlat = _lattice(11 + c)
    jw, jbw = jgn._block_words(jnp.asarray(jlat), c, *csub)
    tw, tbw = grain_natural._block_words(tlat, c, *csub)
    assert tbw == jbw and tw.dtype == torch.int32
    assert np.array_equal(tw.numpy(), np.asarray(jw))
    jl = jgn._lane_words_xla(jw, jbw)
    tl = grain_natural._lane_words_xla(tw, tbw)
    assert tuple(tl.shape) == jl.shape
    assert np.array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("csub", [(2, 2), (2, 1), (1, 1)])
def test_expand_words_plain_matches_jax_kernel(csub):
    """expand_words_plain == _expand_words_pallas(interpret=True), all three
    planes in one call; 2*5 block rows pad to the kernel's 64-row chunk."""
    jlat, tlat = _lattice(3)
    jblk = [jgn._block_words(jnp.asarray(jlat), c, *csub) for c in range(3)]
    tblk = [grain_natural._block_words(tlat, c, *csub) for c in range(3)]
    want = jgn._expand_words_pallas([w for w, _ in jblk],
                                    [bw for _, bw in jblk], interpret=True)
    got = grain_natural.expand_words_plain([w for w, _ in tblk],
                                           [bw for _, bw in tblk])
    for c, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == w.shape, c
        assert np.array_equal(g.numpy(), np.asarray(w)), c


@pytest.mark.parametrize("c,csub", PLANES)
def test_lane_word_decode_matches_block_offsets(c, csub):
    """Decoding K1's stream input gives each lane its block's sign and
    pattern row and the column ox + x % bw, on random lattices: the
    in-block column never carries into the sign bit."""
    _, tlat = _lattice(100 + c, shape=(4, 16, 64))
    words = grain_natural._lane_words_xla(
        *grain_natural._block_words(tlat, c, *csub))
    s, col, oy = grain_natural.lane_word_offsets(words, c, *csub)
    bw = 16 // (csub[0] if c else 1)
    bs, box, boy = (t.repeat_interleave(bw, dim=-1)
                    for t in block_offsets(tlat, c, *csub))
    i = torch.arange(tlat.shape[-1] * bw) % bw
    assert torch.equal(s, bs) and torch.equal(oy, boy)
    assert torch.equal(col, box + i)
    assert int(words.max()) < 2048 and int(words.min()) >= 0
    assert all(torch.equal(a, b) for a, b in zip(
        (s, col, oy), grain_ref.lane_offsets(tlat, c, *csub)))


@pytest.mark.parametrize("active", list(itertools.product((True, False),
                                                          repeat=3)))
def test_lane_words3_matches_jax(active):
    """Every zero-scale mask, including all planes absent (no expansion at
    all): "xla" and "pallas" against JAX's "pallas" in interpret mode."""
    jlat, tlat = _lattice(17)
    want = jgn._lane_words3(jnp.asarray(jlat), 2, 2, interpret=True,
                            expand="pallas", active=active)
    for mode in ("xla", "pallas"):
        got = grain_natural._lane_words3(tlat, 2, 2, expand=mode,
                                         active=active)
        for c, (g, w) in enumerate(zip(got, want)):
            assert tuple(g.shape) == w.shape, (mode, c)
            assert np.array_equal(g.numpy(), np.asarray(w)), (mode, c)


def test_lane_words3_rejects_block_modes():
    _, tlat = _lattice(1)
    with pytest.raises(ValueError, match="lane words"):
        grain_natural._lane_words3(tlat, 2, 2, expand="kernel")


@pytest.mark.parametrize("kind", ["sei_ff", "sei_ar", "afgs1"])
@pytest.mark.parametrize("mode", MODES)
def test_batch_word_modes_match_jax(kind, mode):
    """add_grain_batch_natural(word_expand=mode) on the CPU against the JAX
    function with the same mode in interpret mode, two frames of 48x128
    10-bit 4:2:0 (sei_ar runs the zero-scale chroma through every mode)."""
    H, W = 48, 128
    R, C = H // 16, W // 16
    jregs = regs_for(JAX_PKG, kind, 10, (2, 2))
    tregs = regs_for(TORCH_PKG, kind, 10, (2, 2))
    planes = random_planes(31, 10, R, C, (2, 2), frames=2)
    bases, bases_up = frame_bases(TORCH_PKG, tregs.seed_state, R, C, (0, 3))
    geo = dict(height=H, width=W, bs=2, csubx=2, csuby=2)
    want = jgn.add_grain_batch_natural(
        *(jnp.asarray(p) for p in planes),
        jnp.asarray(np.array(bases, np.uint32)),
        jnp.asarray(np.array(bases_up, np.uint32)),
        jgn.natural_tables(jregs), interpret=True, word_expand=mode, **geo)
    got = grain_natural.add_grain_batch_natural(
        *(torch.from_numpy(p) for p in planes), bases, bases_up,
        grain_natural.natural_tables(tregs, "cpu"), word_expand=mode, **geo)
    for c in range(3):
        assert np.array_equal(got[c].numpy(), np.asarray(want[c])), \
            f"{kind} {mode} plane {c}"


@pytest.mark.parametrize("mode", MODES)
def test_all_components_absent(mode):
    """Every plane zero-scaled: clip(x) on all three planes in every mode
    (cf. tests/test_natural_engine.py::test_all_components_absent)."""
    cfgmod, fw = mod(TORCH_PKG, "models.config"), mod(TORCH_PKG, "models.fw")
    regs = mod(TORCH_PKG, "models.hw").HwRegs()
    regs.set_depth(10)
    regs.set_chroma_subsampling(2, 2)
    sei = cfgmod.default_sei()
    sei.comp_model_present_flag = [0, 0, 0]
    fw.init_sei(sei, regs)
    tables = grain_natural.natural_tables(regs, "cpu")
    assert tables["zero_scale"] == (True, True, True)
    planes = [torch.from_numpy(p) for p in
              random_planes(3, 10, 5, 10, (2, 2), frames=2)]
    out = grain_natural.add_grain_batch_natural(
        *planes, [0, 0], None, tables, height=80, width=160, bs=2, csubx=2,
        csuby=2, word_expand=mode)
    lims = [(regs.y_min, regs.y_max)] + [(regs.c_min, regs.c_max)] * 2
    for c, (lo, hi) in enumerate(lims):
        assert torch.equal(out[c], planes[c].int().clamp(lo << 2, hi << 2)
                           .to(planes[c].dtype)), c


def test_word_expand_rejects_unknown_mode():
    regs = regs_for(TORCH_PKG, "sei_ff", 10, (2, 2))
    tables = grain_natural.natural_tables(regs, "cpu")
    planes = [torch.from_numpy(p) for p in
              random_planes(3, 10, 3, 8, (2, 2), frames=1)]
    with pytest.raises(ValueError, match="word_expand"):
        grain_natural.add_grain_batch_natural(
            *planes, [1], None, tables, height=48, width=128, bs=2, csubx=2,
            csuby=2, word_expand="butterfly")


def test_expand_words_cuda_rejects_cpu_tensors():
    blk = [torch.zeros((1, 2, 3), dtype=torch.int32)]
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        grain_natural.expand_words_cuda(blk, [16])
    with pytest.raises(ValueError, match="1-3 planes"):
        grain_natural.expand_words_cuda([], [])
    assert grain_natural.expand_words_cuda.launches == 0


def _expand_writes(plan, k, cols, bw):
    """How often csrc/expand_words.cu's indexing, under ``plan``'s grid,
    reads each block word and writes each 16-byte quad of plane ``k``: row
    blocks take rows bx, bx + gx, ...; warp w words 32 w + 256 p of a row;
    a lane its word, then quad q = 32 i + lane of the warp's words in round
    i, which holds word q / (bw / 4)."""
    rows, gx = plan["rows"], plan["grid"][0]
    kq = bw // 4
    reads = np.zeros((rows, cols), np.int64)
    writes = np.zeros((rows, cols * kq), np.int64)
    lane = np.arange(32)
    for bx in range(gx):
        for row in range(bx, rows, gx):
            for b0 in range(0, cols, 32):       # each warp's pass
                w = b0 + lane
                np.add.at(reads[row], w[w < cols], 1)
                for i in range(kq):
                    q = 32 * i + lane
                    ok = b0 + q // kq < cols
                    np.add.at(writes[row], (b0 * kq + q)[ok], 1)
    return reads, writes


@pytest.mark.parametrize("rows,cols,bws,sms", [
    (1080, [240, 240, 240], [16, 8, 8], 132),   # 4K 4:2:0, three planes
    (1080, [240], [16], 132),                   # luma alone
    (1080, [240, 240], [8, 8], 132),            # the two chroma planes
    (15, [17, 9], [16, 8], 132),                # odd rows, pad-leak widths
    (7, [33, 49, 300], [16, 16, 8], 132),       # a row of two passes
    (1080, [240, 240, 240], [16, 16, 16], 4)])  # many rows a block
def test_expand_words_plan_covers_every_quad_once(rows, cols, bws, sms):
    """K2's launch plan (grain_natural.expand_words_plan): about one wave
    of 256-thread blocks; under its grid every block word is read once and
    every quad of lane words written once."""
    plan = grain_natural.expand_words_plan(rows, cols, bws, sms=sms)
    gx, planes = plan["grid"]
    assert planes == len(cols) and 1 <= gx <= rows
    assert plan["rows_per_block"] == -(-rows // gx)
    # one wave, give or take a block a plane where rows do not divide
    assert plan["rows_per_block"] == 1 or gx * planes <= (
        sms * grain_natural.EXPAND_BLOCKS_PER_SM + planes)
    assert plan["stores_per_word"] == [bw // 4 for bw in bws]
    for k, (c, bw) in enumerate(zip(cols, bws)):
        reads, writes = _expand_writes(plan, k, c, bw)
        assert (reads == 1).all() and (writes == 1).all(), (k, c, bw)


def test_expand_words_plan_refusals():
    for args in (([], []), ([4, 4, 4, 4], [16] * 4), ([4], [12]),
                 ([0], [16]), ([4, 4], [16])):
        with pytest.raises(ValueError):
            grain_natural.expand_words_plan(3, *args)
    with pytest.raises(ValueError):
        grain_natural.expand_words_plan(0, [4], [16])


def test_expand_words_cuda_rejects_bad_shapes():
    """Shapes are checked before the device: a plane of another frame or
    row count, a block width other than 8 or 16, words of another type."""
    blk = torch.zeros((2, 3, 4), dtype=torch.int32)
    for wblks, bws in (([blk, torch.zeros((2, 4, 4), dtype=torch.int32)],
                        [16, 8]),
                       ([blk], [12]),
                       ([blk.to(torch.int64)], [16]),
                       ([blk[0]], [16])):
        with pytest.raises(ValueError, match="expected|bw"):
            grain_natural.expand_words_cuda(wblks, bws)
    assert grain_natural.expand_words_cuda.launches == 0
