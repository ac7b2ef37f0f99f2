"""The torch port's device grain state against the JAX package: the LFSR
state lattice, the scalar jump of one state and the per-block offset/sign
decode."""

import numpy as np
import pytest
import torch

from versatilefilmgrain_tpu.ops import lfsr as jlfsr
from versatilefilmgrain_tpu.ops.offsets import block_offsets as jblock_offsets
from versatilefilmgrain_tpu_torch.ops import lfsr
from versatilefilmgrain_tpu_torch.ops.offsets import block_offsets
from versatilefilmgrain_tpu_torch.utils import tracing

from test_lfsr import _serial_schedule

_rng = np.random.default_rng(19)
JUMP_STATES = [0, 1, 0xFFFFFFFF, 0x80000001] + [
    int(s) | 1 for s in _rng.integers(0, 1 << 32, 4, dtype=np.uint64)]
JUMP_EXPONENTS = {
    "small": [0, 1],
    "pow2_minus_1": [(1 << k) - 1 for k in range(1, 48)],
    "pow2": [1 << k for k in range(48)],
    "pow2_plus_1": [(1 << k) + 1 for k in range(1, 48)],
    "random": [int(e) for e in _rng.integers(0, 1 << 40, 16, dtype=np.uint64)],
}


@pytest.mark.parametrize("base,rows,cols", [
    (0xDEADBEEF, 1, 1), (0x12345678 << 1, 5, 9), (0xFFFFFFFF, 9, 16),
    (0x80000001, 135, 240)])
def test_state_lattice_torch_matches_np_and_jax(base, rows, cols):
    want = jlfsr.state_lattice_np(base, rows, cols)
    got = lfsr.state_lattice_torch([base], rows, cols, "cpu")
    assert got.dtype == torch.int64 and got.shape == (1, rows, cols)
    assert np.array_equal(got[0].numpy(), want.astype(np.int64))
    j = np.asarray(jlfsr.state_lattice_jax(np.uint32(base), rows, cols))
    assert np.array_equal(got[0].numpy(), j.astype(np.int64))


def test_state_lattice_torch_batches_bases():
    bases = [0xDEADBEEF, 1, 0x7FFFFFFF << 1, 0xCAFEBABE]
    got = lfsr.state_lattice_torch(torch.tensor(bases), 4, 7, "cpu")
    for f, b in enumerate(bases):
        assert np.array_equal(got[f].numpy(),
                              jlfsr.state_lattice_np(b, 4, 7).astype(np.int64))


def test_closed_form_matches_reference_schedule():
    """Frame bases + torch lattices reproduce the reference's serial
    register schedule (vfgs_hw.c:288-312), upper rows included."""
    seed = 0xDEADBEEF
    R, C, F = 4, 5, 3
    serial = _serial_schedule(seed, R, C, F)
    for f in range(F):
        e0 = lfsr.frame_base_exponent(f, R, C)
        base = int(lfsr.advance(np.uint32(seed), e0))
        lat = lfsr.state_lattice_torch([base], R, C, "cpu")[0]
        for r in range(R):
            for c in range(C):
                assert int(lat[r, c]) == serial[(f, r, c)][0], (f, r, c)
                if r > 0:
                    assert int(lat[r - 1, c]) == serial[(f, r, c)][1]


def test_host_lfsr_matches_jax():
    assert np.array_equal(lfsr.step_matrix_cols(), jlfsr.step_matrix_cols())
    assert lfsr.advance(np.uint32(0xDEADBEEF), 12345) == \
        jlfsr.advance(np.uint32(0xDEADBEEF), 12345)
    assert np.array_equal(lfsr._lattice_matrix_table(6, 11),
                          jlfsr._lattice_matrix_table(6, 11))


@pytest.mark.parametrize("family", JUMP_EXPONENTS)
@pytest.mark.parametrize("state", JUMP_STATES, ids=hex)
def test_advance_int_matches_np_and_jax(state, family):
    """The byte-table jump of one state gives the numpy matrix path's and
    the JAX package's bits."""
    for e in JUMP_EXPONENTS[family]:
        got = lfsr.advance_int(state, e)
        assert type(got) is int and 0 <= got < 1 << 32
        assert got == int(lfsr.advance(np.uint32(state), e)), e
        assert got == int(jlfsr.advance(np.uint32(state), e)), e


@pytest.mark.parametrize("e", [(1 << 64) - 1, 1 << 64, (1 << 64) + 1,
                               (5 << 70) + 12345, 1 << 130])
def test_advance_int_past_one_block_of_tables(e):
    """Exponents past the first ``TABLE_BITS`` bits take the next blocks."""
    for state in (1, 0xDEADBEEF):
        assert lfsr.advance_int(state, e) == int(
            lfsr.advance(np.uint32(state), e))


def test_advance_int_rejects_negative_exponent():
    for jump in (lfsr.advance_int, lfsr.advance):
        with pytest.raises(AssertionError):
            jump(0xDEADBEEF, -1)


def test_byte_tables_are_the_jump_matrices(monkeypatch):
    """Entry v of table b of bit k is A^(2^k) applied to v << 8b; a block
    is built once and counted as ``TABLE_BITS`` tables."""
    monkeypatch.setattr(tracing, "_R", tracing.Recorder())
    lfsr._byte_tables.cache_clear()
    with tracing.forced():
        tables = lfsr._byte_tables(0)
        assert lfsr._byte_tables(0) is tables
        assert tracing.counters()["lfsr_tables"] == lfsr.TABLE_BITS
    assert len(tables) == lfsr.TABLE_BITS
    v = np.arange(256, dtype=np.uint32)
    for k in (0, 1, 13, 47, 63):
        for b in range(4):
            want = lfsr.apply_cols(lfsr.jump_cols_pow2(k), v << (8 * b))
            assert tables[k][b] == want.tolist(), (k, b)


@pytest.mark.parametrize("c", [0, 1, 2])
@pytest.mark.parametrize("csub", [(2, 2), (2, 1), (1, 1)])
def test_block_offsets_match_jax(c, csub):
    rng = np.random.default_rng(17 + c)
    words = rng.integers(0, 1 << 32, (37, 29), dtype=np.uint64)
    words[0, :4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    ref = jblock_offsets(words.astype(np.uint32), c, *csub)
    got = block_offsets(torch.from_numpy(words.astype(np.int64)), c, *csub)
    for name, a, b in zip(("sign", "ox", "oy"), ref, got):
        assert b.dtype == torch.int32, name
        assert np.array_equal(np.asarray(a), b.numpy()), name
