"""31-bit LFSR pseudo-random generator as a GF(2) linear map, with jump-ahead.

The reference advances one 32-bit register serially, once per 16-pixel block
column (vfgs_hw.c:74-79, 288-312), with a per-block-row backup/restore schedule
(vfgs_hw.c:291-298) and carry-over across frames (the state is never reset
between frames).  Working out that schedule gives a closed form: with
``C = ceil(width/16)`` block columns and ``R = ceil(height/16)`` block rows, the
register value used for block (frame f, block-row r, block-col c) is

    state(f, r, c) = A^((f*(R-1) + r)*C + c) . S0

where ``S0 = seed << 1`` (vfgs_hw.c:339-344) and ``A`` is the one-step LFSR
transition, a linear map over GF(2)^32.  (Frame f's block-row 0 reuses frame
f-1's last block-row state because the backup only triggers for ``y > 0``,
hence the ``R-1`` factor.)  The "upper block" register ``rnd_up`` used for
vertical overlap is the same lattice shifted one block-row up:
``state_up(f, r, c) = state(f, r-1, c)``, i.e. exponent minus ``C``.

This module computes ``A^e`` by square-and-multiply on a column representation
(32 uint32 columns; applying the matrix is 32 select-XOR ops, which vectorizes
over arbitrarily-shaped state arrays in numpy and torch).  That replaces the
serial dependency with an embarrassingly parallel per-(frame, row, col) state
lattice: every block row of every frame can be grained independently while
staying bit-exact with the C model.  One state held as a Python int (a
frame's lattice base) jumps instead through byte tables of the cached
``A^(2^k)`` (:func:`advance_int`): four lookups and three XORs per set bit of
``e``, no matrix composed per call.

Torch lattices are int64 tensors holding the uint32 values: torch has no
shifts on uint32/uint16 tensors on the CPU, so the arithmetic runs in int64
and is masked to 32 bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils import tracing

MASK32 = np.uint32(0xFFFFFFFF)


def lfsr_step(x):
    """One LFSR step: bit-reversed SMPTE RDD-5 polynomial (vfgs_hw.c:74-79).

    Works on python ints and numpy uint32 scalars/arrays.
    """
    s = ((x << 30) ^ (x << 2)) & 0x80000000
    return (s | (x >> 1)) & 0xFFFFFFFF


def _identity_cols() -> np.ndarray:
    return (np.uint32(1) << np.arange(32, dtype=np.uint32)).astype(np.uint32)


def step_matrix_cols() -> np.ndarray:
    """Column representation of A: cols[j] = A applied to basis vector e_j."""
    return np.array([lfsr_step(1 << j) for j in range(32)], dtype=np.uint32)


def apply_cols(cols, x):
    """Apply a GF(2) matrix (column rep) to state(s) ``x`` (uint32, any shape).

    Pure arithmetic (mul by 0/1 + xor) in numpy.
    """
    out = x & 0  # zeros of x's shape/dtype
    for j in range(32):
        out = out ^ (np.uint32(cols[j]) * ((x >> j) & 1))
    return out


def matmul_cols(a_cols: np.ndarray, b_cols: np.ndarray) -> np.ndarray:
    """Compose: result = A . B in column representation (numpy only)."""
    return apply_cols(a_cols, b_cols.astype(np.uint32))


@functools.lru_cache(maxsize=None)
def jump_cols_pow2(k: int) -> np.ndarray:
    """Column rep of A^(2^k) (cached)."""
    if k == 0:
        return step_matrix_cols()
    m = jump_cols_pow2(k - 1)
    m2 = matmul_cols(m, m)
    m2.setflags(write=False)
    return m2


def power_cols(e: int) -> np.ndarray:
    """Column rep of A^e for a non-negative python int exponent."""
    assert e >= 0
    cols = _identity_cols()
    k = 0
    while e:
        if e & 1:
            cols = matmul_cols(jump_cols_pow2(k), cols)
        e >>= 1
        k += 1
    return cols


def advance(state, e: int):
    """A^e . state for python-int e >= 0 (numpy path)."""
    if e == 0:
        return state
    return apply_cols(power_cols(e), state)


# Bits of the exponent whose byte tables are built together (one block).
TABLE_BITS = 64


@functools.lru_cache(maxsize=None)
def _byte_tables(block: int) -> list[tuple[list[int], ...]]:
    """Byte tables of ``A^(2^k)`` for the ``TABLE_BITS`` values of k from
    ``block * TABLE_BITS``: entry k holds four 256-entry tables, entry v
    of table b being ``A^(2^k)`` applied to ``v << 8*b`` (the XOR of
    ``cols[8*b + j]`` over the set bits j of v).  Built once per process,
    with numpy."""
    ks = range(block * TABLE_BITS, (block + 1) * TABLE_BITS)
    cols = np.stack([jump_cols_pow2(k) for k in ks]).reshape(-1, 4, 1, 8)
    bits = (np.arange(256, dtype=np.uint32)[:, None]
            >> np.arange(8, dtype=np.uint32)) & 1           # (256, 8)
    tables = np.bitwise_xor.reduce(cols * bits, axis=-1)    # (k, 4, 256)
    tracing.count("lfsr_tables", TABLE_BITS)
    return [tuple(t) for t in tables.tolist()]


def advance_int(state: int, e: int) -> int:
    """A^e . state for one uint32 ``state`` and python-int e >= 0, as a
    python int; the same bits as :func:`advance`.  Powers of A commute, so
    the jumps of e's set bits apply in any order."""
    assert e >= 0
    s = int(state)
    block, k = 0, 0
    tables = _byte_tables(0)
    while e:
        if k == TABLE_BITS:
            block, k = block + 1, 0
            tables = _byte_tables(block)
        if e & 1:
            t0, t1, t2, t3 = tables[k]
            s = (t0[s & 255] ^ t1[s >> 8 & 255] ^ t2[s >> 16 & 255]
                 ^ t3[s >> 24])
        e >>= 1
        k += 1
    return s


def state_lattice_np(base: int, rows: int, cols: int) -> np.ndarray:
    """(rows, cols) uint32 lattice: L[r, c] = A^(r*cols + c) . base  (numpy)."""
    e = np.arange(rows * cols, dtype=np.uint32).reshape(rows, cols)
    state = np.full((rows, cols), np.uint32(base), dtype=np.uint32)
    nbits = max(1, (rows * cols - 1).bit_length())
    for k in range(nbits):
        jumped = apply_cols(jump_cols_pow2(k), state)
        bit = (e >> k) & 1
        state = np.where(bit.astype(bool), jumped, state)
    return state


@functools.lru_cache(maxsize=8)
def _lattice_matrix_table(rows: int, cols: int) -> np.ndarray:
    """Static (rows, cols, 32) table: entry [r, c] is the column rep of
    A^(r*cols + c).

    Built on the host once per lattice shape by composing per-row and
    per-column exponent matrices: A^(r*cols+c) = A^(r*cols) . A^c.  Each
    factor family is computed with the same square-multiply-on-batches trick
    as :func:`state_lattice_np`, so construction is O(log(n)) numpy passes.
    """
    def _exp_family(n: int, stride: int) -> np.ndarray:
        """(n, 32) uint32: row e holds the column rep of A^(e*stride)."""
        fam = np.broadcast_to(_identity_cols(), (n, 32)).copy()
        e = np.arange(n, dtype=np.uint64) * stride
        nbits = max(1, int(e.max()).bit_length()) if n > 1 else 1
        for k in range(nbits):
            jumped = apply_cols(jump_cols_pow2(k), fam)
            bit = ((e >> k) & 1).astype(bool)[:, None]
            fam = np.where(bit, jumped, fam)
        return fam.astype(np.uint32)

    arow = _exp_family(rows, cols)      # A^(r*cols)
    acol = _exp_family(cols, 1)         # A^c
    # compose: out[r, c, i] = XOR_j arow[r, j] * bit_j(acol[c, i])
    out = np.zeros((rows, cols, 32), np.uint32)
    for j in range(32):
        out ^= arow[:, None, None, j] * ((acol[None, :, :] >> j) & 1)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=8)
def _lattice_matrix_tensor(rows: int, cols: int,
                           device: torch.device) -> torch.Tensor:
    """:func:`_lattice_matrix_table` as an int64 (32, rows, cols) tensor on
    ``device``, uploaded once per shape (4.1 MB of uint32 at 4K)."""
    table = _lattice_matrix_table(rows, cols).astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(
        table.transpose(2, 0, 1))).to(device)


def state_lattice_torch(bases, rows: int, cols: int,
                        device) -> torch.Tensor:
    """(F, rows, cols) int64 lattices, one per base in ``bases``:
    ``L[f, r, c] = A^(r*cols + c) . bases[f]``, values in [0, 2^32).

    ``bases`` is a sequence of uint32 values or an integer tensor.  The
    per-exponent matrices are a host table uploaded once per shape; the
    device work is the 32 select-XOR contraction against each base's bits.
    """
    device = torch.device(device)
    if not isinstance(bases, torch.Tensor):
        bases = torch.from_numpy(np.asarray(bases, np.int64).reshape(-1))
    bases = bases.to(device=device, dtype=torch.int64) & 0xFFFFFFFF
    m = _lattice_matrix_tensor(rows, cols, device)
    state = torch.zeros((bases.shape[0], rows, cols), dtype=torch.int64,
                        device=device)
    for j in range(32):
        bit = ((bases >> j) & 1)[:, None, None]
        state ^= m[j][None] * bit
    return state


def frame_base_exponent(frame: int, rows: int, cols: int) -> int:
    """Exponent of the lattice base state for ``frame`` frames after a seed set."""
    return frame * (rows - 1) * cols
