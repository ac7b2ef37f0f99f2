"""What the two relayout probes share: K9 (probe_relayout) and K10
(probe_relayout5d).

On the TPU the tiled engine read its planes in a tiled (256, C) layout, and
these probes measured what it costs to turn a natural (16, W) block row into
that layout inside the kernel and back.  Every form writes ``y ^ 1`` on a
uint16 plane ``y``.  Here are their shape, their seeded input (drawn as
both JAX ``main``s draw it), the plain torch versions of every form, the
wrappers of the kernel, csrc/probe_relayout.cu, and the torch round trip of
the tiled step's glue that the probes time beside it.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import _kernels
from ..ops.grain_natural import _check_plane
from ..ops.grain_pallas import _tile, _untile
from . import _harness as hz

F, H, W = hz.FRAMES_BATCH, hz.H, hz.W
R, C = H // 16, W // 16
RCHUNKS = (1, 5, 15)             # block rows per thread block (relayout)
MODES = {"passthrough": 0, "relayout": 1}
# K10's forms: the instance of csrc/probe_relayout.cu each one runs
MODES_5D = {"5d_passthrough": "passthrough", "5d_transpose": "relayout"}


def relayout_inputs(seed: int = 0, frames: int = F, height: int = H,
                    width: int = W, device="cpu") -> torch.Tensor:
    """The plane ``y``: uint16 (frames, height, width) in [0, 1024), drawn
    as tools/probe_relayout.py's and probe_relayout5d.py's main draw it."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 1024, (frames, height, width),
                                         np.uint16)).to(device)


def view5d(y: torch.Tensor) -> torch.Tensor:
    """K10's free (F, R, 16, C, 16) view of a natural (F, 16R, 16C) plane."""
    Fy, Hy, Wy = y.shape
    return y.view(Fy, Hy // 16, 16, Wy // 16, 16)


# -- plain versions (torch, any device) ----------------------------------------

def _xor1(x):
    """x ^ 1 on a uint16 tensor, taken on its int16 view (bit for bit the
    same; torch has few uint16 operators on CUDA)."""
    return (x.view(torch.int16) ^ 1).view(torch.uint16)


def passthrough_plain(y):
    """passthrough (K9) and 5d_passthrough (K10, on the 5-D view): y ^ 1."""
    return _xor1(y)


def relayout_plain(y, rchunk: int = 1):
    """relayout at ``rchunk`` block rows per grid step, as
    ``_relayout_rows_kernel`` writes it (``_relayout_kernel`` at 1): each
    (16 rchunk, W) block to (16 rchunk, C, 16), transposed to the tiled
    (16 rchunk * 16, C), XOR, then back."""
    Fy, Hy, Wy = y.shape
    bh, Cy = 16 * rchunk, Wy // 16
    g = Hy // bh
    t = y.reshape(Fy, g, bh, Cy, 16).permute(0, 1, 2, 4, 3)
    t = _xor1(t.reshape(Fy, g, bh * 16, Cy))
    return (t.reshape(Fy, g, bh, 16, Cy).permute(0, 1, 2, 4, 3)
            .reshape(Fy, Hy, Wy))


def relayout5d_plain(y5):
    """5d_transpose, as ``_kernel_5d`` writes it on the (F, R, 16, C, 16)
    view: each (16, C, 16) block transposed to (16, 16, C), collapsed to
    (256, C), XOR, then back."""
    Fy, Ry, bh, Cy, bw = y5.shape
    t = _xor1(y5.permute(0, 1, 2, 4, 3).reshape(Fy, Ry, bh * bw, Cy))
    return t.reshape(Fy, Ry, bh, bw, Cy).permute(0, 1, 2, 4, 3).contiguous()


def plain(mode: str, y, rchunk: int = 1):
    """The plain version of ``mode`` (K9's on the natural plane, K10's on
    the 5-D view) on any device."""
    if mode in ("passthrough", "5d_passthrough"):
        return passthrough_plain(y)
    if mode == "relayout":
        return relayout_plain(y, rchunk)
    if mode == "5d_transpose":
        return relayout5d_plain(y)
    raise ValueError(f"unknown mode {mode!r}: expected one of "
                     f"{[*MODES, *MODES_5D]}")


def tile_round_trip(y):
    """The library yardstick: the tiled step's own glue around the XOR,
    ``_untile(_tile(y) ^ 1)`` (ops/grain_pallas.py), three kernels."""
    g = (y.shape[0], y.shape[1] // 16, 16, y.shape[2] // 16, 16)
    return _untile(_xor1(_tile(y, *g)), *g)


def tile_only(y):
    """``_tile`` alone: what the tiled step pays per plane on the way in."""
    return _tile(y, y.shape[0], y.shape[1] // 16, 16, y.shape[2] // 16, 16)


# -- the kernel -----------------------------------------------------------------

def _launch(y, mode, rchunk, frames, rows, width):
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: expected one of "
                         f"{list(MODES)}")
    if rchunk not in RCHUNKS or (mode == "passthrough" and rchunk != 1):
        raise ValueError(f"no {mode} instance for rchunk {rchunk}")
    if y.data_ptr() % 16:
        raise ValueError("y must be 16-byte aligned")
    if y.device.type != "cuda":
        raise ValueError(f"the relayout probe needs CUDA tensors, got "
                         f"{y.device}")
    lib = _kernels.load("probe_relayout")
    out = torch.empty_like(y)
    rc = lib.vfg_probe_relayout(
        MODES[mode], rchunk, y.data_ptr(), out.data_ptr(), frames, rows,
        width, ctypes.c_void_p(torch.cuda.current_stream(
            y.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"probe_relayout kernel launch failed: CUDA "
                           f"error {rc}")
    return out


def relayout_probe_cuda(y, *, mode: str, rchunk: int = 1) -> torch.Tensor:
    """K9 on the card: launch csrc/probe_relayout.cu's ``mode``
    ("passthrough", or "relayout" at ``rchunk`` 1, 5 or 15 block rows per
    thread block) on a (F, 16R, W) uint16 CUDA plane, R a multiple of
    ``rchunk``, W of 16; returns ``y ^ 1``.  Adds one to
    ``relayout_probe_cuda.launches`` per launch."""
    if (rchunk < 1 or y.dim() != 3 or y.shape[1] % (16 * rchunk)
            or y.shape[2] % 16):
        raise ValueError(f"y must be (F, 16 rchunk R, 16 C) with rchunk "
                         f"{rchunk}, got {tuple(y.shape)}")
    Fy, Hy, Wy = y.shape
    _check_plane("y", y, (Fy, Hy, Wy), torch.uint16, y.device)
    out = _launch(y, mode, rchunk, Fy, Hy // 16, Wy)
    relayout_probe_cuda.launches += 1
    return out


relayout_probe_cuda.launches = 0


def relayout5d_probe_cuda(y5, *, mode: str) -> torch.Tensor:
    """K10 on the card: ``mode`` "5d_passthrough" or "5d_transpose" on the
    (F, R, 16, C, 16) view of a uint16 CUDA plane.  That view is the natural
    plane's memory, and the two forms compute what K9's passthrough and
    rchunk-1 relayout compute, so they launch those instances; returns the
    (F, R, 16, C, 16) result.  Adds one to ``relayout5d_probe_cuda.launches``
    per launch."""
    if y5.dim() != 5 or y5.shape[2] != 16 or y5.shape[4] != 16:
        raise ValueError(f"y5 must be (F, R, 16, C, 16), got "
                         f"{tuple(y5.shape)}")
    if mode not in MODES_5D:
        raise ValueError(f"unknown mode {mode!r}: expected one of "
                         f"{list(MODES_5D)}")
    Fy, Ry, _, Cy, _ = y5.shape
    _check_plane("y5", y5, tuple(y5.shape), torch.uint16, y5.device)
    out = _launch(y5, MODES_5D[mode], 1, Fy, Ry, 16 * Cy)
    relayout5d_probe_cuda.launches += 1
    return out


relayout5d_probe_cuda.launches = 0


def make_step(mode: str, rchunk: int = 1):
    """One probe step ``y -> (y ^ 1,)`` for ``mode`` (K9's on the natural
    plane, K10's on the 5-D view): the kernel on CUDA tensors, :func:`plain`
    on CPU tensors."""
    def step(y):
        if y.device.type == "cpu":
            return (plain(mode, y, rchunk),)
        if mode in MODES_5D:
            return (relayout5d_probe_cuda(y, mode=mode),)
        return (relayout_probe_cuda(y, mode=mode, rchunk=rchunk),)

    return step


def bound(y) -> tuple[float, str]:
    """(ms, "bytes"): the least time an H100 SXM could take for one step on
    ``y``: y read once and written once at 3.35 TB/s (data sheet)."""
    return 1e3 * 2 * y.numel() * y.element_size() / hz.HBM_BYTES_S, "bytes"


def occupancy(mode: str, rchunk: int, width: int) -> tuple[int, int]:
    """(dynamic shared memory bytes per thread block, thread blocks per SM)
    of ``mode``'s instance at ``width``, from the card's occupancy
    calculator.  Builds the kernel; needs a card."""
    lib = _kernels.load("probe_relayout")
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.vfg_probe_relayout_info(MODES[mode], rchunk, width,
                                     ctypes.byref(smem), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"probe_relayout occupancy query failed: CUDA "
                           f"error {rc}")
    return smem.value, blocks.value


def time_library(y) -> dict:
    """Time the torch round trip (checked == y ^ 1) and ``_tile`` alone on
    the card, ms per call; prints one line."""
    trip = hz.chain_ms(lambda yy: (tile_round_trip(yy),), (y,), ())
    tile = hz.chain_ms(lambda yy: (tile_only(y),), (y,), ())
    exact = bool(torch.equal(tile_round_trip(y), passthrough_plain(y)))
    print(f"  library: _untile(_tile(y) ^ 1) {trip:.4f} ms (exact: "
          f"{exact}), _tile alone {tile:.4f} ms", flush=True)
    return dict(round_trip=trip, tile=tile, exact=exact)
