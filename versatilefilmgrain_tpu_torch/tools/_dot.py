"""What the three one-hot dot probes share: K6 (probe_dot), K7 (probe_dot2)
and K8 (probe_dotscale).

On the TPU the grain kernel fetched its pattern windows as a one-hot matrix
product on the matrix unit, and these probes measured what that product
costs.  For every (frame, 16-line block row) of a uint16 plane ``y`` they
write ``clip(y + s, 0, hi)``, where ``s`` sums row slices of 16 of a
candidate matrix (see csrc/probe_dot.cu for none, gather and build, and
csrc/probe_dotconst.cu for the persistent wgmma products: K6's int8, bf16
and f32 (TF32) one-hot products and the dense product of dotconst and K8).
Here are their shapes, their seeded inputs (drawn in the order of each JAX
probe's ``main``), the plain torch versions of every mode, the wrapper of
both kernels, and the work schedule and TF32 row groups of the persistent
one.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes

import numpy as np
import torch

from ..ops import _kernels
from ..ops.grain_natural import _check_plane
from . import _harness as hz

K, M = 768, 144                   # one-hot depth, pattern rows
F, H, W = hz.FRAMES_BATCH, hz.H, hz.W
CLIP_HI = 1023 << 2               # K6, K7
CLIP_HI_SCALE = 4095              # K8
ROWS_K6 = (18, 8)                 # slice stride and count: rows 18p + i
SCALE_MS = (16, 64, 128, 144, 160, 256)
MODES = {"none": 0, "int8": 1, "bf16": 2, "f32": 3, "gather": 4,
         "build": 5, "dotconst": 6}
ONEHOT_MODES = ("int8", "bf16", "f32", "gather")
# The modes of csrc/probe_dotconst.cu, by the source of its A operand: the
# constant oh_t, or the one-hot of t built in int8, bf16 or TF32 registers.
WGMMA_SRC = {"dotconst": 0, "int8": 1, "bf16": 2, "f32": 3}
# The inputs besides y that each mode reads ("oh": the constant matrix).
READS = {"none": (), "build": ("t",), "dotconst": ("pat", "oh"),
         **{m: ("t", "pat") for m in ONEHOT_MODES}}
# H100 SXM data sheet (dense): operations/s per input type.
PEAK_OPS_S = {"int8": 1979e12, "dotconst": 1979e12, "bf16": 989e12,
              "f32": 495e12}


def scale_rows(m: int) -> tuple[int, int]:
    """K8's slices: every 16 rows of the (m, W) product."""
    return (16, m // 16)


def _draw_yt(rng, frames, height, width):
    y = rng.integers(0, 1024, (frames, height, width), np.uint16)
    t = rng.integers(0, K, (frames, height // 16, 1, width), np.int32)
    return y, t


def _tensors(arrays, device):
    return tuple(torch.from_numpy(a).to(device) for a in arrays)


def dot_inputs(seed: int = 0, frames: int = F, height: int = H,
               width: int = W, device="cpu"):
    """K6's (y, t, pat), drawn as tools/probe_dot.py's main draws them."""
    rng = np.random.default_rng(seed)
    y, t = _draw_yt(rng, frames, height, width)
    pat = rng.integers(-128, 128, (M, K), np.int8)
    return _tensors((y, t, pat), device)


def dot2_inputs(seed: int = 0, frames: int = F, height: int = H,
                width: int = W, device="cpu"):
    """K7's (y, t, pat, constoh): K6's, then the constant 0/1 matrix
    (K, width), about 25% ones, as tools/probe_dot2.py's main draws it."""
    rng = np.random.default_rng(seed)
    y, t = _draw_yt(rng, frames, height, width)
    pat = rng.integers(-128, 128, (M, K), np.int8)
    constoh = (rng.integers(0, 2, (K, width))
               * rng.integers(0, 2, (K, width))).astype(np.int8)
    return _tensors((y, t, pat, constoh), device)


def dotscale_inputs(seed: int = 0, frames: int = F, height: int = H,
                    width: int = W, ms=SCALE_MS, device="cpu"):
    """K8's (y, oh, {m: pat}): y, the 50%-ones matrix (K, width), then one
    (m, K) pattern per m in order, as tools/probe_dotscale.py's main draws
    them."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 1024, (frames, height, width), np.uint16)
    oh = rng.integers(0, 2, (K, width)).astype(np.int8)
    pats = {m: rng.integers(-128, 128, (m, K), np.int8) for m in ms}
    y, oh = _tensors((y, oh), device)
    return y, oh, {m: torch.from_numpy(p).to(device) for m, p in pats.items()}


# -- plain versions (torch, any device, int32 sums) ---------------------------

@contextlib.contextmanager
def _exact_f32():
    """float32 products in full float32, never TF32."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _slice_sum(cand, rows):
    """Sum of the row slices ``cand[..., p*stride : p*stride + 16, :]``."""
    stride, slices = rows
    return sum(cand[..., p * stride:p * stride + 16, :]
               for p in range(slices))


def _clip(y, s, clip_hi):
    """clip(y + s, 0, clip_hi) as y's type; ``s`` broadcasts against the
    (F, R, 16, W) view of y."""
    Fy, Hy, Wy = y.shape
    x = y.view(Fy, Hy // 16, 16, Wy).to(torch.int32) + s
    return torch.clamp(x, 0, clip_hi).to(y.dtype).view(Fy, Hy, Wy)


def _onehot(t_frame, dtype):
    """(R, K, W) one-hot of one frame's (R, 1, W) indices."""
    kio = torch.arange(K, dtype=torch.int32, device=t_frame.device)
    return (kio.view(K, 1) == t_frame).to(dtype)


def onehot_plain(y, t, pat, *, clip_hi=CLIP_HI, rows=ROWS_K6):
    """int8, bf16, f32 and gather: ``s`` from ``pat @ onehot`` per (frame,
    block row), one frame at a time.  The product runs in float32 and is
    exact: each entry is one value of ``pat`` (the one-hot has one 1 per
    column), an integer far below 2^24; TF32 is switched off around it."""
    out = torch.empty_like(y)
    patf = pat.to(torch.float32)
    with _exact_f32():
        for f in range(y.shape[0]):
            cand = torch.matmul(patf, _onehot(t[f], torch.float32))
            s = _slice_sum(cand, rows).to(torch.int32)
            out[f] = _clip(y[f:f + 1], s[None], clip_hi)[0]
    return out


def build_plain(y, t, *, clip_hi=CLIP_HI, rows=ROWS_K6):
    """build: the (K, W) one-hot of each block row, the sum of its 8 row
    slices 96q .. 96q + 15, stacked M // 16 times and summed over ``rows``'
    slices, literally as the TPU build mode does; one frame at a time."""
    out = torch.empty_like(y)
    for f in range(y.shape[0]):
        onehot = _onehot(t[f], torch.bool)
        s8 = sum(onehot[:, q * 96:q * 96 + 16].to(torch.int32)
                 for q in range(8))
        cand = torch.cat([s8] * (M // 16), dim=1)
        out[f] = _clip(y[f:f + 1], _slice_sum(cand, rows)[None], clip_hi)[0]
    return out


def dotconst_plain(y, pat, oh, *, rows=ROWS_K6, clip_hi=CLIP_HI):
    """dotconst (K7) and K8: ``s`` from ``pat @ oh``, the same for every
    (frame, block row).  The product runs in float32 and is exact: every
    partial sum is an integer of magnitude at most 128 * 768 < 2^24; TF32
    is switched off around it."""
    with _exact_f32():
        cand = torch.matmul(pat.to(torch.float32), oh.to(torch.float32))
    return _clip(y, _slice_sum(cand, rows).to(torch.int32), clip_hi)


def none_plain(y, *, clip_hi=CLIP_HI):
    """none: clip(y, 0, clip_hi)."""
    return torch.clamp(y.to(torch.int32), 0, clip_hi).to(y.dtype)


def plain(mode, y, t=None, pat=None, oh=None, *, clip_hi=CLIP_HI,
          rows=ROWS_K6):
    """The plain version of ``mode`` on any device."""
    if mode == "none":
        return none_plain(y, clip_hi=clip_hi)
    if mode in ONEHOT_MODES:
        return onehot_plain(y, t, pat, clip_hi=clip_hi, rows=rows)
    if mode == "build":
        return build_plain(y, t, clip_hi=clip_hi, rows=rows)
    if mode == "dotconst":
        return dotconst_plain(y, pat, oh, rows=rows, clip_hi=clip_hi)
    raise ValueError(f"unknown mode {mode!r}: expected one of {list(MODES)}")


# -- the kernels --------------------------------------------------------------

DOTCONST_COLS = 64    # columns of W in one work item of the wgmma kernel


def dotconst_schedule(frames: int, rows: int, width: int,
                      ctas: int) -> list[tuple[int, int]]:
    """The work ranges of csrc/probe_dotconst.cu (every mode of
    :data:`WGMMA_SRC`), in the kernel's own arithmetic: the items are
    (64-column tile, strip), numbered tile first (``item = tile * frames *
    rows + strip``), and thread block ``b`` of ``ctas`` takes items
    ``[total b // ctas, total (b + 1) // ctas)``."""
    total = -(-width // DOTCONST_COLS) * frames * rows
    return [(total * b // ctas, total * (b + 1) // ctas)
            for b in range(ctas)]


def tf32_row_groups() -> torch.Tensor:
    """The banks of csrc/probe_dotconst.cu's TF32 instance, in the kernel's
    own arithmetic: (2, 9, 8) int64, ``groups[g, i', p]`` the pattern row
    that group ``g`` stages as its bank row ``8 i' + p``: ``stride p + 9 g +
    i'``, slice ``p`` of line ``9 g + i'``.  The f32 bank of all 144 rows
    does not fit in shared memory; each group's 72 rows do, and hold whole
    lines, so a thread block stages group 0, walks its items, restages with
    group 1 and walks them again, and no partial sum crosses groups.  Group
    1's lines 16 and 17 (rows 18p + 16, 18p + 17) are computed, as the TPU
    computed them, and fold nowhere."""
    stride, slices = ROWS_K6
    lines = M // slices // 2      # 9 a group
    g, i, p = torch.meshgrid(torch.arange(2), torch.arange(lines),
                             torch.arange(slices), indexing="ij")
    return stride * p + lines * g + i


def dotconst_info(m: int, rows, mode: str = "dotconst") -> dict:
    """Registers, dynamic shared memory bytes, local memory bytes (stack
    and spills) a thread and thread blocks per SM of the csrc/probe_dotconst.cu
    instance for (m, rows) of ``mode`` (dotconst, or K6's int8, bf16 or
    f32); builds the library on first use."""
    if mode not in WGMMA_SRC:
        raise ValueError(f"{mode} does not run csrc/probe_dotconst.cu: "
                         f"expected one of {list(WGMMA_SRC)}")
    _kernel_shape(mode, m, rows)
    lib = _kernels.load("probe_dotconst")
    vals = [ctypes.c_int(0) for _ in range(4)]
    rc = lib.vfg_probe_dotconst_info(WGMMA_SRC[mode], m, rows[0], rows[1],
                                     *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"probe_dotconst info failed: CUDA error {rc}")
    return dict(zip(("registers", "smem", "local_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


def _kernel_shape(mode, m, rows):
    """Raise unless a kernel has an instance for (mode, m, rows)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}: expected one of "
                         f"{list(MODES)}")
    ok = (m, tuple(rows)) == (M, ROWS_K6)
    if mode == "dotconst":
        ok = ok or (m in SCALE_MS and tuple(rows) == scale_rows(m))
    if not ok:
        raise ValueError(f"no {mode} instance for {m} pattern rows and "
                         f"slices {tuple(rows)}")


def dot_probe_cuda(y, t=None, pat=None, oh_t=None, *, mode: str,
                   clip_hi: int = CLIP_HI, rows=ROWS_K6,
                   strips: int = 1) -> torch.Tensor:
    """Launch the kernel of ``mode`` on CUDA tensors; returns the new
    plane.  ``y``: (F, 16R, W) uint16; ``t``: (F, R, 1, W) int32 (an index
    outside [0, K) matches no one-hot row, as in the plain versions);
    ``pat``: (m, K) int8, 16-byte aligned; ``oh_t``: (W, K) int8, the
    constant matrix transposed; each where :data:`READS` says ``mode`` reads
    it.  ``rows``: slice stride and count.  none, gather and build run
    csrc/probe_dot.cu, where ``strips`` is the block rows per thread block
    (the bank is staged once for them).  dotconst, int8, bf16 and f32
    (:data:`WGMMA_SRC`) run csrc/probe_dotconst.cu on a persistent grid
    that schedules the strips itself (:func:`dotconst_schedule`; f32 walks
    it once per row group, :func:`tf32_row_groups`, in the same launch):
    they take ``strips`` = 1 only and refuse any other, and need W a
    multiple of 8 and ``y`` (and dotconst's ``oh_t``) 16-byte aligned.
    Adds one to ``dot_probe_cuda.launches`` and to
    ``dot_probe_cuda.by_mode[mode]`` per launch."""
    dev = y.device
    if y.dim() != 3 or y.shape[1] % 16:
        raise ValueError(f"y must be (F, 16R, W), got {tuple(y.shape)}")
    Fy, Hy, Wy = y.shape
    R = Hy // 16
    m = M if pat is None else pat.shape[0]
    _kernel_shape(mode, m, rows)
    reads = READS[mode]
    for name, x in (("t", t), ("pat", pat), ("oh", oh_t)):
        if name in reads and x is None:
            raise ValueError(f"mode {mode} needs {name}")
    _check_plane("y", y, (Fy, Hy, Wy), torch.uint16, dev)
    if "t" in reads:
        _check_plane("t", t, (Fy, R, 1, Wy), torch.int32, dev)
    if "pat" in reads:
        _check_plane("pat", pat, (m, K), torch.int8, dev)
        if pat.data_ptr() % 16:
            raise ValueError("pat must be 16-byte aligned")
    if "oh" in reads:
        _check_plane("oh_t", oh_t, (Wy, K), torch.int8, dev)
    if strips < 1 or not 0 <= clip_hi <= 0xFFFF:
        raise ValueError(f"strips {strips} or clip_hi {clip_hi} out of "
                         f"range")
    if mode in WGMMA_SRC:
        if strips != 1:
            raise ValueError(f"strips {strips}: {mode} schedules its "
                             f"strips on a persistent grid; pass 1")
        if Wy % 8:
            raise ValueError(f"{mode} needs a width that is a multiple "
                             f"of 8, got {Wy}")
        for name, x in (("y", y), ("oh_t", oh_t)):
            if x is not None and x.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")
    if dev.type != "cuda":
        raise ValueError(f"dot_probe_cuda needs CUDA tensors, got {dev}")
    out = torch.empty_like(y)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    if mode in WGMMA_SRC:
        lib = _kernels.load("probe_dotconst")
        a = oh_t if mode == "dotconst" else t
        rc = lib.vfg_probe_dotconst(WGMMA_SRC[mode], m, rows[0], rows[1],
                                    clip_hi, y.data_ptr(), out.data_ptr(),
                                    pat.data_ptr(), a.data_ptr(), Fy, R, Wy,
                                    stream)
    else:
        lib = _kernels.load("probe_dot")
        rc = lib.vfg_probe_dot(MODES[mode], m, rows[0], rows[1], clip_hi,
                               y.data_ptr(), out.data_ptr(),
                               None if t is None else t.data_ptr(),
                               None if pat is None else pat.data_ptr(), Fy,
                               R, Wy, strips, stream)
    if rc != 0:
        raise RuntimeError(f"{mode} kernel launch failed: CUDA error {rc}")
    dot_probe_cuda.launches += 1
    dot_probe_cuda.by_mode[mode] += 1
    return out


dot_probe_cuda.launches = 0
dot_probe_cuda.by_mode = collections.Counter()


def make_step(mode, t=None, pat=None, oh=None, *, clip_hi=CLIP_HI,
              rows=ROWS_K6, strips=1):
    """One probe step ``y -> (y,)`` for ``mode``: the kernel on CUDA
    tensors, :func:`plain` on CPU tensors.  For dotconst on the card the
    kernel reads ``oh`` transposed, a (W, K) copy made here once, outside
    any timed chain."""
    oh_t = (oh.t().contiguous() if mode == "dotconst" and oh is not None
            and oh.device.type == "cuda" else None)

    def step(y):
        if y.device.type == "cpu":
            return (plain(mode, y, t, pat, oh, clip_hi=clip_hi, rows=rows),)
        return (dot_probe_cuda(y, t, pat, oh_t, mode=mode, clip_hi=clip_hi,
                               rows=rows, strips=strips),)

    return step


def bound(mode, y, t=None, pat=None, oh=None) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time an H100 SXM could take
    for one step of ``mode`` on these inputs, from its data-sheet rates:
    the larger of the bytes read and written once (y in and out, and t,
    pat, oh where the mode reads them) over 3.35 TB/s, and the product's
    2 m K W F R operations over the peak rate of its type (int8, bf16, TF32
    for f32)."""
    ins = {"t": t, "pat": pat, "oh": oh}
    nbytes = sum(x.numel() * x.element_size()
                 for x in (y, y, *(ins[n] for n in READS[mode])))
    byte_ms = 1e3 * nbytes / hz.HBM_BYTES_S
    if mode not in PEAK_OPS_S:
        return byte_ms, "bytes"
    Fy, Hy, Wy = y.shape
    ops = 2 * pat.shape[0] * K * Wy * Fy * (Hy // 16)
    op_ms = 1e3 * ops / PEAK_OPS_S[mode]
    return (op_ms, "operations") if op_ms > byte_ms else (byte_ms, "bytes")
