"""The batched grain step: the hand-written CUDA kernels and their plain
versions.

Port of the JAX package's ops/grain_natural.py.  ``add_grain_batch_natural``
grains (Y, U, V) for a batch of frames, ``add_grain_shard_natural`` one
(frames x block rows) shard of it (parallel/mesh.py):

* on CUDA tensors it launches csrc/grain_natural.cu once per plane
  (the counterpart of the TPU kernel ``_fused_pallas``), fed either the
  state lattice (block granularity, decoded per pixel in the kernel) or
  lane words (one packed word per column, the TPU kernel's stream input);
  the lane words come from csrc/expand_words.cu (the counterpart of
  ``_expand_words_pallas``) or from the plain torch expansion;
* on CPU tensors it runs the plain torch version (ops/grain_ref.py,
  batched), which is also what the kernels are compared against on the
  card.

The TPU kernel's one-hot window fetch, byte-packed one-hot, LUT-dot and
piecewise-linear LUT paths exist because the TPU has slow gathers and no
sub-32-bit compares; a Hopper kernel reads the pattern bank and the
256-entry LUTs from shared memory directly, so none of them is here.  The
lane-word transports are (``word_expand``), because they are the TPU
kernel's inputs.

The config tables are runtime tensors (:func:`natural_tables`): a config
switch uploads new tables and builds nothing.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _kernels
from . import lfsr
from ..utils import tracing
from .grain_ref import lane_offsets, plane_grain_lanes
from .offsets import block_offsets


def natural_tables(regs, device) -> dict:
    """Device copy of what the kernel reads from the register file.

    ``pattern``: (2, 8, 64, 64) int8 banks (luma, chroma); ``slut``/``plut``:
    (3, 256) uint8; ``scalars``: int32 [scale_shift, y_min, y_max, c_min,
    c_max]; the chroma block geometry; and ``zero_scale``, per component,
    whether its scale LUT is identically zero.  Such a component gets grain
    exactly 0 (the rounding bias vanishes under a scale shift >= 1), so its
    plane is clip(x) -- the common luma-only case, where SEI init leaves
    both chroma sLUTs zero (models/fw.py).
    """
    if int(np.max(regs.plut)) >> 4 >= 8:
        raise ValueError("pattern LUT selects a pattern index above 7")
    dev = torch.device(device)
    # torch.tensor copies: the tables must not alias the live register file,
    # which the next config switch overwrites.
    return dict(
        pattern=torch.tensor(regs.pattern, device=dev),
        slut=torch.tensor(regs.slut, device=dev),
        plut=torch.tensor(regs.plut, device=dev),
        scalars=torch.tensor([regs.scale_shift, regs.y_min, regs.y_max,
                              regs.c_min, regs.c_max], dtype=torch.int32,
                             device=dev),
        zero_scale=tuple(bool(np.all(regs.slut[c] == 0)) for c in range(3)),
        bh_c=16 // regs.csuby, bw_c=16 // regs.csubx,
        n_ov_c=1 if regs.csuby == 2 else 2,
    )


def _lattice(bases, y: torch.Tensor) -> torch.Tensor:
    _, Hp, Wp = y.shape
    return lfsr.state_lattice_torch(bases, Hp // 16, Wp // 16, y.device)


def _grain_planes_plain(planes, words, words_up, tables: dict, ov_mask=None,
                       *, bs: int, csubx: int, csuby: int):
    """Plain version of :func:`grain_plane_cuda` on (Y, U, V).  ``words[c]``
    / ``words_up[c]``: plane c's words of each block row and of the row
    above it, (F, R, C) lattice words or (F, R, 1, Wp) lane words."""
    geo = dict(csubx=csubx, csuby=csuby)
    sc = tables["scalars"]
    out = []
    for c, plane in enumerate(planes):
        lo, hi = (sc[1], sc[2]) if c == 0 else (sc[3], sc[4])
        offs = [(lane_word_offsets if w.dim() == 4 else lane_offsets)(
            w, c, **geo) for w in (words[c], words_up[c])]
        out.append(plane_grain_lanes(
            plane, *offs, tables["pattern"][1 if c else 0],
            tables["slut"][c], tables["plut"][c], sc[0], lo, hi, ov_mask,
            c=c, bs=bs, **geo))
    return tuple(out)


def _rows_above(words):
    """Each block row's upper-row words: the previous row; row 0 is a copy
    of itself, never read where a frame's first block row does not blend
    (vfgs_hw.c overlap applies for y > 15 only)."""
    return torch.cat([words[:, :1], words[:, :-1]], dim=1)


def add_grain_batch_plain(y, u, v, bases, tables: dict, *, bs: int,
                          csubx: int, csuby: int):
    """Plain torch version of the kernel, on any device.

    y: (F, R*16, C*16); u, v: (F, R*bh_c, C*bw_c); uint8 or uint16.
    ``bases``: F uint32 lattice bases (ops/lfsr.py).  Returns new planes.
    """
    with tracing.span("grain.prep"):
        lat = _lattice(bases, y)
        lat_up = _rows_above(lat)
    with tracing.span("grain.kernels"):
        return _grain_planes_plain((y, u, v), [lat] * 3, [lat_up] * 3,
                                   tables, bs=bs, csubx=csubx, csuby=csuby)


def _as_int32_words(lat: torch.Tensor) -> torch.Tensor:
    """int64 lattice values in [0, 2^32) -> int32 tensor of the same bits."""
    return (lat - ((lat >> 31) << 32)).to(torch.int32).contiguous()


def _check_plane(name, p, shape, dtype, device):
    if p.device != device or p.dtype != dtype or tuple(p.shape) != shape:
        raise ValueError(f"{name}: expected {tuple(shape)} {dtype} on {device}, "
                         f"got {tuple(p.shape)} {p.dtype} on {p.device}")
    if not p.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_batch(y, u, v, bases, tables, height, width):
    """Check a batch's padded planes against its geometry and frame count
    (both engines' batched steps); returns (R, C)."""
    F, Hp, Wp = y.shape
    R, C = -(-height // 16), -(-width // 16)
    if (Hp, Wp) != (R * 16, C * 16):
        raise ValueError(f"luma plane {Hp}x{Wp} is not {height}x{width} "
                         f"padded to whole 16x16 blocks")
    cshape = (F, R * tables["bh_c"], C * tables["bw_c"])
    for name, p in (("u", u), ("v", v)):
        _check_plane(name, p, cshape, y.dtype, y.device)
    if y.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"planes must be uint8 or uint16, got {y.dtype}")
    if len(bases) != F:
        raise ValueError(f"{len(bases)} bases for {F} frames")
    return R, C


# ---------------------------------------------------------------------------
# Lane words: the TPU kernel's per-column input (JAX grain_natural.py:755-899)
# ---------------------------------------------------------------------------

def _block_words(lat, c: int, csubx: int, csuby: int):
    """Packed per-block kernel word of component c, (F, R, C) int32, and the
    plane's block width ``bw``.  Bits 0-9 hold the base ``t`` of the
    block's first lane, ``t = (oy / ymul) * KC + ox`` with ``KC = 16 *
    xmul``; bit 10 is sign < 0.  Lane x's word is
    ``block_word[x >> log2(bw)] + (x & (bw - 1))``: the in-block column
    never carries into bit 10 (``ox + bw - 1 < KC`` in every geometry)."""
    subx = csubx if c else 1
    suby = csuby if c else 1
    bw = 16 // subx
    ymul, xmul = 4 // suby, 4 // subx
    s, ox, oy = block_offsets(lat, c, csubx, csuby)
    baset = (oy // ymul) * (16 * xmul) + ox
    return (baset | ((s < 0).to(torch.int32) << 10)).to(torch.int32), bw


def _lane_words_xla(wblk, bw: int):
    """Block words (F, R, C) -> lane words (F, R, 1, C*bw) by a broadcast
    add (the JAX package's XLA transport)."""
    F, R, C = wblk.shape
    i = torch.arange(bw, dtype=torch.int32, device=wblk.device)
    return (wblk[..., None] + i).reshape(F, R, 1, C * bw)


def expand_words_plain(wblks, bws):
    """Plain torch version of csrc/expand_words.cu: per-plane block words
    (F, R, C_p) int32 -> lane words (F, R, 1, C_p*bw_p) int32."""
    return [_lane_words_xla(w, bw) for w, bw in zip(wblks, bws)]


def lane_word_offsets(words, c: int, csubx: int, csuby: int):
    """Decode lane words (F, R, 1, Wp) into per-lane ``(sign, col, oy)``
    (F, R, Wp) int32 tensors -- what csrc/grain_natural.cu does per pixel
    with its stream input: ``t = w & 0x3FF``, ``oy = (t >> log2 KC) *
    ymul``, ``col = ox + x % bw = t & (KC - 1)``, sign from bit 10."""
    KC = 16 * (4 // (csubx if c else 1))
    ymul = 4 // (csuby if c else 1)
    w = words.reshape(words.shape[0], words.shape[1], -1)
    t = w & 0x3FF
    return (1 - 2 * ((w >> 10) & 1), t & (KC - 1),
            (t >> (KC.bit_length() - 1)) * ymul)


EXPAND_THREADS = 256        # csrc/expand_words.cu: threads a block
EXPAND_BLOCKS_PER_SM = 8   # of them resident on an SM (2,048 threads)


def expand_words_plan(rows: int, cols, bws, *, sms: int = 132) -> dict:
    """The launch plan of csrc/expand_words.cu for ``rows`` (frames x block
    rows) of each plane's ``cols[k]`` block words of width ``bws[k]``, on
    a card of ``sms`` SMs: grid (row_blocks, planes) of 256 threads, about
    one wave, each block taking ``rows_per_block`` rows (the last block of
    a plane fewer), a warp 32 block words of a row in ``passes`` passes
    and writing ``stores_per_word`` 16-byte quads for each word."""
    if not 1 <= len(cols) <= 3 or len(bws) != len(cols):
        raise ValueError(f"expand_words takes 1-3 planes, got {len(cols)} "
                         f"with {len(bws)} block widths")
    if rows < 1 or sms < 1 or min(cols) < 1 or any(b not in (8, 16)
                                                   for b in bws):
        raise ValueError(f"expected rows, block words and SMs >= 1 and bw "
                         f"8 or 16, got {rows} rows, {list(cols)} words, bws "
                         f"{list(bws)}, {sms} SMs")
    wave = sms * EXPAND_BLOCKS_PER_SM
    per = -(-rows * len(cols) // wave)       # rows a block, about one wave
    row_blocks = -(-rows // per)
    return dict(rows=rows, threads=EXPAND_THREADS,
                grid=(row_blocks, len(cols)),
                rows_per_block=-(-rows // row_blocks),
                passes=[-(-c // EXPAND_THREADS) for c in cols],
                stores_per_word=[b // 4 for b in bws],
                waves=row_blocks * len(cols) / wave)


def expand_words_cuda(wblks, bws):
    """Launch csrc/expand_words.cu once for every plane of ``wblks`` (one
    to three (F, R, C_p) int32 block-word tensors on one CUDA device, block
    widths ``bws``) with :func:`expand_words_plan`'s grid; returns the (F,
    R, 1, C_p*bw_p) int32 lane words.  Adds one to
    ``expand_words_cuda.launches`` per launch."""
    if not 1 <= len(wblks) <= 3 or len(bws) != len(wblks):
        raise ValueError(f"expand_words_cuda takes 1-3 planes, got "
                         f"{len(wblks)} with {len(bws)} block widths")
    dev = wblks[0].device
    F, R = wblks[0].shape[:2]
    for k, (w, bw) in enumerate(zip(wblks, bws)):
        if w.dim() != 3 or bw not in (8, 16):
            raise ValueError(f"plane {k}: expected (F, R, C) block words and "
                             f"bw 8 or 16, got {tuple(w.shape)}, bw {bw}")
        _check_plane(f"block words {k}", w, (F, R, w.shape[2]), torch.int32,
                     dev)
    if dev.type != "cuda":
        raise ValueError(f"expand_words_cuda needs CUDA tensors, got {dev}")
    plan = expand_words_plan(
        F * R, [w.shape[2] for w in wblks], bws,
        sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    args, outs = [], []
    for w, bw in zip(wblks, bws):
        C = w.shape[2]
        out = torch.empty((F, R, 1, C * bw), dtype=torch.int32, device=dev)
        outs.append(out)
        args += [w.data_ptr(), out.data_ptr(), C, bw]
    args += [None, None, 0, 0] * (3 - len(wblks))
    lib = _kernels.load("expand_words")
    rc = lib.vfg_expand_words(
        len(wblks), F * R, plan["grid"][0], *args,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"expand_words kernel launch failed: CUDA error "
                           f"{rc}")
    expand_words_cuda.launches += 1
    return outs


expand_words_cuda.launches = 0


# Default lane-word transport of the port.  "kernel" (block-granular
# words, expanded inside the grain kernel) is what csrc/grain_natural.cu
# does with the state lattice: it reads about 1 MB of lattice per 4K batch
# instead of 33 MB of lane words.  "chunk" names the same input here.
# "xla" and "pallas" feed the kernel lane words (the TPU kernel's stream
# input), expanded by plain torch or by csrc/expand_words.cu.
WORD_EXPAND = "kernel"
_WORD_MODES = ("xla", "pallas", "kernel", "chunk")


def _word_mode(word_expand) -> str:
    mode = word_expand or WORD_EXPAND
    if mode not in _WORD_MODES:
        raise ValueError(f"word_expand must be one of {_WORD_MODES} or None, "
                         f"got {word_expand!r}")
    return mode


def _lane_words3(lat, csubx: int, csuby: int, *, expand: str = "xla",
                 active=(True, True, True)):
    """All three planes' lane words (F, R, 1, C*bw_p) int32 from the (F, R,
    C) state lattice.

    ``expand``: "xla" (plain torch) or "pallas" (csrc/expand_words.cu in one
    launch for every active plane; its plain version on the CPU).  The
    block-granular modes never build lane words.  ``active``: planes whose
    scale LUT is identically zero never read their words -- they get a
    zeros placeholder, and with no active plane nothing is launched."""
    if expand not in ("xla", "pallas"):
        raise ValueError(f"lane words are built by 'xla' or 'pallas', not "
                         f"{expand!r}")
    F, R, C = lat.shape
    bws = [16 // (csubx if c else 1) for c in range(3)]
    idx = [c for c in range(3) if active[c]]
    blk = [_block_words(lat, c, csubx, csuby)[0] for c in idx]
    plain = expand == "xla" or lat.device.type == "cpu"
    expand_fn = expand_words_plain if plain else expand_words_cuda
    words = dict(zip(idx, expand_fn(blk, [bws[c] for c in idx]))) \
        if idx else {}
    return [words[c] if c in words else
            torch.zeros((F, R, 1, C * bws[c]), dtype=torch.int32,
                        device=lat.device)
            for c in range(3)]


# ---------------------------------------------------------------------------
# The grain kernel
# ---------------------------------------------------------------------------

def grain_plane_cuda(pix, words, tables: dict, *, c: int, csubx: int,
                     csuby: int, bs: int, up0=None,
                     blend0: bool = False) -> torch.Tensor:
    """Launch csrc/grain_natural.cu on one plane of F frames; returns the new
    plane.

    ``pix``: (F, R*bh, C*bw) uint8/uint16 on a CUDA device.  ``words``:
    (F, R, C) int32 lattice words, or (F, R, 1, C*bw) int32 lane words (the
    TPU kernel's stream input).  ``up0`` (shard boot): the upper block row
    of each frame's first local row, in the same form with R = 1; with
    ``blend0`` that row blends from it, else a frame's first row does not
    blend.  Adds one to ``grain_plane_cuda.launches`` per launch, and to
    ``grain_plane_cuda.boot_launches`` when ``blend0`` is set."""
    dev = pix.device
    if dev.type != "cuda":
        raise ValueError(f"grain_plane_cuda needs CUDA tensors, got {dev}")
    if pix.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"planes must be uint8 or uint16, got {pix.dtype}")
    bh, bw = 16 // (csuby if c else 1), 16 // (csubx if c else 1)
    F, R = words.shape[:2]
    C = pix.shape[2] // bw
    lane = words.dim() == 4
    tail = (1, C * bw) if lane else (C,)
    _check_plane(f"plane {c}", pix, (F, R * bh, C * bw), pix.dtype, dev)
    _check_plane("words", words, (F, R) + tail, torch.int32, dev)
    if up0 is not None:
        _check_plane("up0", up0, (F, 1) + tail, torch.int32, dev)
    elif blend0:
        raise ValueError("blend0 needs the upper row's words (up0)")
    for k in ("pattern", "slut", "plut", "scalars"):
        if tables[k].device != dev or not tables[k].is_contiguous():
            raise ValueError(f"tables[{k!r}] must be contiguous on {dev}")
    pattern = tables["pattern"][1 if c else 0]
    if pattern.data_ptr() % 16:
        raise ValueError("pattern bank must be 16-byte aligned")
    if pix.data_ptr() % (8 * pix.element_size()):
        # a thread moves 8 samples as one vector: take a plane that starts
        # off that grid (a view into a larger buffer) into a fresh one
        pix = pix.clone()
    lib = _kernels.load("grain_natural")
    out = torch.empty_like(pix)
    rc = lib.vfg_grain_plane(
        pix.data_ptr(), out.data_ptr(), pix.element_size(),
        words.data_ptr(), int(lane),
        None if up0 is None else up0.data_ptr(), int(blend0),
        pattern.data_ptr(), tables["slut"][c].data_ptr(),
        tables["plut"][c].data_ptr(), tables["scalars"].data_ptr(),
        F, R, C, c, csubx, csuby, bs, int(tables["zero_scale"][c]),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"grain_natural kernel launch failed: CUDA error "
                           f"{rc}")
    grain_plane_cuda.launches += 1
    grain_plane_cuda.boot_launches += int(blend0)
    return out


grain_plane_cuda.launches = 0
grain_plane_cuda.boot_launches = 0


def grain_plane_info(elem_bytes: int, lane: bool) -> dict:
    """Registers per thread, static shared memory bytes per thread block,
    local memory bytes per thread (stack and spills) and thread blocks per
    SM (the CUDA occupancy calculator) of csrc/grain_natural.cu's instance
    for ``elem_bytes`` (1 or 2) and lattice or lane words.  Builds the
    kernel; needs a card."""
    return _kernels.kernel_info(
        _kernels.load("grain_natural").vfg_grain_plane_info, elem_bytes,
        int(lane))


def _active(tables: dict):
    return tuple(not z for z in tables["zero_scale"])


def add_grain_batch_natural(y, u, v, bases, bases_up, tables: dict, *,
                            height: int, width: int, bs: int, csubx: int,
                            csuby: int, word_expand: str | None = None):
    """Batched whole-frame grain (signature of the JAX function).

    y: (F, R*16, C*16); u, v: (F, R*bh_c, C*bw_c), uint8 or uint16, padded
    from height x width.  ``bases``: F uint32 lattice bases.  ``bases_up``
    is accepted for interface parity but unused: a frame's first block row
    never blends, and every other row's upper lattice row is the previous
    row of the same lattice.

    ``word_expand`` picks what the kernel reads per block row:

    * None (:data:`WORD_EXPAND`), "kernel", "chunk": the state lattice, one
      word per block, decoded per pixel inside the kernel -- what the TPU
      kernel's block-granular modes do;
    * "xla": lane words, one per column, from the plain torch expansion;
    * "pallas": lane words from csrc/expand_words.cu (one launch per step).

    CUDA tensors launch the kernels (or raise).  CPU tensors take the plain
    version in every mode; "xla" and "pallas" then decode the offsets from
    the lane words.  Every mode gives the same pixels.
    """
    del bases_up
    mode = _word_mode(word_expand)
    dev = y.device
    _check_batch(y, u, v, bases, tables, height, width)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no grain kernel for device {dev}")
    geo = dict(csubx=csubx, csuby=csuby)
    with tracing.span("grain.prep"):
        lat = _lattice(bases, y)
        if mode in ("kernel", "chunk"):
            words = [_as_int32_words(lat)] * 3
        else:
            words = _lane_words3(lat, expand=mode, active=_active(tables),
                                 **geo)
        if dev.type == "cpu":
            words_up = [_rows_above(w) for w in words]
    with tracing.span("grain.kernels"):
        if dev.type == "cpu":
            return _grain_planes_plain((y, u, v), words, words_up, tables,
                                       bs=bs, **geo)
        return tuple(grain_plane_cuda(p, words[c], tables, c=c, bs=bs, **geo)
                     for c, p in enumerate((y, u, v)))


def add_grain_shard_natural(y, u, v, states, states_up, ov_mask,
                            tables: dict, *, bs: int, csubx: int, csuby: int,
                            word_expand: str | None = None):
    """Per-shard step (signature of the JAX function; parallel/mesh.py).

    y, u, v: the shard's (F, R_local*bh, C*bw) planes.  ``states``: the
    shard's (F, R_local, C) lattice (int64 values in [0, 2^32), ops/lfsr.py);
    ``states_up``: its upper-row lattice, of which only row 0 is read (every
    later row's upper row is the previous row of ``states``).  ``ov_mask``:
    (R_local,) bool; its first entry says whether the shard's first block
    row blends (tile shards below the frame top do), every later entry must
    be True, as the kernel blends every row below the first.  Zero halo:
    the boot row's samples come from ``states_up``, not from pixels.

    ``word_expand`` as in :func:`add_grain_batch_natural`.  The boot row is
    the lattice row, or its lane words from the plain expansion.  CUDA
    tensors launch the kernel with the boot row; CPU tensors run the plain
    version with ``ov_mask``.
    """
    mode = _word_mode(word_expand)
    dev = y.device
    F, R, C = states.shape
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no grain kernel for device {dev}")
    if y.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"planes must be uint8 or uint16, got {y.dtype}")
    _check_plane("y", y, (F, R * 16, C * 16), y.dtype, dev)
    cshape = (F, R * tables["bh_c"], C * tables["bw_c"])
    for name, p in (("u", u), ("v", v)):
        _check_plane(name, p, cshape, y.dtype, dev)
    if states_up.dim() != 3 or tuple(states_up.shape[::2]) != (F, C) \
            or states_up.shape[1] < 1:
        raise ValueError(f"states_up: expected (F, >=1, C) = ({F}, ., {C}), "
                         f"got {tuple(states_up.shape)}")
    ov = torch.as_tensor(ov_mask, dtype=torch.bool).cpu()
    if tuple(ov.shape) != (R,) or not bool(ov[1:].all()):
        raise ValueError(f"ov_mask: expected ({R},) bool, True after the "
                         f"first entry, got {ov.tolist()}")
    blend0 = bool(ov[0])
    geo = dict(csubx=csubx, csuby=csuby)
    up_row = states_up[:, :1]
    if mode in ("kernel", "chunk"):
        words = [_as_int32_words(states)] * 3
        words_up = [_as_int32_words(up_row)] * 3
    else:
        words = _lane_words3(states, expand=mode, active=_active(tables),
                             **geo)
        # One block row per frame: the plain expansion, as in JAX.
        words_up = [_lane_words_xla(*_block_words(up_row, c, **geo))
                    for c in range(3)]
    if dev.type == "cpu":
        return _grain_planes_plain(
            (y, u, v), words,
            [torch.cat([wu, w[:, :-1]], dim=1)
             for w, wu in zip(words, words_up)], tables, ov, bs=bs, **geo)
    return tuple(grain_plane_cuda(p, words[c], tables, c=c, bs=bs,
                                  up0=words_up[c], blend0=blend0, **geo)
                 for c, p in enumerate((y, u, v)))
