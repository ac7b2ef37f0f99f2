"""The tiled engine (``--engine pallas``): the hand-written CUDA kernel and its
plain version.

Port of the JAX package's ops/grain_pallas.py.  The TPU kernel
``_plane_pallas`` grains each (frame, 16-luma-line block row) strip of a
plane in the tiled layout ``(S, C)`` with ``S = bh*bw``: rows enumerate the
in-block pixel ``y*bw + i``, columns the block column.
:func:`add_grain_batch_pallas` computes per-block window indices and signs
(:func:`_offset_arrays`) and grains each plane:

* on CUDA tensors with csrc/grain_tiled.cu (:func:`plane_tiled_cuda`, the
  counterpart of ``_plane_pallas``), which reads and writes the natural
  plane: the step tiles and untiles nothing;
* on CPU tensors with :func:`plane_tiled_natural_plain`, which tiles the
  plane (:func:`_tile`), runs :func:`plane_tiled_plain` -- the TPU kernel's
  strip function in plain torch -- and untiles the result; it is also what
  the kernel is compared against on the card.

The TPU kernel fetches the 8 pattern candidates of every block's window with
a one-hot int8 matrix product, its stand-in for a gather.  Neither version
here does: the plain version indexes the window table, and the CUDA kernel
stages in shared memory, of each block's window, the candidates the
plane's LUT can select.  The window tables keep the window-major (156, 8,
rows, bw) layout of ``build_window_table``.

The config tables are runtime tensors (:func:`pallas_tables`): a config
switch uploads new tables and builds nothing.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _kernels
from . import lfsr
from ..utils import tracing
from .grain_fast import build_segments, build_window_table
from .grain_natural import _check_batch, _check_plane, _rows_above
from .offsets import block_offsets

N_WINDOWS = 12 * 13
_PACK_SHIFT = 9  # scale in bits 0..8, pattern index in bits 9..12
# (bh, bw, n_ov) of every plane the engine grains: luma and 4:4:4 chroma,
# 4:2:2 chroma, 4:2:0 chroma.
_GEOMETRIES = ((16, 16, 2), (16, 8, 2), (8, 8, 1))


def pallas_tables(regs, device) -> dict:
    """Device copy of the register file, packaged for the tiled engine.

    ``win_luma`` (156, 8, 16, 16) / ``win_luma_up`` (156, 8, 2, 16) and
    ``win_chroma`` / ``win_chroma_up`` at the chroma geometry: int8 window
    tables (``build_window_table``).  ``seg_starts`` / ``seg_deltas``: (3, S)
    int32 run-length code of each component's packed LUT, padded with zero
    deltas to a multiple of 8.  ``scalars``: int32 [scale_shift, y_min,
    y_max, c_min, c_max].  ``bh_c``, ``bw_c``, ``n_ov_c``: chroma geometry.
    """
    if int(np.max(regs.plut)) >> 4 >= 8:
        raise ValueError("pattern LUT selects a pattern index above 7")
    csubx, csuby = regs.csubx, regs.csuby
    win_l, win_l_up = build_window_table(regs.pattern[0], 16, 16, 2, 4, 4)
    bh_c, bw_c = 16 // csuby, 16 // csubx
    n_ov_c = 1 if csuby == 2 else 2
    win_c, win_c_up = build_window_table(regs.pattern[1], bh_c, bw_c, n_ov_c,
                                         4 // csuby, 4 // csubx)
    seg = [build_segments(regs.slut[c], regs.plut[c]) for c in range(3)]
    S = max(len(s) for s, _ in seg)
    S = -(-S // 8) * 8
    starts = np.zeros((3, S), np.int32)
    deltas = np.zeros((3, S), np.int32)
    for c, (s, d) in enumerate(seg):
        starts[c, :len(s)] = s
        deltas[c, :len(d)] = d
    dev = torch.device(device)
    # torch.tensor copies: the tables must not alias the live register file,
    # which the next config switch overwrites.
    return dict(
        win_luma=torch.tensor(win_l, device=dev),
        win_luma_up=torch.tensor(win_l_up, device=dev),
        win_chroma=torch.tensor(win_c, device=dev),
        win_chroma_up=torch.tensor(win_c_up, device=dev),
        seg_starts=torch.tensor(starts, device=dev),
        seg_deltas=torch.tensor(deltas, device=dev),
        scalars=torch.tensor([regs.scale_shift, regs.y_min, regs.y_max,
                              regs.c_min, regs.c_max], dtype=torch.int32,
                             device=dev),
        bh_c=bh_c, bw_c=bw_c, n_ov_c=n_ov_c,
    )


# ---------------------------------------------------------------------------
# Layout and offsets around the strip function
# ---------------------------------------------------------------------------

def _tile(p, F, R, bh, C, bw):
    """(F, R*bh, C*bw) -> (F, R, bh*bw, C) tiled strips."""
    return (p.reshape(F, R, bh, C, bw).permute(0, 1, 2, 4, 3).contiguous()
            .view(F, R, bh * bw, C))


def _untile(t, F, R, bh, C, bw):
    """(F, R, bh*bw, C) tiled strips -> (F, R*bh, C*bw)."""
    return (t.reshape(F, R, bh, bw, C).permute(0, 1, 2, 4, 3).contiguous()
            .view(F, R * bh, C * bw))


def _offset_arrays(states, states_up, c, csubx, csuby):
    """Per-block window index ``(oy//ymul)*13 + ox//xmul`` and sign, of this
    block row and of the row above: four (F, R, 1, C) int32 tensors from
    (F, R, C) int64 lattices."""
    subx = csubx if c else 1
    suby = csuby if c else 1
    ymul, xmul = 4 // suby, 4 // subx
    s, ox, oy = block_offsets(states, c, csubx, csuby)
    su, oxu, oyu = block_offsets(states_up, c, csubx, csuby)
    widx = (oy // ymul) * 13 + ox // xmul
    widxu = (oyu // ymul) * 13 + oxu // xmul
    return tuple(a.to(torch.int32)[:, :, None, :].contiguous()
                 for a in (widx, s, widxu, su))


# ---------------------------------------------------------------------------
# The strip function, its natural-plane form and the CUDA kernel
# ---------------------------------------------------------------------------

def plane_tiled_plain(xt, widx, sign, widxu, signu, segs, segd, win, win_up,
                      *, bh, bw, n_ov, bs, scale_shift, imin, imax):
    """Plain torch version of the tiled kernel, over all (F, R) strips.

    xt: (F, R, bh*bw, C) uint8/uint16 strips; widx/sign/widxu/signu:
    (F, R, 1, C) int32; segs/segd: (nseg,) int32 segment chain; win:
    (156, 8, bh, bw) and win_up (156, 8, n_ov, bw) int8 window tables;
    scale_shift/imin/imax: ints or 0-d integer tensors.  Returns new strips.
    """
    F, R, S, C = xt.shape
    dev = xt.device
    x = xt.to(torch.int32)
    inten = (x >> bs) & 0xFF

    # Packed (scale | pattern << 9) through the run-length chain.
    acc = torch.zeros_like(inten)
    for k in range(segs.shape[0]):
        acc = acc + torch.where(inten >= segs[k], segd[k], 0)
    sc = acc & ((1 << _PACK_SHIFT) - 1)
    pi = (acc >> _PACK_SHIFT).long()

    # Window fetch: pattern pi of the block's window, at pixel s.
    nov = n_ov * bw
    s_idx = torch.arange(S, device=dev).view(1, 1, S, 1)
    P = (win.reshape(-1)[(widx.long() * 8 + pi) * S + s_idx].to(torch.int32)
         * sign)
    Pu = (win_up.reshape(-1)[(widxu.long() * 8 + pi[:, :, :nov]) * nov
                             + s_idx[:, :, :nov]].to(torch.int32) * signu)

    # Vertical overlap on the first n_ov pixel rows (vfgs_hw.c:223-229), for
    # every block row but the frame's first.
    if n_ov == 1:
        oc1 = oc2 = 20
    else:
        oc1 = torch.tensor([12] * bw + [24] * bw, dtype=torch.int32,
                           device=dev).view(1, 1, nov, 1)
        oc2 = torch.tensor([24] * bw + [12] * bw, dtype=torch.int32,
                           device=dev).view(1, 1, nov, 1)
    blend = (P[:, :, :nov] * oc1 + Pu * oc2 + 16) >> 5
    rmask = (torch.arange(R, device=dev) > 0).view(1, R, 1, 1)
    top = torch.where(rmask, blend, P[:, :, :nov])
    P = torch.cat([top, P[:, :, nov:]], dim=2)

    # Horizontal deblock at inner block-column edges (vfgs_hw.c:250-258),
    # both new edge values from pre-deblock grain.
    P3 = P.view(F, R, bh, bw, C)
    i0, i1 = P3[:, :, :, 0], P3[:, :, :, 1]
    il1, il0 = P3[:, :, :, bw - 2], P3[:, :, :, bw - 1]
    r0m = torch.roll(i0, -1, dims=-1)    # column c holds r0 of column c+1
    l0p = torch.roll(il0, 1, dims=-1)    # column c holds l0 of column c-1
    col = torch.arange(C, device=dev)
    new_l0 = torch.where(col < C - 1, (il1 + 3 * il0 + r0m + 2) >> 2, il0)
    new_r0 = torch.where(col > 0, (l0p + 3 * i0 + i1 + 2) >> 2, i0)
    P = torch.cat([new_r0[:, :, :, None], P3[:, :, :, 1:bw - 1],
                   new_l0[:, :, :, None]], dim=3).view(F, R, S, C)

    # Scale, round, add, clip (vfgs_hw.c:266-276).
    g = (sc * P + (1 << (scale_shift - 1))) >> scale_shift
    return torch.clamp(x + g, imin << bs, imax << bs).to(xt.dtype)


def plane_tiled_natural_plain(x, widx, sign, widxu, signu, segs, segd, win,
                              win_up, *, bh, bw, n_ov, bs, scale_shift, imin,
                              imax):
    """:func:`plane_tiled_plain` on a natural plane: tile ``x`` (F, R*bh,
    C*bw), grain the strips, untile.  Arguments as :func:`plane_tiled_cuda`;
    the plain version of the kernel, on any device."""
    F, R, _, C = widx.shape
    xt = _tile(x, F, R, bh, C, bw)
    return _untile(plane_tiled_plain(
        xt, widx, sign, widxu, signu, segs, segd, win, win_up, bh=bh, bw=bw,
        n_ov=n_ov, bs=bs, scale_shift=scale_shift, imin=imin, imax=imax),
        F, R, bh, C, bw)


def plane_tiled_cuda(x, widx, sign, widxu, signu, segs, segd, win, win_up,
                     *, bh, bw, n_ov, bs, scale_shift, imin, imax):
    """Launch csrc/grain_tiled.cu on one plane of F frames; returns the new
    plane.

    x: (F, R*bh, C*bw) uint8/uint16, the natural padded plane; the other
    arguments as :func:`plane_tiled_plain`, all on one CUDA device
    (``scale_shift``, ``imin`` and ``imax`` as 0-d int32 device tensors or
    ints).  Adds one to ``plane_tiled_cuda.launches`` per launch."""
    out = _launch_tiled(x, widx, sign, widxu, signu, segs, segd, win, win_up,
                        bh=bh, bw=bw, n_ov=n_ov, bs=bs,
                        scale_shift=scale_shift, imin=imin, imax=imax)
    plane_tiled_cuda.launches += 1
    return out


plane_tiled_cuda.launches = 0


def _launch_tiled(x, widx, sign, widxu, signu, segs, segd, win, win_up, *,
                  bh, bw, n_ov, bs, scale_shift, imin, imax, defines=()):
    """:func:`plane_tiled_cuda` without its count, on the library built
    with ``defines`` (tools/probe_tiled.py's variants; none for K3)."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"plane_tiled_cuda needs CUDA tensors, got {dev}")
    if x.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"planes must be uint8 or uint16, got {x.dtype}")
    if (bh, bw, n_ov) not in _GEOMETRIES:
        raise ValueError(f"no tiled kernel for block {bh}x{bw}, n_ov {n_ov}")
    if widx.dim() != 4:
        raise ValueError(f"widx: expected (F, R, 1, C), got "
                         f"{tuple(widx.shape)}")
    F, R, _, C = widx.shape
    _check_plane("x", x, (F, R * bh, C * bw), x.dtype, dev)
    for name, a in (("widx", widx), ("sign", sign), ("widxu", widxu),
                    ("signu", signu)):
        _check_plane(name, a, (F, R, 1, C), torch.int32, dev)
    nseg = segs.shape[0]
    for name, a in (("segs", segs), ("segd", segd)):
        _check_plane(name, a, (nseg,), torch.int32, dev)
    _check_plane("win", win, (N_WINDOWS, 8, bh, bw), torch.int8, dev)
    _check_plane("win_up", win_up, (N_WINDOWS, 8, n_ov, bw), torch.int8, dev)
    if win.data_ptr() % 16 or win_up.data_ptr() % 8:
        raise ValueError("window tables must be 16-byte (win) and 8-byte "
                         "(win_up) aligned")
    if x.data_ptr() % (8 * x.element_size()):
        # a thread moves 8 samples as one vector: take a plane that starts
        # off that grid (a view into a larger buffer) into a fresh one
        x = x.clone()
    ss, lo, hi = (torch.as_tensor(a, dtype=torch.int32, device=dev)
                  for a in (scale_shift, imin, imax))
    lib = _kernels.load("grain_tiled", defines)
    out = torch.empty_like(x)
    rc = lib.vfg_grain_tiled(
        x.data_ptr(), out.data_ptr(), x.element_size(),
        widx.data_ptr(), sign.data_ptr(), widxu.data_ptr(), signu.data_ptr(),
        segs.data_ptr(), segd.data_ptr(), nseg,
        win.data_ptr(), win_up.data_ptr(),
        ss.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        F, R, C, bh, bw, n_ov, bs,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"grain_tiled kernel launch failed: CUDA error "
                           f"{rc}")
    return out


def grain_tiled_info(elem_bytes: int, bh: int, bw: int) -> dict:
    """Registers per thread, static shared memory bytes per thread block
    (the launch asks for no dynamic shared memory), local memory bytes per
    thread (stack and spills) and thread blocks per SM (the CUDA occupancy
    calculator) of csrc/grain_tiled.cu's instance for ``elem_bytes`` (1 or
    2) and block ``bh`` x ``bw``.  Builds the kernel; needs a card."""
    return _kernels.kernel_info(
        _kernels.load("grain_tiled").vfg_grain_tiled_info, elem_bytes, bh, bw)


# ---------------------------------------------------------------------------
# The batched step
# ---------------------------------------------------------------------------

def add_grain_batch_pallas(y, u, v, bases, bases_up, tables: dict, *,
                           height: int, width: int, bs: int, csubx: int,
                           csuby: int):
    """Batched whole-frame grain, tiled engine (signature of the JAX
    function).

    y: (F, R*16, C*16); u, v: (F, R*bh_c, C*bw_c), uint8 or uint16, padded
    from height x width.  ``bases``: F uint32 lattice bases (ops/lfsr.py).
    ``bases_up`` (the bases of the row above each frame's first block row)
    is accepted for interface parity and only its length is checked: a
    frame's first block row never blends, and every other row's upper row
    is the previous row of the same lattice.  CUDA tensors launch the
    kernel (or raise); CPU tensors take the plain version.
    """
    dev = y.device
    R, C = _check_batch(y, u, v, bases, tables, height, width)
    if len(bases_up) != len(bases):
        raise ValueError(f"{len(bases_up)} upper bases for {len(bases)} "
                         f"frames")
    if dev.type == "cpu":
        plane_fn = plane_tiled_natural_plain
    elif dev.type == "cuda":
        plane_fn = plane_tiled_cuda
    else:
        raise ValueError(f"no grain kernel for device {dev}")
    return _tiled_batch(y, u, v, bases, tables, R=R, C=C, bs=bs, csubx=csubx,
                        csuby=csuby, plane_fn=plane_fn)


def _tiled_batch(y, u, v, bases, tables, *, R, C, bs, csubx, csuby,
                 plane_fn):
    """The tiled step around ``plane_fn``: the lattice, the offsets, the
    three planes.  ``chip_smoke.py`` and the card tests also run it with
    :func:`plane_tiled_natural_plain` on CUDA tensors to hold the kernel
    against its plain version."""
    with tracing.span("grain.prep"):
        lat = lfsr.state_lattice_torch(bases, R, C, y.device)
        lat_up = _rows_above(lat)
        planes = [_plane_args(plane, c, lat, lat_up, tables, bs=bs,
                              csubx=csubx, csuby=csuby)
                  for c, plane in enumerate((y, u, v))]
    with tracing.span("grain.kernels"):
        return tuple(plane_fn(*args, **kw) for args, kw in planes)


def _plane_args(plane, c, lat, lat_up, tables, *, bs, csubx, csuby):
    """Arguments of the plane function for plane ``c`` of a batch: the
    plane, the offset arrays and the plane's tables, and the keyword
    geometry and scalars."""
    sc = tables["scalars"]
    if c == 0:
        bh, bw, n_ov = 16, 16, 2
        win, win_up = tables["win_luma"], tables["win_luma_up"]
        imin, imax = sc[1], sc[2]
    else:
        bh, bw, n_ov = tables["bh_c"], tables["bw_c"], tables["n_ov_c"]
        win, win_up = tables["win_chroma"], tables["win_chroma_up"]
        imin, imax = sc[3], sc[4]
    args = (plane, *_offset_arrays(lat, lat_up, c, csubx, csuby),
            tables["seg_starts"][c], tables["seg_deltas"][c], win, win_up)
    return args, dict(bh=bh, bw=bw, n_ov=n_ov, bs=bs, scale_shift=sc[0],
                      imin=imin, imax=imax)
