"""The batched grain step: the hand-written CUDA kernel and its plain version.

Port of the JAX package's ops/grain_natural.py.  ``add_grain_batch_natural``
grains (Y, U, V) for a batch of frames:

* on CUDA tensors it launches csrc/grain_natural.cu once per plane
  (the counterpart of the TPU kernel ``_fused_pallas``);
* on CPU tensors it runs :func:`add_grain_batch_plain`, the plain torch
  version (ops/grain_ref.py, batched), which is also what the kernel is
  compared against on the card.

The TPU kernel's one-hot window fetch, byte-packed one-hot, lane words,
LUT-dot and piecewise-linear LUT paths exist because the TPU has slow
gathers and no sub-32-bit compares; a Hopper kernel reads the pattern bank
and the 256-entry LUTs from shared memory directly, so none of them is here.

The config tables are runtime tensors (:func:`natural_tables`): a config
switch uploads new tables and builds nothing.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _kernels
from . import lfsr
from .grain_ref import plane_grain


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


def add_grain_batch_plain(y, u, v, bases, tables: dict, *, bs: int,
                          csubx: int, csuby: int):
    """Plain torch version of the kernel, on any device.

    y: (F, R*16, C*16); u, v: (F, R*bh_c, C*bw_c); uint8 or uint16.
    ``bases``: F uint32 lattice bases (ops/lfsr.py).  Returns new planes.
    """
    lat = _lattice(bases, y)
    # Row 0 of the upper lattice is never read: a frame's first block row
    # does not blend (vfgs_hw.c overlap applies for y > 15 only).
    lat_up = torch.cat([lat[:, :1], lat[:, :-1]], dim=1)
    sc = tables["scalars"]
    out = []
    for c, plane in enumerate((y, u, v)):
        lo, hi = (sc[1], sc[2]) if c == 0 else (sc[3], sc[4])
        out.append(plane_grain(
            plane, lat, lat_up, tables["pattern"][1 if c else 0],
            tables["slut"][c], tables["plut"][c], sc[0], lo, hi,
            c=c, csubx=csubx, csuby=csuby, bs=bs))
    return tuple(out)


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


def grain_plane_cuda(pix, lat32, tables: dict, *, c: int, csubx: int,
                     csuby: int, bs: int) -> torch.Tensor:
    """Launch csrc/grain_natural.cu on one plane of F frames; returns the new
    plane.  ``pix``: (F, R*bh, C*bw) uint8/uint16 on a CUDA device;
    ``lat32``: (F, R, C) int32 lattice words on the same device.  Adds one
    to ``grain_plane_cuda.launches`` per launch."""
    dev = pix.device
    if dev.type != "cuda":
        raise ValueError(f"grain_plane_cuda needs CUDA tensors, got {dev}")
    if pix.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"planes must be uint8 or uint16, got {pix.dtype}")
    F, R, C = lat32.shape
    bh, bw = 16 // (csuby if c else 1), 16 // (csubx if c else 1)
    _check_plane(f"plane {c}", pix, (F, R * bh, C * bw), pix.dtype, dev)
    _check_plane("lat32", lat32, (F, R, C), torch.int32, dev)
    for k in ("pattern", "slut", "plut", "scalars"):
        if tables[k].device != dev or not tables[k].is_contiguous():
            raise ValueError(f"tables[{k!r}] must be contiguous on {dev}")
    pattern = tables["pattern"][1 if c else 0]
    if pattern.data_ptr() % 16:
        raise ValueError("pattern bank must be 16-byte aligned")
    lib = _kernels.load("grain_natural")
    out = torch.empty_like(pix)
    rc = lib.vfg_grain_plane(
        pix.data_ptr(), out.data_ptr(), pix.element_size(),
        lat32.data_ptr(), pattern.data_ptr(), tables["slut"][c].data_ptr(),
        tables["plut"][c].data_ptr(), tables["scalars"].data_ptr(),
        F, R, C, c, csubx, csuby, bs, int(tables["zero_scale"][c]),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"grain_natural kernel launch failed: CUDA error "
                           f"{rc}")
    grain_plane_cuda.launches += 1
    return out


grain_plane_cuda.launches = 0


def add_grain_batch_natural(y, u, v, bases, bases_up, tables: dict, *,
                            height: int, width: int, bs: int, csubx: int,
                            csuby: int):
    """Batched whole-frame grain (signature of the JAX function).

    y: (F, R*16, C*16); u, v: (F, R*bh_c, C*bw_c), uint8 or uint16, padded
    from height x width.  ``bases``: F uint32 lattice bases.  ``bases_up``
    is accepted for interface parity but unused: a frame's first block row
    never blends, and every other row's upper lattice row is the previous
    row of the same lattice.  CUDA tensors launch the kernel (or raise);
    CPU tensors take the plain version.
    """
    del bases_up
    dev = y.device
    _check_batch(y, u, v, bases, tables, height, width)
    if dev.type == "cpu":
        return add_grain_batch_plain(y, u, v, bases, tables, bs=bs,
                                     csubx=csubx, csuby=csuby)
    if dev.type != "cuda":
        raise ValueError(f"no grain kernel for device {dev}")
    lat32 = _as_int32_words(_lattice(bases, y))
    return tuple(grain_plane_cuda(p, lat32, tables, c=c, csubx=csubx,
                                  csuby=csuby, bs=bs)
                 for c, p in enumerate((y, u, v)))
