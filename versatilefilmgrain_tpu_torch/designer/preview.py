"""YUV preview utilities for the designer (reference: fgc-designer.py:228-303).

A copy of the JAX package's designer/preview.py: pure numpy (display code
needs no device), with single-frame YUV reading, chroma upsampling to 4:4:4
with a separable half-band interpolation filter, and BT.709 limited-range
YUV->RGB.
"""

from __future__ import annotations

import numpy as np

from ..utils import yuv as yuvio

# Half-band interpolator taps for chroma upsampling (windowed sinc).
_TAPS = np.array([-4, 54, 16, -2], dtype=np.int32)  # /64, for phase 0.5


def read_yuv_frame(filename: str, frame: int, width: int, height: int,
                   depth: int, fmt: int):
    """Read one (Y, U, V) frame from a planar YUV file."""
    with open(filename, "rb") as f:
        yuvio.skip_frames(f, frame, width, height, depth, fmt)
        planes = yuvio.read_frame(f, width, height, depth, fmt)
    if planes is None:
        raise EOFError(f"frame {frame} beyond end of {filename}")
    return planes


def _upsample_axis(p: np.ndarray, axis: int) -> np.ndarray:
    """2x co-sited upsample along ``axis`` with a 4-tap half-band filter."""
    p = np.moveaxis(p, axis, 0).astype(np.int32)
    n = p.shape[0]
    idx = np.arange(n)
    pm1 = p[np.maximum(idx - 1, 0)]
    pp1 = p[np.minimum(idx + 1, n - 1)]
    pp2 = p[np.minimum(idx + 2, n - 1)]
    half = (pm1 * _TAPS[0] + p * _TAPS[1] + pp1 * _TAPS[2]
            + pp2 * _TAPS[3] + 32) >> 6
    out = np.empty((2 * n,) + p.shape[1:], dtype=np.int32)
    out[0::2] = p
    out[1::2] = half
    return np.moveaxis(out, 0, axis)


def upsample_chroma(y: np.ndarray, u: np.ndarray, v: np.ndarray, fmt: int):
    """Upsample U/V to luma resolution (4:4:4), integer half-band filter."""
    for _ in range(2):
        if u.shape[1] < y.shape[1]:
            u = _upsample_axis(u, 1)
            v = _upsample_axis(v, 1)
        if u.shape[0] < y.shape[0]:
            u = _upsample_axis(u, 0)
            v = _upsample_axis(v, 0)
    return u[:y.shape[0], :y.shape[1]], v[:y.shape[0], :y.shape[1]]


def _conv_rows(p: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Correlate rows of ``p`` with reversed ``w`` centered at (len-1)//2,
    edges clamped (scipy.ndimage.convolve1d(..., mode='nearest') semantics,
    which the reference preview uses)."""
    n = p.shape[0]
    c = (len(w) - 1) // 2
    wr = w[::-1]
    out = np.zeros_like(p)
    idx = np.arange(n)
    for k, wk in enumerate(wr):
        out += wk * p[np.clip(idx + k - c, 0, n - 1)]
    return out


def _sinc_upsample_h(p: np.ndarray) -> np.ndarray:
    """2x horizontal, co-sited: even columns pass through, odd columns are
    the half-phase windowed-sinc interpolation
    (reference: fgc-designer.py:305-311)."""
    f = np.sinc(np.arange(-1.5, 1.6))
    f /= np.sum(f)
    half = _conv_rows(p.T, f).T
    out = np.empty((p.shape[0], 2 * p.shape[1]), dtype=p.dtype)
    out[:, 0::2] = p
    out[:, 1::2] = half
    return out


def _sinc_upsample_v(p: np.ndarray) -> np.ndarray:
    """2x vertical, midpoint-sited: both output phases are quarter-phase
    windowed-sinc interpolations (chroma sits between luma rows;
    reference: fgc-designer.py:313-320)."""
    f = np.append(0, np.sinc(np.arange(-1.25, 1.76)))
    f /= np.sum(f)
    out = np.empty((2 * p.shape[0], p.shape[1]), dtype=p.dtype)
    out[0::2] = _conv_rows(p, f)
    out[1::2] = _conv_rows(p, f[::-1])
    return out


def upsample_chroma_sinc(yf: np.ndarray, uf: np.ndarray, vf: np.ndarray):
    """Float-domain windowed-sinc chroma upsample matching the reference
    designer: horizontal co-sited first, then vertical midpoint."""
    if 2 * uf.shape[1] == yf.shape[1]:
        uf = _sinc_upsample_h(uf)
        vf = _sinc_upsample_h(vf)
    if 2 * uf.shape[0] == yf.shape[0]:
        uf = _sinc_upsample_v(uf)
        vf = _sinc_upsample_v(vf)
    return uf, vf


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray, depth: int,
               fmt: int, method: str = "sinc") -> np.ndarray:
    """BT.709 limited-range YUV -> float RGB in [0, 1] for display.

    ``method="sinc"`` (default) matches the reference designer's rendering:
    range-convert to float first, then windowed-sinc chroma upsample
    (co-sited horizontal, midpoint vertical).  ``method="halfband"`` keeps
    the integer 4-tap half-band as a cheap fallback."""
    scale = float(1 << (depth - 8))
    if method == "halfband":
        u, v = upsample_chroma(y, u, v, fmt)
    yf = (y.astype(np.float32) / scale - 16.0) / 219.0
    uf = (u.astype(np.float32) / scale - 128.0) / 224.0
    vf = (v.astype(np.float32) / scale - 128.0) / 224.0
    if method == "sinc":
        uf, vf = upsample_chroma_sinc(yf, uf, vf)
    r = yf + 1.5748 * vf
    g = yf - 0.18733 * uf - 0.46813 * vf
    b = yf + 1.8556 * uf
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)
