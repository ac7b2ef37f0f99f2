"""Input frames made from the run's seed, structured like video.

Each plane is a smooth field (a coarse random grid, bilinearly upsampled, so
it changes little across a 16x16 block) stretched over the depth's whole code
range, plus a fine texture: a small tile of low-amplitude noise repeated over
the plane at a random offset.  A run of 8 pixels then reads one or two grain
patterns, as decoded video does, and every intensity interval of the LUTs is
reached somewhere.  Uniform noise would select most patterns in every run.

Frame ``i`` of a pool depends only on (seed, i), so another process (the
pipe feeder) or the check after the window makes the same frame again.
Numpy only: the feeder process imports no torch.
"""

from __future__ import annotations

import numpy as np

GRID = 128     # samples between two points of the coarse grid (luma)
TILE = 64      # side of the texture tile
TEXTURE = 3.0  # texture amplitude (standard deviation), in 8-bit codes


def chroma_dims(width: int, height: int, fmt: int) -> tuple[int, int]:
    """(width, height) of a chroma plane of format ``fmt`` (0 = 4:2:0,
    1 = 4:2:2, 2 = 4:4:4)."""
    return width // (1 if fmt == 2 else 2), height // (2 if fmt == 0 else 1)


def padded_shapes(width: int, height: int, fmt: int):
    """(rows, columns) of the Y, U and V planes padded to whole 16x16 luma
    blocks, as the program's batched step takes them."""
    R, C = -(-height // 16), -(-width // 16)
    bh = 8 if fmt == 0 else 16
    bw = 16 if fmt == 2 else 8
    return ((R * 16, C * 16), (R * bh, C * bw), (R * bh, C * bw))


def frame_bytes(width: int, height: int, depth: int, fmt: int) -> int:
    """Bytes of one raw planar frame (Y, then U, then V; 16-bit little
    endian above 8 bits)."""
    cw, ch = chroma_dims(width, height, fmt)
    return (width * height + 2 * cw * ch) * (1 if depth == 8 else 2)


def _interp(n: int, points: int) -> np.ndarray:
    """(n, points) float32 matrix of linear interpolation from ``points``
    evenly spread grid points onto ``n`` samples."""
    pos = np.linspace(0.0, points - 1.0, n, dtype=np.float64)
    lo = np.minimum(pos.astype(np.int64), points - 2)
    w = pos - lo
    m = np.zeros((n, points), np.float32)
    m[np.arange(n), lo] = 1.0 - w
    m[np.arange(n), lo + 1] = w
    return m


def _plane(rng, h: int, w: int, grid: int, depth: int) -> np.ndarray:
    top = (1 << depth) - 1
    gh, gw = h // grid + 2, w // grid + 2
    coarse = rng.random((gh, gw), dtype=np.float32)
    lo, hi = float(coarse.min()), float(coarse.max())
    coarse = (coarse - lo) * (top / max(hi - lo, 1e-6))
    field = _interp(h, gh) @ coarse @ _interp(w, gw).T
    tile = rng.standard_normal((TILE, TILE), dtype=np.float32)
    tile *= TEXTURE * (1 << (depth - 8))
    tile = np.roll(tile, tuple(rng.integers(0, TILE, 2)), axis=(0, 1))
    field += np.tile(tile, (-(-h // TILE), -(-w // TILE)))[:h, :w]
    np.clip(np.rint(field), 0, top, out=field)
    return field.astype(np.uint8 if depth == 8 else np.uint16)


def frame_planes(width: int, height: int, depth: int, fmt: int, seed: int,
                 index: int):
    """The (Y, U, V) planes of frame ``index`` drawn from ``seed``: uint8
    for 8-bit, uint16 above."""
    rng = np.random.default_rng([seed % (1 << 64), index])
    cw, ch = chroma_dims(width, height, fmt)
    cgrid = GRID * cw // width
    return (_plane(rng, height, width, GRID, depth),
            _plane(rng, ch, cw, cgrid, depth),
            _plane(rng, ch, cw, cgrid, depth))


def raw_frame(planes) -> np.ndarray:
    """A frame's planes as the bytes of a raw planar file (uint8)."""
    return np.concatenate([np.ascontiguousarray(p).astype(
        p.dtype.newbyteorder("<"), copy=False).view(np.uint8).reshape(-1)
        for p in planes])


def split_raw(raw: np.ndarray, width: int, height: int, depth: int,
              fmt: int):
    """The (Y, U, V) planes of one raw frame's bytes."""
    cw, ch = chroma_dims(width, height, fmt)
    arr = raw.view(np.uint8 if depth == 8 else np.dtype("<u2"))
    y = arr[:width * height].reshape(height, width)
    u = arr[width * height:width * height + cw * ch].reshape(ch, cw)
    v = arr[width * height + cw * ch:].reshape(ch, cw)
    return y, u, v


def pad_plane(p: np.ndarray, ph: int, pw: int) -> np.ndarray:
    """Edge-pad a plane to (ph, pw)."""
    h, w = p.shape
    if (h, w) == (ph, pw):
        return p
    return np.pad(p, ((0, ph - h), (0, pw - w)), mode="edge")


def padded_frame(width: int, height: int, depth: int, fmt: int, seed: int,
                 index: int):
    """Frame ``index``'s planes padded to whole 16x16 luma blocks."""
    return tuple(pad_plane(p, *s) for p, s in zip(
        frame_planes(width, height, depth, fmt, seed, index),
        padded_shapes(width, height, fmt)))
