"""Planar YUV file I/O (reference: src/yuv.c).

The reference allocates stride-aligned frames and reads/writes row-wise
(yuv.c:54-214); file bytes are plain contiguous W*H planes, so we read
straight into contiguous numpy arrays and let the engine do its own padding
(:func:`pad_batch` on the device; :func:`pad_plane` is its numpy oracle).
10-bit samples are uint16 little-endian.
"""

from __future__ import annotations

import io

import numpy as np

YUV_420 = 0
YUV_422 = 1
YUV_444 = 2


def chroma_dims(width: int, height: int, fmt: int) -> tuple[int, int]:
    subx = 1 if fmt > YUV_422 else 2
    suby = 1 if fmt > YUV_420 else 2
    return width // subx, height // suby


def frame_bytes(width: int, height: int, depth: int, fmt: int) -> int:
    cw, ch = chroma_dims(width, height, fmt)
    sz = 1 if depth == 8 else 2
    return (width * height + 2 * cw * ch) * sz


def skip_frames(f, n: int, width: int, height: int, depth: int, fmt: int) -> None:
    """yuv_skip (yuv.c:97-106).

    The reference ignores fseeko's return value, so seeking an unseekable
    stream (FIFO/stdin) silently does nothing; replicate that."""
    if not n:
        return
    try:
        f.seek(frame_bytes(width, height, depth, fmt) * n, 1)
    except (OSError, ValueError, io.UnsupportedOperation):
        pass


def read_frame(f, width: int, height: int, depth: int, fmt: int):
    """Read one frame; returns (Y, U, V) uint8/uint16 arrays or None at EOF.

    Uses plain read() + frombuffer (np.fromfile needs a seekable stream and
    fails on FIFOs/pipes, which the reference's fread handles fine)."""
    cw, ch = chroma_dims(width, height, fmt)
    dt = np.dtype(np.uint8) if depth == 8 else np.dtype("<u2")
    planes = []
    for w, h in ((width, height), (cw, ch), (cw, ch)):
        want = w * h * dt.itemsize
        raw = f.read(want)
        if len(raw) != want:
            return None
        planes.append(np.frombuffer(raw, dtype=dt).reshape(h, w))
    return tuple(planes)


def pad_plane(p: np.ndarray, ph: int, pw: int) -> np.ndarray:
    """Edge-pad a plane to (ph, pw).  The padded samples never reach the
    output, except at a pad-leak width (``GrainPipeline._has_pad_leak``),
    where the pipeline takes the padding from the last frame's output."""
    h, w = p.shape
    if h == ph and w == pw:
        return p
    return np.pad(p, ((0, ph - h), (0, pw - w)), mode="edge")


def pad_batch(dst, p) -> None:
    """Write the planes ``p`` (frames, h, w) edge-padded to ``dst``'s
    shape (frames, ph, pw) into ``dst``, torch tensors on any one device
    (what :func:`pad_plane` returns for each frame): columns to the right
    take the last column, rows below the last row."""
    h, w = p.shape[1:]
    dst[:, :h, :w] = p
    if w < dst.shape[2]:
        dst[:, :h, w:] = dst[:, :h, w - 1:w]
    if h < dst.shape[1]:
        dst[:, h:] = dst[:, h - 1:h]
