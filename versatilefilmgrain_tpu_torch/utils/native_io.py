"""ctypes bindings for the native pipelined frame I/O library (native/vfgsio.c).

Builds the shared library on first use (gcc, cached under build/); every
entry point degrades gracefully to the numpy/stdio path in utils/yuv.py when
the toolchain or library is unavailable, so correctness never depends on it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_lib = None
_lib_lock = threading.Lock()
_lib_failed = False
_build_lock = threading.Lock()


def build_native(name: str):
    """Compile native/<name>.c to build/lib<name>_torch.so (cached) and load it.

    Returns the CDLL or None if the toolchain/compile is unavailable.
    Staleness uses <= so equal mtimes (fresh checkouts) trigger a rebuild;
    compiles to a temp name then renames so concurrent callers never load a
    partially written library.  The ``_torch`` suffix keeps this package's
    build apart from the JAX package's, which compiles the same sources to
    build/lib<name>.so, so parallel test workers of the two packages never
    rebuild one file.
    """
    src = os.path.join(_REPO, "native", f"{name}.c")
    so = os.path.join(_REPO, "build", f"lib{name}_torch.so")
    try:
        with _build_lock:
            if (not os.path.exists(so)
                    or os.path.getmtime(so) <= os.path.getmtime(src)):
                os.makedirs(os.path.dirname(so), exist_ok=True)
                tmp = so + f".tmp{os.getpid()}"
                subprocess.run(
                    ["gcc", "-O3", "-shared", "-fPIC", "-pthread",
                     "-o", tmp, src],
                    check=True, capture_output=True)
                os.replace(tmp, so)
        return ctypes.CDLL(so)
    except Exception:
        return None


def _load():
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = build_native("vfgsio")
            if lib is None:
                _lib_failed = True
                return None
            lib.vfgsio_reader_open.restype = ctypes.c_void_p
            lib.vfgsio_reader_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                               ctypes.c_int, ctypes.c_long]
            lib.vfgsio_reader_next.restype = ctypes.c_int
            lib.vfgsio_reader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.vfgsio_reader_close.argtypes = [ctypes.c_void_p]
            lib.vfgsio_writer_open.restype = ctypes.c_void_p
            lib.vfgsio_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                               ctypes.c_int]
            lib.vfgsio_writer_put.restype = ctypes.c_int
            lib.vfgsio_writer_put.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                              ctypes.c_size_t]
            lib.vfgsio_writer_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        except Exception:
            _lib_failed = True
        return _lib


def available() -> bool:
    return _load() is not None


class FrameReader:
    """Prefetching whole-frame reader; yields numpy uint8 frame buffers."""

    def __init__(self, path: str, frame_bytes: int, nbuf: int = 4,
                 seek_frames: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError("native I/O unavailable")
        self._lib = lib
        self.frame_bytes = frame_bytes
        self._h = lib.vfgsio_reader_open(path.encode(), frame_bytes, nbuf,
                                         seek_frames)
        if not self._h:
            raise OSError(f"Can not open file {path}")

    def next(self, out: np.ndarray | None = None) -> np.ndarray | None:
        """The next frame, read into ``out`` (a writable contiguous uint8
        buffer of ``frame_bytes``) or into a new buffer; None at the end."""
        if out is None:
            out = np.empty(self.frame_bytes, dtype=np.uint8)
        elif (out.dtype != np.uint8 or out.size != self.frame_bytes
              or not out.flags.c_contiguous or not out.flags.writeable):
            raise ValueError(f"out must be a writable contiguous uint8 "
                             f"buffer of {self.frame_bytes} bytes, got "
                             f"{out.dtype} of {out.size}")
        ok = self._lib.vfgsio_reader_next(
            self._h, out.ctypes.data_as(ctypes.c_void_p))
        return out if ok else None

    def close(self):
        if self._h:
            self._lib.vfgsio_reader_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class FrameWriter:
    """Async frame writer with a background drain thread."""

    def __init__(self, path: str, frame_bytes: int, nbuf: int = 4):
        lib = _load()
        if lib is None:
            raise RuntimeError("native I/O unavailable")
        self._lib = lib
        self._h = lib.vfgsio_writer_open(path.encode(), frame_bytes, nbuf)
        if not self._h:
            raise OSError(f"Can not create file {path}")

    def put(self, frame: np.ndarray) -> None:
        frame = np.ascontiguousarray(frame).view(np.uint8).reshape(-1)
        ok = self._lib.vfgsio_writer_put(
            self._h, frame.ctypes.data_as(ctypes.c_void_p), frame.nbytes)
        if not ok:
            raise OSError("write error")

    def close(self):
        if self._h:
            self._lib.vfgsio_writer_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
