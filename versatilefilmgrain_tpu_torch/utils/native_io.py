"""ctypes bindings for the frame loop's pipelined frame I/O library
(csrc/vfgsio_ring.c).

Builds the shared library on first use (gcc, cached under build/).  A
:class:`FrameReader` and a :class:`FrameWriter` own their ring of host
frames (:func:`host_ring`, pinned for a CUDA device), which the library's
threads read into and write from, and lend its frames by reference, so
that the frame loop's copies to and from the device use them directly.
Where the toolchain or library is unavailable the frame loop reads and
writes the files itself (``pipeline.py``), so correctness never depends on
it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np
import torch

from . import tracing

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_lib = None
_lib_lock = threading.Lock()
_lib_failed = False
_build_lock = threading.Lock()


def build_native(name: str, src: str | None = None):
    """Compile ``src`` (default native/<name>.c) to build/lib<name>_torch.so
    (cached) and load it.

    Returns the CDLL or None if the toolchain/compile is unavailable.
    Staleness uses <= so equal mtimes (fresh checkouts) trigger a rebuild;
    compiles to a temp name then renames so concurrent callers never load a
    partially written library.  The ``_torch`` suffix keeps this package's
    build apart from the JAX package's, which compiles the sources under
    native/ to build/lib<name>.so, so parallel test workers of the two
    packages never rebuild one file.
    """
    src = src or os.path.join(_REPO, "native", f"{name}.c")
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
            lib = build_native("vfgsio_ring", os.path.join(
                os.path.dirname(os.path.dirname(__file__)), "csrc",
                "vfgsio_ring.c"))
            if lib is None:
                _lib_failed = True
                return None
            P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
            for name, res, args in (
                    ("reader_open", P,
                     [ctypes.c_char_p, S, I, ctypes.c_long, P]),
                    ("reader_acquire", I, [P]),
                    ("reader_release", None, [P, I]),
                    ("reader_close", None, [P]),
                    ("writer_open", P, [ctypes.c_char_p, S, I, P]),
                    ("writer_acquire", I, [P]),
                    ("writer_commit", I, [P, I, S]),
                    ("writer_close", None, [P])):
                fn = getattr(lib, f"vfgsio_ring_{name}")
                fn.restype, fn.argtypes = res, args
            _lib = lib
        except Exception:
            _lib_failed = True
        return _lib


def available() -> bool:
    return _load() is not None


def host_ring(nbuf: int, frame_bytes: int, pinned: bool) -> torch.Tensor:
    """``nbuf`` host frames of ``frame_bytes``, one a row, pinned where
    ``pinned``; counted as ``staging_allocs``."""
    tracing.count("staging_allocs")
    return torch.empty((nbuf, frame_bytes), dtype=torch.uint8,
                       pin_memory=pinned)


class _Ring:
    """What the reader and the writer share: the library, the ring of
    ``nbuf`` frames (:func:`host_ring`), each frame's numpy view, and the
    handle, which lives until :meth:`close`."""

    def __init__(self, frame_bytes: int, nbuf: int, pinned: bool):
        lib = _load()
        if lib is None:
            raise RuntimeError("native I/O unavailable")
        self._lib = lib
        self.frame_bytes = frame_bytes
        self._h = None
        # the C thread reads into or writes from the ring until close()
        self._ring = host_ring(nbuf, frame_bytes, pinned)
        self._frames = list(self._ring.numpy())

    def _call(self, name: str, *args):
        return getattr(self._lib, f"vfgsio_ring_{self._kind}_{name}")(
            self._h, *args)

    def close(self):
        if self._h:
            self._call("close")
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class FrameReader(_Ring):
    """Prefetching whole-frame reader: a C thread reads the file ahead into
    a ring of ``nbuf`` frames (pinned where ``pinned``), which
    :meth:`next` lends in order."""

    _kind = "reader"

    def __init__(self, path: str, frame_bytes: int, nbuf: int = 4,
                 seek_frames: int = 0, pinned: bool = False):
        super().__init__(frame_bytes, nbuf, pinned)
        self._held = 0
        self._h = self._lib.vfgsio_ring_reader_open(
            path.encode(), frame_bytes, nbuf, seek_frames,
            self._ring.data_ptr())
        if not self._h:
            raise OSError(f"Can not open file {path}")

    def next(self) -> np.ndarray | None:
        """The next frame, or None at the end of the stream: the ring's
        frame itself (a uint8 view of ``frame_bytes``), valid until
        :meth:`release` gives it back."""
        slot = self._call("acquire")
        if slot == -2:
            raise RuntimeError(f"all {len(self._frames)} ring frames are "
                               "held: release some first")
        if slot < 0:
            return None
        self._held += 1
        return self._frames[slot]

    def release(self, n: int = 1) -> None:
        """Give the ``n`` oldest frames that :meth:`next` lent back to the
        reader thread."""
        if not 0 <= n <= self._held:
            raise ValueError(f"{n} frames to give back, {self._held} held")
        if n:
            self._call("release", n)
            self._held -= n


class FrameWriter(_Ring):
    """Async frame writer: a C thread writes out the frames of a ring of
    ``nbuf`` frames (pinned where ``pinned``) that :meth:`acquire` lent and
    :meth:`put` handed back, in the order they were lent."""

    _kind = "writer"

    def __init__(self, path: str, frame_bytes: int, nbuf: int = 4,
                 pinned: bool = False):
        super().__init__(frame_bytes, nbuf, pinned)
        self._held = set()      # the slots lent and not yet put
        self._base = self._ring.data_ptr()
        self._h = self._lib.vfgsio_ring_writer_open(
            path.encode(), frame_bytes, nbuf, self._base)
        if not self._h:
            raise OSError(f"Can not create file {path}")

    def acquire(self) -> np.ndarray:
        """A free frame of the ring (a uint8 view of ``frame_bytes``) to
        fill and :meth:`put`; waits while the writer thread has none."""
        slot = self._call("acquire")
        if slot < 0:
            raise RuntimeError("the ring's oldest frame is still held: put "
                               "it or give it back first")
        self._held.add(slot)
        return self._frames[slot]

    def _slot(self, frame) -> int | None:
        """The held slot that ``frame`` is, whole, or None."""
        if (not isinstance(frame, np.ndarray)
                or frame.nbytes != self.frame_bytes
                or not frame.flags.c_contiguous):
            return None
        off = frame.__array_interface__["data"][0] - self._base
        slot, rem = divmod(off, self.frame_bytes)
        return slot if not rem and slot in self._held else None

    def _commit(self, slot: int, nbytes: int) -> None:
        self._held.remove(slot)
        if not self._call("commit", slot, nbytes):
            raise OSError("write error")

    def put(self, frame: np.ndarray) -> None:
        """Write ``frame``, a frame that :meth:`acquire` lent, by reference
        (counted as ``ring_frames``); anything else is an error."""
        slot = self._slot(frame)
        if slot is None:
            raise ValueError("put takes a frame that acquire() lent and "
                             "that was not put")
        self._commit(slot, self.frame_bytes)
        tracing.count("ring_frames")

    def give_back(self, frames) -> None:
        """Give back, unwritten, each of ``frames`` that :meth:`acquire`
        lent and that was not put."""
        for frame in frames:
            slot = self._slot(frame)
            if slot is not None:
                self._commit(slot, 0)

    def close(self):
        """Write what was put, give back what is held, and close."""
        super().close()
        self._held.clear()
