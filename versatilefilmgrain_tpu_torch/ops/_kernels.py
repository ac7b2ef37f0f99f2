"""Build and bind the package's hand-written CUDA kernels (csrc/*.cu).

Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under ``build/kernels/`` at first use, and loaded
with ``ctypes``.  A library is rebuilt when its source or any shared header
(csrc/*.cuh) is newer.  A probe may build a source with ``-D`` defines
(its hooks), into a library of its own name.  Nothing here runs at import: the package imports on
machines without a card or a CUDA toolkit, and only a launch on a CUDA tensor
builds.  A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: dict = {}
build_logs: dict = {}   # library name -> nvcc's output (ptxas registers/smem)


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def _paths(name: str, defines=()) -> tuple[str, str]:
    tag = "".join(f".{d}" for d in defines)
    return (os.path.join(_PKG, "csrc", f"{name}.cu"),
            os.path.join(_BUILD_DIR, f"lib{name}{tag}.so"))


def stale(src: str, so: str) -> bool:
    """Whether the library ``so`` is missing, or not newer than its source
    ``src`` and every header (``*.cuh``) in the source's directory."""
    if not os.path.exists(so):
        return True
    deps = [src, *glob.glob(os.path.join(os.path.dirname(src), "*.cuh"))]
    return os.path.getmtime(so) <= max(os.path.getmtime(d) for d in deps)


def build(names, defines=()) -> None:
    """Compile each csrc/<name>.cu to build/kernels/lib<name>.so that is
    :func:`stale`: one nvcc per source, all started together, then wait for
    every one.  ``defines`` ("NAME=VALUE") go to every nvcc as ``-D`` and
    into the libraries' names.  Raises if any build fails."""
    jobs = []
    for name in names:
        src, so = _paths(name, defines)
        if not stale(src, so):
            continue
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS,
                                 *(f"-D{d}" for d in defines), "-o", tmp, src],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((os.path.basename(so)[3:-3], src, so, tmp, proc))
    failed = []
    for lib, src, so, tmp, proc in jobs:
        build_logs[lib] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {src} (exit "
                          f"{proc.returncode}):\n{build_logs[lib]}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str, defines=()) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu (built with ``defines``, see
    :func:`build`), built on first use."""
    key = (name, tuple(defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            build([name], defines)
            lib = ctypes.CDLL(_paths(name, defines)[1])
            _bind(name, lib)
            _libs[key] = lib
        return lib


def kernel_info(entry, *args) -> dict:
    """Registers per thread, static shared memory bytes per thread block,
    local memory bytes per thread (stack and spills) and thread blocks per
    SM of a kernel instance, from a library's info entry point
    ``entry(*args, &registers, &smem, &local, &blocks)``.  Raises on a CUDA
    error."""
    out = [ctypes.c_int() for _ in range(4)]
    rc = entry(*args, *(ctypes.byref(o) for o in out))
    if rc != 0:
        raise RuntimeError(f"{entry.__name__} failed: CUDA error {rc}")
    return dict(zip(("registers", "static_smem", "local_bytes",
                     "blocks_per_sm"), (o.value for o in out)))


def _bind(name: str, lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    if name == "grain_natural":
        lib.vfg_grain_plane.restype = i
        lib.vfg_grain_plane.argtypes = [
            vp, vp, i,              # in, out, elem_bytes
            vp, i, vp, i,           # words, lane, up0, blend0
            vp, vp, vp, vp,         # pattern, slut, plut, scalars
            i, i, i,                # frames, rows, cols
            i, i, i, i, i,          # c, csubx, csuby, bs, zero_scale
            vp]                     # stream
        lib.vfg_grain_plane_info.restype = i
        lib.vfg_grain_plane_info.argtypes = [
            i, i,                   # elem_bytes, lane
            ctypes.POINTER(i), ctypes.POINTER(i),  # registers, static smem
            ctypes.POINTER(i), ctypes.POINTER(i)]  # local bytes, blocks/SM
    elif name == "grain_tiled":
        lib.vfg_grain_tiled.restype = i
        lib.vfg_grain_tiled.argtypes = [
            vp, vp, i,              # in, out, elem_bytes
            vp, vp, vp, vp,         # widx, sign, widxu, signu
            vp, vp, i,              # segs, segd, nseg
            vp, vp,                 # win, win_up
            vp, vp, vp,             # scale_shift, imin, imax
            i, i, i,                # frames, rows, cols
            i, i, i, i,             # bh, bw, n_ov, bs
            vp]                     # stream
        lib.vfg_grain_tiled_info.restype = i
        lib.vfg_grain_tiled_info.argtypes = [
            i, i, i,                # elem_bytes, bh, bw
            ctypes.POINTER(i), ctypes.POINTER(i),  # registers, static smem
            ctypes.POINTER(i), ctypes.POINTER(i)]  # local bytes, blocks/SM
    elif name == "expand_words":
        lib.vfg_expand_words.restype = i
        lib.vfg_expand_words.argtypes = [
            i, i, i,                # planes, rows, row blocks (grid.x)
            vp, vp, i, i,           # in0, out0, cols0, bw0
            vp, vp, i, i,           # in1, out1, cols1, bw1
            vp, vp, i, i,           # in2, out2, cols2, bw2
            vp]                     # stream
    elif name == "probe_budget":
        lib.vfg_probe_budget.restype = i
        lib.vfg_probe_budget.argtypes = [
            vp, vp, vp,             # in, out, words
            vp, vp, vp, vp,         # pattern, slut, plut, scalars
            i, i, i,                # frames, rows, cols
            i, i, i, i, i,          # c, csubx, csuby, bs, zero_scale
            i, i,                   # pat_mask, skip
            vp]                     # stream
    elif name == "probe_pipe":
        lib.vfg_probe_pipe.restype = i
        lib.vfg_probe_pipe.argtypes = [
            vp, vp, vp,             # in, out, words
            vp, vp, vp, vp,         # pattern, slut, plut, scalars
            i, i, i,                # frames, rows, cols
            i, i, i, i, i,          # c, csubx, csuby, bs, zero_scale
            i, i, i,                # blocks_per_sm, blocks, ring
            i, i, i,                # tile, lines, stages
            vp]                     # stream
        lib.vfg_probe_pipe_info.restype = i
        lib.vfg_probe_pipe_info.argtypes = [
            i, i, i,                # blocks_per_sm, ring, dynamic smem
            ctypes.POINTER(i), ctypes.POINTER(i),  # registers, static smem
            ctypes.POINTER(i), ctypes.POINTER(i)]  # local bytes, blocks/SM
    elif name == "probe_dot":
        lib.vfg_probe_dot.restype = i
        lib.vfg_probe_dot.argtypes = [
            i, i, i, i, i,          # mode, m, stride, slices, hi
            vp, vp, vp, vp,         # y, out, t, pat
            i, i, i, i,             # frames, rows, width, strips
            vp]                     # stream
    elif name == "probe_dotconst":
        lib.vfg_probe_dotconst.restype = i
        lib.vfg_probe_dotconst.argtypes = [
            i, i, i, i, i,          # src, m, stride, slices, hi
            vp, vp, vp, vp,         # y, out, pat, oh_t or t
            i, i, i,                # frames, rows, width
            vp]                     # stream
        lib.vfg_probe_dotconst_info.restype = i
        lib.vfg_probe_dotconst_info.argtypes = [
            i, i, i, i,             # src, m, stride, slices
            ctypes.POINTER(i), ctypes.POINTER(i),  # registers, smem bytes
            ctypes.POINTER(i), ctypes.POINTER(i)]  # local bytes, blocks/SM
    elif name == "probe_relayout":
        lib.vfg_probe_relayout.restype = i
        lib.vfg_probe_relayout.argtypes = [
            i, i, vp, vp,           # mode, rchunk, y, out
            i, i, i,                # frames, rows, width
            vp]                     # stream
        lib.vfg_probe_relayout_info.restype = i
        lib.vfg_probe_relayout_info.argtypes = [
            i, i, i,                # mode, rchunk, width
            ctypes.POINTER(i), ctypes.POINTER(i)]  # smem, blocks per SM
