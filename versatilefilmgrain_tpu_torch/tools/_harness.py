"""Shared helpers of the probes: the headline shape, the register files of
the three probe configs, frame bases, seeded planes, chained timing on the
card and the timed, checked run of a probe's cases.

The counterpart of what the JAX probes import from ``bench.py`` and
``__graft_entry__.py``, on the port's own modules.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

from ..models import config as cfgmod
from ..models import fw
from ..models.hw import HwRegs
from ..ops import lfsr
from ..pipeline import adjust_chroma_cfg, check_cfg
from ..utils import parsers, yuv

H, W = 2160, 3840      # the headline shape: 4K 10-bit 4:2:0
FRAMES_BATCH = 8       # frames per batch step
HBM_BYTES_S = 3.35e12  # H100 SXM data sheet: device memory bytes/s

CFG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "golden", "cfg")
CFG_FILES = {"sei_ar": "fgs_sei_ar_test1.cfg",
             "afgs1": "fgs_afgs1_test1.cfg"}


def default_regs(depth: int = 10, csub=(2, 2)) -> HwRegs:
    """Register file of the CLI's built-in FGC SEI config."""
    regs = HwRegs()
    regs.set_depth(depth)
    regs.set_chroma_subsampling(*csub)
    fw.init_sei(cfgmod.default_sei(), regs)
    return regs


def regs_from_cfg(path: str, depth: int = 10, csub=(2, 2)) -> HwRegs:
    """Register file from a .cfg file, as a pipeline config pop builds it
    (read, check, chroma adjust, FW init) for 4:2:0."""
    sei, afgs1 = cfgmod.default_sei(), cfgmod.default_afgs1()
    parsers.read_cfg(path, sei, afgs1)
    check_cfg(sei, afgs1, yuv.YUV_420, depth)
    adjust_chroma_cfg(sei, yuv.YUV_420)
    regs = HwRegs()
    regs.set_depth(depth)
    regs.set_chroma_subsampling(*csub)
    if afgs1.num_y_points:
        fw.init_afgs1(afgs1, regs)
    else:
        fw.init_sei(sei, regs)
    return regs


def config_regs(kind: str) -> HwRegs:
    """Register file of a probe config: "default", "sei_ar" or "afgs1"."""
    if kind == "default":
        return default_regs()
    if kind not in CFG_FILES:
        raise ValueError(f"unknown config {kind!r}: expected default, "
                         f"{', '.join(CFG_FILES)}")
    return regs_from_cfg(os.path.join(CFG_DIR, CFG_FILES[kind]))


def frame_bases(regs, nframes: int, R: int, C: int, offset: int = 0):
    """uint32 lattice bases (and their one-block-row-earlier siblings) of
    frames [offset, offset + nframes)."""
    bases, bases_up = [], []
    for f in range(offset, offset + nframes):
        e0 = lfsr.frame_base_exponent(f, R, C)
        bases.append(int(lfsr.advance(np.uint32(regs.seed_state), e0)))
        bases_up.append(int(lfsr.advance(np.uint32(regs.seed_state), e0 - C))
                        if e0 else bases[-1])
    return (np.array(bases, np.uint32), np.array(bases_up, np.uint32))


def random_state(F: int, seed: int, height: int = H, width: int = W,
                 device="cpu"):
    """Seeded (y, u, v) uint16 10-bit 4:2:0 planes of F frames, drawn with
    numpy in the order of the JAX probes' state."""
    R, C = height // 16, width // 16
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.integers(0, 1024, (F, h, w),
                                               dtype=np.uint16)).to(device)
                 for h, w in ((R * 16, C * 16), (R * 8, C * 8),
                              (R * 8, C * 8)))


def chain_ms(step, state0, cargs, n: int = 20) -> float:
    """Device ms per call of ``state = step(*state, *cargs)`` chained ``n``
    times, timed with CUDA events: one warm-up chain, then the median of
    three.  Raises unless the state lies on a CUDA device."""
    if state0[0].device.type != "cuda":
        raise RuntimeError(f"chain_ms times on the card; the state lies on "
                           f"{state0[0].device}")

    def chain():
        state = state0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            state = step(*state, *cargs)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n

    chain()
    return sorted(chain() for _ in range(3))[1]


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def run_modes(cases: dict, y, n: int = 20) -> dict:
    """Time and check each named case ``(step, want, (bound_ms,
    bound_by))`` on the card: device ms per step chained ``n`` times (each
    step's output is the next step's ``y``, as the JAX chain does), then
    whether one step on ``y`` equals ``want``, its plain version's output.
    Prints one line per case; returns {name: {"ms", "bound_ms", "bound_by",
    "exact"}}."""
    res = {}
    for name, (step, want, (bms, by)) in cases.items():
        ms = chain_ms(step, (y,), (), n=n)
        ok = bool(torch.equal(step(y)[0], want))
        res[name] = dict(ms=ms, bound_ms=bms, bound_by=by, exact=ok)
        print(f"  {name:14s} {ms:9.4f} ms  bound {bms:.4f} ms ({by}), "
              f"{ms / bms:6.2f}x  exact vs plain: {ok}", flush=True)
    return res


def header(what: str, y) -> None:
    Fy, Hy, Wy = y.shape
    print(f"card: {card()}; {what}: {Wy}x{Hy} uint16, {Fy} frames per "
          f"step, {Fy * (Hy // 16)} block rows; ms per step (CUDA events, "
          f"median of 3 chains of 20); bounds from the H100 SXM data sheet",
          flush=True)


def no_card(name: str) -> bool:
    """True (after saying so) when there is no CUDA device: the probes time
    the kernel on the card only."""
    if torch.cuda.is_available():
        return False
    print(f"{name}: no CUDA device; the probe times the kernel on the card "
          f"only", file=sys.stderr)
    return True
