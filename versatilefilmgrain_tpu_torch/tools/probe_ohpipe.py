"""Persistent pipeline probe of the grain kernel K1 on the card.

Port of the JAX package's tools/probe_ohpipe.py, which asks whether the
one-hot build of the next strip can hide under the current strip's matrix
product.  The Hopper kernel (csrc/probe_pipe.cu) asks the card's form of
that question: can a schedule other than K1's one thread block per (frame,
block row) bring K1's own body nearer its bound?  Its persistent grid
stages the pattern bank once per thread block, walks a contiguous range of
lines, and is fed its pixels by bulk copies through a ring of stages in
shared memory.  It computes exactly what K1 computes, so its plain version
is the grain step's own (``add_grain_batch_plain``), and it must equal K1
byte for byte.

Run on the card from the repo root:
  python -m versatilefilmgrain_tpu_torch.tools.probe_ohpipe [default sei_ar afgs1] [--sweep]
For each config it prints K1's and the probe's time per 8-frame 4K step
(chained, CUDA events) and each plane's device time (profiled), for the
grids of :data:`GRIDS`, and whether the outputs equal K1's and the plain
version's; with ``--sweep``, each plane's device time on the default config
at each grid, lines per stage and without the ring (:func:`sweep`).
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..ops import _kernels
from ..ops.grain_natural import (_as_int32_words, _check_batch, _check_plane,
                                 _grain_planes_plain, _lattice, _rows_above,
                                 add_grain_batch_plain, grain_plane_cuda,
                                 natural_tables)
from . import _harness as hz

BLOCKS_PER_SM = 2   # default grid: at most this many thread blocks per SM
GRIDS = (1, 2)      # the grids run_config times: every instance

# The kernel's fixed sizes (csrc/probe_pipe.cu) and the card's limits.
THREADS = 288             # 8 compute warps and one producer warp
MAX_TILE = 256 * 8        # columns of a tile: 8 a compute thread
HALO = 8                  # staged samples on each side of a tile's line
MAX_STAGES = 16
BAR_BYTES = 272           # the mbarriers, 16-byte aligned
TABLE_BYTES = 8 * 64 * 64 + 512   # pattern bank, slut, plut
SMEM_BLOCK = 232448       # shared memory a block can use (227 KB)
SMEM_SM = 233472          # shared memory of an SM (228 KB)
SMEM_RESERVED = 1024      # reserved by the system for each resident block
H100_SMS = 132


def pipe_plan(frames: int, rows: int, cols: int, *, c: int, csubx: int,
              csuby: int, blocks_per_sm: int = BLOCKS_PER_SM,
              sms: int = H100_SMS, ring: bool = True,
              lines: int | None = None) -> dict:
    """The launch plan of csrc/probe_pipe.cu for one uint16 plane of
    ``frames`` x ``rows`` block rows of ``cols`` blocks on a card of ``sms``
    SMs, at most ``blocks_per_sm`` (1 or 2) thread blocks per SM.

    A tile is the whole row up to 2,048 columns, else the fewest tiles of a
    multiple of 256 columns (whole warps) that cover it.  The ring takes
    what shared memory is left beside the bank and LUTs when
    ``blocks_per_sm`` blocks share an SM: ``lines`` per stage (by default
    the largest power of two up to bh that leaves at least 4 stages), and
    as many ``stages`` as fit (at most 16).  ``ring`` False plans the
    ablation without one (no ring memory; the loop still takes bh lines a
    group).  The grid is one block per SM and slot, at most one per line;
    :func:`block_lines` gives each its lines."""
    if blocks_per_sm not in GRIDS:
        raise ValueError(f"blocks_per_sm must be one of {GRIDS}, got "
                         f"{blocks_per_sm!r}")
    if min(frames, rows, cols) < 1 or sms < 1:
        raise ValueError(f"empty plane or card: {frames} frames, {rows} "
                         f"rows, {cols} blocks, {sms} SMs")
    bh, bw = 16 // (csuby if c else 1), 16 // (csubx if c else 1)
    if lines is not None and (lines not in (1, 2, 4, 8, 16) or lines > bh):
        raise ValueError(f"lines per stage must be a power of two up to "
                         f"bh = {bh}, got {lines!r}")
    width = cols * bw
    if width <= MAX_TILE:
        tile = width
    else:
        tile = -(-width // (-(-width // MAX_TILE) * 256)) * 256
    tiles = -(-width // tile)
    line = (tile + 2 * HALO) * 2
    if ring:
        budget = (min(SMEM_BLOCK, SMEM_SM // blocks_per_sm - SMEM_RESERVED)
                  - BAR_BYTES - TABLE_BYTES)
        fit = budget // line
        if lines is None:
            lines = bh
            while lines > 1 and fit // lines < 4:
                lines //= 2
        stages = min(MAX_STAGES, fit // lines)
        if stages < 2:
            raise ValueError(f"a ring of 2 stages of {lines} lines of {line} "
                             f"bytes does not fit {blocks_per_sm} blocks per "
                             f"SM")
    else:
        lines, stages = bh, 2
    strips = frames * rows
    total = tiles * strips * bh
    return dict(frames=frames, rows=rows, cols=cols, bh=bh, width=width,
                strips=strips, tile=tile, tiles=tiles, line_bytes=line,
                ring=ring, lines=lines, stages=stages,
                smem=BAR_BYTES + TABLE_BYTES + (stages * lines * line if ring else 0),
                blocks=min(blocks_per_sm * sms, total),
                blocks_per_sm=blocks_per_sm, threads=THREADS,
                total_lines=total)


def block_lines(plan: dict, b: int) -> tuple:
    """Lines [start, end) of thread block ``b``, as the kernel's
    ``split_line`` computes them: lines in (tile, strip, line) order, split
    so that each block's share of work (columns x lines) is even."""
    B, W, tile, nt = plan["blocks"], plan["width"], plan["tile"], plan["tiles"]
    LT = plan["strips"] * plan["bh"]
    last = W - (nt - 1) * tile

    def start(k):
        target = LT * W * k // B
        full = (nt - 1) * LT * tile
        if target <= full:
            return -(-target // tile)
        return (nt - 1) * LT + -(-(target - full) // last)

    return start(b), start(b + 1)


def line_copy(plan: dict, line: int) -> tuple:
    """What the producer warp copies for line ``line`` (in (tile, strip,
    line) order): (tile, strip, line of the strip, first sample copied (a
    flat index into the plane), bytes, byte offset in the staged line).
    The tile's columns and, where they lie in the row, HALO samples on each
    side."""
    LT = plan["strips"] * plan["bh"]
    t, rem = divmod(line, LT)
    s, j = divmod(rem, plan["bh"])
    W, tile = plan["width"], plan["tile"]
    x_t = t * tile
    xa, xb = max(x_t - HALO, 0), min(x_t + tile + HALO, W)
    return (t, s, j, (s * plan["bh"] + j) * W + xa, (xb - xa) * 2,
            (xa - x_t + HALO) * 2)


def grain_plane_pipe_cuda(pix, words, tables: dict, *, c: int, csubx: int,
                          csuby: int, bs: int,
                          blocks_per_sm: int = BLOCKS_PER_SM,
                          ring: bool = True,
                          lines: int | None = None) -> torch.Tensor:
    """Launch csrc/probe_pipe.cu on one plane of F frames with
    :func:`pipe_plan`'s grid (``ring`` and ``lines`` as it takes them);
    returns the new plane, equal to :func:`grain_plane_cuda`'s.  ``pix``:
    (F, R*bh, C*bw) uint16 on a CUDA device (a plane that is not 16-byte
    aligned is copied first); ``words``: (F, R, C) int32 lattice words.
    Adds one to ``grain_plane_pipe_cuda.launches`` per launch."""
    if blocks_per_sm not in GRIDS:
        raise ValueError(f"blocks_per_sm must be one of {GRIDS}, got "
                         f"{blocks_per_sm!r}")
    bh, bw = 16 // (csuby if c else 1), 16 // (csubx if c else 1)
    F, R, C = words.shape
    dev = pix.device
    _check_plane(f"plane {c}", pix, (F, R * bh, C * bw), torch.uint16, dev)
    _check_plane("words", words, (F, R, C), torch.int32, dev)
    if dev.type != "cuda":
        raise ValueError(f"grain_plane_pipe_cuda needs CUDA tensors, got "
                         f"{dev}")
    plan = pipe_plan(F, R, C, c=c, csubx=csubx, csuby=csuby,
                     blocks_per_sm=blocks_per_sm,
                     sms=torch.cuda.get_device_properties(dev)
                     .multi_processor_count, ring=ring, lines=lines)
    for k in ("pattern", "slut", "plut", "scalars"):
        if tables[k].device != dev or not tables[k].is_contiguous():
            raise ValueError(f"tables[{k!r}] must be contiguous on {dev}")
    pattern = tables["pattern"][1 if c else 0]
    slut, plut = tables["slut"][c], tables["plut"][c]
    if any(t.data_ptr() % 16 for t in (pattern, slut, plut)):
        raise ValueError("pattern bank and LUTs must be 16-byte aligned")
    if pix.data_ptr() % 16:
        # bulk copies read 16-byte aligned lines: take a plane that starts
        # off that grid (a view into a larger buffer) into a fresh one
        pix = pix.clone()
    lib = _kernels.load("probe_pipe")
    out = torch.empty_like(pix)
    rc = lib.vfg_probe_pipe(
        pix.data_ptr(), out.data_ptr(), words.data_ptr(), pattern.data_ptr(),
        slut.data_ptr(), plut.data_ptr(), tables["scalars"].data_ptr(),
        F, R, C, c, csubx, csuby, bs, int(tables["zero_scale"][c]),
        blocks_per_sm, plan["blocks"], int(ring), plan["tile"],
        plan["lines"], plan["stages"],
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"probe_pipe kernel launch failed: CUDA error {rc}")
    grain_plane_pipe_cuda.launches += 1
    return out


grain_plane_pipe_cuda.launches = 0


def pipe_info(plan: dict) -> dict:
    """Registers per thread, static and dynamic shared memory bytes, local
    memory bytes per thread (stack and spills) and thread blocks per SM
    (the occupancy calculator) of the instance that runs ``plan``.  Builds
    the kernel; needs a card."""
    info = _kernels.kernel_info(
        _kernels.load("probe_pipe").vfg_probe_pipe_info,
        plan["blocks_per_sm"], int(plan["ring"]), plan["smem"])
    return dict(info, dynamic_smem=plan["smem"])


def make_pipe_step(tables: dict, *, height: int, width: int, bs: int = 2,
                   csubx: int = 2, csuby: int = 2,
                   blocks_per_sm: int = BLOCKS_PER_SM, ring: bool = True):
    """The probe as a batched step ``(y, u, v, bases, bases_up) -> (y, u,
    v)`` (signature of the JAX probe's step): the lattice, then the probe
    kernel on each plane (``ring`` False: its ablation without the ring);
    on CPU tensors the plain grain step."""
    geo = dict(bs=bs, csubx=csubx, csuby=csuby)

    def step(y, u, v, bases, bases_up):
        del bases_up   # a frame's first block row never blends
        _check_batch(y, u, v, bases, tables, height, width)
        if y.device.type == "cpu":
            return add_grain_batch_plain(y, u, v, bases, tables, **geo)
        words = _as_int32_words(_lattice(bases, y))
        return tuple(grain_plane_pipe_cuda(p, words, tables, c=c,
                                           blocks_per_sm=blocks_per_sm,
                                           ring=ring, **geo)
                     for c, p in enumerate((y, u, v)))

    return step


def run_config(kind: str, state0, F: int):
    """Time K1 and the probe (at each of :data:`GRIDS` blocks per SM) on
    config ``kind`` on the card, kernels alone on one lattice: the
    three-plane step (chained, CUDA events) and each plane's launch (its
    device time, profiled); check both against each other and the plain
    version.  Prints two lines; returns ({name: ms per step}, {name: [device
    ms per plane]}, exact)."""
    regs = hz.config_regs(kind)
    dev = state0[0].device
    tables = natural_tables(regs, dev)
    y = state0[0]
    R, C = y.shape[1] // 16, y.shape[2] // 16
    bases, _ = hz.frame_bases(regs, F, R, C)
    lat = _lattice(bases, y)
    words = _as_int32_words(lat)
    geo = dict(bs=regs.bs, csubx=regs.csubx, csuby=regs.csuby)

    def k1(c):
        return lambda p, w: (grain_plane_cuda(p, w, tables, c=c, **geo),)

    def pipe(bps):
        return lambda c: lambda p, w: (grain_plane_pipe_cuda(
            p, w, tables, c=c, blocks_per_sm=bps, **geo),)

    def step(per_plane):
        fns = [per_plane(c) for c in range(3)]
        return lambda y, u, v, w: tuple(f(p, w)[0] for f, p in
                                        zip(fns, (y, u, v)))

    kernels = {"K1": k1, **{f"pipe/{bps}": pipe(bps) for bps in GRIDS}}
    want = step(k1)(*state0, words)
    plain = _grain_planes_plain(state0, [lat] * 3, [_rows_above(lat)] * 3,
                                tables, **geo)
    exact = all(torch.equal(a, b) for a, b in zip(want, plain))
    exact &= all(all(torch.equal(a, b) for a, b in
                     zip(step(pipe(bps))(*state0, words), want))
                 for bps in GRIDS)
    times = {n: hz.chain_ms(step(f), state0, (words,))
             for n, f in kernels.items()}
    planes = {n: [hz.profile(lambda c=c, p=p, f=f: f(c)(p, words),
                             20)["kernels_ms"]
                  for c, p in enumerate(state0)]
              for n, f in kernels.items()}
    print(f"{kind:8s} " + "  ".join(f"{n}={ms:.4f} ms" for n, ms in
                                    times.items())
          + f"  {'exact (K4 == K1 == plain)' if exact else '*** DIVERGES ***'}",
          flush=True)
    print(f"{'':8s} per plane Y/U/V: " + "  ".join(
        f"{n}=" + "/".join(f"{ms:.4f}" for ms in v) for n, v in
        planes.items()), flush=True)
    return times, planes, exact


SWEEP_LINES = (1, 2, 4, 8)   # lines per stage the sweep tries


def sweep(state0, F: int) -> dict:
    """On the default config: each plane's device time (profiled, 20
    launches) of the probe at each grid of :data:`GRIDS`, with the ring at
    each of :data:`SWEEP_LINES` lines per stage that fits and without it,
    beside K1's; each output checked against K1's.  Prints one line per
    case; returns ({case: [ms per plane]}, exact)."""
    regs = hz.config_regs("default")
    dev = state0[0].device
    tables = natural_tables(regs, dev)
    R, C = state0[0].shape[1] // 16, state0[0].shape[2] // 16
    bases, _ = hz.frame_bases(regs, F, R, C)
    words = _as_int32_words(_lattice(bases, state0[0]))
    geo = dict(bs=regs.bs, csubx=regs.csubx, csuby=regs.csuby)
    want = [grain_plane_cuda(p, words, tables, c=c, **geo)
            for c, p in enumerate(state0)]
    cases = {"K1": lambda c, p: grain_plane_cuda(p, words, tables, c=c,
                                                 **geo)}
    for bps in GRIDS:
        for lines in SWEEP_LINES:
            try:
                for c in range(3):
                    pipe_plan(F, R, C, c=c, csubx=regs.csubx,
                              csuby=regs.csuby, blocks_per_sm=bps,
                              lines=lines)
            except ValueError:
                continue   # the ring does not fit at this grid
            cases[f"ring/{bps}/{lines}"] = (
                lambda c, p, bps=bps, lines=lines: grain_plane_pipe_cuda(
                    p, words, tables, c=c, blocks_per_sm=bps, lines=lines,
                    **geo))
        cases[f"direct/{bps}"] = (
            lambda c, p, bps=bps: grain_plane_pipe_cuda(
                p, words, tables, c=c, blocks_per_sm=bps, ring=False, **geo))
    res, exact = {}, True
    for name, fn in cases.items():
        exact &= all(torch.equal(fn(c, p), want[c])
                     for c, p in enumerate(state0))
        res[name] = [hz.profile(lambda c=c, p=p: fn(c, p), 20)["kernels_ms"]
                     for c, p in enumerate(state0)]
        print(f"  {name:12s} device ms Y/U/V " + " / ".join(
            f"{ms:.4f}" for ms in res[name])
              + f"  sum {sum(res[name]):.4f}", flush=True)
    print(f"  sweep {'exact (== K1)' if exact else '*** DIVERGES ***'}",
          flush=True)
    return res, exact


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kinds = [a for a in argv if not a.startswith("--")] or [
        "default", "sei_ar", "afgs1"]
    if not torch.cuda.is_available():
        print("probe_ohpipe: no CUDA device; the probe times the kernel on "
              "the card only", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    F = hz.FRAMES_BATCH
    state0 = hz.random_state(F, 0, device=dev)
    print(f"card: {hz.card()}; {hz.W}x{hz.H} 10-bit 4:2:0, {F} frames per "
          f"step; kernels alone, CUDA events, median of 3 chains of 20, "
          f"planes profiled; pipe/N: at most N thread blocks per SM",
          flush=True)
    ok = True
    for kind in kinds:
        ok &= run_config(kind, state0, F)[2]
    if "--sweep" in argv:
        print("sweep (default config): ring/N/L: N blocks per SM, L lines a "
              "stage; direct/N: no ring, pixels from device memory",
              flush=True)
        ok &= sweep(state0, F)[1]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
