"""Device-mesh sharding for the grain engine.

Port of the JAX package's parallel/mesh.py.  The reference is strictly
serial; the engine parallelises on two mesh axes:

* ``data`` -- frames.  Grain state at any frame is closed-form in the frame
  index (ops/lfsr.py), so frames are embarrassingly parallel.
* ``tile`` -- 16-luma-line block rows within a frame.  Vertical overlap
  blends *pattern samples* selected by the upper row's lattice, never
  neighbouring pixels, so row tiles need zero halo exchange: a tile shard's
  first row blends from its ``states_up`` row (the kernel's shard boot).

Output is bit-identical under any mesh shape.  A mesh is a grid of
``torch.device``s, repeats allowed: the CPU is one torch device, and one
card can hold every shard (``make_mesh(2, 3, ["cuda:0"] * 6)``).  The step
runs the shards one after another from this process, each on its device;
there are no collectives.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import lfsr
from ..ops.grain_natural import add_grain_shard_natural
from ..ops.grain_ref import plane_grain


@dataclass(frozen=True)
class Mesh:
    """An (n_data, n_tile) grid of devices; ``devices[d][t]`` runs the
    shard of data slice d and tile slice t."""
    devices: tuple

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "tile": len(self.devices[0])}


def make_mesh(n_data: int, n_tile: int, devices=None) -> Mesh:
    """A mesh of the first ``n_data * n_tile`` of ``devices`` (names or
    ``torch.device``s; repeats allowed).  With no ``devices``, the CUDA
    devices; raises if there are too few (never falls back to the CPU)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_data * n_tile
    if n_data < 1 or n_tile < 1 or len(devices) < n:
        raise ValueError(f"mesh ({n_data}, {n_tile}) needs {n} devices, have "
                         f"{len(devices)}")
    return Mesh(tuple(tuple(devices[d * n_tile:(d + 1) * n_tile])
                      for d in range(n_data)))


def default_mesh_shape(n_devices: int, rows: int) -> tuple[int, int]:
    """Pick (data, tile) factors.

    Frames (data) are embarrassingly parallel so they get the larger share;
    tile only takes what divides the block-row count, keeping the mesh 2-D
    when possible (tile sharding is what cuts single-frame latency)."""
    best = (n_devices, 1)
    for t in range(2, min(n_devices, rows) + 1):
        if n_devices % t == 0 and rows % t == 0 and t <= n_devices // t:
            best = (n_devices // t, t)
    return best


def _on(x, dev):
    """``x`` on ``dev``: tensors moved, in dicts and lists too; other
    values as they are."""
    if isinstance(x, dict):
        return {k: _on(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_on(v, dev) for v in x]
    return x.to(dev) if isinstance(x, torch.Tensor) else x


def make_grain_step(mesh: Mesh, *, height: int, width: int, bs: int,
                    csubx: int, csuby: int, engine: str = "fast",
                    tables: dict | None = None,
                    word_expand: str | None = None):
    """Build a multi-device grain step over ``mesh``.

    Returned fn: ``run(y, u, v, bases, bases_up, *table_args) -> (y, u, v)``
    with y: (F, R*16, C*16), u, v: (F, R*bh_c, C*bw_c) (F divisible by the
    mesh's ``data`` size, R by its ``tile`` size); ``bases``/``bases_up``: F
    uint32 per-frame lattice bases.

    ``engine="fast"`` or ``"ref"``: the plain torch engine on each shard
    (the port has no separate fast engine, as its pipeline maps ``--engine
    fast|ref``); ``table_args`` are (pattern, sluts, pluts, scale_shift,
    y_min, y_max, c_min, c_max), as the JAX ``"ref"`` step takes them.

    ``engine="natural"``: pass ``tables=natural_tables(regs, device)`` here
    and call ``run(y, u, v, bases, bases_up)``.  Each shard runs
    ``add_grain_shard_natural`` (the CUDA kernel on a card, its plain
    version on the CPU), its first local row booted from the up-state
    lattice, with ``word_expand`` as in ``add_grain_batch_natural`` (the
    JAX step does not expose it; its shard body takes it).
    """
    R = -(-height // 16)
    C = -(-width // 16)
    nd, nt = mesh.shape["data"], mesh.shape["tile"]
    if R % nt:
        raise ValueError(f"{R} block rows do not split over {nt} tiles")
    if engine == "natural":
        if tables is None:
            raise ValueError("engine='natural' needs tables=")
        on_dev = {}
    elif engine not in ("fast", "ref"):
        raise ValueError(f"unknown engine {engine!r}")
    rt = R // nt
    geo = dict(csubx=csubx, csuby=csuby, bs=bs)

    def shard(y, u, v, states, states_up, ov, dev, targs):
        if engine == "natural":
            if dev not in on_dev:
                on_dev[dev] = _on(tables, dev)
            return add_grain_shard_natural(
                y, u, v, states, states_up, ov, on_dev[dev],
                word_expand=word_expand, **geo)
        pattern, sluts, pluts, ss, y_min, y_max, c_min, c_max = targs
        pattern = pattern.reshape(2, 8, 64, 64)
        return tuple(
            plane_grain(p, states, states_up, pattern[1 if c else 0],
                        sluts[c], pluts[c], ss, lo, hi, ov, c=c, **geo)
            for c, (p, lo, hi) in enumerate(((y, y_min, y_max),
                                             (u, c_min, c_max),
                                             (v, c_min, c_max))))

    def run(y, u, v, bases, bases_up, *table_args):
        F = y.shape[0]
        if F % nd:
            raise ValueError(f"{F} frames do not split over {nd} data shards")
        if tuple(y.shape[1:]) != (R * 16, C * 16):
            raise ValueError(f"luma plane {tuple(y.shape[1:])} is not "
                             f"{height}x{width} padded to 16x16 blocks")
        if engine != "natural" and len(table_args) != 8:
            raise ValueError(f"engine {engine!r} takes 8 table arguments, "
                             f"got {len(table_args)}")
        dev0 = y.device
        states = lfsr.state_lattice_torch(bases, R, C, dev0)
        row0 = lfsr.state_lattice_torch(bases_up, 1, C, dev0)
        states_up = torch.cat([row0, states[:, :-1]], dim=1)
        ov = torch.arange(R) > 0
        bhc = u.shape[1] // R
        fd = F // nd
        rows = []
        for d in range(nd):
            fs = slice(d * fd, (d + 1) * fd)
            tiles = []
            for t in range(nt):
                dev = mesh.devices[d][t]
                rs = slice(t * rt, (t + 1) * rt)
                ls, cs = slice(rs.start * 16, rs.stop * 16), \
                    slice(rs.start * bhc, rs.stop * bhc)
                part = [_on(x.contiguous(), dev) for x in
                        (y[fs, ls], u[fs, cs], v[fs, cs], states[fs, rs],
                         states_up[fs, rs])]
                out = shard(*part, ov[rs], dev, _on(table_args, dev))
                tiles.append([o.to(dev0) for o in out])
            rows.append([torch.cat(p, dim=1) for p in zip(*tiles)])
        return tuple(torch.cat(p, dim=0) for p in zip(*rows))

    return run
