"""Multi-process deployment helpers.

Port of the JAX package's parallel/distributed.py.  The engine's zero-halo
design (see parallel/mesh.py) means multi-process scaling is pure data
parallelism over frames: each process grains its own frame subset with
closed-form LFSR bases, no collectives in the steady state, and the
concatenated output is bit-identical to a single-process run.

Two deployment shapes:

* **Process group** (`init_distributed` + `make_global_mesh`): one torch
  process per host (or per card), joined in a ``torch.distributed`` gloo
  group; each process meshes its own devices and feeds the frames of its
  contiguous shard (:func:`frame_shard`, or ``frame_index % world_size ==
  rank``); the per-frame lattice bases make any assignment bit-exact.  The
  group carries only small host objects (a digest gather, say), so gloo
  serves it on any layout, including several ranks sharing one card, which
  NCCL refuses.
* **Embarrassingly parallel**: independent jobs over disjoint frame ranges
  using ``GrainPipeline(seek=N, grain_offset=N)`` (CLI: ``-s N
  --grain-offset N``).  ``grain_offset`` computes the state lattice at the
  *global* frame index (the reference's ``-s`` only seeks the input,
  restarting grain state from the seed -- replicated when grain_offset=0),
  so shard outputs concatenate bit-identically to a single full run, AFGS1
  mid-stream reseeds included.  A crashed shard is simply re-run from its
  start frame: checkpoint/resume needs no state files at all.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import make_mesh


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Join the gloo process group whose rendezvous is ``host:port``
    ``coordinator_address`` as rank ``process_id`` of ``num_processes``
    (no-op when single-process / already up)."""
    if num_processes in (None, 1) or dist.is_initialized():
        return
    dist.init_process_group("gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def make_global_mesh(tile: int = 1, devices=None):
    """Mesh over this process's devices: ('data', 'tile').

    JAX's global mesh spans every device of every process, because one jitted
    step drives them all.  A torch process launches only on its own devices,
    and the port's ``Mesh`` runs its shards in turn (parallel/mesh.py), so
    here the global view is the process group and each process meshes its
    own devices: the CUDA devices, or ``devices`` (``["cpu"] * n`` on the
    CPU).  With neither a card nor ``devices`` it raises, as ``make_mesh``
    does; there is no CPU fallback."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: make_global_mesh meshes this "
                               "process's CUDA devices; pass "
                               "devices=[\"cpu\"] * n for the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = len(devices)
    if n % tile:
        raise ValueError(f"{n} devices do not split into tiles of {tile}")
    return make_mesh(n // tile, tile, devices)


def frame_shard(num_frames: int, num_shards: int, shard: int) -> range:
    """Contiguous frame range for one shard (balanced)."""
    base = num_frames // num_shards
    extra = num_frames % num_shards
    start = shard * base + min(shard, extra)
    return range(start, start + base + (1 if shard < extra else 0))
