"""Worker process for the torch port's 2-process runs (tests/
test_torch_distributed.py, tests/test_torch_cuda.py, chip_smoke.py).

Each worker:

1. joins the gloo process group (the real ``init_process_group`` branch of
   parallel/distributed.init_distributed);
2. asserts the group's world size and its own rank;
3. grains its contiguous frame shard of a 10-bit 4:2:0 file through the
   batched file pipeline (``seek=start, grain_offset=start`` -- the
   stateless data-parallel deployment mode) on ``device``;
4. gathers every shard's sha256 across the processes
   (``all_gather_object``) and records what it saw, with its own K1
   launches and the seconds its ``run_file`` took, so the parent can verify
   the gather really moved data between processes.

Run it as a fresh interpreter (never fork after CUDA is up); ranks may share
one card.

Usage: torch_distributed_worker.py <coord> <nproc> <pid> <input.yuv> <outdir>
           <width> <height> <frames> <batch> <device>
"""

import hashlib
import json
import os
import sys
import time


def main():
    (coord, nproc, pid, inp, outdir, width, height, frames, batch,
     device) = sys.argv[1:11]
    nproc, pid, width, height, frames, batch = (
        int(nproc), int(pid), int(width), int(height), int(frames),
        int(batch))

    import torch.distributed as dist

    from versatilefilmgrain_tpu_torch.parallel import distributed
    distributed.init_distributed(coordinator_address=coord,
                                 num_processes=nproc, process_id=pid)
    assert dist.get_world_size() == nproc, dist.get_world_size()
    assert dist.get_rank() == pid, dist.get_rank()

    from versatilefilmgrain_tpu_torch.ops.grain_natural import \
        grain_plane_cuda
    from versatilefilmgrain_tpu_torch.pipeline import GrainPipeline
    from versatilefilmgrain_tpu_torch.utils import yuv

    shard = distributed.frame_shard(frames, nproc, pid)
    out = os.path.join(outdir, f"out_{pid}.yuv")
    pipe = GrainPipeline(width, height, 10, yuv.YUV_420, seek=shard.start,
                         grain_offset=shard.start, device=device)
    grain_plane_cuda.launches = 0
    t0 = time.perf_counter()
    n = pipe.run_file(inp, out, frames=len(shard), batch=batch)
    seconds = time.perf_counter() - t0
    assert n == len(shard), (n, len(shard))

    with open(out, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    gathered = [None] * nproc
    dist.all_gather_object(gathered, digest)
    with open(os.path.join(outdir, f"gathered_{pid}.json"), "w") as f:
        json.dump({"pid": pid, "digests": gathered,
                   "launches": grain_plane_cuda.launches,
                   "seconds": seconds}, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
