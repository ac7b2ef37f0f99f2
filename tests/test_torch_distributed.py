"""The torch port's multi-process helpers (parallel/distributed.py) against
the JAX package's: the init no-op, the shard math, the mesh shape, a real
2-process gloo run (subprocess-spawned, rendezvous on localhost) whose
shards concatenate to the JAX package's single-process bytes, and
``--grain-offset`` shards through the port's CLI against the JAX CLI's full
run (the twin of tests/test_shard_recovery.py).  Bytes exact everywhere."""

import os
import sys

import jax
import pytest
import torch

from versatilefilmgrain_tpu.parallel import distributed as jdist
from versatilefilmgrain_tpu_torch.parallel import distributed

from torch_port_cases import CFG_DIR, REPO, run_workers

sys.path.insert(0, os.path.join(REPO, "tools"))

from gen_input import make_input_yuv  # noqa: E402

W, H, NF = 256, 192, 6


def test_init_noop_single_process():
    distributed.init_distributed()          # must not raise
    distributed.init_distributed(num_processes=1)
    assert not torch.distributed.is_initialized()


def test_frame_shard_matches_jax():
    for nf in (1, 5, 6, 7, 8, 10, 13):
        for ns in range(1, 9):
            seen = []
            for s in range(ns):
                got = distributed.frame_shard(nf, ns, s)
                assert got == jdist.frame_shard(nf, ns, s), (nf, ns, s)
                seen.extend(got)
            assert seen == list(range(nf))


@pytest.mark.parametrize("tile", [1, 2, 4, 8])
def test_global_mesh_shape_matches_jax(tile):
    n = len(jax.devices())
    m = distributed.make_global_mesh(tile, devices=["cpu"] * n)
    assert m.shape == dict(jdist.make_global_mesh(tile).shape)
    assert {d for row in m.devices for d in row} == {torch.device("cpu")}
    with pytest.raises(ValueError, match="tiles of"):
        distributed.make_global_mesh(3, devices=["cpu"] * n)


def test_global_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA.*\"cpu\""):
        distributed.make_global_mesh()


def test_two_process_distributed(tmp_path):
    """Two port processes join a gloo group, grain their contiguous frame
    shards on the CPU and gather the shard digests; the concatenated shards
    equal the JAX package's single-process run_file bytes."""
    from versatilefilmgrain_tpu.pipeline import GrainPipeline
    from versatilefilmgrain_tpu.utils import yuv

    inp = str(tmp_path / "in.yuv")
    make_input_yuv(inp, W, H, 10, 0, NF)
    parts, recs, _ = run_workers(inp, str(tmp_path), W, H, NF, 2, "cpu")
    assert all(r["launches"] == 0 for r in recs)   # the CPU runs no kernel

    full = str(tmp_path / "full.yuv")
    pipe = GrainPipeline(W, H, 10, yuv.YUV_420)
    assert pipe.run_file(inp, full, frames=NF, batch=2) == NF
    assert parts == open(full, "rb").read()


def _run(main, prog, args, out):
    assert main([prog] + args + [out]) == 0
    return open(out, "rb").read()


@pytest.mark.parametrize("configs", [
    [],
    ["-c", f"2:{CFG_DIR}/fgs_afgs1_test1.cfg"],
])
def test_grain_offset_shards_equal_jax_full_run(tmp_path, configs):
    from versatilefilmgrain_tpu.cli import main as jax_main
    from versatilefilmgrain_tpu_torch.cli import main as torch_main

    inp = str(tmp_path / "in.yuv")
    make_input_yuv(inp, W, H, 10, 0, NF)
    base = ["-w", str(W), "-h", str(H), "-b", "10"] + configs
    port = ["--device", "cpu"] + base

    full = _run(jax_main, "vfgs-tpu", base + ["-n", str(NF), inp],
                str(tmp_path / "full.yuv"))

    if not configs:
        # The reference's -s restarts grain state per run, so a plain seek
        # shard must not match the full run's slice (with an AFGS1 reseed
        # exactly at the shard boundary it would).
        plain = _run(torch_main, "vfgs-torch",
                     port + ["-s", "2", "-n", "2", inp],
                     str(tmp_path / "plain.yuv"))
        assert plain != full[len(plain):2 * len(plain)]

    parts = b""
    for shard, (start, count) in enumerate(((0, 2), (2, 2), (4, 2))):
        parts += _run(torch_main, "vfgs-torch",
                      port + ["-s", str(start), "--grain-offset", str(start),
                              "-n", str(count), inp],
                      str(tmp_path / f"part{shard}.yuv"))
    assert parts == full
