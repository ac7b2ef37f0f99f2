"""The port's ``run_file`` across mid-stream AFGS1 config switches (the C
model's ``-c POC:file`` list over VFGS's 15 AFGS1 test cfgs) against the
benchmark's frozen plain reference (``portbench/reference/``) and the JAX
package, on the CPU: every frame byte-equal.  The cases switch at POC 1,
twice inside one batch, on a batch boundary and in scenes of one frame,
at batches of 8 and 3, through the native reader and writer and through
the Python path, at 8 and 10 bits; their scenes cover AR lag 2 and 3,
luma-only grain, chroma scaled from luma, overlap off and every grain
seed of the cfgs."""

import os

import numpy as np
import pytest
import torch

from portbench import frames
from portbench.reference.model import Reference
from versatilefilmgrain_tpu.pipeline import GrainPipeline as JaxPipeline
from versatilefilmgrain_tpu_torch.pipeline import GrainPipeline
from versatilefilmgrain_tpu_torch.utils import native_io

from torch_port_cases import CFG_DIR

W, H = 256, 144
SEED = 2021
# The benchmark configuration's cfgs, in its order (fhd8_afgs1_scenes).
CFGS = [f"fgs_afgs1_test{k}.cfg"
        for k in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 15, 16)]

# name: (depth, batch, native I/O, frames, [(poc, index into CFGS), ...])
CASES = {
    "switch_at_poc_1": (8, 8, True, 12, [(0, 0), (1, 1)]),
    "two_switches_in_one_batch": (8, 8, False, 14,
                                  [(0, 2), (3, 5), (6, 13)]),
    "switch_on_batch_boundary": (8, 8, True, 20,
                                 [(0, 3), (8, 6), (16, 12)]),
    "scenes_of_one_frame": (8, 3, True, 11,
                            [(0, 4), (4, 7), (5, 8), (6, 9), (7, 11)]),
    "batch_3_boundaries": (8, 3, False, 13, [(0, 10), (3, 14), (9, 0)]),
    "switch_at_poc_1_batch_3": (8, 3, False, 7, [(1, 12), (2, 13)]),
    "ten_bit_batch_8": (10, 8, True, 14, [(0, 1), (2, 5), (10, 13)]),
    "ten_bit_batch_3": (10, 3, False, 10, [(1, 13), (2, 0), (7, 11)]),
}


def _schedule(pocs):
    return [(poc, os.path.join(CFG_DIR, CFGS[k])) for poc, k in pocs]


def test_cases_cover_the_schedule_kinds():
    """Every cfg of the configuration appears in some case."""
    used = {k for case in CASES.values() for _, k in case[4]}
    assert used == set(range(len(CFGS)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_file_across_scenes_matches_reference_and_jax(
        name, tmp_path, monkeypatch):
    depth, batch, native, nfr, pocs = CASES[name]
    schedule = _schedule(pocs)
    configs = [f"{poc}:{path}" for poc, path in schedule]
    src = tmp_path / "in.yuv"
    with open(src, "wb") as f:
        for n in range(nfr):
            f.write(frames.raw_frame(
                frames.frame_planes(W, H, depth, 0, SEED, n)).tobytes())
    outs = {}
    for side in ("torch", "jax"):
        with monkeypatch.context() as m:
            if side == "torch" and not native:
                m.setattr(native_io, "available", lambda: False)
            pipe = (GrainPipeline(W, H, depth, 0, configs=configs,
                                  engine="ref", device="cpu")
                    if side == "torch" else
                    JaxPipeline(W, H, depth, 0, configs=configs,
                                engine="fast"))
            dst = tmp_path / f"out_{side}.yuv"
            assert pipe.run_file(str(src), str(dst), batch=batch) == nfr
            outs[side] = dst.read_bytes()
    assert outs["torch"] == outs["jax"]

    ref = Reference(W, H, depth, 0, schedule)
    fb = frames.frame_bytes(W, H, depth, 0)
    got = np.frombuffer(outs["torch"], np.uint8)
    assert got.size == nfr * fb
    for n in range(nfr):
        planes = frames.split_raw(got[n * fb:(n + 1) * fb], W, H, depth, 0)
        want = ref.grain(*(torch.from_numpy(p.copy()) for p in
                           frames.padded_frame(W, H, depth, 0, SEED, n)), n)
        for g, w in zip(planes, want):
            assert np.array_equal(g, w.numpy()[:g.shape[0], :g.shape[1]]), \
                f"frame {n}"
