"""The torch port's GrainPipeline against the JAX package's (engine "fast"):
per-frame processing and the batched file loop, at an unaligned size
(padding + crop) and at a pad-leak width (stateful padded buffer), plus the
engine/device rules of the port."""

import json
import os

import numpy as np
import pytest

from versatilefilmgrain_tpu.pipeline import GrainPipeline as JaxPipeline
from versatilefilmgrain_tpu_torch import cli
from versatilefilmgrain_tpu_torch.ops import grain_natural
from versatilefilmgrain_tpu_torch.pipeline import GrainPipeline
from versatilefilmgrain_tpu_torch.utils.parsers import ConfigError

from torch_port_cases import CFG_DIR

# (width, height, depth, frames): 250x140 is unaligned; width 145 leaves a
# one-sample deblock read past the frame edge (145 % 16 == 1, pad leak).
SIZES = [(250, 140, 10, 3), (145, 128, 8, 5)]


def _frames(w, h, depth, n, seed):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if depth == 8 else np.uint16
    hi = (1 << depth) - 1
    return [tuple(rng.integers(0, hi + 1, shape).astype(dt)
                  for shape in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
            for _ in range(n)]


@pytest.mark.parametrize("w,h,depth,nfr", SIZES)
def test_process_frame_matches_jax(w, h, depth, nfr):
    ref = JaxPipeline(w, h, depth, 0, engine="fast")
    got = GrainPipeline(w, h, depth, 0, engine="ref", device="cpu")
    assert got._has_pad_leak() == (w == 145)
    refs, outs = [], []
    for n, planes in enumerate(_frames(w, h, depth, nfr, 11)):
        refs.append(ref.process_frame(tuple(p.copy() for p in planes), n))
        outs.append(got.process_frame(planes, n))
    # Compared after the whole run: a returned frame must not change when
    # later frames are processed.
    for n, (a, b) in enumerate(zip(refs, outs)):
        for c in range(3):
            assert b[c].dtype == a[c].dtype, (n, c)
            assert np.array_equal(a[c], b[c]), f"frame {n} plane {c}"


@pytest.mark.parametrize("w,h,depth,nfr", SIZES)
def test_run_file_matches_jax(w, h, depth, nfr, tmp_path):
    src = tmp_path / "in.yuv"
    with open(src, "wb") as f:
        for planes in _frames(w, h, depth, nfr, 23):
            for p in planes:
                f.write(p.tobytes())
    # A mid-stream config switch at frame 2 splits the batches there.
    cfgs = [f"2:{os.path.join(CFG_DIR, 'fgs_sei_ar_test1.cfg')}"]
    outs = {}
    for name, pipe in (
            ("jax", JaxPipeline(w, h, depth, 0, configs=cfgs, engine="fast")),
            ("torch", GrainPipeline(w, h, depth, 0, configs=cfgs,
                                    engine="ref", device="cpu"))):
        dst = tmp_path / f"out_{name}.yuv"
        assert pipe.run_file(str(src), str(dst), batch=2) == nfr
        outs[name] = dst.read_bytes()
    assert outs["torch"] == outs["jax"]


def test_process_frame_then_run_share_the_carry(tmp_path):
    """At a pad-leak width, process_frame for frames 0-2 and then run() on
    the rest of the file, on one pipeline, against the JAX package doing
    the same: run() starts from the padding that frame 2 left (it numbers
    its own frames from 0 again, in both packages).  Gain 400 grows the
    carried padding fast enough for three frames of it to show."""
    w, h, depth, gain = 145, 128, 8, 400
    frames = _frames(w, h, depth, 6, 31)
    src = tmp_path / "in.yuv"
    with open(src, "wb") as f:
        for planes in frames[3:]:
            for p in planes:
                f.write(p.tobytes())
    outs = {}
    for name, pipe in (
            ("jax", JaxPipeline(w, h, depth, 0, gain=gain, engine="fast")),
            ("torch", GrainPipeline(w, h, depth, 0, gain=gain, engine="ref",
                                    device="cpu")),
            ("fresh", GrainPipeline(w, h, depth, 0, gain=gain, engine="ref",
                                    device="cpu"))):
        got = [] if name == "fresh" else [
            pipe.process_frame(tuple(p.copy() for p in planes), n)
            for n, planes in enumerate(frames[:3])]
        dst = tmp_path / f"out_{name}.yuv"
        with open(src, "rb") as fs, open(dst, "wb") as fd:
            assert pipe.run(fs, fd) == 3
        outs[name] = (got, dst.read_bytes())
    for n, (a, b) in enumerate(zip(outs["jax"][0], outs["torch"][0])):
        for c in range(3):
            assert np.array_equal(a[c], b[c]), f"frame {n} plane {c}"
    assert outs["torch"][1] == outs["jax"][1]
    # without the first three frames' padding, run() writes other bytes
    assert outs["fresh"][1] != outs["torch"][1]


def test_run_file_outdepth_and_profile(tmp_path):
    w, h, nfr = 256, 144, 3
    src = tmp_path / "in.yuv"
    with open(src, "wb") as f:
        for planes in _frames(w, h, 10, nfr, 5):
            for p in planes:
                f.write(p.tobytes())
    ref_dst, dst = tmp_path / "ref.yuv", tmp_path / "out.yuv"
    JaxPipeline(w, h, 10, 0, engine="fast").run_file(
        str(src), str(ref_dst), odepth=8, batch=4)
    prof = tmp_path / "prof"
    n = GrainPipeline(w, h, 10, 0, device="cpu").run_file(
        str(src), str(dst), odepth=8, batch=4, profile_dir=str(prof),
        verbose=True)
    assert n == nfr
    assert dst.read_bytes() == ref_dst.read_bytes()
    with open(prof / "trace.json") as f:
        assert json.load(f)["traceEvents"]


def test_tables_follow_config_generation():
    path = os.path.join(CFG_DIR, "fgs_afgs1_test2.cfg")
    pipe = GrainPipeline(256, 144, 10, 0, configs=[f"3:{path}"], device="cpu")
    first = pipe._tables()
    pipe.maybe_switch_config(2)
    assert pipe._tables() is first
    pipe.maybe_switch_config(3)
    second = pipe._tables()
    assert second is not first
    assert not np.array_equal(first["slut"].numpy(), second["slut"].numpy())


def test_engine_selection_without_card(monkeypatch, tmp_path):
    """No device means the card: without one, the pipeline and the CLI
    raise, naming CUDA.  ``device="cpu"`` runs the plain engines there;
    the CUDA-only engine still raises on the CPU."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}, {"engine": "fast"}):
        with pytest.raises(RuntimeError, match="CUDA.*device=\"cpu\""):
            GrainPipeline(256, 144, 10, 0, **kw)
    pipe = GrainPipeline(256, 144, 10, 0, device="cpu")
    assert (pipe.device.type, pipe.engine) == ("cpu", "ref")
    assert GrainPipeline(256, 144, 10, 0, engine="fast",
                         device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        GrainPipeline(256, 144, 10, 0, engine="natural", device="cpu")
    tiled = GrainPipeline(256, 144, 10, 0, engine="pallas", device="cpu")
    assert (tiled.device.type, tiled.engine) == ("cpu", "pallas")
    assert "win_luma" in tiled._tables()
    with pytest.raises(ConfigError, match="unknown engine"):
        GrainPipeline(256, 144, 10, 0, engine="tiled", device="cpu")
    src = tmp_path / "in.yuv"
    src.write_bytes(bytes(256 * 144 * 3))
    args = ["vfgs-torch", "-w", "256", "-h", "144", "-b", "8"]
    files = [str(src), str(tmp_path / "o.yuv")]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(args + ["--engine", "natural", "--device", "cpu"] + files)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(args + files)
    assert cli.main(args + ["--device", "tpu"] + files) == 1
    assert cli.main(args + ["--device", "cpu"] + files) == 0
    assert (tmp_path / "o.yuv").stat().st_size == src.stat().st_size
    assert grain_natural.grain_plane_cuda.launches == 0
