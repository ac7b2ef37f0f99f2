"""The frame loop on frames that live on the device
(``GrainPipeline.run_device`` with ``utils/device_io.py``'s ends), on the
CPU, where the ends hold CPU tensors: its output bytes and frame count
against ``run_file`` across a batch of 8 with the built-in FGC SEI, AFGS1
switches that cut batches, a pad-leak width, 10 bits written as 8,
luma-only 4:2:2, ``seek``, fewer frames than the source holds and a
source that ends mid-batch, with the ``device_frames``, ``ring_frames``
and ``switch_cuts`` counters; its frames against the benchmark's frozen
plain reference (``portbench/reference/``), exactly; the ends' lending
and refusals; and the benchmark's ``device`` driver on a small
configuration: correct, not correct under the control, and refused by a
program without ``run_device``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import frames
from portbench.reference.model import Reference
from portbench.run import load_file
from versatilefilmgrain_tpu_torch.models import config as cfgmod
from versatilefilmgrain_tpu_torch.pipeline import GrainPipeline
from versatilefilmgrain_tpu_torch.utils import device_io, tracing, yuv

from torch_port_cases import CFG_DIR, REPO, luma_only_sei

# name: (width, height, depth, odepth, batch, frames in the source, frames
#        asked for (0: all), [(poc, AFGS1 test cfg), ...])
CASES = {
    # the built-in FGC SEI (frequency filtering on Y, Cb, Cr): 8, 8, 4
    "sei_batch_8": (256, 192, 10, 0, 8, 20, 0, []),
    # batches [0, 3), [3, 6), [6, 10), [10, 12): both switches cut one
    "afgs1_switches": (256, 144, 8, 0, 4, 12, 0, [(3, 2), (6, 12)]),
    # luma 145 % 16 == 1: one frame a step, the padding carried
    "pad_leak": (145, 130, 10, 0, 4, 6, 0, []),
    "ten_bits_to_eight": (200, 130, 10, 8, 4, 9, 0, []),
    # 4:2:2, luma-only grain
    "luma_only_422": (250, 140, 10, 0, 3, 7, 0, []),
    # the source lends from POC 2; the switch at POC 5 cuts [0, 3)
    "seek_two": (256, 144, 8, 0, 4, 12, 0, [(5, 7)]),
    # 5 of 12 frames asked for
    "fewer_frames_than_the_source": (256, 144, 10, 0, 4, 12, 5, []),
    # 4, 4 and 3 frames: the source ends inside the third batch
    "source_ends_mid_batch": (256, 144, 10, 0, 4, 11, 0, []),
}
EXTRA = {"luma_only_422": dict(fmt=yuv.YUV_422, luma_only=True),
         "seek_two": dict(seek=2)}


@pytest.fixture(autouse=True)
def recorder(monkeypatch):
    """A fresh recorder for each test."""
    monkeypatch.setattr(tracing, "_R", tracing.Recorder())


def _raw(w, h, depth, fmt, nfr, seed=26) -> bytes:
    rng = np.random.default_rng(seed)
    dt = np.uint8 if depth == 8 else np.uint16
    n = nfr * yuv.frame_bytes(w, h, depth, fmt) // np.dtype(dt).itemsize
    return rng.integers(0, 1 << depth, n).astype(dt).tobytes()


def _device_frames(data: bytes, fb: int) -> list:
    """The frames of ``data`` as the device ends lend them: 1-D uint8
    tensors, here on the CPU."""
    arr = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    return list(arr.view(-1, fb))


class _AdapterSink:
    """An encoder's adapter in place of ``DeviceSink``: frames of its own
    allocation each, none a row of a shared buffer, written out in the
    order put."""

    def __init__(self, frame_bytes: int, nbuf: int):
        self.free = [torch.empty(frame_bytes, dtype=torch.uint8)
                     for _ in range(nbuf)]
        self.got = []

    def acquire(self):
        return self.free.pop(0)

    def put(self, frame):
        self.got.append(frame.numpy().tobytes())
        self.free.append(frame)

    def give_back(self, frames):
        self.free += [f for f in frames
                      if all(f is not g for g in self.free)]


def _run_device(pipe, lent, fb_out, batch, adapter=False, **kw):
    """``run_device`` over the frames ``lent`` into ``DeviceSink`` (or an
    adapter's sink); returns (frames written, the bytes handed on)."""
    if adapter:
        sink = _AdapterSink(fb_out, 3 * batch)
        got = sink.got
    else:
        got = []
        sink = device_io.DeviceSink(fb_out, 3 * batch, pipe.device,
                                    lambda f: got.append(f.numpy().tobytes()))
    n = pipe.run_device(device_io.DeviceSource(lent), sink, batch=batch,
                        **kw)
    return n, b"".join(got)


@pytest.mark.parametrize("layout", ["rows", "frames"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_run_device_matches_run_file(name, layout, tmp_path):
    """``rows``: the source's frames are rows of one buffer and the sink is
    ``DeviceSink``, whose ring frames are rows too; ``frames``: each frame
    an allocation of its own, as a decoder's surfaces and an encoder's
    adapter hold them.  Both take a copy a frame and plane each way."""
    w, h, depth, odepth, batch, nfr, want, pocs = CASES[name]
    extra = EXTRA.get(name, {})
    fmt, seek = extra.get("fmt", yuv.YUV_420), extra.get("seek", 0)
    configs = [f"{poc}:{os.path.join(CFG_DIR, f'fgs_afgs1_test{k}.cfg')}"
               for poc, k in pocs]

    def pipe():
        return GrainPipeline(w, h, depth, fmt, device="cpu", configs=configs,
                             seek=seek, initial_sei=luma_only_sei(cfgmod)
                             if extra.get("luma_only") else None)
    data = _raw(w, h, depth, fmt, nfr)
    src = tmp_path / "in.yuv"
    src.write_bytes(data)
    n_out = want or nfr - seek
    with tracing.forced():
        assert pipe().run_file(str(src), str(tmp_path / "out.yuv"),
                               frames=want, odepth=odepth,
                               batch=batch) == n_out
    by_file = tracing.counters()
    tracing._R.restart()
    fb = yuv.frame_bytes(w, h, depth, fmt)
    with tracing.forced():
        lent = _device_frames(data, fb)[seek:]
        if layout == "frames":
            lent = [f.clone() for f in lent]
        n, got = _run_device(
            pipe(), lent, yuv.frame_bytes(w, h, odepth or depth, fmt), batch,
            adapter=layout == "frames", frames=want, odepth=odepth)
    c = tracing.counters()
    assert n == n_out
    assert got == (tmp_path / "out.yuv").read_bytes()
    assert c["frames"] == c["device_frames"] == n_out
    assert c.get("ring_frames", 0) == 0
    assert c.get("switch_cuts", 0) == by_file.get("switch_cuts", 0)
    assert c["batches"] == by_file["batches"]
    # padded planes alone: no device bytes for host frames
    assert c["staging_allocs"] == 3


# The reference's configurations: the built-in FGC SEI, and one AFGS1 cfg
# popped at frame 0 over it.
REFERENCE = {"fgc_sei": [], "afgs1": [(0, "fgs_afgs1_test2.cfg")]}


@pytest.mark.parametrize("name", sorted(REFERENCE))
def test_run_device_equals_the_reference(name):
    """Every frame ``run_device`` hands on, at 256x192 10-bit and batch 8,
    against ``portbench/reference/``'s grain of the same seeded input,
    sample for sample."""
    W, H, D, seed, nfr = 256, 192, 10, 2**31 + 5, 12
    schedule = [(poc, os.path.join(CFG_DIR, cfg))
                for poc, cfg in REFERENCE[name]]
    fb = frames.frame_bytes(W, H, D, 0)
    lent = [torch.from_numpy(frames.raw_frame(
        frames.frame_planes(W, H, D, 0, seed, i))) for i in range(nfr)]
    pipe = GrainPipeline(W, H, D, 0, device="cpu", configs=[
        f"{poc}:{cfg}" for poc, cfg in schedule])
    n, got = _run_device(pipe, lent, fb, 8)
    assert n == nfr and len(got) == nfr * fb
    ref = Reference(W, H, D, 0, schedule)
    out = np.frombuffer(got, np.uint8)
    for i in range(nfr):
        planes = frames.split_raw(out[i * fb:(i + 1) * fb], W, H, D, 0)
        want = ref.grain(*(torch.from_numpy(p.copy()) for p in
                           frames.padded_frame(W, H, D, 0, seed, i)), i)
        for g, w in zip(planes, want):
            assert np.array_equal(g, w.numpy()[:g.shape[0], :g.shape[1]]), \
                f"frame {i}"


def test_device_ends_lend_and_refuse():
    """The sink lends its ring in turn, refuses a frame it did not lend or
    that was put, and takes back given-back frames; the source counts
    what it lends and what is released."""
    handed = []
    sink = device_io.DeviceSink(6, 2, "cpu", handed.append)
    a, b = sink.acquire(), sink.acquire()
    with pytest.raises(RuntimeError):
        sink.acquire()
    a.fill_(1)
    sink.put(a)
    assert len(handed) == 1 and handed[0].tolist() == [1] * 6
    with pytest.raises(ValueError):
        sink.put(a)
    with pytest.raises(ValueError):
        sink.put(torch.zeros(6, dtype=torch.uint8))
    sink.give_back([a, b])
    assert sink.acquire().data_ptr() == a.data_ptr()
    src = device_io.DeviceSource(iter([a, b]))
    assert src.next() is a and src.next() is b and src.next() is None
    src.release(1)
    with pytest.raises(ValueError):
        src.release(2)
    assert (src.lent, src.released) == (2, 1)


def test_run_device_refuses_a_frame_of_another_size():
    pipe = GrainPipeline(256, 144, 8, 0, device="cpu")
    fb = yuv.frame_bytes(256, 144, 8, 0)
    sink = device_io.DeviceSink(fb, 3, "cpu", lambda f: None)
    with pytest.raises(ValueError, match="1-D uint8 tensor"):
        pipe.run_device(device_io.DeviceSource(
            [torch.zeros(fb - 2, dtype=torch.uint8)]), sink, batch=1)


# -- the benchmark's device driver on the CPU ---------------------------------

CELL = "small10_sei.gpu"
CELLS_DIR = os.path.join(REPO, "portbench", "tests")
# A run of the cell on the CPU, in a process of its own: this one has
# loaded JAX (tests/conftest.py), which a run refuses.  Arguments: the
# checkout, the seed, --trace, and ``sound``, a fault of faults.py, or
# ``parent`` (a program without run_device).  Prints [rc, result, stderr].
RUN = """
import contextlib, json, sys
from cells import run_cell
from portbench import faults
from versatilefilmgrain_tpu_torch.pipeline import GrainPipeline
root, seed, trace, kind = sys.argv[1:5]
if kind == "parent":
    del GrainPipeline.run_device
with (faults.planted(kind) if kind in faults.KINDS
      else contextlib.nullcontext()):
    got = run_cell(root, "%s", seed=int(seed), trace=int(trace))
print(json.dumps(got))
""" % CELL


@pytest.fixture(scope="module")
def bench_root(tmp_path_factory):
    """A checkout copy (``portbench/tests/cells.py``) whose
    ``BENCHMARK.json`` adds a 256x192 10-bit FGC SEI cell under the
    ``device_b8`` mix, reporting what ``uhd10_sei.gpu_b8`` reports."""
    cells = load_file(os.path.join(CELLS_DIR, "cells.py"),
                      "portbench_test_cells")
    root = cells.make_root(str(tmp_path_factory.mktemp("checkout")))
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append(dict(name=CELL, config="small10_sei",
                                   traffic="device_b8", chips=1, why="test"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "uhd10_sei.gpu_b8" in m.get("workloads", []):
            m["workloads"].append(CELL)
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


def _run_cell(root, kind="sound", trace=0, seed=2**31 + 77):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([CELLS_DIR, REPO]))
    proc = subprocess.run([sys.executable, "-c", RUN, root, str(seed),
                           str(trace), kind], capture_output=True,
                          text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", ["sound", "control"])
def test_device_cell_is_correct_and_fails_the_control(kind, bench_root):
    rc, res, err = _run_cell(bench_root, kind)
    assert rc == 0, err
    checks = res["checks"]
    if kind == "sound":
        assert res["correct"] and res["failed"] == 0, err
        assert checks["mismatched_samples"]["value"] == 0
        assert checks["frames_checked"]["value"] >= 9
        assert checks["frames_missing"]["value"] == 0
        assert set(res["metrics"]) == {"fps_pipe", "setup_s"}
    else:
        assert res["correct"] is False
        assert checks["mismatched_samples"]["value"] > 0


def test_device_cell_traced_reads_the_program_spans(bench_root):
    rc, res, err = _run_cell(bench_root, trace=1)
    assert rc == 0, err
    assert res["correct"]
    # the spans are read on the CPU; device metrics read nothing there
    assert set(res["metrics"]) == {"ends_ms.gpu", "prep_host_ms.gpu",
                                   "bases_ms.gpu", "loop_self_pct.gpu"}
    assert all(m["value"] > 0 for m in res["metrics"].values())


def test_device_cell_refused_by_a_program_without_run_device(bench_root):
    rc, res, err = _run_cell(bench_root, "parent")
    assert rc == 2 and res is None
    assert "run_device" in err
