"""``run_file``'s host buffers, made once a call and reused batch after
batch (a raw ring, two input slots padded in place, two output slots),
on the CPU: its output bytes against ``run()`` (the same loop, one frame
a step) and the JAX package's ``run_file`` across config switches that
cut batches, a short last batch, planes padded in both directions, 10-bit
input written as 8 bits, pad-leak widths, a batch of one, and the native
and the Python I/O; the ``staging_allocs`` counter against the frame
count; the reader's ``next(out=)``; and the in-place padding against
``yuv.pad_plane``."""

import os

import numpy as np
import pytest

from versatilefilmgrain_tpu.pipeline import GrainPipeline as JaxPipeline
from versatilefilmgrain_tpu_torch.pipeline import GrainPipeline
from versatilefilmgrain_tpu_torch.utils import native_io, tracing, yuv

from torch_port_cases import CFG_DIR

# name: (width, height, depth, odepth, batch, frames in the file,
#        frames asked for (0: all), [(poc, AFGS1 test cfg), ...])
CASES = {
    # batches [0, 3), [3, 9), [9, 17), [17, 18): each switch cuts one
    "switches_cut_batches": (256, 144, 8, 0, 8, 18, 0, [(3, 2), (9, 12)]),
    # batches of 4, 4 and 2
    "short_last_batch": (256, 144, 10, 0, 4, 10, 0, []),
    # 250 x 140: 6 padding columns and 4 rows of luma, 3 and 2 of chroma
    "padded_both_ways": (250, 140, 10, 0, 3, 7, 0, []),
    # 200 x 130: odd chroma height (65); 10 bits in, 8 out
    "ten_bits_to_eight": (200, 130, 10, 8, 4, 9, 0, []),
    # 5 of 12 frames asked for, at batch 8: [0, 2) cut, [2, 5)
    "fewer_frames_than_a_batch": (256, 144, 8, 0, 8, 12, 5, [(2, 7)]),
    # pad-leak widths step one frame at a time, whatever the batch, with
    # the padding carried on the device: luma 145 % 16 == 1 ...
    "luma_pad_leak": (145, 128, 8, 0, 4, 6, 0, []),
    # ... and chroma 73 % 8 == 1 (luma 146 % 16 == 2); 10 bits in, 8 out
    "chroma_pad_leak": (146, 130, 10, 8, 4, 5, 0, []),
    "batch_of_one": (256, 144, 8, 0, 1, 5, 0, []),
}


def _source(path, w, h, depth, nfr, seed=22):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if depth == 8 else np.uint16
    with open(path, "wb") as f:
        for _ in range(nfr):
            for shape in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
                f.write(rng.integers(0, 1 << depth, shape).astype(dt)
                        .tobytes())
    return str(path)


@pytest.fixture(autouse=True)
def recorder(monkeypatch):
    """A fresh recorder for each test."""
    monkeypatch.setattr(tracing, "_R", tracing.Recorder())


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_run_file_matches_run_and_jax(name, native, tmp_path, monkeypatch):
    w, h, depth, odepth, batch, nfr, frames, pocs = CASES[name]
    if native and not native_io.available():
        pytest.skip("native I/O toolchain unavailable")
    if not native:
        monkeypatch.setattr(native_io, "available", lambda: False)
    src = _source(tmp_path / "in.yuv", w, h, depth, nfr)
    configs = [f"{poc}:{os.path.join(CFG_DIR, f'fgs_afgs1_test{k}.cfg')}"
               for poc, k in pocs]
    want_n = frames or nfr
    outs = {}
    pipe = GrainPipeline(w, h, depth, 0, configs=configs, device="cpu")
    with tracing.forced():
        assert pipe.run_file(src, str(tmp_path / "b.yuv"), frames=frames,
                             odepth=odepth, batch=batch) == want_n
    outs["run_file"] = (tmp_path / "b.yuv").read_bytes()
    c = tracing.counters()
    assert c["frames"] == want_n
    assert c.get("switch_cuts", 0) == len(pocs)
    pipe = GrainPipeline(w, h, depth, 0, configs=configs, device="cpu")
    with open(src, "rb") as fs, open(tmp_path / "f.yuv", "wb") as fd:
        assert pipe.run(fs, fd, frames=frames, odepth=odepth) == want_n
    outs["run"] = (tmp_path / "f.yuv").read_bytes()
    jpipe = JaxPipeline(w, h, depth, 0, configs=configs, engine="fast")
    assert jpipe.run_file(src, str(tmp_path / "j.yuv"), frames=frames,
                          odepth=odepth, batch=batch) == want_n
    outs["jax"] = (tmp_path / "j.yuv").read_bytes()
    assert len(outs["run_file"]) == want_n * yuv.frame_bytes(
        w, h, odepth or depth, 0)
    assert outs["run_file"] == outs["run"] == outs["jax"]


@pytest.mark.parametrize("odepth", [0, 8])
def test_staging_allocs_do_not_grow_with_the_frames(odepth, tmp_path,
                                                    monkeypatch):
    """16 and 64 frames at batch 4 make the same host buffers: 4 raw
    frames, two input slots of three planes, two output slots."""
    w, h, batch = 144, 128, 4
    src = _source(tmp_path / "in.yuv", w, h, 10, 64)
    made = []
    for frames in (16, 64):
        monkeypatch.setattr(tracing, "_R", tracing.Recorder())
        pipe = GrainPipeline(w, h, 10, 0, device="cpu")
        with tracing.forced():
            assert pipe.run_file(src, str(tmp_path / "out.yuv"),
                                 frames=frames, odepth=odepth,
                                 batch=batch) == frames
        c = tracing.counters()
        assert c["frames"] == frames
        made.append(c["staging_allocs"])
    assert made == [batch + 3 * 2 + 2] * 2


def test_verbose_counters_line_prints_staging_allocs(tmp_path, capsys):
    src = _source(tmp_path / "in.yuv", 144, 128, 8, 6)
    GrainPipeline(144, 128, 8, 0, device="cpu").run_file(
        src, str(tmp_path / "out.yuv"), batch=4, verbose=True)
    err = capsys.readouterr().err
    assert ("counters: frames 6, batches 2, switch_cuts 0, config_pops 0, "
            "table_uploads 1, lfsr_tables ") in err
    assert err.rstrip().endswith("staging_allocs 12")


@pytest.fixture
def reader_file(tmp_path):
    if not native_io.available():
        pytest.skip("native I/O toolchain unavailable")
    fb = 3000
    data = np.random.default_rng(5).integers(0, 256, 3 * fb, np.uint8)
    path = tmp_path / "frames.bin"
    data.tofile(path)
    return str(path), fb


def test_reader_next_into_a_given_buffer(reader_file):
    path, fb = reader_file
    fresh = native_io.FrameReader(path, fb, nbuf=2)
    given = native_io.FrameReader(path, fb, nbuf=2)
    try:
        buf = np.full(fb, 7, np.uint8)
        for _ in range(3):
            want = fresh.next()
            got = given.next(out=buf)
            assert got is buf and np.array_equal(got, want)
        assert fresh.next() is None and given.next(out=buf) is None
    finally:
        fresh.close()
        given.close()


@pytest.mark.parametrize("bad", [
    np.empty(2999, np.uint8), np.empty(3001, np.uint8),
    np.empty(1500, np.uint16), np.empty((3000, 2), np.uint8)[:, 0]],
    ids=["short", "long", "uint16", "strided"])
def test_reader_next_refuses_a_wrong_buffer(reader_file, bad):
    path, fb = reader_file
    r = native_io.FrameReader(path, fb, nbuf=2)
    try:
        with pytest.raises(ValueError):
            r.next(out=bad)
        # a refused buffer consumes no frame
        assert np.array_equal(r.next(), np.fromfile(path, np.uint8)[:fb])
    finally:
        r.close()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape,padded", [
    ((135, 241), (144, 256)), ((67, 120), (72, 128)), ((1, 1), (16, 16)),
    ((64, 61), (64, 64)), ((59, 64), (64, 64)), ((32, 48), (32, 48))])
def test_pad_into_equals_pad_plane(shape, padded, dtype):
    rng = np.random.default_rng(sum(shape))
    p = rng.integers(0, np.iinfo(dtype).max, shape).astype(dtype)
    dst = np.full(padded, 3, dtype)
    yuv.pad_into(dst, p)
    assert np.array_equal(dst, yuv.pad_plane(p, *padded))
