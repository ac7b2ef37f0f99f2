"""The frame loop's staging, on the CPU: frames stay in the native
reader's and writer's host rings, lent by reference (``FrameReader.next``
and ``release``, ``FrameWriter.acquire`` and ``put``), or in the loop's
own rings on the Python I/O path, and are padded on the device.  Its
output bytes against ``run()`` (the same loop, one frame a step) and the
JAX package's ``run_file`` across config switches that cut batches, a
short last batch, planes padded in both directions, 10-bit input written
as 8 bits, pad-leak widths, 4:2:2, ``seek``, batches of 1, 3 and 8, and
the native and the Python I/O; the ``staging_allocs`` and ``ring_frames``
counters; the rings' lending, waiting, order, refusals and closing; and the
device padding against ``yuv.pad_plane``."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from versatilefilmgrain_tpu.models import config as jax_cfgmod
from versatilefilmgrain_tpu.pipeline import GrainPipeline as JaxPipeline
from versatilefilmgrain_tpu_torch.models import config as torch_cfgmod
from versatilefilmgrain_tpu_torch.pipeline import GrainPipeline
from versatilefilmgrain_tpu_torch.utils import native_io, tracing, yuv

from torch_port_cases import CFG_DIR, luma_only_sei

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
    # 4:2:2 (chroma 125 x 140, padded to 128 x 144), luma-only grain
    "luma_only_422": (250, 140, 10, 0, 3, 7, 0, []),
    # 3 frames skipped; the switch at POC 5 cuts [0, 2), then [2, 6), [6, 9)
    "seek_three": (256, 144, 8, 0, 4, 12, 0, [(5, 2)]),
}
# what a case sets beyond the above: chroma format, luma-only grain, seek
EXTRA = {"luma_only_422": dict(fmt=yuv.YUV_422, luma_only=True),
         "seek_three": dict(seek=3)}


def _source(path, w, h, depth, nfr, seed=22, fmt=yuv.YUV_420):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if depth == 8 else np.uint16
    cw, ch = yuv.chroma_dims(w, h, fmt)
    with open(path, "wb") as f:
        for _ in range(nfr):
            for shape in ((h, w), (ch, cw), (ch, cw)):
                f.write(rng.integers(0, 1 << depth, shape).astype(dt)
                        .tobytes())
    return str(path)


@pytest.fixture(autouse=True)
def recorder(monkeypatch):
    """A fresh recorder for each test."""
    monkeypatch.setattr(tracing, "_R", tracing.Recorder())


@pytest.fixture
def native():
    if not native_io.available():
        pytest.skip("native I/O toolchain unavailable")


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_run_file_matches_run_and_jax(name, native, tmp_path, monkeypatch):
    w, h, depth, odepth, batch, nfr, frames, pocs = CASES[name]
    extra = EXTRA.get(name, {})
    fmt, seek = extra.get("fmt", yuv.YUV_420), extra.get("seek", 0)
    if native and not native_io.available():
        pytest.skip("native I/O toolchain unavailable")
    if not native:
        monkeypatch.setattr(native_io, "available", lambda: False)
    src = _source(tmp_path / "in.yuv", w, h, depth, nfr, fmt=fmt)
    configs = [f"{poc}:{os.path.join(CFG_DIR, f'fgs_afgs1_test{k}.cfg')}"
               for poc, k in pocs]

    def kw(cfgmod):
        return dict(configs=configs, seek=seek, initial_sei=luma_only_sei(
            cfgmod) if extra.get("luma_only") else None)
    want_n = frames or nfr - seek
    outs = {}
    pipe = GrainPipeline(w, h, depth, fmt, device="cpu", **kw(torch_cfgmod))
    with tracing.forced():
        assert pipe.run_file(src, str(tmp_path / "b.yuv"), frames=frames,
                             odepth=odepth, batch=batch) == want_n
    outs["run_file"] = (tmp_path / "b.yuv").read_bytes()
    c = tracing.counters()
    assert c["frames"] == want_n
    assert c.get("switch_cuts", 0) == len(pocs)
    assert c.get("ring_frames", 0) == (want_n if native else 0)
    pipe = GrainPipeline(w, h, depth, fmt, device="cpu", **kw(torch_cfgmod))
    with open(src, "rb") as fs, open(tmp_path / "f.yuv", "wb") as fd:
        assert pipe.run(fs, fd, frames=frames, odepth=odepth) == want_n
    outs["run"] = (tmp_path / "f.yuv").read_bytes()
    jpipe = JaxPipeline(w, h, depth, fmt, engine="fast", **kw(jax_cfgmod))
    assert jpipe.run_file(src, str(tmp_path / "j.yuv"), frames=frames,
                          odepth=odepth, batch=batch) == want_n
    outs["jax"] = (tmp_path / "j.yuv").read_bytes()
    assert len(outs["run_file"]) == want_n * yuv.frame_bytes(
        w, h, odepth or depth, fmt)
    assert outs["run_file"] == outs["run"] == outs["jax"]


@pytest.mark.parametrize("odepth", [0, 8])
def test_staging_allocs_do_not_grow_with_the_frames(odepth, tmp_path,
                                                    monkeypatch):
    """16 and 64 frames at batch 4 make the same buffers: the reader's
    and the writer's host rings, and on the device the raw input frames,
    three padded planes and the output frames."""
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
    assert made == [2 + 5] * 2


def test_verbose_counters_line_prints_staging_allocs(tmp_path, capsys,
                                                     native):
    """On the native path every frame leaves through the rings by
    reference: ``ring_frames`` equals ``frames``."""
    src = _source(tmp_path / "in.yuv", 144, 128, 8, 6)
    GrainPipeline(144, 128, 8, 0, device="cpu").run_file(
        src, str(tmp_path / "out.yuv"), batch=4, verbose=True)
    err = capsys.readouterr().err
    assert ("counters: frames 6, batches 2, switch_cuts 0, config_pops 0, "
            "table_uploads 1, lfsr_tables ") in err
    assert err.rstrip().endswith("staging_allocs 7, ring_frames 6")


def test_verbose_ring_frames_is_zero_on_the_python_path(tmp_path, capsys,
                                                        monkeypatch):
    monkeypatch.setattr(native_io, "available", lambda: False)
    src = _source(tmp_path / "in.yuv", 144, 128, 8, 6)
    GrainPipeline(144, 128, 8, 0, device="cpu").run_file(
        src, str(tmp_path / "out.yuv"), batch=4, verbose=True)
    err = capsys.readouterr().err
    assert "counters: frames 6, batches 2, " in err
    assert err.rstrip().endswith("staging_allocs 7, ring_frames 0")


# -- the native rings ---------------------------------------------------------

FB = 3000


def _frames_file(tmp_path, n, fb=FB, extra=0):
    data = np.random.default_rng(n).integers(0, 256, n * fb + extra,
                                             np.uint8)
    path = tmp_path / "frames.bin"
    data.tofile(path)
    return str(path), data[:n * fb].reshape(n, fb)


@pytest.mark.parametrize("hold", [1, 2, 3])
def test_reader_lends_in_order_around_a_smaller_ring(hold, tmp_path, native):
    """11 frames through a ring of 3, ``hold`` lent at a time and given
    back oldest first: every frame in order, each a view of one of the
    ring's 3 frames, which serve in turn."""
    path, want = _frames_file(tmp_path, 11)
    r = native_io.FrameReader(path, FB, nbuf=3)
    try:
        got, lent, where = [], [], []
        while (frame := r.next()) is not None:
            where.append(frame.__array_interface__["data"][0])
            lent.append(frame)
            if len(lent) == hold:
                got += [f.copy() for f in lent]
                r.release(hold)
                lent = []
        got += [f.copy() for f in lent]
        assert np.array_equal(np.stack(got), want)
        assert len(set(where)) == 3
        assert where[3:] == where[:-3]
    finally:
        r.close()


def test_reader_ends_in_the_middle_of_a_batch(tmp_path, native):
    """5 whole frames and a partial one, taken 4 at a time: the second
    batch ends after one frame, and the end stays the end."""
    path, want = _frames_file(tmp_path, 5, extra=FB // 2)
    r = native_io.FrameReader(path, FB, nbuf=8)
    try:
        batches, frame = [], True
        while frame is not None:
            batch = []
            while len(batch) < 4 and (frame := r.next()) is not None:
                batch.append(frame.copy())
            batches.append(batch)
            r.release(len(batch))
        assert [len(b) for b in batches] == [4, 1]
        assert np.array_equal(np.stack(batches[0] + batches[1]), want)
        assert r.next() is None
    finally:
        r.close()


def test_reader_refuses_to_lend_past_its_ring(tmp_path, native):
    path, _ = _frames_file(tmp_path, 4)
    r = native_io.FrameReader(path, FB, nbuf=2)
    try:
        r.next(), r.next()
        with pytest.raises(RuntimeError):
            r.next()
        with pytest.raises(ValueError):
            r.release(3)
        r.release(2)
        assert r.next() is not None
    finally:
        r.close()


def test_reader_closes_with_frames_held(tmp_path, native):
    """Closing while frames are lent neither waits nor frees what the
    caller still holds."""
    path, want = _frames_file(tmp_path, 6)
    r = native_io.FrameReader(path, FB, nbuf=3)
    held = [r.next(), r.next()]
    r.close()
    assert np.array_equal(np.stack(held), want[:2])


def test_writer_acquire_waits_for_a_lagging_writer(tmp_path, native):
    """A ring of 2 frames writing into a FIFO that nobody reads yet: the
    third ``acquire`` waits until the reader drains the first frame."""
    fb = 1 << 18   # larger than a pipe's buffer
    fifo = str(tmp_path / "out.fifo")
    os.mkfifo(fifo)
    go, got = threading.Event(), []

    def read():
        with open(fifo, "rb") as f:
            go.wait()
            got.append(f.read())
    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    w = native_io.FrameWriter(fifo, fb, nbuf=2)
    frames = np.random.default_rng(3).integers(0, 256, (3, fb), np.uint8)
    try:
        for i in range(2):
            buf = w.acquire()
            buf[:] = frames[i]
            w.put(buf)
        third = []
        waiter = threading.Thread(target=lambda: third.append(w.acquire()),
                                  daemon=True)
        waiter.start()
        time.sleep(0.3)
        assert not third and waiter.is_alive()
        go.set()
        waiter.join(timeout=30)
        assert not waiter.is_alive() and third
        third[0][:] = frames[2]
        w.put(third[0])
    finally:
        go.set()
        w.close()
        reader.join(timeout=30)
    assert not reader.is_alive() and got == [frames.tobytes()]


def _filled(w, frame):
    buf = w.acquire()
    buf[:] = frame
    return buf


def test_writer_writes_in_the_order_lent(tmp_path, native):
    """Frames put out of the order they were lent come out in the order
    lent, each counted as ``ring_frames``."""
    dst = str(tmp_path / "out.bin")
    frames = np.random.default_rng(4).integers(0, 256, (5, FB), np.uint8)
    w = native_io.FrameWriter(dst, FB, nbuf=3)
    with tracing.forced():
        lent = [_filled(w, f) for f in frames[:3]]
        for i in (2, 0, 1):
            w.put(lent[i])
        for f in frames[3:]:
            w.put(_filled(w, f))
        w.close()
        assert tracing.counters()["ring_frames"] == 5
    with open(dst, "rb") as f:
        assert f.read() == frames.tobytes()


@pytest.mark.parametrize("kind", ["copy", "reversed", "half", "put_twice",
                                  "another_writer"])
def test_writer_put_refuses_a_frame_it_did_not_lend(kind, tmp_path, native):
    """``put`` takes only a whole frame that ``acquire`` lent and that
    was not put: anything else is an error, and writes nothing."""
    dst = str(tmp_path / "out.bin")
    frames = np.random.default_rng(6).integers(0, 256, (2, FB), np.uint8)
    w = native_io.FrameWriter(dst, FB, nbuf=2)
    other = native_io.FrameWriter(str(tmp_path / "other.bin"), FB, nbuf=2)
    try:
        buf = _filled(w, frames[0])
        bad = {"copy": lambda: buf.copy(),
               "reversed": lambda: buf[::-1],
               "half": lambda: buf[:FB // 2],
               "put_twice": lambda: (w.put(buf), buf)[1],
               "another_writer": lambda: _filled(other, frames[0])}[kind]()
        with pytest.raises(ValueError):
            w.put(bad)
        if kind != "put_twice":
            w.put(buf)
        w.put(_filled(w, frames[1]))
    finally:
        w.close()
        other.close()
    with open(dst, "rb") as f:
        assert f.read() == frames.tobytes()


def test_writer_gives_back_what_was_never_put(tmp_path, native):
    """``give_back`` returns, unwritten, the frames of those given that
    were not put, as ``close`` does with the frames still held; the
    frames after them are written without waiting on them."""
    dst = str(tmp_path / "out.bin")
    frames = np.random.default_rng(5).integers(0, 256, (6, FB), np.uint8)
    w = native_io.FrameWriter(dst, FB, nbuf=3)
    lent = [_filled(w, f) for f in frames[:3]]
    w.put(lent[0])
    w.put(lent[2])          # frame 1 is never put
    w.give_back(lent)
    for f in frames[3:5]:   # the ring's 3 frames serve again
        w.put(_filled(w, f))
    _filled(w, frames[5])   # still held at close
    w.close()
    with open(dst, "rb") as f:
        assert f.read() == frames[[0, 2, 3, 4]].tobytes()


def test_writer_refuses_to_lend_past_a_held_oldest_frame(tmp_path, native):
    """Every frame of a ring of 2 lent and the oldest not put: the next
    ``acquire`` could wait for ever, and is an error instead; once the
    oldest is put it lends again."""
    dst = str(tmp_path / "out.bin")
    frames = np.random.default_rng(7).integers(0, 256, (3, FB), np.uint8)
    w = native_io.FrameWriter(dst, FB, nbuf=2)
    lent = [_filled(w, f) for f in frames[:2]]
    w.put(lent[1])
    with pytest.raises(RuntimeError):
        w.acquire()
    w.put(lent[0])
    w.put(_filled(w, frames[2]))
    w.close()
    with open(dst, "rb") as f:
        assert f.read() == frames.tobytes()


@pytest.mark.parametrize("batch", [1, 4])
def test_run_file_gives_back_frames_it_did_not_put(batch, tmp_path,
                                                   monkeypatch, native):
    """Where a sink's ``put`` skips a frame (here one in three), the loop
    gives it back at the end of its batch: the other frames come out, in
    order, and the ring never runs dry."""
    w, h, nfr = 144, 128, 14
    src = _source(tmp_path / "in.yuv", w, h, 8, nfr)
    GrainPipeline(w, h, 8, 0, device="cpu").run_file(
        src, str(tmp_path / "all.yuv"), batch=batch)
    put, calls = native_io.FrameWriter.put, iter(range(nfr))

    def skipping(self, frame):
        if next(calls) % 3 != 1:
            put(self, frame)
    monkeypatch.setattr(native_io.FrameWriter, "put", skipping)
    assert GrainPipeline(w, h, 8, 0, device="cpu").run_file(
        src, str(tmp_path / "some.yuv"), batch=batch) == nfr
    fb = yuv.frame_bytes(w, h, 8, yuv.YUV_420)
    every = np.fromfile(tmp_path / "all.yuv", np.uint8).reshape(nfr, fb)
    kept = [n for n in range(nfr) if n % 3 != 1]
    assert np.array_equal(
        np.fromfile(tmp_path / "some.yuv", np.uint8).reshape(-1, fb),
        every[kept])


def test_rings_keep_order_under_contention(tmp_path, native):
    """5,000 small frames from a reader's ring of 3 into a writer's ring
    of 3, two lent at a time, each frame copied from one ring into the
    other, with the interpreter switching threads every microsecond: the
    file comes out whole and in order."""
    import sys
    fb, n = 64, 5000
    path, want = _frames_file(tmp_path, n, fb=fb)
    dst = str(tmp_path / "out.bin")
    r = native_io.FrameReader(path, fb, nbuf=3)
    w = native_io.FrameWriter(dst, fb, nbuf=3)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        done = False
        while not done:
            lent = [f for f in (r.next(), r.next()) if f is not None]
            done = len(lent) < 2
            for frame in lent:
                buf = w.acquire()
                buf[:] = frame
                w.put(buf)
            r.release(len(lent))
    finally:
        sys.setswitchinterval(interval)
        r.close()
        w.close()
    with open(dst, "rb") as f:
        assert f.read() == want.tobytes()


# -- padding on the device ----------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("shape,padded", [
    ((135, 241), (144, 256)), ((67, 120), (72, 128)), ((1, 1), (16, 16)),
    ((64, 61), (64, 64)), ((59, 64), (64, 64)), ((32, 48), (32, 48))])
def test_pad_batch_equals_pad_plane(shape, padded, dtype):
    """Two frames padded on the CPU device equal ``yuv.pad_plane`` of
    each."""
    rng = np.random.default_rng(sum(shape))
    p = rng.integers(0, np.iinfo(dtype).max, (2, *shape)).astype(dtype)
    dst = torch.full((2, *padded), 3, dtype=torch.from_numpy(p).dtype)
    yuv.pad_batch(dst, torch.from_numpy(p))
    for got, frame in zip(dst.numpy(), p):
        assert np.array_equal(got, yuv.pad_plane(frame, *padded))


@pytest.mark.parametrize("w,h,depth,fmt", [
    (250, 140, 10, yuv.YUV_420), (200, 130, 8, yuv.YUV_420),
    (250, 140, 10, yuv.YUV_422), (150, 131, 8, yuv.YUV_444)])
def test_upload_pads_each_frame_as_pad_plane(w, h, depth, fmt, tmp_path):
    """The device planes after the loop's upload of three raw frames
    equal ``yuv.pad_plane`` of each frame's planes."""
    pipe = GrainPipeline(w, h, depth, fmt, device="cpu", initial_sei=(
        luma_only_sei(torch_cfgmod) if fmt != yuv.YUV_420 else None))
    assert not pipe._has_pad_leak()
    with open(_source(tmp_path / "in.yuv", w, h, depth, 3, fmt=fmt),
              "rb") as f:
        fb = yuv.frame_bytes(w, h, depth, fmt)
        raw = np.frombuffer(f.read(), np.uint8).reshape(3, fb).copy()
        f.seek(0)
        planes = [yuv.read_frame(f, w, h, depth, fmt) for _ in range(3)]
    dev = pipe._upload(list(raw), torch.empty((4, fb), dtype=torch.uint8),
                       pipe._padded_batch(4))
    for c, d in enumerate(dev):
        assert d.shape[0] == 3
        for i in range(3):
            assert np.array_equal(d[i].numpy(), yuv.pad_plane(
                planes[i][c], *d.shape[1:])), (c, i)
