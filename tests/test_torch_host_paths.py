"""The port's host paths against the JAX package's: the counterparts of
tests/test_robustness.py (gain edge cases, malformed configs, the width
limit, FIFO input), tests/test_native_io.py (the pipelined frame reader and
writer) and tests/test_pipeline_formats.py (4:2:2 and 4:4:4 through
``run_file``).

Every case runs the port (``device="cpu"``) and, where the JAX package has
the same function, the JAX package on the same input, and requires the same
result: equal config state, the same exception class, identical bytes.
"""

import os
import sys
import threading

import numpy as np
import pytest

from versatilefilmgrain_tpu import cli as jax_cli
from versatilefilmgrain_tpu import pipeline as jax_pipeline
from versatilefilmgrain_tpu.models import config as jax_cfgmod
from versatilefilmgrain_tpu.utils import native_io as jax_native_io
from versatilefilmgrain_tpu.utils import parsers as jax_parsers
from versatilefilmgrain_tpu_torch import cli as torch_cli
from versatilefilmgrain_tpu_torch import pipeline as torch_pipeline
from versatilefilmgrain_tpu_torch.models import config as torch_cfgmod
from versatilefilmgrain_tpu_torch.utils import native_io as torch_native_io
from versatilefilmgrain_tpu_torch.utils import parsers as torch_parsers
from versatilefilmgrain_tpu_torch.utils import yuv as torch_yuv

from torch_port_cases import REPO

sys.path.insert(0, os.path.join(REPO, "tools"))
from gen_input import make_input_yuv  # noqa: E402

SIDES = {"jax": (jax_pipeline, jax_cfgmod, jax_parsers),
         "torch": (torch_pipeline, torch_cfgmod, torch_parsers)}
JOIN_S = 120     # the longest any test waits on a thread


def _state(obj):
    """A config object's fields, arrays as lists, for equality."""
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in vars(obj).items()}


def _gained(side, gain, edit=None):
    pipeline, cfgmod, _ = SIDES[side]
    sei, afgs1 = cfgmod.default_sei(), cfgmod.default_afgs1()
    if edit:
        edit(sei)
    pipeline.apply_gain(gain, sei, afgs1)
    return _state(sei), _state(afgs1)


def _pipe(side, *args, **kw):
    pipeline = SIDES[side][0]
    if side == "torch":
        kw["device"] = "cpu"
    return pipeline.GrainPipeline(*args, **kw)


# -- tests/test_robustness.py ----------------------------------------------

def test_negative_gain_terminates():
    """A negative gain wraps unsigned as in the C reference (about 25
    halvings) and must not hang."""
    sei, afgs1 = _gained("torch", -5)
    assert 0 <= sei["log2_scale_factor"] <= 255
    assert (sei, afgs1) == _gained("jax", -5)


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_negative_gain_cli_fails_cleanly(side):
    """With the default config the wrapped gain drives scale_shift out of
    range: the reference aborts, both packages raise a fatal config
    error."""
    with pytest.raises(SIDES[side][0].FatalConfigError):
        _pipe(side, 256, 192, 10, 0, gain=-5)


def test_gain_zero_scales_to_zero():
    sei, afgs1 = _gained("torch", 0)
    assert sei["comp_model_value"][0][0][0] == 0
    assert (sei, afgs1) == _gained("jax", 0)


def test_unsigned_gain_multiply_wraps():
    """(int)v * (unsigned)gain / 100 for a negative model value."""
    def edit(sei):
        sei.comp_model_value[0][0][0] = -250

    sei, afgs1 = _gained("torch", 50, edit)
    expect = ((2**32 - 12500) // 100 + 0x8000) % 0x10000 - 0x8000
    assert sei["comp_model_value"][0][0][0] == expect
    assert (sei, afgs1) == _gained("jax", 50, edit)


@pytest.mark.parametrize("text,want", [
    ("²3", 0), (" +42x", 42), ("-", 0), ("\t-17 ", -17), ("٣", 0),
    ("", 0), ("0x10", 0), ("  99999", 99999)])
def test_atoi_rejects_unicode_digits(text, want):
    assert torch_parsers.atoi(text) == want
    assert jax_parsers.atoi(text) == want


def test_malformed_cfg_mid_stream_continues(tmp_path, capsys):
    """Binary garbage and counter-overflow configs must not kill the run:
    the pop fails, the previous config stays, as in JAX."""
    bad = tmp_path / "bad.cfg"
    bad.write_bytes(b"\x80\xff\xfe SEIFGCModelId : 1\n"
                    b"fg_comp_model_present_flag[c]: 1\n" * 5)
    y = np.random.default_rng(0).integers(0, 1024, (192, 256)).astype("<u2")
    u = v = np.zeros((96, 128), "<u2")
    outs = {}
    for side in ("torch", "jax"):
        pipe = _pipe(side, 256, 192, 10, 0, configs=[f"0:{bad}"])
        outs[side] = pipe.process_frame((y, u, v), 0)
    assert outs["torch"][0].shape == (192, 256)
    for a, b in zip(outs["torch"], outs["jax"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert not np.array_equal(outs["torch"][0], y)


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_width_128_rejected(side):
    """The reference hard-asserts width > 128 (vfgs_hw.c:167-170) and aborts
    at 128; both packages reject it as a config error and take 130."""
    with pytest.raises(SIDES[side][2].ConfigError):
        _pipe(side, 128, 192, 10, 0)
    _pipe(side, 130, 192, 10, 0)


def test_fifo_input(tmp_path):
    """A FIFO source works like the reference's fopen (vfgs_main.c:711),
    and gives the bytes the JAX CLI gives for the same data in a file."""
    fifo = str(tmp_path / "in.fifo")
    os.mkfifo(fifo)
    data = np.random.default_rng(5).integers(
        0, 1024, 256 * 192 * 3 // 2, dtype="<u2").tobytes()
    fed = []

    def feed():
        with open(fifo, "wb") as f:
            f.write(data)
        fed.append(True)

    argv = ["-w", "256", "-h", "192", "-b", "10", "-n", "1"]
    out = str(tmp_path / "torch.yuv")
    result = {}

    def run():
        try:
            result["rc"] = torch_cli.main(["vfgs-torch", "--device", "cpu",
                                           *argv, fifo, out])
        except BaseException as e:   # reported below, in the test's thread
            result["error"] = e

    feeder = threading.Thread(target=feed, daemon=True)
    reader = threading.Thread(target=run, daemon=True)
    feeder.start()
    reader.start()
    reader.join(timeout=JOIN_S)
    feeder.join(timeout=JOIN_S)
    if feeder.is_alive():
        # never opened for reading: unblock the writer, then fail
        os.close(os.open(fifo, os.O_RDONLY | os.O_NONBLOCK))
        feeder.join(timeout=JOIN_S)
    assert not reader.is_alive(), f"the CLI did not finish in {JOIN_S} s"
    assert not feeder.is_alive() and fed, "the FIFO was never drained"
    if "error" in result:
        raise result["error"]
    assert result["rc"] == 0
    assert os.path.getsize(out) == len(data)
    src = tmp_path / "in.yuv"
    src.write_bytes(data)
    ref = str(tmp_path / "jax.yuv")
    assert jax_cli.main(["vfgs-tpu", *argv, str(src), ref]) == 0
    assert open(out, "rb").read() == open(ref, "rb").read()


# -- tests/test_native_io.py ---------------------------------------------------

@pytest.fixture
def native():
    """The port's and the JAX package's native I/O, or a skip where the C
    toolchain is missing (decided here, not at import)."""
    if not (torch_native_io.available() and jax_native_io.available()):
        pytest.skip("native I/O toolchain unavailable")
    return torch_native_io, jax_native_io


def _read_all(mod, path, fb, **kw):
    r = mod.FrameReader(path, fb, **kw)
    try:
        got = []
        while (buf := r.next()) is not None:
            got.append(buf)
        return got
    finally:
        r.close()


def test_reader_writer_roundtrip(tmp_path, native):
    tio, jio = native
    fb = 4096
    frames = [np.random.default_rng(i).integers(0, 256, fb, dtype=np.uint8)
              for i in range(7)]
    src = str(tmp_path / "a.bin")
    with open(src, "wb") as f:
        for fr in frames:
            fr.tofile(f)
    got = _read_all(tio, src, fb, nbuf=3)
    assert len(got) == 7
    for a, b, c in zip(frames, got, _read_all(jio, src, fb, nbuf=3)):
        assert np.array_equal(a, b) and np.array_equal(b, c)
    dst = str(tmp_path / "b.bin")
    w = tio.FrameWriter(dst, fb, nbuf=3)
    for fr in got:
        w.put(fr)
    w.close()
    assert open(dst, "rb").read() == open(src, "rb").read()


def test_reader_seek_and_partial(tmp_path, native):
    tio, jio = native
    fb = 1000
    src = str(tmp_path / "c.bin")
    with open(src, "wb") as f:
        f.write(bytes(range(250)) * 10)   # 2.5 frames
    got = _read_all(tio, src, fb, nbuf=2, seek_frames=1)
    assert len(got) == 1                  # frame 1; partial frame 2 is EOF
    assert got[0].tobytes() == (bytes(range(250)) * 10)[fb:2 * fb]
    (want,) = _read_all(jio, src, fb, nbuf=2, seek_frames=1)
    assert np.array_equal(got[0], want)


# -- tests/test_pipeline_formats.py ------------------------------------------

def _luma_only_sei(cfgmod):
    sei = cfgmod.FgsSei()
    sei.model_id = 0
    sei.log2_scale_factor = 5
    sei.comp_model_present_flag = [1, 0, 0]
    sei.num_intensity_intervals = [4, 0, 0]
    sei.num_model_values = [3, 0, 0]
    sei.intensity_interval_lower_bound[0, :4] = [0, 60, 120, 180]
    sei.intensity_interval_upper_bound[0, :4] = [59, 119, 179, 255]
    sei.comp_model_value[0, :4, :3] = [[90, 4, 6], [120, 8, 8],
                                       [140, 11, 9], [160, 14, 14]]
    return sei


@pytest.mark.parametrize("side", ["jax", "torch"])
def test_default_config_rejects_422(side):
    with pytest.raises(SIDES[side][2].ConfigError):
        _pipe(side, 320, 192, 10, torch_yuv.YUV_422)


@pytest.mark.parametrize("fmt", [torch_yuv.YUV_422, torch_yuv.YUV_444])
def test_run_file_formats(fmt, tmp_path):
    """A luma-only config at 4:2:2 and 4:4:4: the port's batched
    ``run_file`` == its per-frame path == the JAX package's ``run_file``."""
    w, h, frames = 320, 192, 3
    inp = str(tmp_path / "in.yuv")
    make_input_yuv(inp, w, h, 10, fmt, frames)
    out_b = str(tmp_path / "b.yuv")
    pipe = _pipe("torch", w, h, 10, fmt,
                 initial_sei=_luma_only_sei(torch_cfgmod))
    assert pipe.run_file(inp, out_b, frames=frames, batch=2) == frames
    pipe2 = _pipe("torch", w, h, 10, fmt,
                  initial_sei=_luma_only_sei(torch_cfgmod))
    out = b""
    with open(inp, "rb") as f:
        for n in range(frames):
            planes = torch_yuv.read_frame(f, w, h, 10, fmt)
            o = pipe2.process_frame(planes, n)
            out += b"".join(np.ascontiguousarray(p).tobytes() for p in o)
    got = open(out_b, "rb").read()
    assert out == got
    out_j = str(tmp_path / "j.yuv")
    jpipe = _pipe("jax", w, h, 10, fmt,
                  initial_sei=_luma_only_sei(jax_cfgmod))
    assert jpipe.run_file(inp, out_j, frames=frames, batch=2) == frames
    assert got == open(out_j, "rb").read()
