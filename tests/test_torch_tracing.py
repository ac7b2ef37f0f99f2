"""The port's span and counter recorder (utils/tracing.py) through
``run_file`` on the CPU: off it records nothing; under a profiler, or with
``verbose``, it records every layer's span with its parent and batch on
the profiler's clock; the ``-v`` line is summed from the spans; a
profiler session after an off stretch starts a fresh record; output bytes
do not depend on it; and the benchmark's readers of it read it, those of
the config switch path per pop, per build and per batch."""

import json
import os
import re
import time

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile, record_function

from portbench.run import load_file
from versatilefilmgrain_tpu_torch import cli
from versatilefilmgrain_tpu_torch.pipeline import GrainPipeline
from versatilefilmgrain_tpu_torch.utils import native_io, tracing

from torch_port_cases import CFG_DIR, REPO

W, H = 256, 144
NFR, BATCH = 10, 4                     # batches of 4, 4 and 2 frames
VERBOSE = re.compile(r"read\+stage ([0-9.]+)s step ([0-9.]+)s "
                     r"drain\+write ([0-9.]+)s")
PER_BATCH = ("read", "stage", "upload", "step", "grain.prep",
             "grain.kernels", "download", "wait")
PER_FRAME = ("frame_bases", "assemble", "put")


@pytest.fixture(autouse=True)
def recorder(monkeypatch):
    """A fresh recorder for each test."""
    rec = tracing.Recorder()
    monkeypatch.setattr(tracing, "_R", rec)
    return rec


def _source(tmp_path, depth=10, frames=NFR, seed=3, name="in.yuv"):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if depth == 8 else np.uint16
    src = tmp_path / name
    with open(src, "wb") as f:
        for _ in range(frames):
            for shape in ((H, W), (H // 2, W // 2), (H // 2, W // 2)):
                f.write(rng.integers(0, 1 << depth, shape).astype(dt)
                        .tobytes())
    return str(src)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _totals():
    got = tracing.record()
    return tracing.summary(got["spans"]), got


def test_off_records_nothing_and_reads_no_clock(tmp_path, monkeypatch):
    src = _source(tmp_path)
    pipe = GrainPipeline(W, H, 10, 0, device="cpu")
    clocks = []

    def clock(real):
        def read():
            clocks.append(real)
            return real()
        return read
    monkeypatch.setattr(time, "perf_counter", clock(time.perf_counter))
    monkeypatch.setattr(time, "time_ns", clock(time.time_ns))
    assert pipe.run_file(src, str(tmp_path / "out.yuv"), batch=BATCH) == NFR
    monkeypatch.undo()
    assert clocks == []
    assert tracing.record() == dict(spans=[], counters={})
    assert tracing.span("step") is tracing.NULL


@pytest.mark.parametrize("engine,native", [
    ("ref", True), ("ref", False), ("pallas", True)])
def test_profiled_run_file_records_every_span(engine, native, tmp_path,
                                              monkeypatch, capsys):
    if not native:
        monkeypatch.setattr(native_io, "available", lambda: False)
    src = _source(tmp_path)
    pipe = GrainPipeline(W, H, 10, 0, engine=engine, device="cpu")
    n, _ = _profiled(lambda: pipe.run_file(
        src, str(tmp_path / "out.yuv"), odepth=8, batch=BATCH,
        verbose=True))
    tot, got = _totals()
    spans, counters = got["spans"], got["counters"]
    assert n == NFR == counters["frames"]
    assert counters["batches"] == 3
    assert tot["run_file"][0] == 1
    for name in PER_BATCH:
        assert tot[name][0] == 3, name
    for name in PER_FRAME:
        assert tot[name][0] == NFR, name
    # the tables are built by the loop's first batch
    assert tot["tables"][0] == counters["table_uploads"] == 1
    assert "config_pop" not in tot
    root = next(i for i, s in enumerate(spans) if s[0] == "run_file")
    for i, (name, s, e, parent, batch) in enumerate(spans):
        assert s <= e, name
        j = i
        while spans[j][3] is not None:
            p = spans[j][3]
            assert spans[p][1] <= spans[j][1] and spans[j][2] <= spans[p][2]
            j = p
        assert j == root, name
        if name in PER_BATCH:
            assert batch in (0, 4, 8), name
    frames_of = [s[4] for s in spans if s[0] == "frame_bases"]
    assert frames_of == [0] * 4 + [4] * 4 + [8] * 2
    m = VERBOSE.search(capsys.readouterr().err)
    assert m
    want = (tot["read"][1] + tot["stage"][1],
            tot["step"][1] + tot["download"][1],
            tot["wait"][1] + tot["assemble"][1] + tot["put"][1])
    for printed, total in zip(m.groups(), want):
        assert printed == f"{total:.3f}"


def test_span_self_time_is_its_duration_less_its_children():
    spans = [("a", 0, 100, None, None), ("b", 10, 30, 0, 0),
             ("c", 12, 20, 1, 0), ("b", 40, 50, 0, 4), ("d", 200, 300, None,
                                                         None)]
    want = {"a": [1, 100, 70], "b": [2, 30, 22], "c": [1, 8, 8],
            "d": [1, 100, 100]}
    got = tracing.summary(spans)
    assert set(got) == set(want)
    for k, (count, total, own) in want.items():
        assert got[k] == [count, pytest.approx(total * 1e-9),
                          pytest.approx(own * 1e-9)], k
    got = tracing.summary(spans, root=1)
    assert {k: v[0] for k, v in got.items()} == {"b": 1, "c": 1}


def test_spans_lie_inside_profiler_ranges_around_the_same_calls(tmp_path):
    """The harness wraps ``frame_bases`` in a ``record_function`` range;
    the program's span inside it lies within it on the profiler's clock."""
    src = _source(tmp_path)
    pipe = GrainPipeline(W, H, 10, 0, device="cpu")
    inner = pipe.frame_bases

    def wrapped(n):
        with record_function("portbench.frame_bases"):
            return inner(n)
    pipe.frame_bases = wrapped
    _, prof = _profiled(lambda: pipe.run_file(
        src, str(tmp_path / "out.yuv"), batch=BATCH))
    ranges = sorted((e.start_ns(), e.end_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "portbench.frame_bases")
    spans = [s for s in tracing.record()["spans"] if s[0] == "frame_bases"]
    assert len(ranges) == len(spans) == NFR
    ms = 1_000_000
    for (r0, r1), (_, s0, s1, _, _) in zip(ranges, spans):
        assert r0 - ms <= s0 <= s1 <= r1 + ms


def test_a_new_session_after_an_off_stretch_starts_a_fresh_record(
        tmp_path):
    pipe = GrainPipeline(W, H, 10, 0, device="cpu")
    first, second = _source(tmp_path, frames=6), _source(
        tmp_path, frames=9, name="second.yuv")
    out = str(tmp_path / "out.yuv")
    _profiled(lambda: pipe.run_file(first, out, batch=BATCH))
    assert tracing.record()["counters"]["frames"] == 6
    pipe.run_file(first, out, batch=BATCH)         # off: recorded nowhere
    assert tracing.record()["counters"]["frames"] == 6
    _profiled(lambda: pipe.run_file(second, out, batch=BATCH))
    tot, got = _totals()
    assert got["counters"]["frames"] == 9
    assert tot["run_file"][0] == 1 and tot["frame_bases"][0] == 9


@pytest.mark.parametrize("pocs", [(2,), (2, 6)])
def test_config_switches_count_pops_and_table_uploads(pocs, tmp_path,
                                                      capsys):
    src = _source(tmp_path)
    cfg = os.path.join(CFG_DIR, "fgs_afgs1_test2.cfg")
    argv = ["vfgs-torch", "-w", str(W), "-h", str(H), "-b", "10",
            "--device", "cpu", "--batch", str(BATCH), "-v"]
    for poc in pocs:
        argv += ["-c", f"{poc}:{cfg}"]
    assert cli.main(argv + [src, str(tmp_path / "out.yuv")]) == 0
    tot, got = _totals()
    c = got["counters"]
    assert c["config_pops"] == tot["config_pop"][0] == len(pocs)
    assert c["table_uploads"] == tot["tables"][0] == len(pocs) + 1
    # a batch never straddles a switch: frames [0, 2), [2, 6), [6, 10);
    # the switch at 2 cuts the first batch short, the one at 6 cuts none
    assert c["batches"] == 3 and c["frames"] == NFR
    assert c["switch_cuts"] == 1
    # each pop's read and FW re-init lie inside its config_pop span
    spans = got["spans"]
    for name in ("cfg_read", "fw_init"):
        inner = [s for s in spans if s[0] == name]
        assert len(inner) == len(pocs), name
        for _, s, e, parent, _ in inner:
            assert spans[parent][0] == "config_pop"
            assert spans[parent][1] <= s <= e <= spans[parent][2]
    err = capsys.readouterr().err
    assert (f"counters: frames {NFR}, batches 3, switch_cuts 1, "
            f"config_pops {len(pocs)}, table_uploads {len(pocs) + 1}") in err


def _scene_cuts(pocs, batch, nfr, frames=0):
    """The batches that the schedule's switches cut short: a scene [a, b)
    that ends at a switch and is no whole number of batches, unless the
    stream ends first (at ``nfr`` frames read to their end) or at the
    switch (at ``frames`` frames asked for)."""
    starts = [0] + [p for p in pocs if p > 0]
    return sum(1 for a, b in zip(starts, starts[1:])
               if (b - a) % batch and (b < frames if frames else b <= nfr))


@pytest.mark.parametrize("pocs,batch,nfr,frames", [
    ((2,), 4, 10, 0), ((3, 5, 13), 4, 16, 0), ((4, 8), 4, 12, 0),
    ((1, 2, 3), 4, 10, 0), ((0, 3, 3, 7), 3, 12, 0),
    ((10,), 4, 10, 0),       # a switch where the unread stream ends
    ((10,), 4, 12, 10),      # ... and where the asked-for frames end
    ((11,), 4, 10, 0),       # the stream ends inside the cut batch
    ((5, 9), 8, 12, 7)])     # the asked-for frames end inside a scene
def test_switch_cuts_count_the_batches_the_schedule_cuts(
        pocs, batch, nfr, frames, tmp_path):
    src = _source(tmp_path, depth=8, frames=nfr)
    cfg = os.path.join(CFG_DIR, "fgs_afgs1_test2.cfg")
    pipe = GrainPipeline(W, H, 8, 0, configs=[f"{p}:{cfg}" for p in pocs],
                         device="cpu")
    n, _ = _profiled(lambda: pipe.run_file(
        src, str(tmp_path / "out.yuv"), frames=frames, batch=batch))
    assert n == (frames or nfr)
    want = _scene_cuts(pocs, batch, nfr, frames)
    assert tracing.record()["counters"].get("switch_cuts", 0) == want
    # and each cut batch is one that ends at a switch, short of a batch
    starts = sorted({s[4] for s in tracing.record()["spans"]
                     if s[0] == "frame_bases"}) + [n]
    short = [b for a, b in zip(starts, starts[1:])
             if b - a < batch and b in pocs and (not frames or b < frames)]
    assert len(short) == want


@pytest.mark.parametrize("depth,odepth", [(10, 0), (10, 8), (8, 0)])
def test_output_bytes_do_not_depend_on_the_recorder(depth, odepth,
                                                     tmp_path):
    src = _source(tmp_path, depth=depth)
    outs = []
    for on in (False, True):
        dst = tmp_path / f"out{int(on)}.yuv"
        pipe = GrainPipeline(W, H, depth, 0, device="cpu")
        run = lambda: pipe.run_file(src, str(dst), odepth=odepth,  # noqa
                                    batch=BATCH, verbose=on)
        n = _profiled(run)[0] if on else run()
        assert n == NFR
        outs.append(dst.read_bytes())
    assert outs[0] == outs[1]


@pytest.mark.parametrize("batch", [BATCH, 3])
def test_output_bytes_across_switches_do_not_depend_on_the_recorder(
        batch, tmp_path):
    src = _source(tmp_path, depth=8)
    cfgs = [f"{poc}:{os.path.join(CFG_DIR, f'fgs_afgs1_test{k}.cfg')}"
            for poc, k in ((1, 14), (2, 1), (7, 12))]
    outs = []
    for on in (False, True):
        dst = tmp_path / f"out{int(on)}.yuv"
        pipe = GrainPipeline(W, H, 8, 0, configs=cfgs, device="cpu")
        run = lambda: pipe.run_file(src, str(dst), batch=batch,  # noqa
                                    verbose=on)
        n = _profiled(run)[0] if on else run()
        assert n == NFR
        outs.append(dst.read_bytes())
    assert tracing.record()["counters"]["config_pops"] == 3
    assert outs[0] == outs[1]


def test_profile_trace_carries_the_spans_on_the_profilers_time_base(
        tmp_path):
    src = _source(tmp_path)
    prof_dir = tmp_path / "prof"
    GrainPipeline(W, H, 10, 0, device="cpu").run_file(
        src, str(tmp_path / "out.yuv"), batch=BATCH,
        profile_dir=str(prof_dir))
    with open(prof_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("cat") == "vfg_span"]
    theirs = [e for e in events
              if e.get("ph") == "X" and e.get("cat") != "vfg_span"]
    assert len(ours) == len(tracing.record()["spans"])
    (root,) = [e for e in ours if e["name"] == "run_file"]
    # the profiler's own events of the loop lie inside the loop's span
    inside = [e for e in theirs
              if root["ts"] - 1e3 <= e["ts"]
              and e["ts"] + e["dur"] <= root["ts"] + root["dur"] + 1e3]
    assert len(inside) >= len(theirs) // 2 > 0


READERS = {"stage_ms.pipe": ("stage", "ms"),
           "assemble_ms.pipe": ("assemble", "ms"),
           "prep_host_ms.pipe": ("grain.prep", "ms"),
           "loop_self_pct.pipe": ("run_file", "self")}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_benchmark_readers_read_the_recorder(metric, tmp_path):
    reader = load_file(os.path.join(REPO, "portbench", "metrics",
                                    metric + ".py"),
                       "reader_" + metric.replace(".", "_"))
    assert reader.read(dict(frames=NFR)) is None       # nothing recorded
    src = _source(tmp_path)
    pipe = GrainPipeline(W, H, 10, 0, device="cpu")
    _profiled(lambda: pipe.run_file(src, str(tmp_path / "out.yuv"),
                                    batch=BATCH, verbose=True))
    name, kind = READERS[metric]
    count, total, own = _totals()[0][name]
    want = 100 * own / total if kind == "self" else 1e3 * total / NFR
    assert reader.read(dict(frames=NFR)) == pytest.approx(want)
    assert reader.read(dict(frames=NFR + 1)) is None   # another run's
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        entry = {m["name"]: m for m in json.load(f)["per_layer"]}[metric]
    assert entry["source"] == "program_span"
    assert entry["unit"] == ("%" if kind == "self" else "ms")


# The readers of the switch path: a span's mean per pop or build, or the
# share of batches cut at a switch.
SWITCH_READERS = {"cfg_read_ms.scenes": "cfg_read",
                  "fw_init_ms.scenes": "fw_init",
                  "tables_ms.scenes": "tables",
                  "cut_batch_pct.scenes": "switch_cuts"}


def _reader(metric):
    return load_file(os.path.join(REPO, "portbench", "metrics",
                                  metric + ".py"),
                     "reader_" + metric.replace(".", "_"))


@pytest.mark.parametrize("metric", sorted(SWITCH_READERS))
def test_switch_readers_read_the_recorder_per_switch(metric, tmp_path):
    reader = _reader(metric)
    assert reader.read(dict(frames=NFR)) is None       # nothing recorded
    src = _source(tmp_path)
    # switches at 1, 2 and 6 in batches of 4: [0, 1) and [1, 2) are cut
    # short, [2, 6) and [6, 10) are whole; luma-only and chroma-from-luma
    # scenes among them
    cfgs = [f"{poc}:{os.path.join(CFG_DIR, f'fgs_afgs1_test{k}.cfg')}"
            for poc, k in ((1, 2), (2, 6), (6, 15))]
    pipe = GrainPipeline(W, H, 10, 0, configs=cfgs, device="cpu")
    _profiled(lambda: pipe.run_file(src, str(tmp_path / "out.yuv"),
                                    batch=BATCH, verbose=True))
    tot, got = _totals()
    name = SWITCH_READERS[metric]
    if name == "switch_cuts":
        c = got["counters"]
        assert (c["switch_cuts"], c["batches"]) == (2, 4)
        want = 50.0
    else:
        count, total, _ = tot[name]
        assert count == (4 if name == "tables" else 3)
        want = 1e3 * total / count
    assert reader.read(dict(frames=NFR)) == pytest.approx(want)
    assert reader.read(dict(frames=NFR + 1)) is None   # another run's
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        entry = {m["name"]: m for m in json.load(f)["per_layer"]}[metric]
    assert entry["source"] == ("program_counter" if name == "switch_cuts"
                               else "program_span")
    assert entry["unit"] == ("%" if name == "switch_cuts" else "ms")
    assert entry["workloads"] == ["fhd8_afgs1.scenes"]
    assert entry["moves"] == "fps_pipe"


def test_switch_readers_without_switches_or_their_counter(tmp_path,
                                                          monkeypatch):
    """A run that pops nothing has no pop spans to read, one table build
    and no cut; a program without the ``switch_cuts`` counter (one from
    before it) reads no share."""
    src = _source(tmp_path)
    pipe = GrainPipeline(W, H, 10, 0, device="cpu")
    _profiled(lambda: pipe.run_file(src, str(tmp_path / "out.yuv"),
                                    batch=BATCH, verbose=True))
    rec = dict(frames=NFR)
    assert _reader("cfg_read_ms.scenes").read(rec) is None
    assert _reader("fw_init_ms.scenes").read(rec) is None
    count, total, _ = _totals()[0]["tables"]
    assert count == 1
    assert _reader("tables_ms.scenes").read(rec) == pytest.approx(
        1e3 * total)
    assert _reader("cut_batch_pct.scenes").read(rec) == 0.0
    monkeypatch.setattr(tracing, "COUNTERS", tuple(
        c for c in tracing.COUNTERS if c != "switch_cuts"))
    assert _reader("cut_batch_pct.scenes").read(rec) is None
