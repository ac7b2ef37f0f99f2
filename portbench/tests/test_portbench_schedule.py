"""A configuration's cfg schedule (the C model's ``-c POC:file`` list):
the frozen reference pops it as the program does, whatever order frames
are asked in; a configuration that gives ``cfg`` alone grains as before;
a malformed schedule refuses the cell; the small switching cell's sink
keeps the frames at the switches, where ``late_switch`` is caught; and the
resident and paced drivers refuse a configuration that switches."""

from __future__ import annotations

import hashlib
import json
import os
import re

import numpy as np
import pytest
import torch

from cells import GOLDEN_CFG, PKG, REFUSED_CELLS, make_root, run_cell
from portbench import faults, frames, run
from portbench.reference.model import Reference
from portbench.sample import Sampler

T2 = os.path.join(PKG, "configs", "fgs_afgs1_test2.cfg")
GEOMETRIES = [(256, 200, 8), (256, 192, 10)]
SCHEDULES = {
    # three AFGS1 cfgs after the built-in config, at POCs off the batch
    # grid; two of them keep their predecessor's grain (update_grain 0)
    "afgs1x3": [(3, "fgs_afgs1_test1.cfg"), (12, "fgs_afgs1_test11.cfg"),
                (29, "fgs_afgs1_test9.cfg")],
    "sei_ar_afgs1_sei_ff": [(0, "fgs_sei_ar_test1.cfg"),
                            (11, "fgs_afgs1_test5.cfg"),
                            (27, "fgs_sei_ff_test3.cfg")],
    "cfg_alone": [(0, "fgs_afgs1_test2.cfg")],
}
FRAMES = 36
# sha256 of frames 0, 1, 9 and 40 (seed 2024) as the reference before it
# took a schedule grained them with fgs_afgs1_test2.cfg at frame 0, or with
# the built-in config alone
BEFORE = {
    (256, 200, 8, True):
        "174bd4535f6b17053a52947b79377d5079d025255187a789309820e82d677f0e",
    (256, 200, 8, False):
        "aaee39ad9ce5cd99885eff59f0a0ae91bf861c0a838bc49eb1a7986b7214e693",
    (256, 192, 10, True):
        "f11f0c341bc236f40c2433e4ebd73b8be5ed3c973f8812bdd7beb03d6409496b",
    (256, 192, 10, False):
        "bc2556be45aeea0c595f02300969c57e9b660b16ffc0033454a498c3792db6c4",
}


def _padded(W, H, D, seed, n):
    return [torch.from_numpy(p.copy())
            for p in frames.padded_frame(W, H, D, 0, seed, n)]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("W,H,D", GEOMETRIES)
def test_reference_pops_the_schedule_as_the_program(W, H, D, name):
    from versatilefilmgrain_tpu_torch import GrainPipeline
    schedule = [(poc, os.path.join(GOLDEN_CFG, f))
                for poc, f in SCHEDULES[name]]
    pipe = GrainPipeline(W, H, D, 0, configs=[f"{p}:{f}" for p, f in
                                              schedule],
                         engine="ref", device="cpu")
    got = [pipe.process_frame(frames.frame_planes(W, H, D, 0, 31, n), n)
           for n in range(FRAMES)]
    ref = Reference(W, H, D, 0, schedule)
    assert [s.start for s in ref.states] == sorted(
        {0} | {poc for poc, _ in schedule})
    order = np.random.default_rng(5).permutation(FRAMES)
    for n in map(int, order):
        want = ref.grain(*_padded(W, H, D, 31, n), n)
        for g, w in zip(got[n], want):
            assert np.array_equal(g, w.numpy()[:g.shape[0], :g.shape[1]]), n
    # each switch changes the grain: at its POC, the state before it
    # grains the same input otherwise
    for poc, _ in schedule:
        if poc:
            inp = _padded(W, H, D, 31, poc)
            before = Reference(W, H, D, 0, [e for e in schedule
                                            if e[0] < poc])
            assert not all(torch.equal(a, b) for a, b in zip(
                ref.grain(*inp, poc), before.grain(*inp, poc)))


@pytest.mark.parametrize("W,H,D", GEOMETRIES)
@pytest.mark.parametrize("cfg", [True, False])
def test_cfg_alone_grains_as_before(W, H, D, cfg):
    ref = Reference(W, H, D, 0, [(0, T2)] if cfg else [])
    h = hashlib.sha256()
    for n in (0, 1, 9, 40):
        for p in ref.grain(*_padded(W, H, D, 2024, n), n):
            h.update(p.numpy().tobytes())
    assert h.hexdigest() == BEFORE[(W, H, D, cfg)]


def test_frame_samples_without_switches_are_as_before():
    # the batch positions' reservoir draws what it drew before the sink
    # kept switch frames beside it
    s = Sampler(2**31 + 99, 8, 1)
    for n in range(1000):
        s.offer(n, n % 8)
    assert sorted(s.kept.values()) == [61, 502, 511, 672, 675, 714, 908,
                                       977]


def _root_with(tmp_path, config: dict) -> str:
    root = make_root(str(tmp_path))
    with open(os.path.join(root, "portbench", "configs", "x.json"), "w") as f:
        json.dump(dict(width=256, height=200, depth=8, chroma_format=0,
                       **config), f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(name="x", source="test", reduced=[],
                                 why="test", file="portbench/configs/x.json"))
    bench["workloads"].append(dict(name="x.pipe", config="x",
                                   traffic="pipe_b8", chips=1, why="test"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.mark.parametrize("config,why", [
    (dict(schedule=[[0, "fgs_afgs1_test2.cfg", 1]]), "schedule entry"),
    (dict(schedule=[["0", "fgs_afgs1_test2.cfg"]]), "schedule entry"),
    (dict(schedule=[[-1, "fgs_afgs1_test2.cfg"]]), "schedule entry"),
    (dict(schedule=[[0, ""]]), "schedule entry"),
    (dict(schedule={"0": "fgs_afgs1_test2.cfg"}), "not a list"),
    (dict(schedule=[[0, "none.cfg"]]), "no cfg file"),
    (dict(schedule=[[9, "fgs_afgs1_test2.cfg"], [4, "fgs_afgs1_test2.cfg"]]),
     "decrease"),
    (dict(cfg="fgs_afgs1_test2.cfg", schedule=[[0, "fgs_afgs1_test2.cfg"]]),
     "both"),
])
def test_malformed_schedule_refuses_the_cell(tmp_path, config, why):
    root = _root_with(tmp_path, config)
    with pytest.raises(ValueError, match=why):
        run.Cell(root, "x.pipe")
    rc, res, err = run_cell(root, "x.pipe")
    assert rc == 2 and res is None and why in err


def test_cfg_is_a_schedule_of_one_pop(tmp_path):
    root = _root_with(tmp_path, dict(cfg="fgs_afgs1_test2.cfg"))
    here = os.path.join(root, "portbench", "configs")
    assert run.Cell(root, "x.pipe").schedule() == [
        (0, os.path.join(here, "fgs_afgs1_test2.cfg"))]
    assert run.Cell(root, "small10_sei.pipe").schedule() == []


def _kept_pocs(err: str) -> list[int]:
    kept = re.search(r"frames kept at POCs ([0-9 ]*) and", err).group(1)
    return [int(p) for p in kept.split()]


def test_late_switch_is_caught_at_a_switch(bench_root):
    pocs = [poc for poc, _ in run.Cell(
        bench_root, "small8_afgs1_scenes.pipe").schedule() if poc]
    rc, sound, err = run_cell(bench_root, "small8_afgs1_scenes.pipe",
                              seed=2**33 + 1, seconds=2.0)
    assert rc == 0 and sound["correct"], err
    kept = _kept_pocs(err)           # 4 switches, 8 slots: all it reached
    assert kept and kept == pocs[:len(kept)], err
    assert sound["checks"]["frames_checked"]["limit"] == 8 + 1 + 2 * len(
        kept)
    with faults.planted("late_switch"):
        rc, res, err = run_cell(bench_root, "small8_afgs1_scenes.pipe",
                                seed=2**33 + 1, seconds=2.0)
    assert rc == 0 and res["correct"] is False, err
    kept = _kept_pocs(err)
    wrong = re.search(r"kept frames that differ from the reference: "
                      r"([0-9 ]+)", err).group(1)
    # every kept switch's frame, grained with the config before it, and no
    # other frame but frame 0 (the frame-0 pop is late as well)
    assert kept and set(kept) <= {int(n) for n in wrong.split()} <= set(
        kept) | {0}, err


@pytest.mark.parametrize("cell", sorted(REFUSED_CELLS))
def test_resident_and_paced_drivers_refuse_switches(bench_root, cell):
    rc, res, err = run_cell(bench_root, cell)
    assert rc == 2 and res is None
    assert "pops cfgs only at frame 0" in err and "no result" in err
