"""Whole runs of the small cells on the CPU, with the look for a card
skipped: sound runs come out correct; with the control or a fault planted
under the timed path, ``correct`` comes out false."""

from __future__ import annotations

import pytest

from cells import SMALL_CELLS, run_cell, schedule_of, traffic_of
from portbench import faults


@pytest.mark.parametrize("cell", sorted(SMALL_CELLS))
def test_sound_run_is_correct(bench_root, cell):
    rc, res, err = run_cell(bench_root, cell, seed=2**31 + 77)
    assert rc == 0, err
    assert res["correct"] and res["failed"] == 0, err
    checks = res["checks"]
    assert list(res)[-1] == "checks"
    assert checks["mismatched_samples"]["value"] == 0
    assert checks["frames_checked"]["value"] >= 9
    assert res["attempted"] > 0
    assert set(res["metrics"]) >= {"setup_s"}
    # the compared numbers are the last lines of standard error
    tail = [ln for ln in err.strip().splitlines()][-3:]
    assert [ln.split()[1] for ln in tail] == list(checks)


CASES = [(cell, kind) for cell in sorted(SMALL_CELLS)
         for kind in faults.kinds_for(traffic_of(cell), schedule_of(cell))]


@pytest.mark.parametrize("cell,kind", CASES)
def test_planted_fault_is_not_correct(bench_root, cell, kind):
    with faults.planted(kind):
        rc, res, err = run_cell(bench_root, cell, seed=12345)
    assert rc == 0, err
    assert res["correct"] is False, (kind, res["checks"])
    assert res["failed"] > 0
    failing = "frames_missing" if kind == "dropped" else "mismatched_samples"
    assert res["checks"][failing]["value"] > 0


SWITCHING = [(0, "a.cfg"), (13, "b.cfg")]


@pytest.mark.parametrize("traffic,schedule,kinds", [
    (dict(driver="pipe", batch=8), SWITCHING, list(faults.KINDS)),
    (dict(driver="pipe", batch=8), [(0, "a.cfg")],
     ["control", "unchanged", "half_batch", "altered", "dropped"]),
    (dict(driver="pipe", batch=1), [],
     ["control", "unchanged", "altered", "dropped"]),
    (dict(driver="resident", batch=8), SWITCHING,
     ["control", "unchanged", "half_batch", "altered"]),
    (dict(driver="paced", rate_fps=60), [],
     ["control", "unchanged", "altered"])])
def test_kinds_follow_the_traffic_not_the_cell_name(traffic, schedule,
                                                    kinds):
    assert faults.kinds_for(traffic, schedule) == kinds


def test_faults_are_removed_after_the_block():
    from versatilefilmgrain_tpu_torch import pipeline
    from versatilefilmgrain_tpu_torch.ops import grain_natural as gn
    from versatilefilmgrain_tpu_torch.utils import native_io

    def current():
        return (pipeline.GrainPipeline.frame_bases,
                pipeline.GrainPipeline._step, gn.add_grain_batch_natural,
                native_io.FrameWriter.put,
                pipeline.GrainPipeline.maybe_switch_config)
    before = current()
    for kind in faults.KINDS:
        with faults.planted(kind):
            assert current() != before
    assert current() == before


def test_traced_run_reads_per_layer_metrics(bench_root):
    rc, res, err = run_cell(bench_root, "small10_sei.pipe", trace=1)
    assert rc == 0, err
    assert res["correct"]
    # run_file's own timers and the harness's spans are read on the CPU;
    # device metrics read nothing without a device
    assert {"read_stage_ms.pipe", "drain_write_ms.pipe",
            "bases_ms.pipe"} <= set(res["metrics"])
    assert "device_idle_pct.pipe" not in res["metrics"]
    assert "breakdown" in res and "window_s" in res["device"]


def test_without_card_exits_nonzero_and_prints_nothing(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from portbench import run
    rc = run.main(["--workload", "fhd8_afgs1.pipe", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
