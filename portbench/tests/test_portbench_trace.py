"""The trace's reduction and the metric readers on made-up records."""

from __future__ import annotations

import pytest

from portbench import readers, roofline
from portbench.trace import op_name, reduce_events, union


def test_union_merges_overlaps():
    assert union([(5, 9), (0, 2), (1, 3), (9, 10)]) == [[0, 3], [5, 10]]


def test_op_names_lose_templates_and_parameters():
    assert op_name("void vfg::grain_plane_kernel<unsigned short, false, 0>"
                   "(Args)") == "void vfg::grain_plane_kernel"
    assert op_name("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD"


def test_reduction_clips_to_the_window_and_splits_idle_over_spans():
    r = reduce_events(
        (0, 100),
        [(-5, 5, "early"), (10, 20, "k1"), (15, 30, "k2"),
         (50, 60, "Memcpy DtoH (Device -> Pinned)"), (95, 120, "late")],
        [(0, 8, "bases"), (30, 45, "step"), (62, 90, "wait")])
    # busy: [0,5] + [10,30] + [50,60] + [95,100]
    assert r["busy_s"] == pytest.approx(40e-6)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["copy_s"] == pytest.approx(10e-6)
    # kernels alone: [0,5] + [10,30] + [95,100], the copy left out
    assert r["kernel_busy_s"] == pytest.approx(30e-6)
    assert r["ops"]["k2"] == [1, pytest.approx(15e-6)]
    assert r["ops"]["early"][1] == pytest.approx(5e-6)   # clipped
    idle = r["idle"]
    assert idle["bases"] == pytest.approx(3e-6)          # [5, 8]
    assert idle["step"] == pytest.approx(15e-6)          # [30, 45]
    assert idle["wait"] == pytest.approx(28e-6)          # [62, 90]
    assert sum(idle.values()) == pytest.approx(60e-6)
    assert idle["other"] == pytest.approx(14e-6)
    assert [k for k, _ in r["idle_gaps"]][0] == "wait"
    assert len(r["device_ops"]) <= 10


def _rec(**kw):
    base = dict(seconds=10.0, frames=80, steps=10, batch=8,
                geometry=(3840, 2160, 10, 0))
    base.update(kw)
    return base


def test_readers_read_nothing_without_a_device():
    rec = _rec(trace=dict(busy_s=0.0, window_s=10.0, copy_s=0.0,
                          kernel_busy_s=0.0, ops={}))
    for read in (readers.idle_pct, readers.copy_ms, readers.prep_launches,
                 readers.step_roofline):
        assert read(rec) is None
    assert readers.span_ms(_rec(spans={}), "frame_bases") is None


def test_readers_on_a_device_trace():
    ops = {"void vfg::grain_plane_kernel": [30, 0.002],
           "void at::native::elementwise_kernel": [1340, 0.003],
           "Memcpy HtoD": [10, 0.0001]}
    rec = _rec(trace=dict(busy_s=0.0051, window_s=10.0, copy_s=0.0001,
                          kernel_busy_s=0.005, ops=ops),
               spans={"frame_bases": [0.003, 0.005]},
               done=[0.5, 9.9, 10.0, 10.2])
    assert readers.idle_pct(rec) == pytest.approx(99.949)
    assert readers.prep_launches(rec) == 134
    bound = roofline.step_bound_s(3840, 2160, 10, 0, 8)
    assert readers.step_roofline(rec) == pytest.approx(
        100 * bound / 0.0005)
    assert readers.span_ms(rec, "frame_bases") == pytest.approx(4.0)
    assert readers.window_rate(rec) == pytest.approx(0.3)
    assert readers.copy_ms(rec) == pytest.approx(1e3 * 0.0001 / 80)
