"""The real cells on the card, those of ``BENCHMARK.json`` and the held
ones, at their own sizes with short windows: a sound run is correct, and
with the control planted it is not.  Marked ``cuda``; each test skips
without a card, decided inside the test.

    python -m pytest portbench/tests/test_portbench_card.py -q
"""

from __future__ import annotations

import json
import os

import pytest

from cells import REPO, with_held
from portbench.control import readings

with open(os.path.join(REPO, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in with_held(json.load(_f))["workloads"]]


def _need_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_card(bench_root, cell):
    _need_card()
    res = readings(cell, 2**31 + 101, 2.0, "sound", root=bench_root)
    assert res is not None and res["correct"], res
    assert res["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_card(bench_root, cell):
    _need_card()
    res = readings(cell, 2**31 + 102, 2.0, "control", root=bench_root)
    assert res is not None and res["correct"] is False, res
    assert res["checks"]["mismatched_samples"]["value"] > 0
