"""The split of a run's CPUs between the program and the helpers."""

from __future__ import annotations

import os

import pytest

from portbench import affinity


@pytest.mark.parametrize("cpus,program,helpers", [
    (range(8), [0, 1, 2, 3, 4, 5], [7, 6]),
    ([3, 9, 4, 12, 5], [3, 4, 5], [12, 9]),
    (range(4), [0, 1], [3, 2]),
    (range(3), [0, 1, 2], [None, None]),
    ([0], [0], [None, None])])
def test_helpers_take_the_top_cpus_one_each(cpus, program, helpers):
    assert affinity.split(cpus) == (program, helpers)


def test_split_defaults_to_this_process():
    mine = sorted(os.sched_getaffinity(0))
    program, helpers = affinity.split()
    assert sorted(program + [c for c in helpers if c is not None]) == mine


def test_pin_of_none_changes_nothing():
    before = os.sched_getaffinity(0)
    affinity.pin(None)
    assert os.sched_getaffinity(0) == before
    assert affinity.helper_cpu(0) is None   # nothing pinned in this process
