"""CPUs of a run's processes: the program's apart from the harness's
helpers.

The top ``HELPERS`` CPUs of the process's CPU set are kept for the pipe
drivers' feeder and sink, one each; the program under test runs on the
rest, in every cell, so that a helper's copies never take a core from the
program's thread.  On a machine with too few CPUs to keep two for the
program, nothing is pinned.
"""

from __future__ import annotations

import os

HELPERS = 2     # the pipe drivers' feeder and sink


def split(cpus=None) -> tuple[list[int], list[int | None]]:
    """(the program's CPUs, one CPU for each helper) out of ``cpus``
    (default: this process's)."""
    cpus = sorted(os.sched_getaffinity(0) if cpus is None else cpus)
    if len(cpus) < HELPERS + 2:
        return cpus, [None] * HELPERS
    return cpus[:-HELPERS], cpus[-HELPERS:][::-1]


def pin(cpus) -> None:
    """Run this process's calling thread, and the threads it starts from
    now on, on ``cpus`` (an int, a list, or None for no change)."""
    if cpus is None:
        return
    os.sched_setaffinity(0, [cpus] if isinstance(cpus, int) else cpus)


_helpers: list[int | None] = [None] * HELPERS


def pin_program() -> None:
    """Pin this process, before it starts any thread, to the program's
    CPUs, and keep the helpers' for ``helper_cpu``.  Called by
    ``python -m portbench`` only: a run inside another process (the tests,
    ``control.py``) pins nothing."""
    global _helpers
    program, _helpers = split()
    if _helpers[0] is not None:
        pin(program)


def helper_cpu(i: int) -> int | None:
    """The CPU kept for helper ``i``, or None."""
    return _helpers[i]
