"""The check's readings with the control and each planted fault, at the
cells' own sizes, on the card (the benchmark's own runs run none of this).

    python -m portbench.control --workload <name> [...] --seeds 11,12,13
        [--seconds 2] [--kinds sound,control,...,late_switch]

For each cell, seed and kind it runs the cell in this process with the
fault planted (``faults.py``; ``sound`` plants nothing) and prints one
line: cell, kind, seed, ``correct``, ``failed`` and each number compared.
Each cell runs the kinds its traffic mix and configuration can have
(``faults.kinds_for``): a batch of one has no half to leave out, only the
pipe driver's frames leave through the program's writer, and only a
configuration that pops a cfg past frame 0 can switch late.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys

from portbench import faults, run


def readings(workload: str, seed: int, seconds: float, kind: str,
             device: str | None = None,
             root: str | None = None) -> dict | None:
    """The result line of one run of ``workload`` with ``kind`` planted,
    or None when it printed none.  ``root``: the checkout whose
    ``BENCHMARK.json`` names the cell (default: this one)."""
    out = io.StringIO()
    plant = (contextlib.nullcontext() if kind == "sound"
             else faults.planted(kind))
    with plant, contextlib.redirect_stdout(out):
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", "0"],
                      device=device, root=root)
    lines = out.getvalue().strip().splitlines()
    return json.loads(lines[-1]) if rc == 0 and lines else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--kinds", default=",".join(faults.KINDS))
    a = ap.parse_args(argv)
    problem = run.card_problem(1)
    if problem:
        print(f"portbench.control: {problem}", file=sys.stderr)
        return 2
    root = os.path.dirname(run.PKG)
    for cell in a.workload:
        c = run.Cell(root, cell)
        can = faults.kinds_for(c.traffic, c.schedule())
        for kind in a.kinds.split(","):
            if kind != "sound" and kind not in can:
                continue
            for seed in map(int, a.seeds.split(",")):
                res = readings(cell, seed, a.seconds, kind)
                if res is None:
                    print(f"{cell} {kind} {seed} no result", flush=True)
                    continue
                nums = " ".join(f"{k}={v['value']}"
                                for k, v in res["checks"].items())
                print(f"{cell} {kind} {seed} correct={res['correct']} "
                      f"failed={res['failed']} attempted={res['attempted']} "
                      f"{nums}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
