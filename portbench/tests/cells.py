"""A checkout copy for the harness's tests, whose ``BENCHMARK.json`` adds
the held cells and small cells of the same deployments beside the real
ones, and an in-process run of a cell on the program's plain versions."""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PKG)

GOLDEN_CFG = os.path.join(REPO, "tests", "golden", "cfg")

# Small configurations of the same deployments: 10-bit FGC SEI, 8-bit
# AFGS1 with a height off the block grid, and the latter switching between
# AFGS1 cfgs (the golden vectors, copied beside it) at POCs that cut
# batches of 8.
SMALL = {
    "small10_sei": dict(width=256, height=192, depth=10, chroma_format=0,
                        cfg=None),
    "small8_afgs1": dict(width=256, height=200, depth=8, chroma_format=0,
                         cfg="fgs_afgs1_test2.cfg"),
    "small8_afgs1_scenes": dict(
        width=256, height=200, depth=8, chroma_format=0,
        schedule=[[0, "fgs_afgs1_test2.cfg"], [5, "fgs_afgs1_test4.cfg"],
                  [13, "fgs_afgs1_test7.cfg"], [22, "fgs_afgs1_test10.cfg"],
                  [35, "fgs_afgs1_test16.cfg"]]),
}
SMALL_CELLS = {
    "small10_sei.pipe": ("small10_sei", "pipe_b8"),
    "small10_sei.resident": ("small10_sei", "resident_b8"),
    "small8_afgs1.live60": ("small8_afgs1", "live60_b1"),
    "small8_afgs1.pipe": ("small8_afgs1", "pipe_b8"),
    "small8_afgs1_scenes.pipe": ("small8_afgs1_scenes", "pipe_b8"),
}
# Cells whose driver refuses their configuration's mid-stream switches.
REFUSED_CELLS = {
    "small8_afgs1_scenes.resident": ("small8_afgs1_scenes", "resident_b8"),
    "small8_afgs1_scenes.live60": ("small8_afgs1_scenes", "live60_b1"),
}


def with_held(bench: dict) -> dict:
    """``bench`` with the cells held out of it (``held.json``) merged in,
    as a later PR would add them back."""
    with open(os.path.join(PKG, "held.json")) as f:
        held = json.load(f)
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[section] += held[section]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.setdefault("workloads", [])
        m["workloads"] += held["also_in"].get(m["name"], [])
        if not m["workloads"]:
            del m["workloads"]
    return bench


def make_root(dest: str) -> str:
    """A checkout at ``dest``: this folder and ``BENCHMARK.json``, with the
    held cells (``held.json``) and the small configurations and cells
    added as files and entries."""
    shutil.copytree(PKG, os.path.join(dest, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = with_held(json.load(f))
    for name, geo in SMALL.items():
        path = f"portbench/configs/{name}.json"
        with open(os.path.join(dest, path), "w") as f:
            json.dump(dict(geo, source="test"), f)
        for _, cfg in geo.get("schedule", []):
            copy = os.path.join(dest, "portbench", "configs", cfg)
            if not os.path.exists(copy):
                shutil.copy(os.path.join(GOLDEN_CFG, cfg), copy)
        bench["configs"].append(dict(name=name, source="test", file=path,
                                     reduced=[], why="test"))
    for name, (config, traffic) in {**SMALL_CELLS, **REFUSED_CELLS}.items():
        bench["workloads"].append(dict(name=name, config=config,
                                       traffic=traffic, chips=1, why="test"))
        kind = name.split(".")[1]
        for m in bench["end_to_end"] + bench["per_layer"]:
            real = [w for w in m.get("workloads", [])
                    if w.split(".")[1] == kind]
            if real:
                m["workloads"].append(name)
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dest


def run_cell(root: str, cell: str, seed: int = 7, seconds: float = 1.0,
             trace: int = 0):
    """Run a cell in this process on the CPU; returns (exit code, result
    or None, standard error)."""
    from portbench import run
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       str(seconds), "--trace", str(trace)], root=root,
                      device="cpu")
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None), \
        err.getvalue()


def traffic_of(cell: str) -> dict:
    """The traffic mix of small cell ``cell``, from its file."""
    path = os.path.join(PKG, "traffic", SMALL_CELLS[cell][1] + ".json")
    with open(path) as f:
        return json.load(f)


def schedule_of(cell: str) -> list:
    """The cfg schedule of small cell ``cell``'s configuration, as
    ``[(poc, cfg file name), ...]``."""
    geo = SMALL[SMALL_CELLS[cell][0]]
    if "schedule" in geo:
        return [tuple(e) for e in geo["schedule"]]
    return [(0, geo["cfg"])] if geo["cfg"] else []
