"""BENCHMARK.json keeps to the benchmark's rules of form: names and units
of the allowed characters, the keys each entry may have, every file it
names present under the harness, and a reader for every metric; and so
does it with the held cells (held.json) merged in."""

from __future__ import annotations

import json
import os
import re

import pytest

from cells import PKG, REPO, with_held

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module", params=["committed", "with the held"])
def bench(request):
    """BENCHMARK.json as committed, and with the held cells merged in (a
    held end-to-end metric takes the largest bound a later PR may set)."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    if request.param == "committed":
        return bench
    bench = with_held(bench)
    for m in bench["end_to_end"]:
        m.setdefault("bound", 0.25)
    return bench


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert bench["command"][:3] == ["python3", "-m", "portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 65536


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(bench, section):
    names = [e["name"] for e in bench[section]]
    assert len(names) == len(set(names))
    for e in bench[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e
        assert NAME.fullmatch(e["name"]), e["name"]
        for k in ("why", "layer", "source"):
            if k in e and k != "source" or section == "configs" and k == "source":
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                    and "\t" not in e[k], (e["name"], k)
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_cells_configs_and_metrics_refer_to_each_other(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"] for w in bench["workloads"]}
    used = {w["config"] for w in bench["workloads"]}
    assert used == set(configs)
    for c in configs.values():
        assert PATH.fullmatch(c["file"]) and c["file"].startswith(
            "portbench/")
        assert os.path.exists(os.path.join(REPO, c["file"]))
        for k in c["reduced"]:
            assert NAME.fullmatch(k)
    for w in bench["workloads"]:
        assert w["chips"] == 1
        assert os.path.exists(os.path.join(PKG, "traffic",
                                           w["traffic"] + ".json"))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(PKG, "metrics",
                                           m["name"] + ".py")), m["name"]
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert "workloads" not in e2e[m["moves"]] \
                or w in e2e[m["moves"]]["workloads"]
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    for w in cells:
        assert sum(w in m.get("workloads", cells)
                   for m in bench["end_to_end"]) >= 2
        assert any(w in m["workloads"] for m in bench["per_layer"])
    # one quantity, one layer name
    assert all(len(v) == 1 for v in layers.values()), layers


def test_files_under_the_harness_are_named_from_name_characters():
    for base, dirs, files in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files + dirs:
            assert NAME.fullmatch(f), os.path.join(base, f)
