"""A configuration, a traffic mix and a per-layer metric are added to a
copy of the harness as new files and ``BENCHMARK.json`` entries, and a run
finds them by name with no existing file edited."""

from __future__ import annotations

import hashlib
import json
import os

from cells import PKG, make_root, run_cell


def _digests(folder: str) -> dict:
    out = {}
    for base, dirs, files in os.walk(folder):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "tests")]
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, folder)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_config_mix_and_metric_are_found_by_name(tmp_path):
    root = make_root(str(tmp_path))
    pb = os.path.join(root, "portbench")
    before = _digests(pb)
    original = _digests(PKG)
    assert all(before[k] == v for k, v in original.items())

    with open(os.path.join(pb, "configs", "tiny10_luma.json"), "w") as f:
        json.dump(dict(width=144, height=128, depth=10, chroma_format=0,
                       cfg=None), f)
    with open(os.path.join(pb, "traffic", "resident_b4.json"), "w") as f:
        json.dump(dict(driver="resident", batch=4, pool_batches=2,
                       check_per_position=1), f)
    with open(os.path.join(pb, "metrics", "steps_done.resident_b4.py"),
              "w") as f:
        f.write('def read(rec):\n    return rec["steps"]\n')
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append(dict(
        name="tiny10_luma", source="test", reduced=[], why="test",
        file="portbench/configs/tiny10_luma.json"))
    bench["workloads"].append(dict(
        name="tiny10_luma.resident_b4", config="tiny10_luma",
        traffic="resident_b4", chips=1, why="test"))
    fps = {m["name"]: m for m in bench["end_to_end"]}["fps_resident"]
    fps["workloads"].append("tiny10_luma.resident_b4")
    bench["per_layer"].append(dict(
        name="steps_done.resident_b4", unit="steps", better="higher",
        source="program_counter", layer="test", moves="fps_resident",
        workloads=["tiny10_luma.resident_b4"]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    rc, res, err = run_cell(root, "tiny10_luma.resident_b4", trace=0)
    assert rc == 0, err
    assert res["correct"] and res["attempted"] % 4 == 0
    assert set(res["metrics"]) == {"fps_resident", "setup_s"}
    rc, res, err = run_cell(root, "tiny10_luma.resident_b4", trace=1)
    assert rc == 0, err
    assert res["metrics"]["steps_done.resident_b4"]["value"] > 0
    after = _digests(pb)
    assert {k: after[k] for k in before} == before


def test_unknown_workload_exits_nonzero(bench_root, capsys):
    from portbench import run
    rc = run.main(["--workload", "no.such", "--seed", "1", "--seconds", "1",
                   "--trace", "0"], root=bench_root, device="cpu")
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_folder_without_the_program_exits_nonzero(tmp_path):
    """A directory that holds only BENCHMARK.json and the harness: the
    program is missing, so the run exits with another code than 0 and
    prints no result."""
    import shutil
    import subprocess
    import sys
    root = make_root(str(tmp_path))
    shutil.copy(os.path.join(os.path.dirname(PKG), "BENCHMARK.json"), root)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                        "fhd8_afgs1.pipe", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=root, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout == ""
