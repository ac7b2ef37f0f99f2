"""Run one benchmark cell once and print its result line.

    python -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``workloads`` in the checkout's ``BENCHMARK.json``.
Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by name, so that a cell, a mix or a metric is added
with new files and a ``BENCHMARK.json`` entry and no edit:

* ``portbench/configs/<file>``: the configuration (geometry, depth, chroma
  format, and either ``cfg``, the cfg file popped at frame 0, or
  ``schedule``, ``[[poc, "file.cfg"], ...]``, the C model's ``-c POC:file``
  list popped in order), named by the ``configs`` entry, with its cfg
  files beside it;
* ``portbench/traffic/<traffic>.json``: the mix's parameters and the name
  of its driver;
* ``portbench/drivers/<driver>.py``: ``run(ctx)`` sets up, warms up, runs
  the window and returns the run's record (see ``Context``);
* ``portbench/metrics/<metric>.py``: ``read(record)`` gives the metric's
  value, or None where the record holds nothing to read.

With ``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a torch.profiler trace of the
window and the harness's spans.  After the window the outputs kept from it
are compared with the frozen plain reference (``check.py``).  The run exits
with another code than 0, and prints no result, without enough CUDA
devices, without the program, on a fault, or when JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
import traceback

PKG = os.path.dirname(os.path.abspath(__file__))
PORT = "versatilefilmgrain_tpu_torch"
# Top-level module names no run may load, compared whole: the port's own
# name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "versatilefilmgrain_tpu")


def load_file(path: str, name: str):
    """Import the Python file ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    names = {m.split(".", 1)[0] for m in (modules or list(sys.modules))}
    return sorted(names & set(FORBIDDEN))


class Refused(Exception):
    """A driver cannot run the cell's configuration: the run exits 2 with
    the message and prints no result."""


class Cell:
    """A workload of ``BENCHMARK.json`` under ``root`` with its
    configuration, traffic mix, driver and metrics, found by name."""

    def __init__(self, root: str, name: str):
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            bench = json.load(f)
        self.pkg = os.path.join(root, "portbench")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[self.entry["config"]]
        self.config_file = os.path.join(root, conf["file"])
        with open(self.config_file) as f:
            self.config = json.load(f)
        self._schedule = self._read_schedule()
        with open(os.path.join(self.pkg, "traffic",
                               self.entry["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        self.driver_file = os.path.join(self.pkg, "drivers",
                                        self.traffic["driver"] + ".py")
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]

    def _has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def _read_schedule(self) -> list[tuple[int, str]]:
        c, where = self.config, self.config_file
        if "cfg" in c and "schedule" in c:
            raise ValueError(f"{where}: gives both 'cfg' and 'schedule'")
        if "schedule" in c:
            entries = c["schedule"]
        else:
            entries = [[0, c["cfg"]]] if c.get("cfg") else []
        if not isinstance(entries, list):
            raise ValueError(f"{where}: 'schedule' is not a list")
        out = []
        for e in entries:
            if not (isinstance(e, list) and len(e) == 2
                    and type(e[0]) is int and e[0] >= 0
                    and isinstance(e[1], str) and e[1]):
                raise ValueError(f"{where}: a schedule entry is [poc, "
                                 f"\"file.cfg\"], poc 0 or more: {e!r}")
            if out and e[0] < out[-1][0]:
                raise ValueError(f"{where}: the schedule's POCs decrease "
                                 f"at {e!r}")
            path = os.path.join(os.path.dirname(where), e[1])
            if not os.path.isfile(path):
                raise ValueError(f"{where}: no cfg file {path}")
            out.append((e[0], path))
        return out

    def schedule(self) -> list[tuple[int, str]]:
        """The configuration's cfg pops, ``[(poc, cfg path), ...]`` in
        order: ``"cfg": X`` is ``[(0, X)]``, no cfg is ``[]``."""
        return list(self._schedule)

    def read(self, metric: dict, record: dict):
        """The metric's value from its reader, or None."""
        path = os.path.join(self.pkg, "metrics", metric["name"] + ".py")
        return load_file(path, "portbench_metric_" + metric["name"].replace(
            ".", "_").replace("-", "_")).read(record)


class Context:
    """What a driver is given: the cell, the run's arguments, the device,
    the process's start time, and the spans and trace of the window.

    A driver's ``run(ctx)`` returns its record, a dict with at least
    ``setup_s``, ``seconds``, ``attempted``, ``missing`` (frames offered
    that never came out), ``samples`` (``(frame index, pool index, planes)``
    of the frames kept for the check), ``crop`` (whether those planes are
    cropped to the frame or padded), ``memory_peak_bytes`` and the raw
    observations its metrics read.  It frees the program's state before
    it returns."""

    def __init__(self, cell: Cell, args, device: str, t_start: float,
                 root: str):
        from portbench.spans import Spans
        from portbench.trace import DeviceTrace
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.seconds = args.seed, args.seconds
        self.traced = bool(args.trace)
        self.device, self.t_start, self.root = device, t_start, root
        self.spans = Spans(self.traced)
        self.trace = DeviceTrace(self.traced, device)
        self.marks = [("start", t_start)]

    def mark(self, name: str) -> None:
        """End the set-up phase ``name`` (for the set-up's breakdown)."""
        self.marks.append((name, time.monotonic()))

    def setup_line(self, t_open: float) -> str:
        """Seconds of each set-up phase, to the window's opening."""
        marks = self.marks + [("to the window", t_open)]
        return "set-up " + ", ".join(
            f"{n} {b - a:.3f} s" for (_, a), (n, b) in zip(marks, marks[1:]))


def parse(argv):
    ap = argparse.ArgumentParser(prog="python -m portbench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_problem(chips: int) -> str | None:
    """Why this machine cannot run a cell on ``chips`` cards, or None."""
    import torch
    if not torch.cuda.is_available():
        return "no CUDA device: the benchmark runs on the card only"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} CUDA devices, "
                f"{torch.cuda.device_count()} present")
    return None


def device_info(device: str, chips: int, record: dict) -> dict:
    import torch
    if device.startswith("cuda"):
        info = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                    count=chips)
    else:
        info = dict(platform="cpu", kind="cpu", count=chips)
    info["memory_peak_bytes"] = int(record["memory_peak_bytes"])
    return info


def card_line() -> str | None:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def main(argv=None, *, t_start: float | None = None, root: str | None = None,
         device: str | None = None) -> int:
    """Run one cell; returns the exit code.  ``device`` None means the
    card, after the look for one; the tests pass ``"cpu"`` to drive the
    rest of a run on the program's plain versions.  ``root``: the checkout
    (default: the folder above this package)."""
    t_start = time.monotonic() if t_start is None else t_start
    args = parse(argv)
    root = root or os.path.dirname(PKG)
    try:
        cell = Cell(root, args.workload)
    except (OSError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    chips = int(cell.entry["chips"])
    if device is None:
        problem = card_problem(chips)
        if problem:
            print(f"portbench: {problem}", file=sys.stderr)
            return 2
        device = "cuda"
    try:
        importlib.import_module(PORT)
    except ImportError as e:
        print(f"portbench: the program under test ({PORT}) does not "
              f"import: {e}", file=sys.stderr)
        return 3

    from portbench import check
    ctx = Context(cell, args, device, t_start, root)
    ctx.mark("imports and card")
    try:
        driver = load_file(cell.driver_file,
                           "portbench_driver_" + cell.traffic["driver"])
        record = driver.run(ctx)
    except Refused as e:
        print(f"portbench: {e}; no result", file=sys.stderr)
        return 2
    except Exception:
        traceback.print_exc()
        print("portbench: the run failed; no result", file=sys.stderr)
        return 1
    found = forbidden_loaded()
    if found:
        print(f"portbench: modules {found} were loaded in the process that "
              f"ran the window; no result", file=sys.stderr)
        return 4
    try:
        verdict = check.verify(cell, record, args.seed, device)
    except Exception:
        traceback.print_exc()
        print("portbench: the check failed to run; no result",
              file=sys.stderr)
        return 1

    metrics = {}
    for m in (cell.per_layer if ctx.traced else cell.end_to_end):
        value = cell.read(m, record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = device_info(device, chips, record)
    result = dict(correct=verdict["correct"],
                  attempted=int(record["attempted"]),
                  failed=int(verdict["failed"]), metrics=metrics, device=dev)
    if ctx.traced and record.get("trace"):
        tr = record["trace"]
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = dict(device_ops=tr["device_ops"],
                                   idle_gaps=tr["idle_gaps"])
    if device.startswith("cuda"):
        result["card"] = card_line()
    notes = [ctx.setup_line(t_start + record["setup_s"])] + \
        record.get("notes", [])
    if verdict["wrong_frames"]:
        notes.append("kept frames that differ from the reference: "
                     + " ".join(map(str, verdict["wrong_frames"])))
    for line in notes:
        print(f"portbench: {line}", file=sys.stderr)
    result["checks"] = verdict["checks"]
    for name, c in verdict["checks"].items():
        print(f"check {name} {c['value']} {c['rule']} {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
