"""What the harness runs imports neither JAX nor the JAX package, and the
frozen reference imports nothing of the program either, compared by whole
top-level module name (the program's name begins with the JAX
package's)."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from cells import PKG, REPO
from portbench.run import FORBIDDEN, PORT, forbidden_loaded


def _imports(folder: str, skip=("tests",)):
    found = {}
    for base, dirs, files in os.walk(folder):
        dirs[:] = [d for d in dirs if d not in skip + ("__pycache__",)]
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(base, f)
            with open(path) as fh:
                tree = ast.parse(fh.read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module]
                else:
                    continue
                for n in names:
                    found.setdefault(n.split(".")[0], set()).add(
                        os.path.relpath(path, folder))
    return found


def test_harness_imports_no_jax():
    top = _imports(PKG, skip=())
    assert not set(top) & set(FORBIDDEN), {k: top[k] for k in FORBIDDEN
                                           if k in top}


def test_reference_imports_nothing_of_either_package():
    top = _imports(os.path.join(PKG, "reference"))
    assert not set(top) & (set(FORBIDDEN) | {PORT}), top
    assert set(top) <= {"__future__", "functools", "os", "numpy", "torch"}


def test_whole_names_are_compared():
    assert forbidden_loaded([PORT, PORT + ".ops.lfsr"]) == []
    assert forbidden_loaded(["versatilefilmgrain_tpu.ops"]) == [
        "versatilefilmgrain_tpu"]
    assert forbidden_loaded(["jaxlib.xla_client", "jaxtyping"]) == ["jaxlib"]


@pytest.mark.parametrize("what,banned", [
    ("import portbench.reference.model", FORBIDDEN + (PORT,)),
    ("import portbench.run, portbench.check, portbench.faults, "
     "portbench.drivers.pipe, portbench.drivers.resident, "
     "portbench.drivers.paced", FORBIDDEN),
])
def test_loaded_modules_at_run_time(what, banned):
    code = (f"{what}\nimport sys\n"
            f"print(sorted({{m.split('.')[0] for m in sys.modules}}))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(ast.literal_eval(out))
    assert not loaded & set(banned), loaded & set(banned)


def test_feeder_and_sink_import_no_torch():
    code = ("import portbench.drivers._feed, portbench.drivers._sink, sys\n"
            "print('torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    assert out.strip() == "False"
