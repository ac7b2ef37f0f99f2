"""Differential fuzz of the port's CLI against the JAX package's CLI.

tools/fuzz_cfg.py (loaded by path, unchanged) draws random film-grain
configs -- FGC SEI frequency filtering and auto-regressive, AFGS1, AFGS1
tables, VTM/HM SEI dumps, and mid-stream switches among them -- and CLI
options (``-b``, ``-g``, ``-r``, ``-s``, ``--outdepth``).  Each case here
draws one the way its ``run_case`` does, then runs
``versatilefilmgrain_tpu.cli.main`` (JAX on the CPU) and
``versatilefilmgrain_tpu_torch.cli.main --device cpu`` in this process on the
same config and input, and requires equal exit codes and, where both
succeed, byte-identical outputs.  The reference binary that fuzz_cfg.py
compares with is not needed: the JAX package is held to it by its own
golden tests.

Ten seeded cases run in tier-1, two of them at the boundary widths 130-160;
forty more are marked ``slow``.
"""

import importlib.util
import os
import random

import pytest

from versatilefilmgrain_tpu import cli as jax_cli
from versatilefilmgrain_tpu_torch import cli as torch_cli

from torch_port_cases import REPO

DIMS = (192, 160)       # fuzz_cfg.py's default geometry
# (seed, boundary widths): tier-1 cases, then the slow ones
TIER1 = [(s, False) for s in range(8)] + [(100, True), (101, True)]
SLOW = ([(s, False) for s in range(8, 38)]
        + [(s, True) for s in range(102, 112)])


@pytest.fixture(scope="module")
def fuzz():
    spec = importlib.util.spec_from_file_location(
        "_fuzz_cfg", os.path.join(REPO, "tools", "fuzz_cfg.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def _draw_case(fuzz, rng, work, w, h):
    """CLI arguments and input path of one case, drawn from ``rng`` as
    fuzz_cfg.run_case draws them; the configs are written under ``work``."""
    kind = rng.choice(["ff", "ff", "ar", "afgs1", "afgs1", "tbl", "multi",
                       "dump"])
    gens = {"ff": fuzz.gen_sei_ff, "ar": fuzz.gen_sei_ar,
            "afgs1": fuzz.gen_afgs1, "tbl": fuzz.gen_tbl,
            "dump": fuzz.gen_dump}
    args = ["-w", str(w), "-h", str(h), "-b", rng.choice(["8", "10"]),
            "-n", "3"]
    if kind == "multi":
        pocs = sorted(rng.sample(range(0, 3), rng.randint(1, 3)))
        for m, poc in enumerate(pocs):
            sub = rng.choice(["ff", "ar", "afgs1", "tbl"])
            cfg = os.path.join(work, f"case_{m}.cfg")
            with open(cfg, "w") as f:
                f.write(gens[sub](rng))
            args += ["-c", f"{poc}:{cfg}"]
    else:
        cfg = os.path.join(work, "case.cfg")
        with open(cfg, "w") as f:
            f.write(gens[kind](rng))
        args += ["-c", cfg]
    if rng.random() < 0.3:
        args += ["-g", str(rng.randint(40, 200))]
    if rng.random() < 0.3:
        args += ["-r", str(rng.randint(1, 2**30))]
    if rng.random() < 0.2:
        args += ["-s", "1"]
    if rng.random() < 0.2 and args[5] == "10":
        args += ["--outdepth", "8"]
    depth = int(args[5])
    inp = os.path.join(work, f"in_{w}x{h}.yuv.{depth}")
    fuzz.make_input_yuv(inp, w, h, depth, 0, 4)
    return kind, args, inp


def _run(main, argv, out):
    """Exit code and output bytes (None where there is no output file)."""
    rc = main(argv + [out])
    data = open(out, "rb").read() if os.path.exists(out) else None
    return rc, data


def _check_case(fuzz, seed, boundary, work):
    rng = random.Random(seed)
    if boundary:
        # fuzz_cfg.main --boundary: even widths hugging the reference's
        # width > 128 limit
        w, h = 2 * rng.randint(65, 80), 2 * rng.randint(65, 80)
    else:
        w, h = DIMS
    kind, args, inp = _draw_case(fuzz, rng, str(work), w, h)
    rc_j, out_j = _run(jax_cli.main, ["vfgs-tpu"] + args + [inp],
                       str(work / "jax.yuv"))
    rc_t, out_t = _run(torch_cli.main,
                       ["vfgs-torch", "--device", "cpu"] + args + [inp],
                       str(work / "torch.yuv"))
    case = f"seed {seed} [{kind}] {' '.join(args)}"
    assert rc_t == rc_j, f"{case}: exit {rc_t}, JAX exit {rc_j}"
    if rc_j == 0:
        assert out_j, f"{case}: no output"
        assert out_t == out_j, (f"{case}: output differs ({len(out_t)} vs "
                                f"{len(out_j)} bytes)")


@pytest.mark.parametrize("seed,boundary", TIER1)
def test_cli_matches_jax(seed, boundary, fuzz, tmp_path):
    _check_case(fuzz, seed, boundary, tmp_path)


@pytest.mark.slow
@pytest.mark.parametrize("seed,boundary", SLOW)
def test_cli_matches_jax_more(seed, boundary, fuzz, tmp_path):
    _check_case(fuzz, seed, boundary, tmp_path)


def test_draw_matches_run_case(fuzz, tmp_path, monkeypatch):
    """The case drawn here is the case fuzz_cfg.run_case draws from the same
    generator state: run_case's two subprocess calls are captured, not
    run."""
    calls = []

    class Done:
        returncode = 1
        stdout = stderr = b""

    def capture(cmd, **kw):
        calls.append(cmd)
        return Done()

    monkeypatch.setattr(fuzz, "WORK", str(tmp_path / "rc"))
    monkeypatch.setattr(fuzz.subprocess, "run", capture)
    os.makedirs(fuzz.WORK)
    for seed in range(20):
        calls.clear()
        fuzz.run_case(0, random.Random(seed), "in", dims=DIMS)
        _, args, _ = _draw_case(fuzz, random.Random(seed), str(tmp_path),
                                *DIMS)
        ref_args = calls[0][1:-2]

        def strip(a):   # config paths differ; their POC prefixes do not
            return [x.split(":")[0] + ":" if ":" in x else
                    ("cfg" if x.endswith(".cfg") else x) for x in a]
        assert strip(args) == strip(ref_args), f"seed {seed}"
