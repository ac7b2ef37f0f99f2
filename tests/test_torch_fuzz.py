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
forty more are marked ``slow``.  The cases and their draw live in
tests/torch_port_cases.py, which imports no JAX: chip_smoke.py runs the same
fifty through the port's CLI on the card.
"""

import os
import random

import pytest

from versatilefilmgrain_tpu import cli as jax_cli
from versatilefilmgrain_tpu_torch import cli as torch_cli

from torch_port_cases import (FUZZ_DIMS, FUZZ_SLOW, FUZZ_TIER1, draw_case,
                              fuzz_case, load_fuzz_cfg)


@pytest.fixture(scope="module")
def fuzz():
    return load_fuzz_cfg()


def _run(main, argv, out):
    """Exit code and output bytes (None where there is no output file)."""
    rc = main(argv + [out])
    data = open(out, "rb").read() if os.path.exists(out) else None
    return rc, data


def _check_case(fuzz, seed, boundary, work):
    kind, args, inp = fuzz_case(fuzz, seed, boundary, work)
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


@pytest.mark.parametrize("seed,boundary", FUZZ_TIER1)
def test_cli_matches_jax(seed, boundary, fuzz, tmp_path):
    _check_case(fuzz, seed, boundary, tmp_path)


@pytest.mark.slow
@pytest.mark.parametrize("seed,boundary", FUZZ_SLOW)
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
        fuzz.run_case(0, random.Random(seed), "in", dims=FUZZ_DIMS)
        _, args, _ = draw_case(fuzz, random.Random(seed), str(tmp_path),
                               *FUZZ_DIMS)
        ref_args = calls[0][1:-2]

        def strip(a):   # config paths differ; their POC prefixes do not
            return [x.split(":")[0] + ":" if ":" in x else
                    ("cfg" if x.endswith(".cfg") else x) for x in a]
        assert strip(args) == strip(ref_args), f"seed {seed}"
