"""Shared inputs for the torch port's tests (tests/test_torch_*.py).

Each helper takes a package (the JAX reference ``versatilefilmgrain_tpu`` or
the port ``versatilefilmgrain_tpu_torch``) and builds the same config through
that package's own modules, so both sides of a comparison run their own host
code on identical inputs.
"""

import hashlib
import importlib
import importlib.util
import json
import os
import random
import socket
import subprocess
import sys
import time

import numpy as np

JAX_PKG = "versatilefilmgrain_tpu"
TORCH_PKG = "versatilefilmgrain_tpu_torch"

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_DIR = os.path.join(REPO, "tests", "golden", "cfg")
CFG_FILES = sorted(f for f in os.listdir(CFG_DIR)
                   if f.endswith((".cfg", ".tbl", ".txt")))

# The engine grid of tests/test_fast_engine.py and test_natural_engine.py.
KINDS = ["sei_ff", "sei_ar", "afgs1"]
DEPTH_CSUB = [(10, (2, 2)), (8, (2, 2)), (10, (2, 1)), (8, (1, 1))]

# The CLI fuzz cases (tests/test_torch_fuzz.py, chip_smoke.py), each a
# (seed, boundary widths) pair: ten in tier-1, two of them at the boundary
# widths 130-160, then forty more, ten of them at boundary widths.
FUZZ_DIMS = (192, 160)       # tools/fuzz_cfg.py's default geometry
FUZZ_TIER1 = [(s, False) for s in range(8)] + [(100, True), (101, True)]
FUZZ_SLOW = ([(s, False) for s in range(8, 38)]
             + [(s, True) for s in range(102, 112)])


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def afgs1_cfg(pkg):
    """The AFGS1 config of tests/test_fast_engine.py (luma + both chroma)."""
    a = mod(pkg, "models.config").default_afgs1()
    a.grain_seed = 4321
    a.num_y_points = 3
    a.point_y_values[:3] = [0, 128, 255]
    a.point_y_scaling[:3] = [40, 90, 20]
    a.num_cb_points = 2
    a.point_cb_values[:2] = [0, 255]
    a.point_cb_scaling[:2] = [60, 60]
    a.num_cr_points = 2
    a.point_cr_values[:2] = [0, 255]
    a.point_cr_scaling[:2] = [30, 80]
    a.grain_scaling = 9
    a.ar_coeff_lag = 2
    a.ar_coeffs_y[:12] = [4, -3, 2, 1, -2, 8, 40, 10, -5, 2, 1, 0]
    a.ar_coeffs_cb[:12] = [2, 0, 1, 0, -1, 3, 30, 5, -2, 1, 0, 0]
    a.ar_coeffs_cr[:12] = [1, 1, 0, 0, -1, 2, 25, 4, -1, 0, 0, 0]
    a.ar_coeff_shift = 7
    a.grain_scale_shift = 1
    a.clip_to_restricted_range = 1
    return a


def golden_cli_args(case, inp, out):
    """``tools/gen_golden.cli_args`` with every path into tests/golden/ based
    on this checkout.  checksums.json records its cfg_extra cases by the
    absolute path of the checkout that generated it; "POC:path" keeps its
    POC."""
    from gen_golden import cli_args

    def rebase(arg):
        head, sep, tail = arg.partition("/tests/golden/")
        if not sep:
            return arg
        poc, colon, _ = head.partition(":")
        keep = poc + colon if colon and poc.isdigit() else ""
        return keep + os.path.join(REPO, "tests", "golden", tail)
    return [rebase(a) for a in cli_args(case, inp, out)]


def golden_output(cli_main, entry, engine, tmpdir, device="cpu"):
    """Run one golden CLI case (an entry of tests/golden/checksums.json)
    through ``cli_main`` with ``--engine engine --device device``; returns
    the output bytes.  Inputs are generated once per geometry into
    ``tmpdir``."""
    from gen_golden import FMT_NAMES
    from gen_input import make_input_yuv
    case = entry["case"]
    inp = os.path.join(tmpdir, "in_%dx%d_%db_%s_%df.yuv" % (
        case["w"], case["h"], case["depth"], FMT_NAMES[case["fmt"]],
        case["in_frames"]))
    if not os.path.exists(inp):
        make_input_yuv(inp, case["w"], case["h"], case["depth"], case["fmt"],
                       case["in_frames"])
    out = os.path.join(tmpdir, f"out_{engine}.yuv")
    assert cli_main(["vfgs-torch", "--engine", engine, "--device", device]
                    + golden_cli_args(case, inp, out)) == 0
    with open(out, "rb") as f:
        return f.read()


def load_fuzz_cfg():
    """tools/fuzz_cfg.py, loaded by path and unchanged (it imports no
    JAX)."""
    spec = importlib.util.spec_from_file_location(
        "_fuzz_cfg", os.path.join(REPO, "tools", "fuzz_cfg.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


def draw_case(fuzz, rng, work, w, h):
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


def fuzz_case(fuzz, seed, boundary, work):
    """Kind, CLI arguments and input path of the fuzz case (seed,
    boundary): at boundary widths the geometry is drawn first, as
    fuzz_cfg.main --boundary draws it (even widths hugging the reference's
    width > 128 limit), else it is fuzz_cfg.py's default."""
    rng = random.Random(seed)
    if boundary:
        w, h = 2 * rng.randint(65, 80), 2 * rng.randint(65, 80)
    else:
        w, h = FUZZ_DIMS
    return draw_case(fuzz, rng, str(work), w, h)


def regs_for(pkg, kind, depth, csub):
    """Register file after FW init for one grid case (cf. test_fast_engine)."""
    cfgmod, fw = mod(pkg, "models.config"), mod(pkg, "models.fw")
    regs = mod(pkg, "models.hw").HwRegs()
    regs.set_depth(depth)
    regs.set_chroma_subsampling(*csub)
    if kind == "sei_ff":
        fw.init_sei(cfgmod.default_sei(), regs)
    elif kind == "sei_ar":
        sei = cfgmod.default_sei()
        sei.model_id = 1
        sei.comp_model_present_flag = [1, 0, 0]
        sei.log2_scale_factor = 6
        sei.comp_model_value[0, :8, :6] = np.array(
            [[100, 11, 0, -8, 32, -7]] * 8, np.int16)
        fw.init_sei(sei, regs)
    else:
        fw.init_afgs1(afgs1_cfg(pkg), regs)
    return regs


def frame_bases(pkg, seed_state, R, C, frames):
    """(bases, bases_up) of ``frames`` through the package's lfsr module."""
    lfsr = mod(pkg, "ops.lfsr")
    bases, bases_up = [], []
    for f in frames:
        e0 = lfsr.frame_base_exponent(f, R, C)
        bases.append(int(lfsr.advance(np.uint32(seed_state), e0)))
        bases_up.append(int(lfsr.advance(np.uint32(seed_state), e0 - C))
                        if e0 else bases[-1])
    return bases, bases_up


def random_planes(seed, depth, R, C, csub, frames=None):
    """Seeded random padded (Y, U, V) numpy planes, optionally batched."""
    csubx, csuby = csub
    rng = np.random.default_rng(seed)
    dt = np.uint8 if depth == 8 else np.uint16
    lead = () if frames is None else (frames,)
    hi = (1 << depth) - 1
    return tuple(rng.integers(0, hi + 1, lead + shape).astype(dt)
                 for shape in ((R * 16, C * 16),
                               (R * (16 // csuby), C * (16 // csubx)),
                               (R * (16 // csuby), C * (16 // csubx))))


def luma_only_sei(cfgmod):
    """A luma-only SEI config of the package whose config module is
    ``cfgmod`` (the default config has chroma grain, which 4:2:2 and
    4:4:4 refuse)."""
    sei = cfgmod.FgsSei()
    sei.model_id = 0
    sei.log2_scale_factor = 5
    sei.comp_model_present_flag = [1, 0, 0]
    sei.num_intensity_intervals = [4, 0, 0]
    sei.num_model_values = [3, 0, 0]
    sei.intensity_interval_lower_bound[0, :4] = [0, 60, 120, 180]
    sei.intensity_interval_upper_bound[0, :4] = [59, 119, 179, 255]
    sei.comp_model_value[0, :4, :3] = [[90, 4, 6], [120, 8, 8],
                                       [140, 11, 9], [160, 14, 14]]
    return sei


def edit_design(d):
    """The designer edits both packages are held to: interval 2 of luma
    split at 70 and its upper half toggled off, two scales changed, another
    log2 scale factor and gain.  Returns ``d``."""
    if not d.split(0, 2, 70):
        raise ValueError("the design's luma interval 2 does not hold 70")
    d.toggle(0, 3)
    d.values[0][0][0] = 200
    d.values[1][1][0] = 40
    d.log2_scale_factor = 6
    d.gain = 80
    return d


def run_workers(inp, outdir, width, height, frames, batch, device,
                nproc=2, timeout=600):
    """Spawn ``nproc`` fresh interpreters of tests/torch_distributed_worker.py
    on one localhost rendezvous, grain ``frames`` 10-bit 4:2:0 frames of
    ``inp`` in contiguous shards on ``device`` and wait for them.  Raises
    unless every worker exits 0 and every rank gathered every shard's
    sha256 in shard order.  Returns (the shards' bytes concatenated, each
    rank's gathered record, wall seconds from spawn to the last exit)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=REPO)
    worker = os.path.join(REPO, "tests", "torch_distributed_worker.py")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, worker, coord, str(nproc), str(pid), inp,
         str(outdir), str(width), str(height), str(frames), str(batch),
         device], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(nproc)]
    try:
        logs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    for pid, (p, (out, err)) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"worker {pid} exit {p.returncode}:\n{out}\n"
                               f"{err}")
    parts = []
    for pid in range(nproc):
        with open(os.path.join(outdir, f"out_{pid}.yuv"), "rb") as f:
            parts.append(f.read())
    digests = [hashlib.sha256(p).hexdigest() for p in parts]
    recs = []
    for pid in range(nproc):
        with open(os.path.join(outdir, f"gathered_{pid}.json")) as f:
            recs.append(json.load(f))
        if recs[-1]["pid"] != pid or recs[-1]["digests"] != digests:
            raise RuntimeError(f"rank {pid} gathered {recs[-1]}, expected "
                               f"the digests {digests}")
    return b"".join(parts), recs, seconds
