"""On-card smoke test of the PyTorch + CUDA port (versatilefilmgrain_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, one result line each:
  1. device   -- the card's name and power limit;
  2. build    -- nvcc builds csrc/grain_natural.cu, csrc/grain_tiled.cu,
                 csrc/expand_words.cu, csrc/probe_budget.cu,
                 csrc/probe_pipe.cu, csrc/probe_dot.cu and
                 csrc/probe_relayout.cu, all at once;
                 ptxas' register, shared memory and spill report;
  3. kernel   -- the kernel against its plain torch version on the card at
                 3840x2160 10-bit 4:2:0, default config, one batch of 8
                 frames; exact equality on all planes; both timed with CUDA
                 events;
  4. geometry -- the same comparison at small sizes for other configs,
                 depths, chroma formats, a pad-leak and an unaligned width;
  5. golden   -- the 48 golden CLI cases through the port's CLI on the card,
                 every sha256 checked, kernel launches counted;
  6. cli 4K   -- the port's CLI on an 8-frame 3840x2160 10-bit 4:2:0 file with
                 --batch 8 (the main path; launches counted), output size and
                 first frame checked against the plain version;
  7. tiled 4K -- the tiled engine (--engine pallas) at phase 3's shape: its
                 kernel against its plain strip function on the card and
                 against the natural kernel, exact on all planes; the kernel
                 alone, the whole tiled step and the plain version timed;
  8. tiled geometry -- phase 4's cases through the tiled kernel;
  9. tiled golden   -- the 48 golden CLI cases through --engine pallas;
 10. tiled cli 4K   -- the CLI with --engine pallas --batch 8 on phase 6's
                 file (the tiled engine's path; launches counted), output
                 byte-identical to phase 6's;
 11. words 4K -- the lane-word kernel (K2, csrc/expand_words.cu) against its
                 plain version at phase 3's shape, exact on all three
                 planes; both timed;
 12. stream 4K -- add_grain_batch_natural with word_expand "xla" (lane words
                 from the plain expansion) and "pallas" (from K2) == the
                 lattice path == the plain version; each step and K1 alone
                 on each input timed; launches of a "pallas" step counted
                 (K2 once, K1 three times);
 13. shard 4K -- make_grain_step on the one card with meshes (1, 1), (1, 5)
                 and (2, 3) in every word mode == the unsharded K1 output;
                 K1 boot launches and K2 launches counted;
 14. shard geometry -- the same at 128x256 over the dryrun_multichip sweep
                 (SEI-FF, AFGS1 x 4:2:0, 4:4:4 luma-only, 4:2:2, 8-bit x
                 grain offset 0 and 3), meshes (2, 4) and (1, 8);
 15. budget   -- every variant of the per-stage budget kernel (K5,
                 csrc/probe_budget.cu) == its plain version at 4K (default
                 config) and at phase 4's 256x192 sei_ar_test1 and
                 afgs1_test1 cases; then the budget table at 4K for the
                 default, sei_ar and afgs1 configs (the probe's run_config,
                 launches counted);
 16. pipe     -- the prefetch probe kernel (K4, csrc/probe_pipe.cu) == K1 ==
                 the plain version at 4K and on phase 4's 10-bit cases;
                 K4 and K1 timed in turns; the probe's run_config for the
                 three configs (launches counted, bit-exact);
 17. dot      -- every mode of the one-hot dot probe K6 (none, int8, bf16,
                 f32 on the tensor cores, csrc/probe_dot.cu) and its gather
                 mode == the plain version, exact, at 2 frames of 160x32 (a
                 width that is not a multiple of 128), then the probe's run
                 at 3840x2160, 8 frames (launches counted, every mode exact,
                 bf16 == int8 == gather); the plain version and one library
                 call per mode timed (torch._int_mm, bf16 and TF32
                 torch.matmul, pat[:, t]);
 18. dot2     -- the same for K7's modes (none, int8, build, dotconst);
 19. dotscale -- the same for K8's dense int8 product at M = 16, 64, 128,
                 144, 160, 256;
 20. relayout -- every instance of csrc/probe_relayout.cu (K9's passthrough
                 and relayout at 1, 5 and 15 block rows per thread block,
                 K10's two forms on the 5-D view) == its plain version ==
                 y ^ 1 at 2 frames of 240x160, then both relayout probes'
                 run at 3840x2160, 8 frames (launches counted, every case
                 exact) with the plain version and the torch round trip
                 _untile(_tile(y) ^ 1) timed beside them; shared memory and
                 thread blocks per SM of each instance, and the SASS counts
                 of the rchunk-1 relayout instance.
Then one JSON line describing the ten kernels, and as the last line
{"ok": true, "device": {...}}.  Any failure raises: the script exits non-zero
and prints no result.  It needs a CUDA device and the rest of the repository.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(REPO, "build", "chip_smoke")
CFG_DIR = os.path.join(REPO, "tests", "golden", "cfg")
DEVICE = "cuda"
FULL = (3840, 2160, 8)   # the main path's width, height and batch


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def phase(name, text):
    print(f"[{name}] {text}", flush=True)


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of fn() in ms over ``iters`` calls, after warm-up."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def byte_bound_ms(n):
    """Least ms to move ``n`` bytes at the H100 SXM's 3.35 TB/s."""
    return 1e3 * n / 3.35e12


def max_err(a, b):
    torch.cuda.synchronize()
    check(a.shape == b.shape and a.dtype == b.dtype,
          f"{a.dtype}{tuple(a.shape)} vs {b.dtype}{tuple(b.shape)}")
    return int((a.int() - b.int()).abs().max())


def exact_small(tag, cases, y):
    """Each case ``label: (step, want)``: one step on ``y`` == ``want``."""
    for label, (step, want) in cases.items():
        err = max_err(step(y)[0], want)
        check(err == 0, f"{tag} {label}: kernel differs from its plain "
              f"version (max |err| {err})")


def int_mm_ms(a, pat):
    """Device ms of torch._int_mm(a, pat^T), the library yardstick of an
    int8 product (pat^T as a column-major view where cuBLASLt takes it)."""
    b = pat.t()
    try:
        torch._int_mm(a, b)
    except RuntimeError:
        b = pat.t().contiguous()
    return cuda_ms(lambda: torch._int_mm(a, b), 5, warmup=1)


def sass_counts(kernels, lib, function,
                keys=("IMMA", "ISETP", "SEL", "SHF", "IADD3", "LDG", "LDS",
                      "STS", "STG")):
    """Counts of the SASS instructions ``keys`` of the kernel instance whose
    mangled name holds ``function``, in the built library ``lib``
    (cuobjdump)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return "cuobjdump not found"
    so = kernels._paths(lib)[1]
    sass = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    body = next((f for f in sass.split("Function : ")[1:]
                 if function in f.split("\n", 1)[0]), None)
    check(body is not None, f"no SASS for {function} in {so}")
    ops = re.findall(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)",
                     body)
    return f"{len(ops)} instructions; " + ", ".join(
        f"{k} {ops.count(k)}" for k in keys)


def random_batch(pipe, frames, seed, dev):
    """Seeded random padded planes for ``frames`` of ``pipe``'s geometry."""
    regs = pipe.regs
    R, C = -(-pipe.height // 16), -(-pipe.width // 16)
    bhc, bwc = 16 // regs.csuby, 16 // regs.csubx
    dt = np.uint8 if pipe.depth == 8 else np.uint16
    rng = np.random.default_rng(seed)
    hi = (1 << pipe.depth) - 1
    return [torch.from_numpy(rng.integers(0, hi + 1, (frames, h, w)).astype(dt))
            .to(dev) for h, w in ((R * 16, C * 16), (R * bhc, C * bwc),
                                  (R * bhc, C * bwc))]


def kernel_vs_plain(pipe, frame_ids, seed, dev):
    """Run the kernel and the plain version on the same inputs; returns
    (max_abs_err, planes, bases, tables)."""
    from versatilefilmgrain_tpu_torch.ops.grain_natural import (
        add_grain_batch_natural, add_grain_batch_plain, natural_tables)
    regs = pipe.regs
    tables = natural_tables(regs, dev)
    planes = random_batch(pipe, len(frame_ids), seed, dev)
    bases = [pipe.frame_bases(f)[0] for f in frame_ids]
    geo = dict(bs=regs.bs, csubx=regs.csubx, csuby=regs.csuby)
    k = add_grain_batch_natural(*planes, bases, None, tables,
                                height=pipe.height, width=pipe.width, **geo)
    p = add_grain_batch_plain(*planes, bases, tables, **geo)
    torch.cuda.synchronize()
    err = max(int((a.int() - b.int()).abs().max()) for a, b in zip(k, p))
    for c, (a, b) in enumerate(zip(k, p)):
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"plane {c}: {a.dtype}{tuple(a.shape)} vs "
              f"{b.dtype}{tuple(b.shape)}")
    return err, planes, bases, tables


def tiled_vs_plain(pipe, frame_ids, seed, dev):
    """Run the tiled engine, its plain strip function (on the same device)
    and the natural kernel on the same inputs; returns (max |err| against
    the plain version, max |err| against the natural kernel, planes,
    (bases, bases_up), tables)."""
    from versatilefilmgrain_tpu_torch.ops import grain_natural, grain_pallas
    regs = pipe.regs
    tables = grain_pallas.pallas_tables(regs, dev)
    planes = random_batch(pipe, len(frame_ids), seed, dev)
    bases, bases_up = (list(b) for b in
                       zip(*(pipe.frame_bases(f) for f in frame_ids)))
    geo = dict(bs=regs.bs, csubx=regs.csubx, csuby=regs.csuby)
    R, C = -(-pipe.height // 16), -(-pipe.width // 16)
    k = grain_pallas.add_grain_batch_pallas(
        *planes, bases, bases_up, tables, height=pipe.height,
        width=pipe.width, **geo)
    p = grain_pallas._tiled_batch(*planes, bases, bases_up, tables, R=R, C=C,
                                  strip_fn=grain_pallas.plane_tiled_plain,
                                  **geo)
    n = grain_natural.add_grain_batch_natural(
        *planes, bases, bases_up, grain_natural.natural_tables(regs, dev),
        height=pipe.height, width=pipe.width, **geo)
    torch.cuda.synchronize()
    for c, (a, b) in enumerate(zip(k, p)):
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"tiled plane {c}: {a.dtype}{tuple(a.shape)} vs "
              f"{b.dtype}{tuple(b.shape)}")
    err_p = max(int((a.int() - b.int()).abs().max()) for a, b in zip(k, p))
    err_n = max(int((a.int() - b.int()).abs().max()) for a, b in zip(k, n))
    return err_p, err_n, planes, (bases, bases_up), tables


def run_golden(cli, golden, golden_cli_args, make_input_yuv, engine):
    """Every golden CLI case through the port's CLI with ``engine``; checks
    each output's size and sha256."""
    for name in sorted(golden):
        entry = golden[name]
        case = entry["case"]
        inp = os.path.join(SCRATCH, "in_%dx%d_%db_%d_%df.yuv" % (
            case["w"], case["h"], case["depth"], case["fmt"],
            case["in_frames"]))
        if not os.path.exists(inp):
            make_input_yuv(inp, case["w"], case["h"], case["depth"],
                           case["fmt"], case["in_frames"])
        out = os.path.join(SCRATCH, "out.yuv")
        rc = cli.main(["vfgs-torch", "--engine", engine]
                      + golden_cli_args(case, inp, out))
        check(rc == 0, f"golden {name} ({engine}): CLI exit {rc}")
        data = open(out, "rb").read()
        check(len(data) == entry["bytes"]
              and hashlib.sha256(data).hexdigest() == entry["sha256"],
              f"golden {name} ({engine}): output differs from the reference")


def luma_only_sei():
    """Luma-only FGC SEI (the 4:2:2/4:4:4 format goldens' config)."""
    from versatilefilmgrain_tpu_torch.models import config as cfgmod
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's kernels run only on the card",
              file=sys.stderr)
        return 2

    sys.path.insert(0, os.path.join(REPO, "tools"))
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from gen_input import make_input_yuv
    from torch_port_cases import golden_cli_args
    from versatilefilmgrain_tpu_torch import GrainPipeline, cli
    from versatilefilmgrain_tpu_torch.ops import (_kernels, grain_natural,
                                                  grain_pallas, lfsr)
    from versatilefilmgrain_tpu_torch.ops.grain_ref import plane_grain
    from versatilefilmgrain_tpu_torch.utils import yuv

    dev = torch.device(DEVICE)
    counter = grain_natural.grain_plane_cuda
    tcounter = grain_pallas.plane_tiled_cuda

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    phase("device", f"{kind}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}")
    print(smi, flush=True)

    # 2. build: one nvcc per source, started together
    t0 = time.perf_counter()
    sources = ("grain_natural", "grain_tiled", "expand_words",
               "probe_budget", "probe_pipe", "probe_dot", "probe_relayout")
    _kernels.build(sources)
    for name in sources:
        _kernels.load(name)
    phase("build", f"{', '.join(s + '.cu' for s in sources)} built and "
          f"loaded in {time.perf_counter() - t0:.1f} s")
    for name in sources:
        log = _kernels.build_logs.get(name, "(library was up to date)")
        for line in log.strip().splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"   {name}: {line.strip()}", flush=True)

    # 3. kernel vs plain at the main path's shape
    W, H, F = FULL
    pipe = GrainPipeline(W, H, 10, yuv.YUV_420, device=dev)
    frame_ids = [0, 1, 2, 3, 4, 5, 6, 97]
    err4k, planes, bases, tables = kernel_vs_plain(pipe, frame_ids, 5, dev)
    check(err4k == 0,
          f"4K kernel differs from plain version (max |err| {err4k})")
    regs = pipe.regs
    geo = dict(bs=regs.bs, csubx=regs.csubx, csuby=regs.csuby)
    lat = grain_natural._lattice(bases, planes[0])
    lat32 = grain_natural._as_int32_words(lat)
    lat_up = torch.cat([lat[:, :1], lat[:, :-1]], dim=1)
    sc = tables["scalars"]

    def run_kernel():
        for c, p in enumerate(planes):
            grain_natural.grain_plane_cuda(p, lat32, tables, c=c, **geo)

    def run_plain():
        for c, p in enumerate(planes):
            lo, hi = (sc[1], sc[2]) if c == 0 else (sc[3], sc[4])
            plane_grain(p, lat, lat_up, tables["pattern"][1 if c else 0],
                        tables["slut"][c], tables["plut"][c], sc[0], lo, hi,
                        c=c, **geo)

    ms_k = cuda_ms(run_kernel, 20)
    ms_p = cuda_ms(run_plain, 5, warmup=1)
    ms_k2 = cuda_ms(run_kernel, 20)
    ms_p2 = cuda_ms(run_plain, 5, warmup=1)
    ms_lat = cuda_ms(lambda: grain_natural._lattice(bases, planes[0]), 20)
    nbytes = 2 * sum(p.numel() * p.element_size() for p in planes)
    phase("kernel", f"{W}x{H} 10-bit 4:2:0 default config, batch {F}, "
          f"frames {frame_ids}: kernel == plain on Y, U, V "
          f"(max |err| {err4k})")
    phase("kernel", f"time per batch step (3 plane launches, CUDA events, "
          f"warmed up; runs kernel, plain, kernel, plain): kernel "
          f"{ms_k:.4f} / {ms_k2:.4f} ms, plain {ms_p:.3f} / {ms_p2:.3f} ms, "
          f"lattice prep {ms_lat:.4f} ms; {nbytes / 1e6:.1f} MB moved = "
          f"{nbytes / (min(ms_k, ms_k2) * 1e-3) / 1e12:.3f} TB/s; "
          f"card {card}")
    kernel_ms, plain_ms = min(ms_k, ms_k2), min(ms_p, ms_p2)
    tbytes = tensor_bytes(*(tables[k] for k in ("pattern", "slut", "plut",
                                                "scalars")))
    k1_bound = byte_bound_ms(nbytes + lat32.numel() * 4 + tbytes)
    del planes, lat, lat32, lat_up

    # 4. other geometries (kernel vs plain, frames 0, 1, 3)
    cases = [
        ("sei_ar_test1 10b 420", 256, 192, 10, yuv.YUV_420,
         dict(configs=[os.path.join(CFG_DIR, "fgs_sei_ar_test1.cfg")])),
        ("afgs1_test1 10b 420", 256, 192, 10, yuv.YUV_420,
         dict(configs=[os.path.join(CFG_DIR, "fgs_afgs1_test1.cfg")])),
        ("default 8b 420", 256, 192, 8, yuv.YUV_420, {}),
        ("luma-only 10b 422", 256, 192, 10, yuv.YUV_422,
         dict(initial_sei=luma_only_sei())),
        ("luma-only 8b 444", 256, 192, 8, yuv.YUV_444,
         dict(initial_sei=luma_only_sei())),
        ("default 10b 420 pad-leak 257x192", 257, 192, 10, yuv.YUV_420, {}),
        ("default 8b 420 pad-leak 145x128", 145, 128, 8, yuv.YUV_420, {}),
        ("default 10b 420 unaligned 250x140", 250, 140, 10, yuv.YUV_420, {}),
    ]
    for i, (name, w, h, depth, fmt, kw) in enumerate(cases):
        p = GrainPipeline(w, h, depth, fmt, device=dev, **kw)
        p.maybe_switch_config(0)
        err, *_ = kernel_vs_plain(p, [0, 1, 3], 100 + i, dev)
        check(err == 0, f"{name}: kernel differs from plain (max |err| {err})")
        phase("geometry", f"{name}: kernel == plain (max |err| 0)")

    # 5. golden CLI cases through the port's CLI on the card
    golden = json.load(open(os.path.join(REPO, "tests", "golden",
                                         "checksums.json")))
    shutil.rmtree(SCRATCH, ignore_errors=True)
    os.makedirs(SCRATCH)
    counter.launches = 0
    t0 = time.perf_counter()
    run_golden(cli, golden, golden_cli_args, make_input_yuv, "auto")
    golden_launches = counter.launches
    check(golden_launches > 0, "golden cases never launched the kernel")
    phase("golden", f"{len(golden)}/{len(golden)} sha256 match through "
          f"the port's CLI (--engine auto); {golden_launches} kernel launches;"
          f" {time.perf_counter() - t0:.1f} s")

    # 6. the main path: the CLI on an 8-frame 4K 10-bit 4:2:0 file
    inp = os.path.join(SCRATCH, "in_4k.yuv")
    out = os.path.join(SCRATCH, "out_4k.yuv")
    make_input_yuv(inp, W, H, 10, yuv.YUV_420, F, seed=77)
    counter.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["vfgs-torch", "-w", str(W), "-h", str(H), "-b", "10",
                   "-f", "420", "-n", str(F), "--batch", str(F), "-v",
                   inp, out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counter.launches
    check(rc == 0, f"4K CLI run exit {rc}")
    check(launches > 0, "4K CLI run never launched the kernel")
    fbytes = yuv.frame_bytes(W, H, 10, yuv.YUV_420)
    check(os.path.getsize(out) == F * fbytes,
          f"4K output is {os.path.getsize(out)} bytes, not {F * fbytes}")
    ref = GrainPipeline(W, H, 10, yuv.YUV_420, device=dev, engine="ref")
    with open(inp, "rb") as fsrc:
        first_in = yuv.read_frame(fsrc, W, H, 10, yuv.YUV_420)
    expect = ref.process_frame(first_in, 0)
    with open(out, "rb") as fdst:
        first_out = yuv.read_frame(fdst, W, H, 10, yuv.YUV_420)
    for c, (a, b) in enumerate(zip(expect, first_out)):
        check(np.array_equal(a, b), f"4K CLI frame 0 plane {c} differs "
              f"from the plain version")
    phase("cli 4K", f"{F} frames {W}x{H} 10-bit 4:2:0 --batch {F}: "
          f"{launches} kernel launches, {F * fbytes} bytes out, frame 0 == "
          f"plain version; wall {wall:.3f} s with file I/O (card {card})")

    # 7. the tiled engine at the main path's shape
    tpipe = GrainPipeline(W, H, 10, yuv.YUV_420, device=dev, engine="pallas")
    terr, terr_n, planes, (bases, bases_up), ttables = tiled_vs_plain(
        tpipe, frame_ids, 5, dev)
    check(terr == 0, f"4K tiled kernel differs from its plain version "
          f"(max |err| {terr})")
    check(terr_n == 0, f"4K tiled kernel differs from the natural kernel "
          f"(max |err| {terr_n})")
    R4, C4 = -(-H // 16), -(-W // 16)
    lat = grain_natural._lattice(bases, planes[0])
    lat_up = torch.cat([lfsr.state_lattice_torch(bases_up, 1, C4, dev),
                        lat[:, :-1]], dim=1)
    tregs = tpipe.regs
    tgeo = dict(bs=tregs.bs, csubx=tregs.csubx, csuby=tregs.csuby)
    # pre-tiled kernel arguments, one per plane
    strips = [grain_pallas._strip_args(p, c, lat, lat_up, ttables, R=R4,
                                       C=C4, **tgeo)
              for c, p in enumerate(planes)]

    def run_tiled_kernel():
        for args, kw in strips:
            grain_pallas.plane_tiled_cuda(*args, **kw)

    def run_tiled_step():
        grain_pallas.add_grain_batch_pallas(
            *planes, bases, bases_up, ttables, height=H, width=W, **tgeo)

    def run_tiled_plain():
        for args, kw in strips:
            grain_pallas.plane_tiled_plain(*args, **kw)

    def run_natural_step():
        grain_natural.add_grain_batch_natural(
            *planes, bases, bases_up, tables, height=H, width=W, **tgeo)

    ms_tk = cuda_ms(run_tiled_kernel, 20)
    ms_tp = cuda_ms(run_tiled_plain, 5, warmup=1)
    ms_ts = cuda_ms(run_tiled_step, 20)
    ms_ns = cuda_ms(run_natural_step, 20)
    ms_tk2 = cuda_ms(run_tiled_kernel, 20)
    ms_tp2 = cuda_ms(run_tiled_plain, 5, warmup=1)
    ms_ts2 = cuda_ms(run_tiled_step, 20)
    ms_ns2 = cuda_ms(run_natural_step, 20)
    phase("tiled 4K", f"{W}x{H} 10-bit 4:2:0 default config, batch {F}, "
          f"frames {frame_ids}: tiled kernel == its plain version (max |err| "
          f"{terr}) == natural kernel (max |err| {terr_n}) on Y, U, V")
    phase("tiled 4K", f"time per batch step (CUDA events, warmed up; runs "
          f"kernel, plain, tiled step, natural step, and again): kernel "
          f"alone (3 launches on pre-tiled strips) {ms_tk:.4f} / "
          f"{ms_tk2:.4f} ms, plain strip function on the same strips "
          f"{ms_tp:.3f} / {ms_tp2:.3f} ms, whole tiled step (lattices, "
          f"offsets, tile, kernel, untile) {ms_ts:.4f} / {ms_ts2:.4f} ms, "
          f"natural step (lattice, K1) {ms_ns:.4f} / {ms_ns2:.4f} ms; "
          f"{nbytes / 1e6:.1f} MB moved by the kernel = "
          f"{nbytes / (min(ms_tk, ms_tk2) * 1e-3) / 1e12:.3f} TB/s; "
          f"card {card}")
    tiled_ms, tiled_plain_ms = min(ms_tk, ms_tk2), min(ms_tp, ms_tp2)
    k3_bound = byte_bound_ms(sum(2 * tensor_bytes(args[0])
                                 + tensor_bytes(*args[1:])
                                 for args, _ in strips))
    del planes, lat, lat_up, strips

    # 8. tiled engine, other geometries (frames 0, 1, 3)
    for i, (name, w, h, depth, fmt, kw) in enumerate(cases):
        p = GrainPipeline(w, h, depth, fmt, device=dev, engine="pallas", **kw)
        p.maybe_switch_config(0)
        err, err_n, *_ = tiled_vs_plain(p, [0, 1, 3], 200 + i, dev)
        check(err == 0 and err_n == 0,
              f"{name}: tiled kernel differs from plain (max |err| {err}) "
              f"or natural kernel (max |err| {err_n})")
        phase("tiled geometry", f"{name}: tiled kernel == plain == natural "
              f"kernel (max |err| 0)")

    # 9. golden CLI cases through the tiled engine
    tcounter.launches = 0
    t0 = time.perf_counter()
    run_golden(cli, golden, golden_cli_args, make_input_yuv, "pallas")
    tgolden_launches = tcounter.launches
    check(tgolden_launches > 0, "golden cases never launched the tiled kernel")
    phase("tiled golden", f"{len(golden)}/{len(golden)} sha256 match through "
          f"the port's CLI (--engine pallas); {tgolden_launches} tiled kernel "
          f"launches; {time.perf_counter() - t0:.1f} s")

    # 10. the tiled engine's path: the CLI on phase 6's file
    tout = os.path.join(SCRATCH, "out_4k_pallas.yuv")
    counter.launches = 0
    tcounter.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["vfgs-torch", "-w", str(W), "-h", str(H), "-b", "10",
                   "-f", "420", "-n", str(F), "--batch", str(F), "-v",
                   "--engine", "pallas", inp, tout])
    torch.cuda.synchronize()
    twall = time.perf_counter() - t0
    tlaunches, nlaunches = tcounter.launches, counter.launches
    check(rc == 0, f"4K CLI run --engine pallas exit {rc}")
    check(tlaunches > 0, "4K CLI run --engine pallas never launched the "
          "tiled kernel")
    check(nlaunches == 0, "4K CLI run --engine pallas launched the natural "
          "kernel")
    with open(out, "rb") as fa, open(tout, "rb") as fb:
        check(fa.read() == fb.read(), "4K CLI output --engine pallas differs "
              "from --engine auto")
    phase("tiled cli 4K", f"{F} frames {W}x{H} 10-bit 4:2:0 --batch {F} "
          f"--engine pallas: {tlaunches} tiled kernel launches, output "
          f"byte-identical to --engine auto ({F * fbytes} bytes); wall "
          f"{twall:.3f} s with file I/O (card {card})")
    shutil.rmtree(SCRATCH, ignore_errors=True)

    # 11. K2 at the main path's shape
    from versatilefilmgrain_tpu_torch.parallel import mesh as pmesh
    kcounter = grain_natural.expand_words_cuda
    planes = random_batch(pipe, F, 5, dev)
    bases, bases_up = (list(b) for b in
                       zip(*(pipe.frame_bases(f) for f in frame_ids)))
    lat = grain_natural._lattice(bases, planes[0])
    blk = [grain_natural._block_words(lat, c, regs.csubx, regs.csuby)
           for c in range(3)]
    wblks, bws = [b for b, _ in blk], [bw for _, bw in blk]
    lanes_k = grain_natural.expand_words_cuda(wblks, bws)
    lanes_p = grain_natural.expand_words_plain(wblks, bws)
    torch.cuda.synchronize()
    err_k2 = max(int((a - b).abs().max()) for a, b in zip(lanes_k, lanes_p))
    check(all(a.shape == b.shape for a, b in zip(lanes_k, lanes_p))
          and err_k2 == 0, f"4K K2 differs from its plain version (max "
          f"|err| {err_k2})")
    ms_w = [cuda_ms(lambda: grain_natural.expand_words_cuda(wblks, bws), 50),
            cuda_ms(lambda: grain_natural.expand_words_plain(wblks, bws), 20),
            cuda_ms(lambda: grain_natural.expand_words_cuda(wblks, bws), 50),
            cuda_ms(lambda: grain_natural.expand_words_plain(wblks, bws), 20)]
    wbytes = sum(w.numel() * 4 for w in lanes_k + wblks)
    k2_ms, k2_plain_ms = min(ms_w[0], ms_w[2]), min(ms_w[1], ms_w[3])
    phase("words 4K", f"{W}x{H} 4:2:0 batch {F}: K2 == plain expansion on "
          f"Y, U, V lane words {[tuple(w.shape) for w in lanes_k]} (max "
          f"|err| {err_k2}); per step (CUDA events; runs K2, plain, K2, "
          f"plain): K2 {ms_w[0]:.4f} / {ms_w[2]:.4f} ms, plain "
          f"{ms_w[1]:.4f} / {ms_w[3]:.4f} ms; {wbytes / 1e6:.1f} MB moved = "
          f"{wbytes / (k2_ms * 1e-3) / 1e12:.3f} TB/s; card {card}")

    # 12. the lane-word input of K1 at the main path's shape
    want = grain_natural.add_grain_batch_plain(*planes, bases, tables, **geo)
    outs = {}
    for mode in (None, "xla", "pallas"):
        counter.launches = kcounter.launches = 0
        outs[mode] = grain_natural.add_grain_batch_natural(
            *planes, bases, bases_up, tables, height=H, width=W,
            word_expand=mode, **geo)
        torch.cuda.synchronize()
        check((counter.launches, kcounter.launches)
              == (3, int(mode == "pallas")),
              f"word_expand={mode}: {counter.launches} K1 and "
              f"{kcounter.launches} K2 launches, not 3 and "
              f"{int(mode == 'pallas')}")
        err = max(int((a.int() - b.int()).abs().max())
                  for a, b in zip(outs[mode], want))
        check(err == 0, f"4K word_expand={mode} differs from the plain "
              f"version (max |err| {err})")
    stream_launches = (counter.launches, kcounter.launches)
    lat32 = grain_natural._as_int32_words(lat)

    def step(mode):
        return lambda: grain_natural.add_grain_batch_natural(
            *planes, bases, bases_up, tables, height=H, width=W,
            word_expand=mode, **geo)

    def k1(words):
        return lambda: [grain_natural.grain_plane_cuda(p, w, tables, c=c,
                                                       **geo)
                        for c, (p, w) in enumerate(zip(planes, words))]

    order = [("lattice step", step(None)), ("xla step", step("xla")),
             ("pallas step", step("pallas")),
             ("K1 lattice", k1([lat32] * 3)), ("K1 lanes", k1(lanes_k))]
    times = {name: [] for name, _ in order}
    for seq in (order, order[::-1]):
        for name, fn in seq:
            times[name].append(cuda_ms(fn, 20))
    phase("stream 4K", f"word_expand None (lattice), xla, pallas == plain "
          f"version on Y, U, V (max |err| 0); a pallas step launched K2 "
          f"{stream_launches[1]}x and K1 {stream_launches[0]}x")
    phase("stream 4K", "per step (CUDA events, warmed up; each in turn, then "
          "in reverse): " + "; ".join(
              f"{n} {a:.4f} / {b:.4f} ms" for n, (a, b) in times.items())
          + f"; card {card}")
    del lanes_k, lanes_p, wblks, blk

    # 13. the sharded step on the one card
    nat = outs[None]
    shard_counts = {}
    for shape in ((1, 1), (1, 5), (2, 3)):
        n = shape[0] * shape[1]
        mesh = pmesh.make_mesh(*shape, [dev] * n)
        for mode in ("kernel", "xla", "pallas"):
            run = pmesh.make_grain_step(mesh, height=H, width=W,
                                        engine="natural", tables=tables,
                                        word_expand=mode, **geo)
            counter.launches = counter.boot_launches = kcounter.launches = 0
            got = run(*planes, bases, bases_up)
            torch.cuda.synchronize()
            counts = (counter.launches, counter.boot_launches,
                      kcounter.launches)
            shard_counts[shape, mode] = counts
            expect = (3 * n, 3 * shape[0] * (shape[1] - 1),
                      n if mode == "pallas" else 0)
            check(counts == expect, f"mesh {shape} {mode}: launches (K1, "
                  f"K1 boot, K2) {counts}, expected {expect}")
            for c, (a, b) in enumerate(zip(got, nat)):
                check(torch.equal(a, b), f"mesh {shape} {mode} plane {c} "
                      f"differs from the unsharded K1 output")
    run = pmesh.make_grain_step(pmesh.make_mesh(2, 3, [dev] * 6), height=H,
                                width=W, engine="natural", tables=tables,
                                word_expand="pallas", **geo)
    ms_sh = cuda_ms(lambda: run(*planes, bases, bases_up), 10)
    mesh_k2_launches = shard_counts[(2, 3), "pallas"][2]
    phase("shard 4K", f"meshes (1, 1), (1, 5), (2, 3) x word_expand kernel, "
          f"xla, pallas == unsharded K1 on Y, U, V; launches (K1, K1 boot, "
          f"K2): " + ", ".join(f"{s} {m} {c}" for (s, m), c in
                                shard_counts.items())
          + f"; (2, 3) pallas step {ms_sh:.4f} ms; card {card}")
    del planes, lat, lat32, want, outs, nat, got

    # 14. sharded step, the dryrun_multichip sweep at a small size
    from torch_port_cases import afgs1_cfg, frame_bases
    from versatilefilmgrain_tpu_torch.models import config as cfgmod
    from versatilefilmgrain_tpu_torch.models import fw
    from versatilefilmgrain_tpu_torch.models.hw import HwRegs
    sh, sw, nf = 128, 256, 8
    srows, scols = sh // 16, sw // 16
    combos = [("sei_ff", (2, 2), 10), ("sei_ff", (1, 1), 10),
              ("afgs1", (2, 2), 10), ("afgs1", (1, 1), 10),
              ("sei_ff", (2, 1), 10), ("sei_ff", (2, 2), 8)]
    ncase = 0
    for family, csub, depth in combos:
        sregs = HwRegs()
        sregs.set_depth(depth)
        sregs.set_chroma_subsampling(*csub)
        if family == "sei_ff":
            sei = cfgmod.default_sei()
            if csub == (1, 1):
                sei.comp_model_present_flag = [1, 0, 0]
            fw.init_sei(sei, sregs)
        else:
            a = afgs1_cfg("versatilefilmgrain_tpu_torch")
            if csub != (2, 2):
                a.num_cb_points = a.num_cr_points = 0
            fw.init_afgs1(a, sregs)
        stables = grain_natural.natural_tables(sregs, dev)
        sgeo = dict(bs=depth - 8, csubx=csub[0], csuby=csub[1])
        rng = np.random.default_rng(ncase)
        dt = np.uint8 if depth == 8 else np.uint16
        splanes = [torch.from_numpy(rng.integers(0, 1 << depth, (nf, h, w))
                                    .astype(dt)).to(dev)
                   for h, w in ((sh, sw), (sh // csub[1], sw // csub[0]),
                                (sh // csub[1], sw // csub[0]))]
        for off in (0, 3):
            sb, sbu = frame_bases("versatilefilmgrain_tpu_torch",
                                  sregs.seed_state, srows, scols,
                                  range(off, off + nf))
            swant = grain_natural.add_grain_batch_plain(*splanes, sb,
                                                        stables, **sgeo)
            sk1 = grain_natural.add_grain_batch_natural(
                *splanes, sb, sbu, stables, height=sh, width=sw, **sgeo)
            for shape in ((2, 4), (1, 8)):
                mesh = pmesh.make_mesh(*shape, [dev] * 8)
                for mode in ("kernel", "xla", "pallas"):
                    got = pmesh.make_grain_step(
                        mesh, height=sh, width=sw, engine="natural",
                        tables=stables, word_expand=mode, **sgeo)(
                            *splanes, sb, sbu)
                    torch.cuda.synchronize()
                    for c in range(3):
                        check(torch.equal(got[c], sk1[c])
                              and torch.equal(got[c], swant[c]),
                              f"{family} {csub} {depth}-bit offset {off} "
                              f"mesh {shape} {mode} plane {c}: sharded "
                              f"differs from unsharded")
                    ncase += 1
        phase("shard geometry", f"{family} csub {csub} {depth}-bit, offsets "
              f"0 and 3, meshes (2, 4) and (1, 8), word_expand kernel, xla, "
              f"pallas: sharded == unsharded K1 == plain (max |err| 0)")
    phase("shard geometry", f"{ncase} cases passed")

    # 15. the per-stage budget kernel (K5)
    from versatilefilmgrain_tpu_torch.tools import _harness as hz
    from versatilefilmgrain_tpu_torch.tools import probe_budget, probe_ohpipe
    bcounter = probe_budget.grain_plane_budget_cuda
    pcounter = probe_ohpipe.grain_plane_pipe_cuda
    budget_cases = [(f"default {W}x{H}", pipe, frame_ids)] + [
        (name, GrainPipeline(w, h, depth, fmt, device=dev, **kw), [0, 1, 3])
        for name, w, h, depth, fmt, kw in cases[:2]]
    err_k5 = 0
    for name, bpipe, fids in budget_cases:
        bpipe.maybe_switch_config(0)
        btables = grain_natural.natural_tables(bpipe.regs, dev)
        bplanes = random_batch(bpipe, len(fids), 300, dev)
        blat = grain_natural._lattice([bpipe.frame_bases(f)[0] for f in fids],
                                      bplanes[0])
        bwords = grain_natural._as_int32_words(blat)
        for vname, skip in probe_budget.VARIANTS.items():
            got = probe_budget.make_step(btables, skip=skip)(*bplanes, blat,
                                                            bwords)
            want = probe_budget.budget_batch_plain(*bplanes, blat, btables,
                                                   skip=skip)
            torch.cuda.synchronize()
            err = max(int((a.int() - b.int()).abs().max())
                      for a, b in zip(got, want))
            check(err == 0, f"budget {name} {vname}: kernel differs from its "
                  f"plain version (max |err| {err})")
            err_k5 = max(err_k5, err)
        phase("budget", f"{name}: {len(probe_budget.VARIANTS)} variants "
              f"({', '.join(probe_budget.VARIANTS)}) == plain (max |err| 0)")
        del bplanes, blat, bwords
    state0 = hz.random_state(F, 0, H, W, device=dev)
    slat = grain_natural._lattice(
        hz.frame_bases(hz.default_regs(), F, H // 16, W // 16)[0], state0[0])
    swords = grain_natural._as_int32_words(slat)
    dtables = grain_natural.natural_tables(hz.default_regs(), dev)
    k5_ms = hz.chain_ms(probe_budget.make_step(dtables), state0,
                        (slat, swords))
    k5_plain_ms = cuda_ms(lambda: probe_budget.budget_batch_plain(
        *state0, slat, dtables), 5, warmup=1)
    # K5's full variant and K4 move what K1 moves on the same state
    k45_bound = byte_bound_ms(2 * tensor_bytes(*state0) + tensor_bytes(
        swords, *(dtables[k] for k in ("pattern", "slut", "plut",
                                       "scalars"))))
    phase("budget", f"card {card}; full variant {k5_ms:.4f} ms, its plain "
          f"version {k5_plain_ms:.3f} ms per {W}x{H} step of {F} frames")
    bcounter.launches = 0
    budgets = {kind: probe_budget.run_config(kind, state0, F)
               for kind in ("default", "sei_ar", "afgs1")}
    k5_launches = bcounter.launches
    check(k5_launches > 0, "the budget run never launched the K5 kernel")
    phase("budget", f"budget of 3 configs on card {card}: {k5_launches} K5 "
          f"launches; full " + ", ".join(
              f"{k} {b['full']:.4f} ms" for k, b in budgets.items()))

    # 16. the prefetch probe kernel (K4)
    pipe_cases = [(f"default {W}x{H}", W, H, pipe, frame_ids)] + [
        (name, w, h, GrainPipeline(w, h, depth, fmt, device=dev, **kw),
         [0, 1, 3])
        for name, w, h, depth, fmt, kw in cases if depth == 10]
    err_k4 = 0
    for name, w, h, ppipe, fids in pipe_cases:
        ppipe.maybe_switch_config(0)
        pregs = ppipe.regs
        ptables = grain_natural.natural_tables(pregs, dev)
        pplanes = random_batch(ppipe, len(fids), 400, dev)
        pb, pbu = (list(b) for b in zip(*(ppipe.frame_bases(f)
                                          for f in fids)))
        pgeo = dict(bs=pregs.bs, csubx=pregs.csubx, csuby=pregs.csuby)
        got = probe_ohpipe.make_pipe_step(ptables, height=h, width=w,
                                          **pgeo)(*pplanes, pb, pbu)
        k1o = grain_natural.add_grain_batch_natural(
            *pplanes, pb, pbu, ptables, height=h, width=w, **pgeo)
        want = grain_natural.add_grain_batch_plain(*pplanes, pb, ptables,
                                                   **pgeo)
        torch.cuda.synchronize()
        err = max(max(int((a.int() - b.int()).abs().max()),
                      int((a.int() - c.int()).abs().max()))
                  for a, b, c in zip(got, k1o, want))
        check(err == 0, f"pipe {name}: K4 differs from K1 or the plain "
              f"version (max |err| {err})")
        err_k4 = max(err_k4, err)
        phase("pipe", f"{name}: K4 == K1 == plain on Y, U, V (max |err| 0)")
        del pplanes, got, k1o, want

    def run_k1():
        for c, p in enumerate(state0):
            grain_natural.grain_plane_cuda(p, swords, dtables, c=c, **geo)

    def run_k4():
        for c, p in enumerate(state0):
            probe_ohpipe.grain_plane_pipe_cuda(p, swords, dtables, c=c, **geo)

    t4 = [cuda_ms(fn, 20) for fn in (run_k1, run_k4, run_k4, run_k1)]
    # the plain version of the kernels alone, on the same lattice
    k4_plain_ms = cuda_ms(lambda: grain_natural._grain_planes_plain(
        state0, [slat] * 3, [grain_natural._rows_above(slat)] * 3, dtables,
        **geo), 5, warmup=1)
    phase("pipe", f"per {W}x{H} step of {F} frames, kernels alone (CUDA "
          f"events; runs K1, K4, K4, K1): K1 {t4[0]:.4f} / {t4[3]:.4f} ms, "
          f"K4 {t4[1]:.4f} / {t4[2]:.4f} ms ({probe_ohpipe.BLOCKS_PER_SM} "
          f"blocks per SM at most); plain {k4_plain_ms:.3f} ms; card {card}")
    pcounter.launches = 0
    pipes = {kind: probe_ohpipe.run_config(kind, state0, F)
             for kind in ("default", "sei_ar", "afgs1")}
    k4_launches = pcounter.launches
    check(k4_launches > 0, "the pipe run never launched the K4 kernel")
    check(all(exact for _, exact in pipes.values()),
          "the pipe run found K4 and K1 diverging")
    phase("pipe", f"probe run of 3 configs: {k4_launches} K4 launches, "
          f"bit-exact; card {card}")
    del state0, slat, swords

    # 17. the one-hot dot probe (K6) and its gather mode
    from versatilefilmgrain_tpu_torch.tools import (_dot, probe_dot,
                                                    probe_dot2,
                                                    probe_dotscale)
    dcounter = _dot.dot_probe_cuda
    ys, ts, ps, cs = _dot.dot2_inputs(21, 2, 32, 160, device=dev)
    exact_small("dot 160x32", {m: (_dot.make_step(m, ts, ps),
                                   _dot.plain(m, ys, ts, ps))
                               for m in probe_dot.MODES}, ys)
    phase("dot", f"2 frames of 160x32: {', '.join(probe_dot.MODES)} == "
          f"plain (max |err| 0)")
    y, t, pat = _dot.dot_inputs(0, device=dev)
    dcounter.launches = 0
    k6 = probe_dot.run(y, t, pat)
    k6_launches = dcounter.launches
    check(k6_launches > 0, "the K6 run never launched the dot kernel")
    check(all(r["exact"] for n, r in k6.items() if n != "equal")
          and all(k6["equal"].values()), f"the K6 run at {W}x{H} found a "
          f"mode differing from its plain version, or from int8")
    k6_want = _dot.onehot_plain(y, t, pat)
    k6_err = max_err(_dot.make_step("int8", t, pat)(y)[0], k6_want)
    plain6 = {"onehot": cuda_ms(lambda: _dot.onehot_plain(y, t, pat), 3,
                                warmup=1),
              "none": cuda_ms(lambda: _dot.none_plain(y), 10)}
    # library yardsticks, timed only: the same products in one call each
    oh = torch.zeros(t.numel(), _dot.K, dtype=torch.int8, device=dev)
    oh.scatter_(1, t.reshape(-1, 1).long(), 1)
    lib6 = {"int8": int_mm_ms(oh, pat)}
    ohx = oh.to(torch.bfloat16)
    patx = pat.to(torch.bfloat16).t()
    lib6["bf16"] = cuda_ms(lambda: torch.matmul(ohx, patx), 5, warmup=1)
    del ohx
    ohx = oh.to(torch.float32)
    del oh
    patx = pat.to(torch.float32).t()
    torch.backends.cuda.matmul.allow_tf32 = True
    lib6["f32"] = cuda_ms(lambda: torch.matmul(ohx, patx), 5, warmup=1)
    torch.backends.cuda.matmul.allow_tf32 = False
    del ohx, patx
    tl = t.long()
    lib6["gather"] = cuda_ms(lambda: pat[:, tl], 10)
    del tl
    torch.cuda.empty_cache()
    phase("dot", f"K6 at {W}x{H}, {F} frames: {k6_launches} launches, every "
          f"mode exact, bf16 == int8 == gather; plain {plain6['onehot']:.3f} "
          f"ms (one-hot product), {plain6['none']:.4f} ms (none); library "
          f"(product only): torch._int_mm {lib6['int8']:.4f} ms, bf16 "
          f"matmul {lib6['bf16']:.4f} ms, TF32 matmul (allow_tf32 True) "
          f"{lib6['f32']:.4f} ms, pat[:, t] {lib6['gather']:.4f} ms; card "
          f"{card}")
    del y, t, pat, k6_want

    # 18. build against multiply (K7)
    exact_small("dot2 160x32", {m: (_dot.make_step(m, ts, ps, cs),
                                    _dot.plain(m, ys, ts, ps, cs))
                                for m in probe_dot2.MODES}, ys)
    phase("dot2", f"2 frames of 160x32: {', '.join(probe_dot2.MODES)} == "
          f"plain (max |err| 0)")
    y, t, pat, constoh = _dot.dot2_inputs(0, device=dev)
    dcounter.launches = 0
    k7 = probe_dot2.run(y, t, pat, constoh)
    k7_launches = dcounter.launches
    check(k7_launches > 0, "the K7 run never launched the dot kernel")
    check(all(r["exact"] for r in k7.values()), f"the K7 run at {W}x{H} "
          f"found a mode differing from its plain version")
    k7_err = max_err(_dot.make_step("dotconst", t, pat, constoh)(y)[0],
                     _dot.dotconst_plain(y, pat, constoh))
    plain7 = {m: cuda_ms(lambda m=m: _dot.plain(m, y, t, pat, constoh), 3,
                         warmup=1) for m in ("build", "dotconst")}
    ohr = constoh.t().contiguous().repeat(F * R4, 1)
    lib7 = int_mm_ms(ohr, pat)
    del ohr
    torch.cuda.empty_cache()
    phase("dot2", f"K7 at {W}x{H}, {F} frames: {k7_launches} launches, "
          f"every mode exact; plain build {plain7['build']:.3f} ms, "
          f"dotconst {plain7['dotconst']:.3f} ms; library torch._int_mm "
          f"(dotconst product) {lib7:.4f} ms; card {card}")
    phase("dot2", "build instance, what the compiler kept: "
          + sass_counts(_kernels, "probe_dot", "dot_kernelILi5E"))
    del y, t, pat, constoh

    # 19. the dense product against M (K8)
    yss, ohs, pss = _dot.dotscale_inputs(23, 2, 32, 160, device=dev)
    exact_small("dotscale 160x32", {
        f"M={m}": (_dot.make_step("dotconst", None, p, ohs,
                                  clip_hi=_dot.CLIP_HI_SCALE,
                                  rows=_dot.scale_rows(m)),
                   _dot.dotconst_plain(yss, p, ohs,
                                       clip_hi=_dot.CLIP_HI_SCALE,
                                       rows=_dot.scale_rows(m)))
        for m, p in pss.items()}, yss)
    phase("dotscale", f"2 frames of 160x32: M = "
          f"{', '.join(map(str, pss))} == plain (max |err| 0)")
    y, oh, pats = _dot.dotscale_inputs(0, device=dev)
    dcounter.launches = 0
    k8 = probe_dotscale.run(y, oh, pats)
    k8_launches = dcounter.launches
    check(k8_launches > 0, "the K8 run never launched the dot kernel")
    check(all(r["exact"] for r in k8.values()), f"the K8 run at {W}x{H} "
          f"found an M differing from its plain version")
    kw8 = dict(clip_hi=_dot.CLIP_HI_SCALE, rows=_dot.scale_rows(256))
    k8_err = max_err(_dot.make_step("dotconst", None, pats[256], oh,
                                    **kw8)(y)[0],
                     _dot.dotconst_plain(y, pats[256], oh, **kw8))
    plain8, lib8 = {}, {}
    ohr = oh.t().contiguous().repeat(F * R4, 1)
    for m, p in pats.items():
        kw = dict(clip_hi=_dot.CLIP_HI_SCALE, rows=_dot.scale_rows(m))
        plain8[m] = cuda_ms(lambda: _dot.dotconst_plain(y, p, oh, **kw), 5,
                            warmup=1)
        lib8[m] = int_mm_ms(ohr, p)
    del ohr
    torch.cuda.empty_cache()
    phase("dotscale", f"K8 at {W}x{H}, {F} frames: {k8_launches} launches, "
          f"every M exact; plain / torch._int_mm (product only) ms: "
          + ", ".join(f"M={m} {plain8[m]:.3f} / {lib8[m]:.4f}"
                      for m in pats) + f"; card {card}")
    del y, oh, pats

    # 20. the relayout probes (K9, K10)
    from versatilefilmgrain_tpu_torch.tools import (_relayout, probe_relayout,
                                                    probe_relayout5d)
    rcounter = _relayout.relayout_probe_cuda
    r5counter = _relayout.relayout5d_probe_cuda
    ys = _relayout.relayout_inputs(25, 2, 240, 160, device=dev)
    ys5 = _relayout.view5d(ys)
    xs = _relayout.passthrough_plain(ys)
    small = {case: (_relayout.make_step(mode, rchunk),
                    _relayout.plain(mode, ys, rchunk))
             for case, (mode, rchunk) in probe_relayout.CASES.items()}
    small5 = {form: (_relayout.make_step(form), _relayout.plain(form, ys5))
              for form in _relayout.MODES_5D}
    for case, (_, want) in {**small, **small5}.items():
        check(torch.equal(want.view(xs.shape), xs), f"relayout 240x160 "
              f"{case}: the plain version differs from y ^ 1")
    exact_small("relayout 240x160", small, ys)
    exact_small("relayout5d 240x160", small5, ys5)
    phase("relayout", f"2 frames of 240x160: "
          f"{', '.join([*small, *small5])} == plain == y ^ 1 (max |err| 0)")
    y = _relayout.relayout_inputs(0, device=dev)
    rcounter.launches = 0
    k9 = probe_relayout.run(y)
    k9_launches = rcounter.launches
    r5counter.launches = 0
    k10 = probe_relayout5d.run(y)
    k10_launches = r5counter.launches
    check(k9_launches > 0, "the K9 run never launched the relayout kernel")
    check(k10_launches > 0, "the K10 run never launched the relayout kernel")
    for tag, res in (("K9", k9), ("K10", k10)):
        check(all(r["exact"] for r in res.values()), f"the {tag} run at "
              f"{W}x{H} found a case differing from its plain version")
    y5 = _relayout.view5d(y)
    k9_err = max_err(_relayout.make_step("relayout")(y)[0],
                     _relayout.relayout_plain(y))
    k10_err = max_err(_relayout.make_step("5d_transpose")(y5)[0],
                      _relayout.relayout5d_plain(y5))
    plain9 = cuda_ms(lambda: _relayout.relayout_plain(y), 10)
    plain10 = cuda_ms(lambda: _relayout.relayout5d_plain(y5), 10)
    lib9, lib10 = k9["library"], k10["library"]
    phase("relayout", f"K9 at {W}x{H}, {F} frames: {k9_launches} launches, "
          f"K10 {k10_launches} (K9's passthrough and rchunk-1 instances on "
          f"the 5-D view), every case exact; plain relayout {plain9:.4f} "
          f"ms, 5d_transpose {plain10:.4f} ms; library "
          f"_untile(_tile(y) ^ 1) {lib9['round_trip']:.4f} / "
          f"{lib10['round_trip']:.4f} ms, _tile alone {lib9['tile']:.4f} / "
          f"{lib10['tile']:.4f} ms; card {card}")
    phase("relayout", f"at width {W}, dynamic shared memory bytes per thread "
          f"block / thread blocks per SM: " + ", ".join(
              "{} r{} {} / {}".format(mode, rchunk, *_relayout.occupancy(
                  mode, rchunk, W))
              for mode, rchunk in (("passthrough", 1), ("relayout", 1),
                                   ("relayout", 5), ("relayout", 15))))
    phase("relayout", "relayout instance at rchunk 1, the transpose through "
          "shared memory: " + sass_counts(
              _kernels, "probe_relayout", "relayout_kernelILi1E",
              keys=("LDG", "STS", "LDS", "STG", "BAR", "LOP3")))
    del y, y5, ys, ys5, xs

    def probe_row(name, source, replaces, mode, res, launches, err, plain,
                  library):
        r = res[mode]
        return {"name": name, "route": "cuda",
                "source": f"versatilefilmgrain_tpu_torch/csrc/{source}",
                "replaces": replaces, "mode": mode, "launches": launches,
                "max_abs_err": err, "ms": r["ms"], "plain_ms": plain,
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": library}

    print(json.dumps({"kernels": [{
        "name": "grain_natural", "route": "cuda",
        "source": "versatilefilmgrain_tpu_torch/csrc/grain_natural.cu",
        "replaces": "versatilefilmgrain_tpu/ops/grain_natural.py:584",
        "launches": launches, "max_abs_err": err4k,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": k1_bound,
        "bound_by": "bytes", "library_ms": None}, {
        "name": "grain_tiled", "route": "cuda",
        "source": "versatilefilmgrain_tpu_torch/csrc/grain_tiled.cu",
        "replaces": "versatilefilmgrain_tpu/ops/grain_pallas.py:189",
        "launches": tlaunches, "max_abs_err": max(terr, terr_n),
        "ms": tiled_ms, "plain_ms": tiled_plain_ms, "bound_ms": k3_bound,
        "bound_by": "bytes", "library_ms": None}, {
        "name": "expand_words", "route": "cuda",
        "source": "versatilefilmgrain_tpu_torch/csrc/expand_words.cu",
        "replaces": "versatilefilmgrain_tpu/ops/grain_natural.py:801",
        "launches": mesh_k2_launches, "max_abs_err": err_k2,
        "ms": k2_ms, "plain_ms": k2_plain_ms,
        "bound_ms": byte_bound_ms(wbytes), "bound_by": "bytes",
        # the plain version is _lane_words_xla's one broadcast add a plane
        "library_ms": k2_plain_ms}, {
        "name": "probe_budget", "route": "cuda",
        "source": "versatilefilmgrain_tpu_torch/csrc/probe_budget.cu",
        "replaces": "tools/probe_budget.py:134",
        "launches": k5_launches, "max_abs_err": err_k5,
        "ms": k5_ms, "plain_ms": k5_plain_ms, "bound_ms": k45_bound,
        "bound_by": "bytes", "library_ms": None}, {
        "name": "probe_pipe", "route": "cuda",
        "source": "versatilefilmgrain_tpu_torch/csrc/probe_pipe.cu",
        "replaces": "tools/probe_ohpipe.py:139",
        "launches": k4_launches, "max_abs_err": err_k4,
        "ms": min(t4[1], t4[2]), "plain_ms": k4_plain_ms,
        "bound_ms": k45_bound, "bound_by": "bytes", "library_ms": None},
        probe_row("probe_dot", "probe_dot.cu", "tools/probe_dot.py:38",
                  "int8", k6, k6_launches, k6_err, plain6["onehot"],
                  lib6["int8"]),
        probe_row("probe_dot2", "probe_dot.cu", "tools/probe_dot2.py:38",
                  "dotconst", k7, k7_launches, k7_err, plain7["dotconst"],
                  lib7),
        probe_row("probe_dotscale", "probe_dot.cu",
                  "tools/probe_dotscale.py:22", "M=256", k8, k8_launches,
                  k8_err, plain8[256], lib8[256]),
        probe_row("probe_relayout", "probe_relayout.cu",
                  "tools/probe_relayout.py:41", "relayout", k9, k9_launches,
                  k9_err, plain9, lib9["round_trip"]),
        probe_row("probe_relayout5d", "probe_relayout.cu",
                  "tools/probe_relayout5d.py:40", "5d_transpose", k10,
                  k10_launches, k10_err, plain10, lib10["round_trip"])]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
