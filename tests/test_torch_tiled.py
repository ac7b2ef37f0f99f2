"""The torch port's tiled engine (``--engine pallas``) against the JAX
package's, bit for bit.

Tables, offsets, layout and the strip function of ops/grain_pallas.py are
held against the JAX package's ops/grain_pallas.py (its kernel in interpret
mode); the batched step over the config x depth x chroma grid of
tests/test_pallas_engine.py; ``GrainPipeline(engine="pallas")`` against the
JAX pipeline's tiled engine; and the golden CLI cases through
``--engine pallas``.  On the CPU the port runs the kernel's plain version.
Every comparison is exact.
"""

import hashlib
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from versatilefilmgrain_tpu.ops import grain_pallas as jgp
from versatilefilmgrain_tpu.ops import lfsr as jlfsr
from versatilefilmgrain_tpu.pipeline import GrainPipeline as JaxPipeline
from versatilefilmgrain_tpu_torch import cli
from versatilefilmgrain_tpu_torch.ops import _kernels, grain_natural
from versatilefilmgrain_tpu_torch.ops import grain_pallas
from versatilefilmgrain_tpu_torch.ops import lfsr as tlfsr
from versatilefilmgrain_tpu_torch.pipeline import GrainPipeline
from versatilefilmgrain_tpu_torch.tools import bench_tiled, probe_tiled

from torch_port_cases import (CFG_DIR, DEPTH_CSUB, JAX_PKG, KINDS, REPO,
                              TORCH_PKG, frame_bases, golden_output,
                              random_planes, regs_for)

sys.path.insert(0, os.path.join(REPO, "tools"))

H, W = 144, 256
R, C = H // 16, W // 16
FRAMES = (0, 1, 3)
GOLDEN = json.load(open(os.path.join(REPO, "tests", "golden",
                                     "checksums.json")))


def _chroma_geometry(csub):
    csubx, csuby = csub
    return 16 // csuby, 16 // csubx, 1 if csuby == 2 else 2


def _lattices(seed_state, csub):
    """(bases, bases_up) of FRAMES and both packages' (lat, lat_up)."""
    bases, bases_up = frame_bases(TORCH_PKG, seed_state, R, C, FRAMES)
    jb = jnp.asarray(np.array(bases, np.uint32))
    jbu = jnp.asarray(np.array(bases_up, np.uint32))
    jlat = jax.vmap(lambda b: jlfsr.state_lattice_jax(b, R, C))(jb)
    jrow0 = jax.vmap(lambda b: jlfsr.state_lattice_jax(b, 1, C))(jbu)
    jlat_up = jnp.concatenate([jrow0, jlat[:, :-1]], axis=1)
    tlat = tlfsr.state_lattice_torch(bases, R, C, "cpu")
    tlat_up = torch.cat([tlfsr.state_lattice_torch(bases_up, 1, C, "cpu"),
                         tlat[:, :-1]], dim=1)
    return bases, bases_up, (jlat, jlat_up), (tlat, tlat_up)


# (a) tables -----------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("depth,csub", DEPTH_CSUB)
def test_pallas_tables_match_jax(kind, depth, csub):
    jt = jgp.pallas_tables(regs_for(JAX_PKG, kind, depth, csub))
    tregs = regs_for(TORCH_PKG, kind, depth, csub)
    tt = grain_pallas.pallas_tables(tregs, "cpu")
    bh_c, bw_c, n_ov_c = _chroma_geometry(csub)
    assert (tt["bh_c"], tt["bw_c"], tt["n_ov_c"]) == (bh_c, bw_c, n_ov_c)
    assert (jt["bh_c"], jt["bw_c"], jt["n_ov_c"]) == (bh_c, bw_c, n_ov_c)
    for key, L, rows, bw in (("win_luma", "L_luma", 16, 16),
                             ("win_luma_up", "L_luma_up", 2, 16),
                             ("win_chroma", "L_chroma", bh_c, bw_c),
                             ("win_chroma_up", "L_chroma_up", n_ov_c, bw_c)):
        want = jt[L].reshape(8, rows, bw, 156).transpose(3, 0, 1, 2)
        assert tt[key].dtype == torch.int8, key
        assert np.array_equal(tt[key].numpy(), want), key
    for key in ("seg_starts", "seg_deltas"):
        assert tt[key].dtype == torch.int32, key
        assert np.array_equal(tt[key].numpy(), jt[key]), key
    assert tt["scalars"].tolist() == [jt[k] for k in (
        "scale_shift", "y_min", "y_max", "c_min", "c_max")]


def test_pallas_tables_are_copies_and_checked():
    regs = regs_for(TORCH_PKG, "afgs1", 10, (2, 2))
    tables = grain_pallas.pallas_tables(regs, "cpu")
    before = {k: v.clone() for k, v in tables.items()
              if isinstance(v, torch.Tensor)}
    regs.pattern[:] = 0
    regs.slut[:] = 0
    for k, v in before.items():
        assert torch.equal(tables[k], v), k
    regs.plut[0, 7] = 8 << 4
    with pytest.raises(ValueError, match="pattern index"):
        grain_pallas.pallas_tables(regs, "cpu")


# (b) offsets and layout -----------------------------------------------------

@pytest.mark.parametrize("csub", [(2, 2), (2, 1), (1, 1)])
def test_offset_arrays_match_jax(csub):
    regs = regs_for(TORCH_PKG, "sei_ff", 10, csub)
    _, _, (jlat, jlat_up), (tlat, tlat_up) = _lattices(regs.seed_state, csub)
    assert np.array_equal(tlat.numpy(), np.asarray(jlat).astype(np.int64))
    assert np.array_equal(tlat_up.numpy(),
                          np.asarray(jlat_up).astype(np.int64))
    for c in range(3):
        want = jgp._offset_arrays(jlat, jlat_up, c, *csub)
        got = grain_pallas._offset_arrays(tlat, tlat_up, c, *csub)
        for name, g, w in zip(("widx", "sign", "widxu", "signu"), got, want):
            assert g.dtype == torch.int32 and g.is_contiguous(), (c, name)
            assert tuple(g.shape) == (len(FRAMES), R, 1, C), (c, name)
            assert np.array_equal(g.numpy(), np.asarray(w)), (c, name)


@pytest.mark.parametrize("depth,csub", DEPTH_CSUB)
def test_tile_untile_match_jax(depth, csub):
    bh_c, bw_c, _ = _chroma_geometry(csub)
    planes = random_planes(3, depth, R, C, csub, frames=len(FRAMES))
    for plane, (bh, bw) in zip(planes, ((16, 16), (bh_c, bw_c), (bh_c, bw_c))):
        want = np.asarray(jgp._tile(jnp.asarray(plane), len(FRAMES), R, bh,
                                    C, bw))
        got = grain_pallas._tile(torch.from_numpy(plane), len(FRAMES), R, bh,
                                 C, bw)
        assert got.dtype == torch.from_numpy(plane).dtype
        assert np.array_equal(got.numpy(), want)
        back = grain_pallas._untile(got, len(FRAMES), R, bh, C, bw)
        assert np.array_equal(back.numpy(), plane)


# (c) the strip function against the JAX kernel ------------------------------

def _jax_plane_case(kind, depth, csub, c):
    """One plane of both packages' kernel inputs: the natural plane, the
    JAX package's offset arrays (numpy), the JAX tables' arguments and the
    port's, and the shared keyword geometry and scalars."""
    jregs = regs_for(JAX_PKG, kind, depth, csub)
    tregs = regs_for(TORCH_PKG, kind, depth, csub)
    jt = jgp.pallas_tables(jregs)
    tt = grain_pallas.pallas_tables(tregs, "cpu")
    _, _, (jlat, jlat_up), _ = _lattices(tregs.seed_state, csub)
    bh_c, bw_c, n_ov_c = _chroma_geometry(csub)
    if c == 0:
        bh, bw, n_ov, suby = 16, 16, 2, 1
        L, Lup, win, win_up = ("L_luma", "L_luma_up", "win_luma",
                               "win_luma_up")
        imin, imax = tregs.y_min, tregs.y_max
    else:
        bh, bw, n_ov, suby = bh_c, bw_c, n_ov_c, csub[1]
        L, Lup, win, win_up = ("L_chroma", "L_chroma_up", "win_chroma",
                               "win_chroma_up")
        imin, imax = tregs.c_min, tregs.c_max
    plane = random_planes(13, depth, R, C, csub, frames=len(FRAMES))[c]
    offs = [np.array(a) for a in
            jgp._offset_arrays(jlat, jlat_up, c, *csub)]
    jargs = (jnp.asarray(jt["seg_starts"][c]),
             jnp.asarray(jt["seg_deltas"][c]), jnp.asarray(jt[L]),
             jnp.asarray(jt[Lup]))
    jkw = dict(suby=suby, nseg=jt["seg_starts"].shape[1], interpret=True)
    targs = (tt["seg_starts"][c], tt["seg_deltas"][c], tt[win], tt[win_up])
    geo = dict(bh=bh, bw=bw, n_ov=n_ov, bs=depth - 8,
               scale_shift=tregs.scale_shift, imin=imin, imax=imax)
    return plane, offs, (jargs, jkw), targs, geo


@pytest.mark.parametrize("kind,depth,csub,c", [
    ("sei_ff", 10, (2, 2), 0), ("afgs1", 8, (2, 2), 1),
    ("sei_ff", 8, (2, 1), 1), ("afgs1", 10, (2, 1), 2),
    ("afgs1", 8, (1, 1), 1), ("sei_ar", 10, (1, 1), 0)])
def test_plane_tiled_plain_matches_jax_kernel(kind, depth, csub, c):
    """plane_tiled_plain against _plane_pallas(interpret=True) on the same
    tiled strips, offsets and tables."""
    plane, offs, (jargs, jkw), targs, geo = _jax_plane_case(kind, depth,
                                                            csub, c)
    xt = np.array(jgp._tile(jnp.asarray(plane), len(FRAMES), R, geo["bh"],
                            C, geo["bw"]))
    want = jgp._plane_pallas(
        jnp.asarray(xt), *(jnp.asarray(a) for a in offs), *jargs, **jkw,
        **geo)
    got = grain_pallas.plane_tiled_plain(
        torch.from_numpy(xt), *(torch.from_numpy(a) for a in offs), *targs,
        **geo)
    assert got.dtype == torch.from_numpy(xt).dtype
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("kind,depth,csub,c", [
    ("sei_ff", 10, (2, 2), 0),      # 16x16 blocks, luma
    ("sei_ff", 8, (2, 1), 1),       # 16x8, 4:2:2 chroma
    ("afgs1", 8, (2, 2), 2)])       # 8x8, 4:2:0 chroma
def test_plane_tiled_natural_plain_matches_jax_kernel(kind, depth, csub, c):
    """plane_tiled_natural_plain (the kernel's plain version on natural
    planes) against _untile(_plane_pallas(_tile(x), interpret=True)), one
    geometry each."""
    plane, offs, (jargs, jkw), targs, geo = _jax_plane_case(kind, depth,
                                                            csub, c)
    lay = (len(FRAMES), R, geo["bh"], C, geo["bw"])
    want = jgp._untile(jgp._plane_pallas(
        jgp._tile(jnp.asarray(plane), *lay),
        *(jnp.asarray(a) for a in offs), *jargs, **jkw, **geo), *lay)
    got = grain_pallas.plane_tiled_natural_plain(
        torch.from_numpy(plane), *(torch.from_numpy(a) for a in offs),
        *targs, **geo)
    assert got.dtype == torch.from_numpy(plane).dtype
    assert got.shape == plane.shape
    assert np.array_equal(got.numpy(), np.asarray(want))


# (d) the batched step -------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("depth,csub", DEPTH_CSUB)
def test_batch_matches_jax_tiled(kind, depth, csub):
    """add_grain_batch_pallas on CPU tensors against the JAX tiled engine
    (interpret mode) and the port's natural step, three frames."""
    jregs = regs_for(JAX_PKG, kind, depth, csub)
    tregs = regs_for(TORCH_PKG, kind, depth, csub)
    planes = random_planes(29, depth, R, C, csub, frames=len(FRAMES))
    bases, bases_up = frame_bases(TORCH_PKG, tregs.seed_state, R, C, FRAMES)
    geo = dict(height=H, width=W, bs=depth - 8, csubx=csub[0], csuby=csub[1])
    want = jgp.add_grain_batch_pallas(
        *(jnp.asarray(p) for p in planes),
        jnp.asarray(np.array(bases, np.uint32)),
        jnp.asarray(np.array(bases_up, np.uint32)),
        jgp.pallas_tables(jregs), interpret=True, **geo)
    tplanes = [torch.from_numpy(p) for p in planes]
    got = grain_pallas.add_grain_batch_pallas(
        *tplanes, bases, bases_up, grain_pallas.pallas_tables(tregs, "cpu"),
        **geo)
    nat = grain_natural.add_grain_batch_natural(
        *tplanes, bases, bases_up, grain_natural.natural_tables(tregs, "cpu"),
        **geo)
    for c in range(3):
        where = f"{kind} d{depth} csub{csub} plane {c}"
        assert got[c].dtype == tplanes[c].dtype, where
        assert np.array_equal(got[c].numpy(), np.asarray(want[c])), where
        assert np.array_equal(got[c].numpy(), nat[c].numpy()), where
    assert grain_pallas.plane_tiled_cuda.launches == 0


def test_jax_tiled_step_ignores_bases_up():
    """The JAX tiled engine gives the same planes for two different
    ``bases_up``: the upper row-0 lattice it builds from them is never read
    (a frame's first block row does not blend), which is why the port's
    step does not build it."""
    jregs = regs_for(JAX_PKG, "sei_ff", 10, (2, 2))
    planes = [jnp.asarray(p) for p in
              random_planes(37, 10, R, C, (2, 2), frames=2)]
    bases, bases_up = frame_bases(TORCH_PKG, jregs.seed_state, R, C, (1, 4))
    other = [b ^ 0x5A5A5A5A for b in bases_up]
    assert other != bases_up
    outs = [jgp.add_grain_batch_pallas(
        *planes, jnp.asarray(np.array(bases, np.uint32)),
        jnp.asarray(np.array(bu, np.uint32)), jgp.pallas_tables(jregs),
        height=H, width=W, bs=2, csubx=2, csuby=2, interpret=True)
        for bu in (bases_up, other)]
    for c in range(3):
        assert np.array_equal(np.asarray(outs[0][c]), np.asarray(outs[1][c]))


def test_tiled_step_builds_one_lattice(monkeypatch):
    """The port's tiled step builds the (F, R, C) lattice of ``bases`` and
    no other: each block row's upper row is the row before it."""
    regs = regs_for(TORCH_PKG, "afgs1", 10, (2, 2))
    planes = [torch.from_numpy(p) for p in
              random_planes(39, 10, R, C, (2, 2), frames=2)]
    bases, bases_up = frame_bases(TORCH_PKG, regs.seed_state, R, C, (0, 3))
    calls = []
    lattice = tlfsr.state_lattice_torch

    def counted(b, rows, cols, device):
        calls.append((list(b), rows, cols))
        return lattice(b, rows, cols, device)

    monkeypatch.setattr(tlfsr, "state_lattice_torch", counted)
    grain_pallas.add_grain_batch_pallas(
        *planes, bases, bases_up, grain_pallas.pallas_tables(regs, "cpu"),
        height=H, width=W, bs=2, csubx=2, csuby=2)
    assert calls == [(list(bases), R, C)]


def test_wrapper_rejects_bad_inputs():
    regs = regs_for(TORCH_PKG, "sei_ff", 10, (2, 2))
    tables = grain_pallas.pallas_tables(regs, "cpu")
    y, u, v = (torch.from_numpy(p) for p in
               random_planes(3, 10, R, C, (2, 2), frames=1))
    geo = dict(height=H, width=W, bs=2, csubx=2, csuby=2)
    with pytest.raises(ValueError, match="bases"):
        grain_pallas.add_grain_batch_pallas(y, u, v, [1], [1, 2], tables,
                                            **geo)
    with pytest.raises(ValueError, match="v: expected"):
        grain_pallas.add_grain_batch_pallas(y, u, v[:, :-8], [1], [1],
                                            tables, **geo)
    with pytest.raises(ValueError, match="uint8 or uint16"):
        grain_pallas.add_grain_batch_pallas(
            y.int(), u.int(), v.int(), [1], [1], tables, **geo)
    meta = [p.to("meta") for p in (y, u, v)]
    with pytest.raises(ValueError, match="no grain kernel"):
        grain_pallas.add_grain_batch_pallas(*meta, [1], [1], tables, **geo)
    offs = [torch.zeros((1, R, 1, C), dtype=torch.int32)] * 4
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        grain_pallas.plane_tiled_cuda(
            y, *offs, tables["seg_starts"][0], tables["seg_deltas"][0],
            tables["win_luma"], tables["win_luma_up"], bh=16, bw=16, n_ov=2,
            bs=2, scale_shift=5, imin=16, imax=235)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        grain_pallas._launch_tiled(
            y, *offs, tables["seg_starts"][0], tables["seg_deltas"][0],
            tables["win_luma"], tables["win_luma_up"], bh=16, bw=16, n_ov=2,
            bs=2, scale_shift=5, imin=16, imax=235,
            defines=probe_tiled.VARIANTS["nostage"])
    assert grain_pallas.plane_tiled_cuda.launches == 0


@pytest.mark.parametrize("name", sorted(probe_tiled.VARIANTS))
def test_probe_variants_build_from_the_kernels_hooks(name):
    """Each of tools/probe_tiled.py's variants sets hooks that
    csrc/grain_tiled.cu defaults (so the engine's build has none of them),
    into a library of its own; the kernel's own entry has no define."""
    src, so = _kernels._paths("grain_tiled", probe_tiled.VARIANTS[name])
    text = open(src).read()
    for define in probe_tiled.VARIANTS[name]:
        macro, value = define.split("=")
        assert f"#ifndef {macro}\n#define {macro} " in text, define
        assert int(value) > 0
    assert (so == _kernels._paths("grain_tiled")[1]) == (name == "kernel")


@pytest.mark.parametrize("tool", [bench_tiled, probe_tiled])
def test_tiled_tools_refuse_cpu(tool, monkeypatch, capsys):
    """Without a card the tiled engine's tools time nothing and exit 2."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tool.main() == 2
    assert "no CUDA device" in capsys.readouterr().err


# (e) the pipeline -----------------------------------------------------------

def _frames(w, h, depth, n, seed):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if depth == 8 else np.uint16
    hi = (1 << depth) - 1
    return [tuple(rng.integers(0, hi + 1, shape).astype(dt)
                  for shape in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
            for _ in range(n)]


@pytest.mark.parametrize("w,h,depth,nfr", [(250, 140, 10, 3),
                                           (145, 128, 8, 4)])
def test_pipeline_process_frame_matches_jax(w, h, depth, nfr):
    """250x140 is unaligned (padding and crop); width 145 is a pad-leak
    width (stateful padded buffer across frames)."""
    ref = JaxPipeline(w, h, depth, 0, engine="pallas")
    got = GrainPipeline(w, h, depth, 0, engine="pallas", device="cpu")
    assert got._has_pad_leak() == (w == 145)
    refs, outs = [], []
    for n, planes in enumerate(_frames(w, h, depth, nfr, 17)):
        refs.append(ref.process_frame(tuple(p.copy() for p in planes), n))
        outs.append(got.process_frame(planes, n))
    for n, (a, b) in enumerate(zip(refs, outs)):
        for c in range(3):
            assert b[c].dtype == a[c].dtype, (n, c)
            assert np.array_equal(a[c], b[c]), f"frame {n} plane {c}"


@pytest.mark.parametrize("w,h,depth,nfr", [(250, 140, 10, 5),
                                           (145, 128, 8, 3)])
def test_pipeline_run_file_matches_jax(w, h, depth, nfr, tmp_path):
    src = tmp_path / "in.yuv"
    with open(src, "wb") as f:
        for planes in _frames(w, h, depth, nfr, 31):
            for p in planes:
                f.write(p.tobytes())
    # A mid-stream AFGS1 switch at frame 2 splits the batches there and
    # uploads new tables.
    cfgs = [f"2:{os.path.join(CFG_DIR, 'fgs_afgs1_test1.cfg')}"]
    outs = {}
    for name, pipe in (
            ("jax", JaxPipeline(w, h, depth, 0, configs=cfgs,
                                engine="pallas")),
            ("torch", GrainPipeline(w, h, depth, 0, configs=cfgs,
                                    engine="pallas", device="cpu"))):
        dst = tmp_path / f"out_{name}.yuv"
        assert pipe.run_file(str(src), str(dst), batch=2) == nfr
        outs[name] = dst.read_bytes()
    assert outs["torch"] == outs["jax"]


def test_pipeline_tables_follow_engine_and_config():
    path = os.path.join(CFG_DIR, "fgs_afgs1_test2.cfg")
    pipe = GrainPipeline(256, 144, 10, 0, configs=[f"3:{path}"],
                         engine="pallas", device="cpu")
    first = pipe._tables()
    assert "win_luma" in first and pipe._tables() is first
    pipe.maybe_switch_config(3)
    second = pipe._tables()
    assert second is not first
    assert not torch.equal(first["seg_starts"], second["seg_starts"])


# (f) golden CLI cases through --engine pallas -------------------------------

@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_cli_engine_pallas(name, tmp_path_factory):
    tmpdir = str(tmp_path_factory.getbasetemp() / "torch_tiled_inputs")
    os.makedirs(tmpdir, exist_ok=True)
    entry = GOLDEN[name]
    data = golden_output(cli.main, entry, "pallas", tmpdir)
    assert len(data) == entry["bytes"]
    assert hashlib.sha256(data).hexdigest() == entry["sha256"], \
        f"output differs from reference for {name}"
    assert grain_pallas.plane_tiled_cuda.launches == 0
