"""The torch port's sharded grain step against the JAX package, bit for bit.

``plane_grain`` with ``ov_mask`` against ``grain_jnp.plane_grain``; the
shard body ``add_grain_shard_natural`` against the JAX shard body (interpret
mode) with the shard's first row booted or not, in every ``word_expand``
mode; the port's ``make_grain_step`` (plain and natural engines, CPU device
meshes with repeats) against the single-device JAX reference over the mesh
shapes of tests/test_sharding.py; and a cut-down sweep of
``__graft_entry__.dryrun_multichip``.  Every comparison is exact.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from versatilefilmgrain_tpu.ops import grain_jnp
from versatilefilmgrain_tpu.ops import grain_natural as jgn
from versatilefilmgrain_tpu_torch.ops import grain_natural, grain_ref
from versatilefilmgrain_tpu_torch.parallel import mesh as pmesh

from torch_port_cases import (JAX_PKG, TORCH_PKG, afgs1_cfg, frame_bases,
                              mod, random_planes, regs_for)

MODES = ["xla", "pallas", "kernel", "chunk"]


def _regs(pkg, family, depth, csub):
    """The register files of __graft_entry__.dryrun_multichip: 4:4:4 drops
    the chroma model (luma-only), as the pipeline requires."""
    cfgmod, fw = mod(pkg, "models.config"), mod(pkg, "models.fw")
    regs = mod(pkg, "models.hw").HwRegs()
    regs.set_depth(depth)
    regs.set_chroma_subsampling(*csub)
    if family == "sei_ff":
        sei = cfgmod.default_sei()
        if csub == (1, 1):
            sei.comp_model_present_flag = [1, 0, 0]
        fw.init_sei(sei, regs)
    else:
        a = afgs1_cfg(pkg)
        if csub != (2, 2):
            a.num_cb_points = a.num_cr_points = 0
        fw.init_afgs1(a, regs)
    return regs


def _ref_args(regs):
    """The plain engine's table arguments (pattern, sluts, pluts,
    scale_shift, y_min, y_max, c_min, c_max) from a port register file."""
    return (torch.tensor(regs.pattern), torch.tensor(regs.slut),
            torch.tensor(regs.plut), regs.scale_shift, regs.y_min,
            regs.y_max, regs.c_min, regs.c_max)


def _jax_frames(jregs, planes, bases, bases_up, H, W, depth, csub):
    """The single-device JAX reference engine, frame by frame."""
    dp = jregs.device_params()
    outs = []
    for f in range(planes[0].shape[0]):
        o = grain_jnp.add_grain_frame_jit(
            *(jnp.asarray(p[f]) for p in planes), jnp.uint32(bases[f]),
            jnp.uint32(bases_up[f]), jnp.asarray(dp["pattern"]),
            jnp.asarray(dp["sluts"]), jnp.asarray(dp["pluts"]),
            dp["scale_shift"], dp["y_min"], dp["y_max"], dp["c_min"],
            dp["c_max"], height=H, width=W, bs=depth - 8, csubx=csub[0],
            csuby=csub[1])
        outs.append([np.asarray(p) for p in o])
    return [np.stack([o[c] for o in outs]) for c in range(3)]


@pytest.mark.parametrize("c,csub", [(0, (2, 2)), (1, (2, 2)), (2, (2, 1)),
                                    (1, (1, 1))])
def test_plane_grain_ov_mask_matches_jax(c, csub):
    """Random ov_mask, first row blending or not, and None."""
    H, W = 80, 96
    R, C = H // 16, W // 16
    jregs = regs_for(JAX_PKG, "sei_ff", 10, csub)
    tregs = regs_for(TORCH_PKG, "sei_ff", 10, csub)
    rng = np.random.default_rng(9 + c)
    pix = random_planes(4, 10, R, C, csub)[c]
    lat = rng.integers(0, 1 << 32, (2, R, C), dtype=np.uint64)
    dp = jregs.device_params()
    pat = jnp.asarray(dp["pattern"]).reshape(2, -1)[1 if c else 0]
    lo, hi = (jregs.y_min, jregs.y_max) if c == 0 else (jregs.c_min,
                                                       jregs.c_max)
    t = grain_natural.natural_tables(tregs, "cpu")
    for mask in (rng.integers(0, 2, R).astype(bool), np.ones(R, bool),
                 None):
        want = grain_jnp.plane_grain(
            jnp.asarray(pix.astype(np.int32)),
            jnp.asarray(lat[0].astype(np.uint32)),
            jnp.asarray(lat[1].astype(np.uint32)), pat,
            jnp.asarray(dp["sluts"][c]), jnp.asarray(dp["pluts"][c]),
            dp["scale_shift"], lo, hi,
            None if mask is None else jnp.asarray(mask), c=c, csubx=csub[0],
            csuby=csub[1], bs=2)
        got = grain_ref.plane_grain(
            torch.from_numpy(pix)[None], torch.from_numpy(
                lat[:1].astype(np.int64)),
            torch.from_numpy(lat[1:].astype(np.int64)),
            t["pattern"][1 if c else 0], t["slut"][c], t["plut"][c],
            tregs.scale_shift, lo, hi,
            None if mask is None else torch.from_numpy(mask), c=c,
            csubx=csub[0], csuby=csub[1], bs=2)
        assert np.array_equal(got[0].numpy(), np.asarray(want).astype(
            pix.dtype)), mask


@pytest.mark.parametrize("csub", [(2, 2), (1, 1)], ids=["420", "444_lumaonly"])
@pytest.mark.parametrize("blend0", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_shard_body_matches_jax(mode, blend0, csub):
    """add_grain_shard_natural on a (2 frames, 3 block rows) shard against
    the JAX shard body in interpret mode, the first row booted from
    states_up or not.  Row 1 of states_up holds junk: only row 0 is read."""
    H, W = 48, 128
    R, C = H // 16, W // 16
    jregs = _regs(JAX_PKG, "sei_ff", 10, csub)
    tregs = _regs(TORCH_PKG, "sei_ff", 10, csub)
    planes = random_planes(61, 10, R, C, csub, frames=2)
    rng = np.random.default_rng(62)
    states = rng.integers(0, 1 << 32, (2, R, C), dtype=np.uint64)
    states_up = np.concatenate([rng.integers(0, 1 << 32, (2, 1, C),
                                             dtype=np.uint64),
                                rng.integers(0, 1 << 32, (2, R - 1, C),
                                             dtype=np.uint64)], axis=1)
    ov = np.array([blend0] + [True] * (R - 1))
    geo = dict(bs=2, csubx=csub[0], csuby=csub[1])
    jup = np.concatenate([states_up[:, :1], states[:, :-1]], axis=1)
    want = jgn.add_grain_shard_natural(
        *(jnp.asarray(p) for p in planes),
        jnp.asarray(states.astype(np.uint32)),
        jnp.asarray(jup.astype(np.uint32)), jnp.asarray(ov),
        jgn.natural_tables(jregs), interpret=True, word_expand=mode, **geo)
    got = grain_natural.add_grain_shard_natural(
        *(torch.from_numpy(p) for p in planes),
        torch.from_numpy(states.astype(np.int64)),
        torch.from_numpy(states_up.astype(np.int64)), torch.from_numpy(ov),
        grain_natural.natural_tables(tregs, "cpu"), word_expand=mode, **geo)
    for c in range(3):
        assert np.array_equal(got[c].numpy(), np.asarray(want[c])), \
            f"{mode} blend0={blend0} plane {c}"


def test_shard_body_rejects_bad_ov_mask():
    tregs = regs_for(TORCH_PKG, "sei_ff", 10, (2, 2))
    planes = [torch.from_numpy(p) for p in
              random_planes(1, 10, 3, 8, (2, 2), frames=1)]
    st = torch.zeros((1, 3, 8), dtype=torch.int64)
    tables = grain_natural.natural_tables(tregs, "cpu")
    for bad in ([True, False, True], [True, True]):
        with pytest.raises(ValueError, match="ov_mask"):
            grain_natural.add_grain_shard_natural(
                *planes, st, st, bad, tables, bs=2, csubx=2, csuby=2)


H, W, F = 128, 256, 4      # the shapes of tests/test_sharding.py
R, C = H // 16, W // 16


@functools.lru_cache(maxsize=None)
def _sharding_case(csub):
    """Inputs of tests/test_sharding.py (as uint16) and the JAX reference."""
    jregs = _regs(JAX_PKG, "sei_ff", 10, csub)
    tregs = _regs(TORCH_PKG, "sei_ff", 10, csub)
    planes = random_planes(7, 10, R, C, csub, frames=F)
    bases, bases_up = frame_bases(TORCH_PKG, tregs.seed_state, R, C,
                                  range(F))
    want = _jax_frames(jregs, planes, bases, bases_up, H, W, 10, csub)
    return tregs, planes, bases, bases_up, want


def _check(got, want, tag):
    for c in range(3):
        assert np.array_equal(got[c].numpy(), want[c]), f"{tag} plane {c}"


@pytest.mark.parametrize("csub", [(2, 2), (1, 1)], ids=["420", "444_lumaonly"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 8), (2, 4), (4, 2), (2, 2),
                                   (4, 1)])
def test_mesh_invariance(shape, csub):
    """The plain engine ("ref" and "fast") sharded over CPU devices."""
    tregs, planes, bases, bases_up, want = _sharding_case(csub)
    m = pmesh.make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    for engine in ("ref", "fast"):
        step = pmesh.make_grain_step(m, height=H, width=W, bs=2,
                                     csubx=csub[0], csuby=csub[1],
                                     engine=engine)
        got = step(*(torch.from_numpy(p) for p in planes), bases, bases_up,
                   *_ref_args(tregs))
        _check(got, want, f"{engine} mesh {shape}")


@pytest.mark.parametrize("csub", [(2, 2), (1, 1)], ids=["420", "444_lumaonly"])
@pytest.mark.parametrize("shape", [(1, 8), (2, 4), (4, 1)])
def test_mesh_invariance_natural(shape, csub):
    """The natural engine's shard body in every word mode over CPU devices:
    tile shards boot their first row from the up-state lattice."""
    tregs, planes, bases, bases_up, want = _sharding_case(csub)
    m = pmesh.make_mesh(*shape, devices=["cpu"] * (shape[0] * shape[1]))
    tables = grain_natural.natural_tables(tregs, "cpu")
    for mode in MODES:
        step = pmesh.make_grain_step(m, height=H, width=W, bs=2,
                                     csubx=csub[0], csuby=csub[1],
                                     engine="natural", tables=tables,
                                     word_expand=mode)
        got = step(*(torch.from_numpy(p) for p in planes), bases, bases_up)
        _check(got, want, f"natural {mode} mesh {shape}")


def test_make_mesh_and_step_checks():
    m = pmesh.make_mesh(2, 3, ["cpu"] * 6)
    assert m.shape == {"data": 2, "tile": 3}
    assert m.devices[1][2] == torch.device("cpu")
    with pytest.raises(ValueError, match="needs 6 devices"):
        pmesh.make_mesh(2, 3, ["cpu"] * 5)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 1 devices, have 0"):
            pmesh.make_mesh(1, 1)
    with pytest.raises(ValueError, match="do not split over 3 tiles"):
        pmesh.make_grain_step(m, height=64, width=128, bs=2, csubx=2,
                              csuby=2)
    step = pmesh.make_grain_step(m, height=48, width=128, bs=2, csubx=2,
                                 csuby=2)
    planes = [torch.from_numpy(p) for p in
              random_planes(1, 10, 3, 8, (2, 2), frames=3)]
    with pytest.raises(ValueError, match="do not split over 2 data"):
        step(*planes, [1, 2, 3], [1, 2, 3])
    with pytest.raises(ValueError, match="needs tables"):
        pmesh.make_grain_step(m, height=48, width=128, bs=2, csubx=2,
                              csuby=2, engine="natural")
    assert pmesh.default_mesh_shape(8, 8) == (4, 2)
    assert pmesh.default_mesh_shape(6, 135) == (6, 1)
    assert pmesh.default_mesh_shape(9, 135) == (3, 3)
    assert pmesh.default_mesh_shape(4, 7) == (4, 1)


# __graft_entry__.dryrun_multichip's sweep: SEI-FF and AFGS1 x 4:2:0 and
# 4:4:4 luma-only, plus SEI-FF 4:2:2 10-bit and 4:2:0 8-bit.
DRYRUN = [("sei_ff", (2, 2), 10), ("sei_ff", (1, 1), 10),
          ("afgs1", (2, 2), 10), ("afgs1", (1, 1), 10),
          ("sei_ff", (2, 1), 10), ("sei_ff", (2, 2), 8)]


@pytest.mark.parametrize("family,csub,depth", DRYRUN)
def test_dryrun_sweep(family, csub, depth):
    """Cut down to 64x128 on (2, 2) and (1, 4) CPU meshes: the sharded
    plain and natural engines (every word mode) at grain offsets 0 and 3
    against the single-device JAX engine."""
    h, w, nf = 64, 128, 2
    r, cc = h // 16, w // 16
    jregs = _regs(JAX_PKG, family, depth, csub)
    tregs = _regs(TORCH_PKG, family, depth, csub)
    tables = grain_natural.natural_tables(tregs, "cpu")
    planes = random_planes(13, depth, r, cc, csub, frames=nf)
    geo = dict(height=h, width=w, bs=depth - 8, csubx=csub[0],
               csuby=csub[1])
    for off in (0, 3):
        bases, bases_up = frame_bases(TORCH_PKG, tregs.seed_state, r, cc,
                                      range(off, off + nf))
        want = _jax_frames(jregs, planes, bases, bases_up, h, w, depth, csub)
        for k, shape in enumerate(((2, 2), (1, 4))):
            m = pmesh.make_mesh(*shape, ["cpu"] * 4)
            tp = [torch.from_numpy(p) for p in planes]
            ref = pmesh.make_grain_step(m, engine="ref", **geo)
            _check(ref(*tp, bases, bases_up, *_ref_args(tregs)), want,
                   f"ref {shape} offset {off}")
            mode = MODES[(2 * off // 3 + k) % len(MODES)]
            nat = pmesh.make_grain_step(m, engine="natural", tables=tables,
                                        word_expand=mode, **geo)
            _check(nat(*tp, bases, bases_up), want,
                   f"natural {mode} {shape} offset {off}")

