"""The torch port's grain engine against the JAX package, bit for bit.

The plain torch engine (ops/grain_ref.py) and the port's batched step
(ops/grain_natural.add_grain_batch_natural on CPU tensors, i.e. the plain
version of the CUDA kernel) are held against the JAX reference engine
``add_grain_frame_jit`` over the config x depth x chroma grid of
tests/test_natural_engine.py, and against the JAX natural-layout Pallas
kernel in interpret mode for two cases.  Every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from versatilefilmgrain_tpu.ops import grain_natural as jgn
from versatilefilmgrain_tpu.ops.grain_jnp import add_grain_frame_jit
from versatilefilmgrain_tpu_torch.ops import grain_natural, grain_ref

from torch_port_cases import (DEPTH_CSUB, JAX_PKG, KINDS, TORCH_PKG,
                              frame_bases, random_planes, regs_for)

H, W = 144, 256
R, C = H // 16, W // 16
FRAMES = (0, 1, 3)


def _jax_ref(regs, planes, base, base_up, depth, csub):
    dp = regs.device_params()
    out = add_grain_frame_jit(
        *(jnp.asarray(p) for p in planes), jnp.uint32(base),
        jnp.uint32(base_up), jnp.asarray(dp["pattern"]),
        jnp.asarray(dp["sluts"]), jnp.asarray(dp["pluts"]),
        dp["scale_shift"], dp["y_min"], dp["y_max"], dp["c_min"],
        dp["c_max"], height=H, width=W, bs=depth - 8, csubx=csub[0],
        csuby=csub[1])
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("depth,csub", DEPTH_CSUB)
def test_plain_engine_matches_jax(kind, depth, csub):
    jregs = regs_for(JAX_PKG, kind, depth, csub)
    tregs = regs_for(TORCH_PKG, kind, depth, csub)
    planes = random_planes(7, depth, R, C, csub)
    bases, bases_up = frame_bases(TORCH_PKG, tregs.seed_state, R, C, FRAMES)
    tables = grain_natural.natural_tables(tregs, "cpu")
    geo = dict(bs=depth - 8, csubx=csub[0], csuby=csub[1])
    batched = grain_natural.add_grain_batch_natural(
        *(torch.from_numpy(np.stack([p] * len(FRAMES))) for p in planes),
        bases, bases_up, tables, height=H, width=W, **geo)
    for fi, f in enumerate(FRAMES):
        want = _jax_ref(jregs, planes, bases[fi], bases_up[fi], depth, csub)
        one = grain_ref.add_grain_frame(
            *(torch.from_numpy(p) for p in planes), bases[fi], bases_up[fi],
            tables["pattern"], tables["slut"], tables["plut"],
            tregs.scale_shift, tregs.y_min, tregs.y_max, tregs.c_min,
            tregs.c_max, height=H, width=W, **geo)
        for c in range(3):
            where = f"{kind} d{depth} csub{csub} frame {f} plane {c}"
            assert one[c].numpy().dtype == want[c].dtype, where
            assert np.array_equal(one[c].numpy(), want[c]), where
            assert np.array_equal(batched[c][fi].numpy(), want[c]), where


@pytest.mark.parametrize("kind,depth,csub", [
    ("sei_ff", 10, (2, 2)), ("afgs1", 8, (2, 1))])
def test_batch_matches_jax_natural_kernel(kind, depth, csub):
    """The port's batched step against the JAX Pallas kernel (interpret
    mode), one batched call over three frames on each side."""
    jregs = regs_for(JAX_PKG, kind, depth, csub)
    tregs = regs_for(TORCH_PKG, kind, depth, csub)
    planes = random_planes(29, depth, R, C, csub, frames=len(FRAMES))
    bases, bases_up = frame_bases(TORCH_PKG, tregs.seed_state, R, C, FRAMES)
    geo = dict(height=H, width=W, bs=depth - 8, csubx=csub[0], csuby=csub[1])
    want = jgn.add_grain_batch_natural(
        *(jnp.asarray(p) for p in planes),
        jnp.asarray(np.array(bases, np.uint32)),
        jnp.asarray(np.array(bases_up, np.uint32)),
        jgn.natural_tables(jregs), interpret=True, **geo)
    got = grain_natural.add_grain_batch_natural(
        *(torch.from_numpy(p) for p in planes), bases, bases_up,
        grain_natural.natural_tables(tregs, "cpu"), **geo)
    for c in range(3):
        assert np.array_equal(got[c].numpy(), np.asarray(want[c])), \
            f"{kind} d{depth} csub{csub} plane {c}"


def test_natural_tables_zero_scale_and_chroma_geometry():
    regs = regs_for(TORCH_PKG, "sei_ar", 10, (2, 1))
    t = grain_natural.natural_tables(regs, "cpu")
    assert t["zero_scale"] == (False, True, True)   # luma-only SEI-AR
    assert (t["bh_c"], t["bw_c"], t["n_ov_c"]) == (16, 8, 2)
    assert t["pattern"].dtype == torch.int8
    assert tuple(t["pattern"].shape) == (2, 8, 64, 64)
    assert t["scalars"].tolist() == [regs.scale_shift, regs.y_min,
                                     regs.y_max, regs.c_min, regs.c_max]
    regs.plut[0, 5] = 8 << 4
    with pytest.raises(ValueError, match="pattern index"):
        grain_natural.natural_tables(regs, "cpu")


def test_wrapper_rejects_bad_inputs():
    regs = regs_for(TORCH_PKG, "sei_ff", 10, (2, 2))
    tables = grain_natural.natural_tables(regs, "cpu")
    y, u, v = (torch.from_numpy(p) for p in
               random_planes(3, 10, R, C, (2, 2), frames=1))
    geo = dict(height=H, width=W, bs=2, csubx=2, csuby=2)
    with pytest.raises(ValueError, match="bases"):
        grain_natural.add_grain_batch_natural(y, u, v, [1, 2], None, tables,
                                              **geo)
    with pytest.raises(ValueError, match="u: expected"):
        grain_natural.add_grain_batch_natural(y, u[:, :-8], v, [1], None,
                                              tables, **geo)
    with pytest.raises(ValueError, match="uint8 or uint16"):
        grain_natural.add_grain_batch_natural(
            y.int(), u.int(), v.int(), [1], None, tables, **geo)
    meta = [p.to("meta") for p in (y, u, v)]
    with pytest.raises(ValueError, match="no grain kernel"):
        grain_natural.add_grain_batch_natural(*meta, [1], None, tables, **geo)
    lat32 = torch.zeros((1, R, C), dtype=torch.int32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        grain_natural.grain_plane_cuda(y, lat32, tables, c=0, csubx=2,
                                       csuby=2, bs=2)
    assert grain_natural.grain_plane_cuda.launches == 0
