"""The frozen plain reference equals the program's CPU output (its plain
engine, which the repository's tests hold against the JAX package) at
small geometries of both deployments, frame by frame and through the
batched step."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from cells import PKG
from portbench import frames
from portbench.reference.model import Reference

CFG = os.path.join(PKG, "configs", "fgs_afgs1_test2.cfg")
GEOMETRIES = [
    (256, 192, 10, None), (256, 200, 8, CFG), (144, 136, 10, CFG),
    (272, 128, 8, None),
]


def _pipeline(W, H, D, cfg):
    from versatilefilmgrain_tpu_torch import GrainPipeline
    pipe = GrainPipeline(W, H, D, 0, configs=[f"0:{cfg}"] if cfg else [],
                         device="cpu")
    pipe.maybe_switch_config(0)
    return pipe


@pytest.mark.parametrize("W,H,D,cfg", GEOMETRIES)
def test_reference_equals_program_frame_by_frame(W, H, D, cfg):
    pipe = _pipeline(W, H, D, cfg)
    ref = Reference(W, H, D, 0, [(0, cfg)] if cfg else [])
    for n in (0, 1, 7, 40):
        planes = frames.frame_planes(W, H, D, 0, 99, n)
        got = pipe.process_frame(planes, n)
        want = ref.grain(*(torch.from_numpy(p.copy())
                           for p in frames.padded_frame(W, H, D, 0, 99, n)),
                         n)
        for g, w, p in zip(got, want, planes):
            assert np.array_equal(g, w.numpy()[:p.shape[0], :p.shape[1]])
            assert not np.array_equal(g, p)     # grain was added


@pytest.mark.parametrize("W,H,D,cfg", GEOMETRIES[:2])
def test_reference_equals_program_batched_step(W, H, D, cfg):
    from versatilefilmgrain_tpu_torch.ops import grain_natural as gn
    pipe = _pipeline(W, H, D, cfg)
    ref = Reference(W, H, D, 0, [(0, cfg)] if cfg else [])
    pool = [frames.padded_frame(W, H, D, 0, 5, i) for i in range(4)]
    y, u, v = (torch.from_numpy(np.stack([f[c] for f in pool]))
               for c in range(3))
    n0 = 16
    bases, ups = zip(*(pipe.frame_bases(n0 + i) for i in range(4)))
    r = pipe.regs
    out = gn.add_grain_batch_natural(
        y, u, v, list(bases), list(ups), gn.natural_tables(r, "cpu"),
        height=H, width=W, bs=r.bs, csubx=r.csubx, csuby=r.csuby)
    for i in range(4):
        want = ref.grain(y[i], u[i], v[i], n0 + i)
        for o, w in zip(out, want):
            assert torch.equal(o[i], w)


def test_reference_bases_follow_the_afgs1_epoch():
    # AFGS1 reseeds at its pop: frame 0's base is the seed state itself
    ref = Reference(256, 200, 8, 0, [(0, CFG)])
    base, up = ref.frame_bases(0)
    assert base == up == ref.state(0).regs.seed_state
    assert ref.frame_bases(1)[0] != base


def test_input_frames_cover_the_code_range_and_are_smooth():
    y, u, v = frames.frame_planes(512, 256, 10, 0, 2**31 + 3, 0)
    assert y.dtype == np.uint16 and y.min() == 0 and y.max() == 1023
    assert u.shape == (128, 256)
    # smooth: most runs of 8 luma samples stay within one 8-bit intensity
    # step of 16, unlike uniform noise
    runs = (y[:, :512 - 512 % 8].reshape(256, -1, 8) >> 2).astype(int)
    spread = runs.max(-1) - runs.min(-1)
    assert np.median(spread) < 16
    again = frames.frame_planes(512, 256, 10, 0, 2**31 + 3, 0)
    assert all(np.array_equal(a, b) for a, b in zip((y, u, v), again))
    other = frames.frame_planes(512, 256, 10, 0, 2**31 + 3, 1)
    assert not np.array_equal(y, other[0])
