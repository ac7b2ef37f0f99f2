"""The torch port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test asks the ``cuda_device`` fixture for a card and
skips without one (the kernel has no CPU mode; the CPU tests hold the plain
version against the JAX package).  Run on a GPU machine with
``python -m pytest --noconftest tests/test_torch_cuda.py`` (tests/conftest.py
sets up JAX, which a GPU machine need not have); ``chip_smoke.py`` covers
the same ground at full size.
"""

import numpy as np
import pytest
import torch

from versatilefilmgrain_tpu_torch.ops import grain_natural, grain_pallas

from torch_port_cases import (TORCH_PKG, frame_bases, random_planes,
                              regs_for)

pytestmark = pytest.mark.cuda

H, W = 192, 256
R, C = H // 16, W // 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_and_plain(kind, depth, csub, dev):
    regs = regs_for(TORCH_PKG, kind, depth, csub)
    tables = grain_natural.natural_tables(regs, dev)
    frames = (0, 1, 3)
    bases, _ = frame_bases(TORCH_PKG, regs.seed_state, R, C, frames)
    planes = [torch.from_numpy(p).to(dev) for p in
              random_planes(41, depth, R, C, csub, frames=len(frames))]
    geo = dict(bs=depth - 8, csubx=csub[0], csuby=csub[1])
    k = grain_natural.add_grain_batch_natural(*planes, bases, None, tables,
                                              height=H, width=W, **geo)
    p = grain_natural.add_grain_batch_plain(*planes, bases, tables, **geo)
    torch.cuda.synchronize()
    return k, p


@pytest.mark.parametrize("kind,depth,csub", [
    ("sei_ff", 10, (2, 2)), ("sei_ar", 8, (2, 1)), ("afgs1", 10, (1, 1))])
def test_kernel_matches_plain(kind, depth, csub, cuda_device):
    k, p = _kernel_and_plain(kind, depth, csub, cuda_device)
    for c in range(3):
        assert k[c].device.type == "cuda" and k[c].dtype == p[c].dtype
        assert np.array_equal(k[c].cpu().numpy(), p[c].cpu().numpy()), \
            f"{kind} d{depth} csub{csub} plane {c}"


def test_launch_counter(cuda_device):
    before = grain_natural.grain_plane_cuda.launches
    _kernel_and_plain("sei_ff", 10, (2, 2), cuda_device)
    assert grain_natural.grain_plane_cuda.launches == before + 3


def _tiled_kernel_plain_natural(kind, depth, csub, dev):
    """The tiled engine on the card, its plain strip function on the card
    and the natural kernel, on the same planes."""
    regs = regs_for(TORCH_PKG, kind, depth, csub)
    frames = (0, 1, 3)
    bases, bases_up = frame_bases(TORCH_PKG, regs.seed_state, R, C, frames)
    planes = [torch.from_numpy(p).to(dev) for p in
              random_planes(43, depth, R, C, csub, frames=len(frames))]
    geo = dict(bs=depth - 8, csubx=csub[0], csuby=csub[1])
    ptab = grain_pallas.pallas_tables(regs, dev)
    k = grain_pallas.add_grain_batch_pallas(*planes, bases, bases_up, ptab,
                                            height=H, width=W, **geo)
    p = grain_pallas._tiled_batch(*planes, bases, bases_up, ptab, R=R, C=C,
                                  strip_fn=grain_pallas.plane_tiled_plain,
                                  **geo)
    n = grain_natural.add_grain_batch_natural(
        *planes, bases, bases_up, grain_natural.natural_tables(regs, dev),
        height=H, width=W, **geo)
    torch.cuda.synchronize()
    return k, p, n


@pytest.mark.parametrize("kind,depth,csub", [
    ("sei_ff", 10, (2, 2)), ("sei_ar", 8, (2, 1)), ("afgs1", 10, (1, 1))])
def test_tiled_kernel_matches_plain_and_natural(kind, depth, csub,
                                                cuda_device):
    k, p, n = _tiled_kernel_plain_natural(kind, depth, csub, cuda_device)
    for c in range(3):
        where = f"{kind} d{depth} csub{csub} plane {c}"
        assert k[c].device.type == "cuda" and k[c].dtype == p[c].dtype, where
        got = k[c].cpu().numpy()
        assert np.array_equal(got, p[c].cpu().numpy()), where
        assert np.array_equal(got, n[c].cpu().numpy()), where


def test_tiled_launch_counter(cuda_device):
    before = grain_pallas.plane_tiled_cuda.launches
    _tiled_kernel_plain_natural("sei_ff", 10, (2, 2), cuda_device)
    assert grain_pallas.plane_tiled_cuda.launches == before + 3
