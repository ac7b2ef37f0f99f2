"""The roofline's byte arithmetic against chip_smoke.py's count of K1's
bytes at 4K, and the peak against its byte bound."""

from __future__ import annotations

import os

import torch

from cells import REPO
from portbench import roofline
from portbench.run import load_file


def test_step_bytes_match_chip_smoke_at_4k():
    smoke = load_file(os.path.join(REPO, "chip_smoke.py"), "chip_smoke")
    from versatilefilmgrain_tpu_torch.ops.grain_natural import natural_tables
    from versatilefilmgrain_tpu_torch.tools._harness import default_regs
    W, H, F = smoke.FULL
    planes = [torch.empty((F, h, w), dtype=torch.uint16)
              for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
    tables = natural_tables(default_regs(), "cpu")
    tbytes = smoke.tensor_bytes(*(tables[k] for k in ("pattern", "slut",
                                                      "plut", "scalars")))
    lattice = F * (H // 16) * (W // 16) * 4      # K1's int32 lattice words
    nbytes = 2 * sum(p.numel() * p.element_size() for p in planes)
    k1 = nbytes + lattice + tbytes               # chip_smoke.py phase 3
    assert tbytes == roofline.TABLE_BYTES
    assert roofline.step_bytes(W, H, 10, 0, F) + lattice == k1
    assert abs(roofline.step_bound_s(W, H, 10, 0, F) * 1e3
               - smoke.byte_bound_ms(k1 - lattice)) < 1e-12
    # the records' 0.1188 ms bound of the step (ISSUE of this benchmark)
    assert 0.1187 < roofline.step_bound_s(W, H, 10, 0, F) * 1e3 < 0.1189


def test_step_bytes_at_1080p_count_the_padded_rows():
    # 1080 rows pad to 1088: 68 block rows of 16 luma and 8 chroma lines
    assert roofline.step_bytes(1920, 1080, 8, 0, 1) == (
        2 * (1088 * 1920 + 2 * 544 * 960) + roofline.TABLE_BYTES)
