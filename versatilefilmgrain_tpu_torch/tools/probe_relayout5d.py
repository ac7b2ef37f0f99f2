"""The relayout through a free 5-D view (K10) on the card.

Port of the JAX package's tools/probe_relayout5d.py.  The 8-frame 3840x2160
uint16 plane is viewed as (F, R, 16, C, 16), which costs nothing, and each
(16, C, 16) block gets y ^ 1:
  5d_passthrough  no transpose;
  5d_transpose    transposed to (16, 16, C), collapsed to the tiled (256, C),
                  XORed, transposed back.
On the TPU the view let Mosaic avoid a lane-splitting reshape.  On Hopper
the view is the natural plane's memory with other strides, and the two
forms compute element for element what K9's passthrough and rchunk-1
relayout compute, so they run those instances of csrc/probe_relayout.cu
(through their own wrapper and launch count).  Each is held exactly against
its plain version on the view and timed beside its bound and the torch round
trip _untile(_tile(y) ^ 1).

Run on the card from the repo root:
  python -m versatilefilmgrain_tpu_torch.tools.probe_relayout5d
"""

from __future__ import annotations

import sys

import torch

from . import _harness as hz
from . import _relayout


def run(y) -> dict:
    """Time and check both forms on the 5-D view of ``y`` on the card;
    prints and returns {form: {"ms", "bound_ms", "bound_by", "exact"}} and,
    under "library", the torch round trip's and ``_tile``'s times."""
    y5 = _relayout.view5d(y)
    want = _relayout.passthrough_plain(y5)
    cases = {mode: (_relayout.make_step(mode), _relayout.plain(mode, y5),
                    _relayout.bound(y5))
             for mode in _relayout.MODES_5D}
    for name, (_, plain, _) in cases.items():
        if not torch.equal(plain, want):
            raise RuntimeError(f"the plain {name} differs from y ^ 1")
    print("probe_relayout5d (K10): y ^ 1 on the free (F, R, 16, C, 16) "
          "view; on Hopper the view is only strides, so the forms run K9's "
          "passthrough and rchunk-1 relayout instances", flush=True)
    res = hz.run_modes(cases, y5)
    res["library"] = _relayout.time_library(y)
    return res


def main(argv=None) -> int:
    if hz.no_card("probe_relayout5d"):
        return 2
    y = _relayout.relayout_inputs(0, device="cuda")
    hz.header("probe_relayout5d", y)
    run(y)
    return 0


if __name__ == "__main__":
    sys.exit(main())
