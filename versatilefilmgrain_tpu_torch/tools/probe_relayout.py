"""The natural <-> tiled relayout (K9) on the card, and what it costs.

Port of the JAX package's tools/probe_relayout.py.  On an 8-frame 3840x2160
uint16 plane, csrc/probe_relayout.cu writes y ^ 1:
  passthrough    a plain pass, 16-byte loads and stores;
  relayout       each (16, 3840) block row into the tiled (256, 240) layout
                 in shared memory, the XOR there, then back; one block row
                 per thread block;
  relayout_r5    the same, 5 block rows per thread block, one after another;
  relayout_r15   15 block rows per thread block.
Each is held exactly against its plain version (every one == y ^ 1) and
timed beside its bound.  Beside them, two library calls: the torch round
trip of the tiled step's glue, _untile(_tile(y) ^ 1), and _tile alone, what
the tiled step pays per plane on the way in.  Whether a relayout in shared
memory costs about what a passthrough costs says whether the tiled kernel
could read natural planes and drop that glue.

Run on the card from the repo root:
  python -m versatilefilmgrain_tpu_torch.tools.probe_relayout
"""

from __future__ import annotations

import sys

import torch

from . import _harness as hz
from . import _relayout

# case -> (mode, block rows per thread block)
CASES = {"passthrough": ("passthrough", 1), "relayout": ("relayout", 1),
         "relayout_r5": ("relayout", 5), "relayout_r15": ("relayout", 15)}


def run(y) -> dict:
    """Time and check every case at ``y``'s shape on the card; prints and
    returns {case: {"ms", "bound_ms", "bound_by", "exact"}} and, under
    "library", the torch round trip's and ``_tile``'s times."""
    want = _relayout.passthrough_plain(y)
    cases = {name: (_relayout.make_step(mode, rchunk),
                    _relayout.plain(mode, y, rchunk), _relayout.bound(y))
             for name, (mode, rchunk) in CASES.items()}
    for name, (_, plain, _) in cases.items():
        if not torch.equal(plain, want):
            raise RuntimeError(f"the plain {name} differs from y ^ 1")
    print("probe_relayout (K9): y ^ 1 through the tiled (256, C) layout in "
          "shared memory, against a plain pass", flush=True)
    res = hz.run_modes(cases, y)
    res["library"] = _relayout.time_library(y)
    return res


def main(argv=None) -> int:
    if hz.no_card("probe_relayout"):
        return 2
    y = _relayout.relayout_inputs(0, device="cuda")
    hz.header("probe_relayout", y)
    run(y)
    return 0


if __name__ == "__main__":
    sys.exit(main())
