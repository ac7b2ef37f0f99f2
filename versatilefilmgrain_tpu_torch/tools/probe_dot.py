"""The one-hot window dot (K6) on the card, by input type.

Port of the JAX package's tools/probe_dot.py.  For every (frame, block row)
of an 8-frame 3840x2160 uint16 plane, the product pat(144 x 768 int8) @
onehot(768 x 3840) on the tensor cores, its 8 row slices summed into the
strip: what the TPU grain kernel's window fetch cost.  int8, bf16 and TF32
(mode f32) run csrc/probe_dotconst.cu, a persistent wgmma kernel that
builds the one-hot in registers and stages the bank once per SM (TF32's
in two row groups of 72, one after the other, in the same launch).  Beside
them "none" (the strip copy alone) and "gather", the Hopper answer: the
same sums read straight from the pattern bank in shared memory, as K1
reads its windows (both csrc/probe_dot.cu).  gather is also timed with 9
block rows per thread block (the bank staged once for 9), which shows
what staging the 110,592-byte bank costs.  Each mode is held exactly
against its plain version; bf16, f32 and gather each == int8.

Run on the card from the repo root:
  python -m versatilefilmgrain_tpu_torch.tools.probe_dot
"""

from __future__ import annotations

import sys

import torch

from . import _dot
from . import _harness as hz

MODES = ("none", "int8", "bf16", "f32", "gather")
STRIPS = 9


def run(y, t, pat) -> dict:
    """Time and check every mode at ``y``'s shape on the card; prints and
    returns {name: {"ms", "bound_ms", "bound_by", "exact"}}, with the
    "bf16 == int8", "f32 == int8" and "gather == int8" checks under
    "equal"."""
    want = _dot.onehot_plain(y, t, pat)
    cases = {}
    for mode in MODES:
        cases[mode] = (_dot.make_step(mode, t, pat),
                       _dot.none_plain(y) if mode == "none" else want,
                       _dot.bound(mode, y, t, pat))
    cases[f"gather x{STRIPS}"] = (
        _dot.make_step("gather", t, pat, strips=STRIPS), want,
        _dot.bound("gather", y, t, pat))
    print("probe_dot (K6): pat(144x768) @ onehot(768xW) per block row, 8 "
          "row slices summed, clip 4092", flush=True)
    res = hz.run_modes(cases, y)
    int8 = cases["int8"][0](y)[0]
    res["equal"] = {f"{m} == int8": bool(torch.equal(cases[m][0](y)[0], int8))
                    for m in ("bf16", "f32", "gather")}
    for name, ok in res["equal"].items():
        print(f"  {name}: {ok}", flush=True)
    return res


def main(argv=None) -> int:
    if hz.no_card("probe_dot"):
        return 2
    y, t, pat = _dot.dot_inputs(0, device="cuda")
    hz.header("probe_dot", y)
    run(y, t, pat)
    return 0


if __name__ == "__main__":
    sys.exit(main())
