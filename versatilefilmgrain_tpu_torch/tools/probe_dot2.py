"""Building the one-hot against multiplying by it (K7) on the card.

Port of the JAX package's tools/probe_dot2.py.  Modes of csrc/probe_dot.cu
at an 8-frame 3840x2160 uint16 plane:
  none      the strip copy alone;
  int8      K6's one-hot product on the tensor cores;
  build     the int8 mode's one-hot fragments built over every K step, no
            product: the 8 row slices 96q .. 96q + 15 summed, as the TPU
            build mode does (what the compiler keeps of the build is in the
            kernel's source note);
  dotconst  the dense int8 product against a constant (768, W) 0/1 matrix
            (about 25% ones), recomputed for every block row.
Each mode is held exactly against its plain version.

Run on the card from the repo root:
  python -m versatilefilmgrain_tpu_torch.tools.probe_dot2
"""

from __future__ import annotations

import sys

from . import _dot
from . import _harness as hz

MODES = ("none", "int8", "build", "dotconst")


def run(y, t, pat, constoh) -> dict:
    """Time and check every mode at ``y``'s shape on the card; prints and
    returns {mode: {"ms", "bound_ms", "bound_by", "exact"}}."""
    cases = {}
    for mode in MODES:
        args = (t, pat, constoh)
        cases[mode] = (_dot.make_step(mode, *args),
                       _dot.plain(mode, y, *args),
                       _dot.bound(mode, y, *args))
    print("probe_dot2 (K7): one-hot build without a dot, and a dense int8 "
          "dot against a constant matrix", flush=True)
    return hz.run_modes(cases, y)


def main(argv=None) -> int:
    if hz.no_card("probe_dot2"):
        return 2
    y, t, pat, constoh = _dot.dot2_inputs(0, device="cuda")
    hz.header("probe_dot2", y)
    run(y, t, pat, constoh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
