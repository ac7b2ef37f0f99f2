"""How the dense int8 product scales with M (K8) on the card.

Port of the JAX package's tools/probe_dotscale.py.  For M in 16, 64, 128,
144, 160 and 256: pat(M x 768 int8) @ oh(768 x 3840, 50% ones) on the
tensor cores (csrc/probe_dot.cu, dotconst), recomputed for every block row
of an 8-frame 3840x2160 uint16 plane, all M/16 row slices summed, clip
4095.  Each M is held exactly against its plain version.

Run on the card from the repo root:
  python -m versatilefilmgrain_tpu_torch.tools.probe_dotscale
"""

from __future__ import annotations

import sys

from . import _dot
from . import _harness as hz


def run(y, oh, pats: dict) -> dict:
    """Time and check the product for every (M, pat) in ``pats`` at ``y``'s
    shape on the card; prints and returns {"M=<m>": {"ms", "bound_ms",
    "bound_by", "exact"}}."""
    cases = {}
    for m, pat in pats.items():
        kw = dict(clip_hi=_dot.CLIP_HI_SCALE, rows=_dot.scale_rows(m))
        cases[f"M={m}"] = (_dot.make_step("dotconst", None, pat, oh, **kw),
                           _dot.dotconst_plain(y, pat, oh, **kw),
                           _dot.bound("dotconst", y, None, pat, oh))
    print("probe_dotscale (K8): pat(Mx768) @ oh(768xW) per block row, M/16 "
          "row slices summed, clip 4095", flush=True)
    return hz.run_modes(cases, y)


def main(argv=None) -> int:
    if hz.no_card("probe_dotscale"):
        return 2
    y, oh, pats = _dot.dotscale_inputs(0, device="cuda")
    hz.header("probe_dotscale", y)
    run(y, oh, pats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
