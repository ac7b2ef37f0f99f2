"""End-to-end demo of the PyTorch + CUDA port: synthesize a test frame, add
film grain with the default FGC SEI config and an AFGS1 config, and save
before/after PNGs (needs matplotlib).  The twin of examples/demo.py.

Run:  python3 examples/demo_torch.py [outdir] [--device cuda|cpu]

``--device`` defaults to ``cuda`` and raises without a card; the PNGs go to
``build/demo_torch/`` of the checkout unless ``outdir`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from versatilefilmgrain_tpu_torch import GrainPipeline  # noqa: E402
from versatilefilmgrain_tpu_torch.designer.preview import \
    yuv_to_rgb  # noqa: E402


def make_test_frame(width: int, height: int):
    """10-bit 4:2:0 frame: horizontal luma ramp + smooth color field."""
    xs = np.linspace(64, 940, width)
    ys = np.linspace(0.8, 1.2, height)[:, None]
    y = np.clip(xs[None, :] * ys, 0, 1023).astype("<u2")
    cw, ch = width // 2, height // 2
    u = (512 + 300 * np.sin(np.linspace(0, 3, cw))[None, :]
         * np.cos(np.linspace(0, 2, ch))[:, None]).astype("<u2")
    v = (512 + 300 * np.cos(np.linspace(0, 2.5, cw))[None, :]
         * np.sin(np.linspace(0, 3.5, ch))[:, None]).astype("<u2")
    return y, u, v


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("outdir", nargs="?",
                    default=os.path.join(REPO, "build", "demo_torch"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="Device: cuda (raises without a card) or cpu "
                         "(plain torch engines)")
    args = ap.parse_args(argv)
    outdir = args.outdir
    os.makedirs(outdir, exist_ok=True)
    W, H = 640, 384
    planes = make_test_frame(W, H)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.image as mpimg

    mpimg.imsave(os.path.join(outdir, "clean.png"),
                 yuv_to_rgb(*planes, 10, 0))

    # Default FGC SEI frequency-filtering grain.
    pipe = GrainPipeline(W, H, 10, 0, device=args.device)
    grained = pipe.process_frame(planes, 0)
    mpimg.imsave(os.path.join(outdir, "sei_ff.png"),
                 yuv_to_rgb(*grained, 10, 0))

    # An AFGS1 auto-regressive config from the reference vectors, if present.
    cfg = os.path.join(REPO, "tests", "golden", "cfg", "fgs_afgs1_test1.cfg")
    if os.path.exists(cfg):
        pipe2 = GrainPipeline(W, H, 10, 0, configs=[cfg], device=args.device)
        grained2 = pipe2.process_frame(planes, 0)
        mpimg.imsave(os.path.join(outdir, "afgs1_ar.png"),
                     yuv_to_rgb(*grained2, 10, 0))

    print(f"wrote PNGs to {outdir} ({args.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
