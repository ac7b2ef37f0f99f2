"""Interactive FGC SEI grain designer (capability port of the reference's
fgc-designer.py tool, D1-D4 in SURVEY.md section 2.5).

Port of the JAX package's designer/.  Unlike the reference tool, which
shells out to the ``vfgs`` binary for every preview (fgc-designer.py:877-885),
this designer calls the port's grain pipeline in-process, on the card unless
asked for the CPU, so previews are interactive-rate.

Headless-safe: importing this package pulls in neither Tk nor matplotlib; the
GUI only loads from :func:`versatilefilmgrain_tpu_torch.designer.app.main`.
"""

from .model import FgcSeiDesign
from .preview import read_yuv_frame, upsample_chroma, yuv_to_rgb

__all__ = ["FgcSeiDesign", "read_yuv_frame", "upsample_chroma", "yuv_to_rgb"]
