"""Film grain synthesis engine (VFGS capability parity) in PyTorch + CUDA.

The port of the JAX package ``versatilefilmgrain_tpu`` to PyTorch on an
NVIDIA Hopper GPU: FGC SEI (frequency-filtering + auto-regressive) and AFGS1
metadata drive a sample-adapted grain blending engine, vectorized over whole
frames with GF(2) LFSR jump-ahead replacing the reference's serial PRNG.  The
grain step is a hand-written CUDA kernel (csrc/grain_natural.cu) with a plain
torch version beside it.  Bit-exact with the C model.
"""

from .pipeline import GrainPipeline
from .models.hw import HwRegs
from .models import config as fgs_config

__version__ = "0.1.0"
__all__ = ["GrainPipeline", "HwRegs", "fgs_config"]
