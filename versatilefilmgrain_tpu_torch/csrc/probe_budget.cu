// Per-stage budget probe of the grain kernel (K1), written for Hopper
// (sm_90a).
//
// Replaces tools/probe_budget.py::_fused_abl, the JAX package's ablation
// probe of its TPU kernel: the same kernel with one stage removed at a time,
// timed against the whole kernel, so that the differences split K1's time
// by stage.  Here the kernel is K1's own device code (grain_natural_body.cuh)
// instantiated once for each stage mask the probe runs, uint16 samples and
// lattice words only (the headline shape, 10-bit 4:2:0).  Each variant's
// output is wrong on purpose and deterministic; tools/probe_budget.py holds
// each against a plain torch version of the same ablation.
//
// What bounds it: what bounds K1 (its integer instructions); a variant runs
// faster by what its stage costs, and a stage whose removal saves nothing is
// hidden under the others.  The TPU probe's "reorder" variant interleaves
// matrix-unit and vector work; K1 has no matrix unit to overlap, so it has
// no counterpart here.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_kernels.py does this at first use).

#include "grain_natural_body.cuh"

namespace {

using namespace vfg;

template <int kSkip>
int launch(const uint16_t* in, uint16_t* out, const uint32_t* words,
           const int8_t* p, const uint8_t* sl, const uint8_t* pl,
           const int* sc, int frames, int rows, int cols, const Plane& g,
           int zero_scale, cudaStream_t st) {
  return launch_grain_plane<uint16_t, false, kSkip>(
      in, out, words, nullptr, p, sl, pl, sc, frames, rows, cols, g,
      zero_scale, 0, st);
}

}  // namespace

// One plane of F frames through the variant with stage mask `skip` (0 or
// one bit of grain_natural_body.cuh's kNo* mask).  `in`/`out`: (F, R*bh,
// C*bw) uint16; `words`: (F, R, C) uint32 lattice words; `pattern`,
// `slut`, `plut`, `scalars`, `zero_scale` as vfg_grain_plane takes them;
// `pat_mask`: n_pat - 1 of the plane class, kNoLut's pattern index mask.
// All pointers are device pointers.  Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a mask that is not built.
extern "C" int vfg_probe_budget(const void* in, void* out, const void* words,
                                const void* pattern, const void* slut,
                                const void* plut, const void* scalars,
                                int frames, int rows, int cols, int c,
                                int csubx, int csuby, int bs, int zero_scale,
                                int pat_mask, int skip, void* stream) {
  Plane g;
  if (frames < 1 || rows < 1 || cols < 1 ||
      !make_plane(c, csubx, csuby, bs, g) || pat_mask < 0 || pat_mask > 7)
    return int(cudaErrorInvalidValue);
  g.pat_mask = pat_mask;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint16_t* i = static_cast<const uint16_t*>(in);
  uint16_t* o = static_cast<uint16_t*>(out);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  const int8_t* p = static_cast<const int8_t*>(pattern);
  const uint8_t* sl = static_cast<const uint8_t*>(slut);
  const uint8_t* pl = static_cast<const uint8_t*>(plut);
  const int* sc = static_cast<const int*>(scalars);
#define VFG_VARIANT(M)                                              \
  case M:                                                           \
    return launch<M>(i, o, w, p, sl, pl, sc, frames, rows, cols, g, \
                     zero_scale, st);
  switch (skip) {
    VFG_VARIANT(0)
    VFG_VARIANT(kNoLut)
    VFG_VARIANT(kNoBlend)
    VFG_VARIANT(kNoDeblock)
    VFG_VARIANT(kNoEpilogue)
    VFG_VARIANT(kNoSelect)
    VFG_VARIANT(kNoFetch)
    VFG_VARIANT(kNoStage)
    default:
      return int(cudaErrorInvalidValue);
  }
#undef VFG_VARIANT
}
