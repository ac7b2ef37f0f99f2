// Film-grain blend for one plane of a batch of frames, written for Hopper
// (sm_90a).
//
// Replaces versatilefilmgrain_tpu/ops/grain_natural.py::_fused_pallas, the
// TPU kernel of the JAX package.  It computes the same integers, not the same
// way: the TPU kernel fetches pattern windows through a one-hot matrix
// product and carries the overlap rows from one grid step to the next.  Here
// each thread reads the pattern bank directly from shared memory and
// recomputes the upper block row's samples from that row's words.
//
// Two word inputs, as the TPU kernel's word modes:
//   lattice    (F, R, C) uint32 state words, one per block; the thread decodes
//              its block's offsets (the TPU kernel's block-granular modes);
//   lane words (F, R, C*bw) int32, one per column (its "stream" mode, made by
//              csrc/expand_words.cu or the plain expansion): t = w & 0x3FF,
//              oy = (t >> log2 KC) * ymul, ox + x%bw = t & (KC-1) with
//              KC = 16 * xmul, sign from bit 10.
// Shard boot (the TPU kernel's `boot`): a (frames x block rows) shard's first
// local row blends from an upper row passed in (`up0`, one row of words per
// frame) when `blend0` is set, as the TPU kernel's do_blend = r > 0 | blend0.
//
// What bounds it on this card: bytes.  A 3840x2160 10-bit 4:2:0 frame is
// 24,883,200 bytes, read once and written once; at the H100 SXM data-sheet
// 3.35 TB/s that is a computed ceiling of about 67k frames/s (arithmetic,
// not a measurement).  The design moves each pixel once in and once out and
// keeps every table on chip: the plane class's pattern bank (8 x 64 x 64
// int8, 32 KB) and the scale/pattern LUT pair (512 B) sit in static shared
// memory, the per-block lattice words (4 bytes per 16x16 luma block) come
// from L2.  Lane words add 4 bytes per column and block row (33 MB per 4K
// batch of 8 frames), read under the arithmetic: the kernel is bound by its
// integer instructions, and the lane decode is shorter than the lattice's.
//
// The device code (offset decode, grain sample, per-pixel body and the
// kernel) is in grain_natural_body.cuh, shared with the two probes that
// fork it (probe_budget.cu, probe_pipe.cu); this file instantiates it with
// no stage removed (kSkip = 0) and holds the C entry point.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_kernels.py does this at first use).

#include "grain_natural_body.cuh"

namespace {

using namespace vfg;

// Launch one kernel instance for a sample type and a word input.
template <typename T>
void launch(const void* in, void* out, const uint32_t* words,
            const uint32_t* up0, int lane, const int8_t* p, const uint8_t* sl,
            const uint8_t* pl, const int* sc, int frames, int rows, int cols,
            const Plane& g, int zero_scale, int blend0, cudaStream_t st) {
  const dim3 grid(unsigned(frames) * unsigned(rows));
  const T* i = static_cast<const T*>(in);
  T* o = static_cast<T*>(out);
  if (lane)
    grain_plane_kernel<T, true, 0><<<grid, kThreads, 0, st>>>(
        i, o, words, up0, p, sl, pl, sc, rows, cols, g, zero_scale, blend0);
  else
    grain_plane_kernel<T, false, 0><<<grid, kThreads, 0, st>>>(
        i, o, words, up0, p, sl, pl, sc, rows, cols, g, zero_scale, blend0);
}

}  // namespace

// Grain one plane of F frames.  `in`/`out`: (F, R*bh, C*bw) samples of
// `elem_bytes` bytes (1: uint8, 2: uint16); `words`: (F, R, C) uint32
// lattice words (`lane` 0) or (F, R, C*bw) int32 lane words (`lane` 1);
// `up0`: one row of words of the same kind per frame, the upper row of each
// frame's first block row, read only if `blend0` (else that row does not
// blend; may be null then); `pattern`: this plane class's (8, 64, 64) int8
// bank, 16-byte aligned; `slut`/`plut`: this component's 256-entry uint8
// LUTs; `scalars`: int32 [scale_shift, y_min, y_max, c_min, c_max].  All
// pointers are device pointers.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int vfg_grain_plane(const void* in, void* out, int elem_bytes,
                               const void* words, int lane, const void* up0,
                               int blend0, const void* pattern,
                               const void* slut, const void* plut,
                               const void* scalars, int frames, int rows,
                               int cols, int c, int csubx, int csuby, int bs,
                               int zero_scale, void* stream) {
  Plane g;
  if (frames < 1 || rows < 1 || cols < 1 ||
      !make_plane(c, csubx, csuby, bs, g) ||
      (elem_bytes != 1 && elem_bytes != 2) || (lane != 0 && lane != 1) ||
      (blend0 != 0 && blend0 != 1) || (blend0 && up0 == nullptr))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  const uint32_t* u = static_cast<const uint32_t*>(up0);
  const int8_t* p = static_cast<const int8_t*>(pattern);
  const uint8_t* sl = static_cast<const uint8_t*>(slut);
  const uint8_t* pl = static_cast<const uint8_t*>(plut);
  const int* sc = static_cast<const int*>(scalars);
  if (elem_bytes == 1)
    launch<uint8_t>(in, out, w, u, lane, p, sl, pl, sc, frames, rows, cols, g,
                    zero_scale, blend0, st);
  else
    launch<uint16_t>(in, out, w, u, lane, p, sl, pl, sc, frames, rows, cols,
                     g, zero_scale, blend0, st);
  return int(cudaGetLastError());
}
