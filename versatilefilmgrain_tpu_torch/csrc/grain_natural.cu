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
// What bounds it on this card.  Bytes set the floor: a 3840x2160 10-bit
// 4:2:0 frame is 24,883,200 bytes, read once and written once, and every
// table stays on chip (the 32 KB pattern bank and the 512-byte LUT pair in
// shared memory, the lattice words, 4 bytes per 16x16 luma block, from L2).
// Above it sit the shared-memory and integer instructions: per pixel a
// pattern LUT read, a pattern read at a data-dependent address (bank
// conflicts follow the data), a scale LUT read and about a dozen integer
// operations, no one stage of them dominating (the per-stage budget,
// tools/probe_budget.py, splits the time).  So the design spends no
// instruction twice
// (grain_natural_body.cuh, K1's kernel): a thread owns 8 consecutive
// columns and walks the block row's lines, decodes its block's offsets
// once per block row, moves its pixels as one vector a line, and computes
// each pixel's grain sample once, the deblock taking an edge's neighbour
// samples from the lanes that computed them (warp shuffles; one extra
// sample at each end of a warp).
//
// The device code is in grain_natural_body.cuh, shared with the two probes
// that fork K1 (probe_budget.cu, probe_pipe.cu); this file instantiates it
// with no stage removed (kSkip = 0) and holds the C entry points.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_kernels.py does this at first use).

#include "grain_natural_body.cuh"

namespace {

using namespace vfg;

// Launch K1 for a sample type and a word input.
template <typename T>
int launch(const void* in, void* out, const uint32_t* words,
           const uint32_t* up0, int lane, const int8_t* p, const uint8_t* sl,
           const uint8_t* pl, const int* sc, int frames, int rows, int cols,
           const Plane& g, int zero_scale, int blend0, cudaStream_t st) {
  const T* i = static_cast<const T*>(in);
  T* o = static_cast<T*>(out);
  if (lane)
    return launch_grain_plane<T, true, 0>(i, o, words, up0, p, sl, pl, sc,
                                          frames, rows, cols, g, zero_scale,
                                          blend0, st);
  return launch_grain_plane<T, false, 0>(i, o, words, up0, p, sl, pl, sc,
                                         frames, rows, cols, g, zero_scale,
                                         blend0, st);
}

template <typename T>
int info(int lane, int* regs, int* smem, int* local, int* blocks) {
  return lane ? kernel_info(grain_plane_kernel<T, true, 0>, kThreads, regs,
                            smem, local, blocks)
              : kernel_info(grain_plane_kernel<T, false, 0>, kThreads, regs,
                            smem, local, blocks);
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
// pointers are device pointers; `in` and `out` aligned to 8 samples (a
// thread's run).  Launches on `stream` and returns cudaGetLastError(), or
// cudaErrorInvalidValue for an argument out of range or an unaligned plane.
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
    return launch<uint8_t>(in, out, w, u, lane, p, sl, pl, sc, frames, rows,
                           cols, g, zero_scale, blend0, st);
  return launch<uint16_t>(in, out, w, u, lane, p, sl, pl, sc, frames, rows,
                          cols, g, zero_scale, blend0, st);
}

// Registers per thread, static shared memory bytes per thread block, local
// memory bytes per thread (stack and spills) and thread blocks per SM (the
// occupancy calculator, at kThreads threads) of K1's instance for
// `elem_bytes` and `lane`.  Returns the first CUDA error, or cudaSuccess.
extern "C" int vfg_grain_plane_info(int elem_bytes, int lane, int* regs,
                                    int* smem, int* local, int* blocks) {
  if ((elem_bytes != 1 && elem_bytes != 2) || (lane != 0 && lane != 1))
    return int(cudaErrorInvalidValue);
  return elem_bytes == 1 ? info<uint8_t>(lane, regs, smem, local, blocks)
                         : info<uint16_t>(lane, regs, smem, local, blocks);
}
