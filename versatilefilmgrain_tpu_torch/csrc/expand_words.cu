// Block words -> lane words for up to three planes in one launch, written for
// Hopper (sm_90a).
//
// Replaces versatilefilmgrain_tpu/ops/grain_natural.py::_expand_words_pallas,
// the TPU kernel of the JAX package.  Both compute, for every plane p and
// every (frame, block row) fr,
//   lane[fr, x] = blk[fr, x >> log2(bw_p)] + (x & (bw_p - 1)),
// the per-column words that csrc/grain_natural.cu reads in its lane-word
// input.  The TPU kernel realises the gather with a butterfly of lane rolls,
// because the TPU has no lane gather; a Hopper thread reads its block word
// directly, so there is no butterfly here.
//
// What bounds it on this card: bytes written.  At 3840x2160 4:2:0, 8 frames,
// the three planes' lane words are 33.2 MB out and 1.0 MB of block words in;
// at the H100 SXM data-sheet 3.35 TB/s that is a computed floor of about
// 0.0108 ms (arithmetic, not a measurement), so launch and ramp are a large
// share of the time.  The design:
//   - 2-D indexing, no division: a thread block takes block rows (grid.x,
//     then strides of gridDim.x; grid.y is the plane), a warp 32 block words
//     of its row (threadIdx), a lane one word;
//   - each lane reads its word once and the warp writes the 32 words' lanes
//     as bw / 4 rounds of one 16-byte store a lane (4 lanes of one block,
//     since bw >= 8), neighbouring lanes on neighbouring addresses: a
//     round's value comes from the lane that read the word, by a shuffle;
//   - a grid of about one wave (the wrapper's expand_words_plan), so every
//     block is resident from the start and none waits for a slot;
//   - plain write-back stores, no streaming hint: the 33.2 MB of lane words
//     fit in the 50 MB L2, where K1's lane-word instance reads them next.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_kernels.py does this at first use).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWords = kThreads;  // block words a thread block takes per pass

struct Planes {
  const int* in[3];  // (rows, cols) block words
  int4* out[3];      // (rows, cols * bw) lane words, as int4 quads
  int cols[3];
  int lbw[3];        // log2(bw)
};

// Entry k of a parameter array, by selects: indexing it with a runtime k
// would copy the whole parameter struct to local memory.
template <typename V>
__device__ __forceinline__ V pick(const V (&a)[3], int k) {
  return k == 0 ? a[0] : (k == 1 ? a[1] : a[2]);
}

// One plane's rows blockIdx.x, blockIdx.x + gridDim.x, ...: lane words of
// block width 1 << kLbw, kQ quads a block word.
template <int kLbw>
__device__ __forceinline__ void expand_plane(const int* __restrict__ in,
                                             int4* __restrict__ out,
                                             int rows, int cols) {
  constexpr int kQ = (1 << kLbw) / 4;
  constexpr int kLq = kLbw - 2;  // log2(kQ)
  const int lane = threadIdx.x & 31;
  const int w0 = threadIdx.x - lane;  // the warp's first word in a pass
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int* src = in + size_t(row) * cols;
    int4* dst = out + size_t(row) * cols * kQ;
    for (int b0 = w0; b0 < cols; b0 += kWords) {
      const int w = b0 + lane < cols ? __ldg(src + b0 + lane) : 0;
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        const int q = k * 32 + lane;  // the warp's quad: word q / kQ
        const int v = __shfl_sync(0xFFFFFFFFu, w, q >> kLq) +
                      ((q & (kQ - 1)) << 2);
        if (b0 + (q >> kLq) < cols)
          dst[b0 * kQ + q] = make_int4(v, v + 1, v + 2, v + 3);
      }
    }
  }
}

// grid.y = plane, grid.x = row blocks.
__global__ void __launch_bounds__(kThreads)
expand_words_kernel(Planes p, int rows) {
  const int k = blockIdx.y;
  const int* in = pick(p.in, k);
  int4* out = pick(p.out, k);
  const int cols = pick(p.cols, k);
  if (pick(p.lbw, k) == 4)
    expand_plane<4>(in, out, rows, cols);
  else
    expand_plane<3>(in, out, rows, cols);
}

}  // namespace

// Expand `planes` (1-3) planes of block words.  Plane k: `in_k` (rows, cols_k)
// int32 block words, `out_k` (rows, cols_k * bw_k) int32 lane words, 16-byte
// aligned, bw_k 8 or 16; `rows` = frames * block rows; `row_blocks` thread
// blocks a plane (grid.x, 1..rows).  Unused planes pass null pointers and
// zeros.  All pointers are device pointers.  Launches on `stream` and
// returns cudaGetLastError(), or cudaErrorInvalidValue for an argument out
// of range.
extern "C" int vfg_expand_words(int planes, int rows, int row_blocks,
                                const void* in0, void* out0, int cols0,
                                int bw0, const void* in1, void* out1,
                                int cols1, int bw1, const void* in2,
                                void* out2, int cols2, int bw2,
                                void* stream) {
  if (planes < 1 || planes > 3 || rows < 1 || row_blocks < 1 ||
      row_blocks > rows)
    return int(cudaErrorInvalidValue);
  const void* ins[3] = {in0, in1, in2};
  void* outs[3] = {out0, out1, out2};
  const int cols[3] = {cols0, cols1, cols2};
  const int bws[3] = {bw0, bw1, bw2};
  Planes p = {};
  for (int k = 0; k < planes; ++k) {
    if (ins[k] == nullptr || outs[k] == nullptr || cols[k] < 1 ||
        (bws[k] != 8 && bws[k] != 16) ||
        (long long)cols[k] * bws[k] / 4 * rows >= (1ll << 31) ||
        reinterpret_cast<uintptr_t>(outs[k]) % 16)
      return int(cudaErrorInvalidValue);
    p.in[k] = static_cast<const int*>(ins[k]);
    p.out[k] = static_cast<int4*>(outs[k]);
    p.cols[k] = cols[k];
    p.lbw[k] = bws[k] == 8 ? 3 : 4;
  }
  const dim3 grid{unsigned(row_blocks), unsigned(planes), 1u};
  expand_words_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, rows);
  return int(cudaGetLastError());
}
