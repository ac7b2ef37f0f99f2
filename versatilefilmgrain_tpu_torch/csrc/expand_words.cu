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
// 0.01 ms (arithmetic, not a measurement).  The design writes 16 bytes per
// thread and iteration (four lanes of one block, since bw >= 8 and four lanes
// start on a multiple of 4), neighbouring threads on neighbouring addresses;
// each block word is read by bw/4 threads, from L1/L2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_kernels.py does this at first use).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 132 * 16;  // then grid-stride

struct Planes {
  const int* in[3];  // (rows, cols) block words
  int4* out[3];      // (rows, cols * bw) lane words, as int4 quads
  int cols[3];
  int lbw[3];        // log2(bw)
  unsigned quads[3]; // rows * cols * bw / 4
};

// Entry k of a parameter array, by selects: indexing it with a runtime k
// would copy the whole parameter struct to local memory.
template <typename V>
__device__ __forceinline__ V pick(const V (&a)[3], int k) {
  return k == 0 ? a[0] : (k == 1 ? a[1] : a[2]);
}

// grid.y = plane; threads stride over the plane's quads of lanes.
__global__ void __launch_bounds__(kThreads)
expand_words_kernel(Planes p) {
  const int k = blockIdx.y;
  const int* __restrict__ in = pick(p.in, k);
  int4* __restrict__ out = pick(p.out, k);
  const int cols = pick(p.cols, k);
  const int lbw = pick(p.lbw, k);
  const unsigned wq = unsigned(cols) << (lbw - 2);  // quads per row
  const unsigned n = pick(p.quads, k);
  for (unsigned q = blockIdx.x * kThreads + threadIdx.x; q < n;
       q += gridDim.x * kThreads) {
    const unsigned row = q / wq;
    const unsigned x = (q - row * wq) << 2;  // first lane of the quad
    const int w = __ldg(in + size_t(row) * cols + (x >> lbw)) +
                  int(x & ((1u << lbw) - 1));
    out[q] = make_int4(w, w + 1, w + 2, w + 3);
  }
}

}  // namespace

// Expand `planes` (1-3) planes of block words.  Plane k: `in_k` (rows, cols_k)
// int32 block words, `out_k` (rows, cols_k * bw_k) int32 lane words, 16-byte
// aligned, bw_k 8 or 16; `rows` = frames * block rows.  Unused planes pass
// null pointers and zeros.  All pointers are device pointers.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int vfg_expand_words(int planes, int rows, const void* in0,
                                void* out0, int cols0, int bw0,
                                const void* in1, void* out1, int cols1,
                                int bw1, const void* in2, void* out2,
                                int cols2, int bw2, void* stream) {
  if (planes < 1 || planes > 3 || rows < 1) return int(cudaErrorInvalidValue);
  const void* ins[3] = {in0, in1, in2};
  void* outs[3] = {out0, out1, out2};
  const int cols[3] = {cols0, cols1, cols2};
  const int bws[3] = {bw0, bw1, bw2};
  Planes p = {};
  unsigned most = 0;
  for (int k = 0; k < planes; ++k) {
    const unsigned long long quads =
        (unsigned long long)rows * (unsigned long long)cols[k] * bws[k] / 4;
    if (ins[k] == nullptr || outs[k] == nullptr || cols[k] < 1 ||
        (bws[k] != 8 && bws[k] != 16) || quads >= (1ull << 31) ||
        reinterpret_cast<uintptr_t>(outs[k]) % 16)
      return int(cudaErrorInvalidValue);
    p.in[k] = static_cast<const int*>(ins[k]);
    p.out[k] = static_cast<int4*>(outs[k]);
    p.cols[k] = cols[k];
    p.lbw[k] = bws[k] == 8 ? 3 : 4;
    p.quads[k] = unsigned(quads);
    most = quads > most ? unsigned(quads) : most;
  }
  unsigned blocks = (most + kThreads - 1) / kThreads;
  blocks = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  const dim3 grid(blocks, unsigned(planes));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  expand_words_kernel<<<grid, kThreads, 0, st>>>(p);
  return int(cudaGetLastError());
}
