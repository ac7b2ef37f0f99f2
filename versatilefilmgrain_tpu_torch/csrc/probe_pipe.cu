// Prefetch-pipeline probe of the grain kernel (K1), written for Hopper
// (sm_90a).
//
// Replaces tools/probe_ohpipe.py::_fused_pipe, the JAX package's probe that
// builds the next strip's one-hot while the current strip's matrix product
// runs.  The Hopper question is the same one in the card's terms: should a
// thread block walk many block rows instead of one?  K1 launches one thread
// block per (frame, block row), and each block stages the 32 KB pattern bank
// for its one row (1,080 blocks per 4K plane launch, about 106 MB of L2 to
// shared memory traffic per 8-frame step, computed).  This kernel computes
// exactly what K1 computes, with K1's own per-pixel code
// (grain_natural_body.cuh), in another schedule:
//
//   grid     a persistent grid, a few thread blocks per SM; each walks a
//            contiguous run of (frame, block row) strips;
//   staging  the pattern bank and the two LUTs once per thread block;
//   prefetch each strip is cut into tiles of 256 columns (a luma strip is
//            122,880 bytes); the next tile's pixels, with a 16-byte halo
//            on each side for the deblock, and at a strip's first tile that
//            strip's words and its upper row's, go to the second of two
//            shared-memory buffers by cp.async while the current tile is
//            computed;
//   compute  one thread per column of the tile, down the strip's bh lines,
//            reading pixels and words from shared memory and writing the
//            output to device memory.
// It does not carry the upper row's overlap samples from one strip to the
// next (the TPU kernel does): a strip's first tile would wait on the row
// above, and the recompute is what K1 does.
//
// uint16 samples and lattice words only.  Copies are 16 bytes where the
// input is 16-byte aligned, else 4 bytes (a template instance each).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_kernels.py does this at first use).

#include <cuda_pipeline_primitives.h>

#include "grain_natural_body.cuh"

namespace {

using namespace vfg;

constexpr int kTile = kThreads;            // columns of a tile, one a thread
constexpr int kHalo = 8;                   // staged columns on each side
constexpr int kTileW = kTile + 2 * kHalo;  // staged columns of a tile line

// Dynamic shared memory: bank, slut, plut, two pixel buffers of bh lines x
// kTileW samples, two word buffers of (upper row, own row) x C words.
size_t smem_bytes(int bh, int C) {
  return size_t(kPatternBytes) + 512 + size_t(2) * bh * kTileW * 2 +
         size_t(2) * 2 * C * 4;
}

template <int kCopy>
__global__ void __launch_bounds__(kThreads)
pipe_plane_kernel(const uint16_t* __restrict__ in, uint16_t* __restrict__ out,
                  const uint32_t* __restrict__ words,
                  const int8_t* __restrict__ pattern,
                  const uint8_t* __restrict__ slut,
                  const uint8_t* __restrict__ plut,
                  const int* __restrict__ scalars, int G, int R, int C,
                  Plane g, int zero_scale) {
  constexpr int kElems = kCopy / 2;          // samples per copy
  constexpr int kChunks = kTileW / kElems;   // copies per staged line
  extern __shared__ __align__(16) unsigned char smem[];
  const int Wp = C * g.bw;
  const int imin = __ldg(scalars + (g.c ? 3 : 1)) << g.bs;
  const int imax = __ldg(scalars + (g.c ? 4 : 2)) << g.bs;
  // This thread block's strips: [s0, s1) of the G = F * R strips.
  const int s0 = int((long long)blockIdx.x * G / gridDim.x);
  const int s1 = int((long long)(blockIdx.x + 1) * G / gridDim.x);

  if (zero_scale) {  // clip only, as K1
    for (int s = s0; s < s1; ++s) {
      const size_t base = size_t(s) * g.bh * Wp;
      for (int k = threadIdx.x; k < g.bh * Wp; k += kThreads)
        out[base + k] = uint16_t(min(max(int(in[base + k]), imin), imax));
    }
    return;
  }

  int8_t* s_pat = reinterpret_cast<int8_t*>(smem);
  uint8_t* s_slut = reinterpret_cast<uint8_t*>(smem + kPatternBytes);
  uint8_t* s_plut = s_slut + 256;
  uint16_t* s_pix = reinterpret_cast<uint16_t*>(smem + kPatternBytes + 512);
  uint32_t* s_words = reinterpret_cast<uint32_t*>(s_pix + 2 * g.bh * kTileW);

  const int4* src = reinterpret_cast<const int4*>(pattern);
  int4* dst = reinterpret_cast<int4*>(s_pat);
  for (int k = threadIdx.x; k < kPatternBytes / 16; k += kThreads)
    dst[k] = __ldg(src + k);
  s_slut[threadIdx.x] = slut[threadIdx.x];
  s_plut[threadIdx.x] = plut[threadIdx.x];

  const int ss = __ldg(scalars);
  const int bias = 1 << (ss - 1);
  const int nt = (Wp + kTile - 1) / kTile;  // tiles per strip
  const int n_items = (s1 - s0) * nt;  // item i: strip s0 + i/nt, tile i%nt

  // Start the copies of item i into pixel buffer i & 1 (and, at a strip's
  // first tile, word buffer (strip - s0) & 1).  Halo copies outside the
  // plane are skipped: the deblock never reads past the plane's edge.
  auto issue = [&](int i) {
    const int s = s0 + i / nt;
    const int x0 = (i % nt) * kTile;
    uint16_t* pd = s_pix + (i & 1) * g.bh * kTileW;
    const uint16_t* ps = in + size_t(s) * g.bh * Wp;
    for (int k = threadIdx.x; k < g.bh * kChunks; k += kThreads) {
      const int j = k / kChunks;
      const int q = k - j * kChunks;
      const int xc = x0 - kHalo + q * kElems;
      if (xc >= 0 && xc + kElems <= Wp)
        __pipeline_memcpy_async(pd + j * kTileW + q * kElems,
                                ps + size_t(j) * Wp + xc, kCopy);
    }
    if (x0 == 0) {
      uint32_t* wd = s_words + ((s - s0) & 1) * 2 * C;
      const uint32_t* ws = words + size_t(s) * C - C;  // the upper row
      const bool has_up = s % R > 0;
      for (int k = threadIdx.x; k < 2 * C; k += kThreads)
        if (k >= C || has_up) __pipeline_memcpy_async(wd + k, ws + k, 4);
    }
  };

  if (n_items > 0) issue(0);
  __pipeline_commit();
  for (int i = 0; i < n_items; ++i) {
    if (i + 1 < n_items) issue(i + 1);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // item i has landed (this thread's copies)
    __syncthreads();           // ... and every thread's; the bank too
    const int s = s0 + i / nt;
    const int x0 = (i % nt) * kTile;
    const int x = x0 + threadIdx.x;
    const uint32_t* lrow = s_words + ((s - s0) & 1) * 2 * C + C;
    const uint32_t* up = s % R > 0 ? lrow - C : nullptr;
    if (x < Wp) {
      const uint16_t* tile = s_pix + (i & 1) * g.bh * kTileW - (x0 - kHalo);
      uint16_t* o = out + size_t(s) * g.bh * Wp + x;
      for (int j = 0; j < g.bh; ++j)
        o[size_t(j) * Wp] = grain_pixel<0, false, SharedWords>(
            tile + j * kTileW, lrow, up, s_pat, s_slut, s_plut, x, j, Wp,
            bias, ss, imin, imax, g);
    }
    __syncthreads();  // buffers i & 1 are free for item i + 2
  }
}

template <int kCopy>
int launch(const uint16_t* in, uint16_t* out, const uint32_t* words,
           const int8_t* p, const uint8_t* sl, const uint8_t* pl,
           const int* sc, int G, int rows, int cols, const Plane& g,
           int zero_scale, int blocks, cudaStream_t st) {
  const size_t smem = smem_bytes(g.bh, cols);
  cudaError_t e = cudaFuncSetAttribute(
      pipe_plane_kernel<kCopy>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (e != cudaSuccess) return int(e);
  pipe_plane_kernel<kCopy><<<blocks, kThreads, smem, st>>>(
      in, out, words, p, sl, pl, sc, G, rows, cols, g, zero_scale);
  return int(cudaGetLastError());
}

}  // namespace

// Grain one plane of F frames, as vfg_grain_plane does for uint16 samples
// and lattice words (same arguments), on a persistent grid of at most
// `blocks_per_sm` thread blocks per SM; the strips are split evenly, so the
// grid is the fewest blocks that give each the same largest share.  `in`
// must be 4-byte aligned (16-byte for the 16-byte copies).  Launches on
// `stream` and returns the first CUDA error, or cudaSuccess.
extern "C" int vfg_probe_pipe(const void* in, void* out, const void* words,
                              const void* pattern, const void* slut,
                              const void* plut, const void* scalars,
                              int frames, int rows, int cols, int c,
                              int csubx, int csuby, int bs, int zero_scale,
                              int blocks_per_sm, void* stream) {
  Plane g;
  const uintptr_t a = reinterpret_cast<uintptr_t>(in);
  if (frames < 1 || rows < 1 || cols < 1 ||
      !make_plane(c, csubx, csuby, bs, g) || blocks_per_sm < 1 ||
      blocks_per_sm > 32 || a % 4)
    return int(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return int(e);
  const int G = frames * rows;
  const int most = blocks_per_sm * sms;
  const int per = (G + most - 1) / most;  // largest share of strips
  const int blocks = (G + per - 1) / per;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint16_t* i = static_cast<const uint16_t*>(in);
  uint16_t* o = static_cast<uint16_t*>(out);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  const int8_t* p = static_cast<const int8_t*>(pattern);
  const uint8_t* sl = static_cast<const uint8_t*>(slut);
  const uint8_t* pl = static_cast<const uint8_t*>(plut);
  const int* sc = static_cast<const int*>(scalars);
  if (a % 16 == 0)
    return launch<16>(i, o, w, p, sl, pl, sc, G, rows, cols, g, zero_scale,
                      blocks, st);
  return launch<4>(i, o, w, p, sl, pl, sc, G, rows, cols, g, zero_scale,
                   blocks, st);
}
