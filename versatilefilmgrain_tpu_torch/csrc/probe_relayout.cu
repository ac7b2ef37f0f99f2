// The relayout probes of the tiled engine's layout, written for Hopper
// (sm_90a): one source, one template instance per form.
//
// Replaces the kernels of two TPU probes of tools/ (each run by its `main`):
//   K9  tools/probe_relayout.py    _passthrough_kernel :37, _relayout_kernel
//                                  :41, _relayout_rows_kernel :49 (rchunk 5
//                                  and 15 block rows per grid step)
//   K10 tools/probe_relayout5d.py  _kernel_5d_notr :50, _kernel_5d :40
// Every form writes out = y ^ 1 on a (F, 16R, W) uint16 plane, W = 16C.  The
// relayout forms take each block row's natural (16, W) strip into the tiled
// (256, C) layout of the tiled engine -- natural (line, 16c + x) is tiled
// (16 line + x, c) -- XOR there, and take it back.
//
// K10 reaches the same instances.  Its plane is the (F, R, 16, C, 16) view
// of the natural plane: on Hopper that is the same memory with other strides
// (a torch `view`, no copy), and _kernel_5d's transpose (16, C, 16) ->
// (16, 16, C) -> (256, C) is, element for element, _relayout_kernel's.  So
// _kernel_5d_notr is the passthrough instance and _kernel_5d the rchunk-1
// relayout instance, launched through the same entry point.
//
// What bounds it on this card (computed from the H100 SXM data sheet, not
// measured): y in and out, 265.4 MB per 8-frame 3840x2160 step, 0.0792 ms at
// 3.35 TB/s.  There is no arithmetic to speak of.
//
// Design.  passthrough: a grid-stride pass of 16-byte loads and stores over
// one wave of resident thread blocks, each 32-bit lane XORed with 0x00010001.
// relayout: a thread block of 1024 threads takes kRchunk block rows of one
// frame, one after another (grid: R / kRchunk x F).  For each strip it
//   1. loads the (16, W) strip with 16-byte loads, coalesced, all of a
//      thread's loads (8 at W = 3840) in flight before the first store;
//   2. stores each of a vector's 8 values into the tiled array in shared
//      memory, tiled row 16 line + x, column c;
//   3. after a barrier, XORs the tiled array row by row, 32 bits at a time
//      (the pad word of each row too; it is never read back);
//   4. after a barrier, gathers the 8 values of each natural vector from 8
//      tiled rows and stores the vector, coalesced; a last barrier guards
//      the array against the next strip's stores.
// The barriers and the exchange between threads keep the compiler from
// folding the transpose away (chip_smoke.py phase 20 prints the instance's
// LDS, STS and BAR counts).  The tiled array holds a whole strip: 256 rows
// of C values, padded to an odd count of 32-bit words a row (C + 2 = 242
// values, 121 words at W = 3840, 123,904 bytes), so that the 16 rows one
// warp's 2-byte stores and loads hit fall in 16 different banks.  That needs
// the dynamic shared-memory opt-in and leaves one thread block per SM, so
// rchunk sets the grid against the 132 SMs: 1080 thread blocks at 1, 216 at
// 5, 72 at 15 for 8 frames of 4K.  (On the TPU rchunk set the VMEM block.)
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_kernels.py does this at first use).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;       // relayout thread block
constexpr int kPassThreads = 256;    // passthrough thread block
constexpr int kPer = 8;              // 16-byte vectors a thread holds
constexpr unsigned kXor = 0x00010001u;

enum Mode { kPassthrough = 0, kRelayout = 1 };

// 32-bit words a tiled row takes: enough for C values, an odd count.
__host__ __device__ __forceinline__ int tiled_words(int cols) {
  return ((cols + 1) / 2) | 1;
}

size_t smem_bytes(int width) {
  return size_t(256) * tiled_words(width / 16) * 4;
}

__global__ void __launch_bounds__(kPassThreads)
passthrough_kernel(const uint4* __restrict__ y, uint4* __restrict__ out,
                   size_t n) {
  const size_t stride = size_t(gridDim.x) * kPassThreads;
  for (size_t i = size_t(blockIdx.x) * kPassThreads + threadIdx.x; i < n;
       i += stride) {
    uint4 v = __ldg(y + i);
    v.x ^= kXor;
    v.y ^= kXor;
    v.z ^= kXor;
    v.w ^= kXor;
    out[i] = v;
  }
}

template <int kRchunk>
__global__ void __launch_bounds__(kThreads)
relayout_kernel(const unsigned short* __restrict__ y,
                unsigned short* __restrict__ out, int rows, int width) {
  extern __shared__ __align__(16) unsigned tiled[];  // 256 x sw words
  unsigned short* t16 = reinterpret_cast<unsigned short*>(tiled);
  const int sw = tiled_words(width / 16), s16 = 2 * sw;
  const int vecs = 2 * width;  // 16-byte vectors of a (16, W) strip

#pragma unroll 1
  for (int k = 0; k < kRchunk; ++k) {
    const size_t strip =
        size_t(blockIdx.y) * rows + size_t(blockIdx.x) * kRchunk + k;
    const uint4* src = reinterpret_cast<const uint4*>(y + strip * 16 * width);
    uint4* dst = reinterpret_cast<uint4*>(out + strip * 16 * width);

    // 1-2. natural (line, 16c + x) -> tiled (16 line + x, c)
    for (int base = 0; base < vecs; base += kThreads * kPer) {
      uint4 v[kPer];
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = base + u * kThreads + threadIdx.x;
        if (i < vecs) v[u] = __ldg(src + i);
      }
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int i = base + u * kThreads + threadIdx.x;
        if (i < vecs) {
          const int line = (8 * i) / width, w = 8 * i - line * width;
          unsigned short* tp = t16 + (16 * line + (w & 15)) * s16 + (w >> 4);
          const unsigned words[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            tp[(2 * j) * s16] = static_cast<unsigned short>(words[j]);
            tp[(2 * j + 1) * s16] = static_cast<unsigned short>(words[j] >> 16);
          }
        }
      }
    }
    __syncthreads();

    // 3. the XOR, walking the tiled rows
    for (int i = threadIdx.x; i < 256 * sw; i += kThreads) tiled[i] ^= kXor;
    __syncthreads();

    // 4. tiled -> natural
    for (int i = threadIdx.x; i < vecs; i += kThreads) {
      const int line = (8 * i) / width, w = 8 * i - line * width;
      const unsigned short* tp =
          t16 + (16 * line + (w & 15)) * s16 + (w >> 4);
      unsigned words[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        words[j] = unsigned(tp[(2 * j) * s16]) |
                   (unsigned(tp[(2 * j + 1) * s16]) << 16);
      dst[i] = make_uint4(words[0], words[1], words[2], words[3]);
    }
    __syncthreads();
  }
}

// Dynamic shared memory for relayout_kernel<kRchunk> at `bytes`, opted in
// once per size grown to.
template <int kRchunk>
int configure(size_t bytes) {
  static size_t configured = 48 * 1024;
  if (bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        relayout_kernel<kRchunk>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    if (e != cudaSuccess) return int(e);
    configured = bytes;
  }
  return 0;
}

template <int kRchunk>
int launch_relayout(const void* y, void* out, int frames, int rows,
                    int width, cudaStream_t st) {
  const size_t smem = smem_bytes(width);
  const int rc = configure<kRchunk>(smem);
  if (rc != 0) return rc;
  const dim3 grid(rows / kRchunk, frames);
  relayout_kernel<kRchunk><<<grid, kThreads, smem, st>>>(
      static_cast<const unsigned short*>(y),
      static_cast<unsigned short*>(out), rows, width);
  return int(cudaGetLastError());
}

template <int kRchunk>
int occupancy_relayout(int width, int* smem, int* blocks) {
  const size_t bytes = smem_bytes(width);
  const int rc = configure<kRchunk>(bytes);
  if (rc != 0) return rc;
  *smem = int(bytes);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, relayout_kernel<kRchunk>, kThreads, bytes));
}

int sm_count(int* sms) {
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return int(e);
  return int(cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                    dev));
}

bool valid(int mode, int rchunk, int rows, int width) {
  if (width < 16 || width % 16 || rows < 1) return false;
  if (mode == kPassthrough) return rchunk == 1;
  return mode == kRelayout && (rchunk == 1 || rchunk == 5 || rchunk == 15) &&
         rows % rchunk == 0;
}

}  // namespace

// One probe step, out = y ^ 1.  `y`, `out`: (frames, 16 rows, width) uint16
// device pointers, 16-byte aligned, width a multiple of 16.  Modes: 0
// passthrough (rchunk 1), 1 relayout through the tiled (256, width / 16)
// layout in shared memory, `rchunk` (1, 5 or 15, dividing rows) block rows
// per thread block.  Launches on `stream` and returns cudaGetLastError().
extern "C" int vfg_probe_relayout(int mode, int rchunk, const void* y,
                                  void* out, int frames, int rows, int width,
                                  void* stream) {
  if (y == nullptr || out == nullptr || frames < 1 || frames > 65535 ||
      !valid(mode, rchunk, rows, width) ||
      reinterpret_cast<uintptr_t>(y) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == kPassthrough) {
    static int sms = 0;
    if (sms == 0) {
      const int rc = sm_count(&sms);
      if (rc != 0) return rc;
    }
    const size_t n = size_t(frames) * rows * 16 * width / 8;
    const size_t want = (n + kPassThreads - 1) / kPassThreads;
    const size_t wave = size_t(sms) * (2048 / kPassThreads);
    passthrough_kernel<<<unsigned(want < wave ? want : wave), kPassThreads,
                         0, st>>>(static_cast<const uint4*>(y),
                                  static_cast<uint4*>(out), n);
    return int(cudaGetLastError());
  }
  switch (rchunk) {
    case 1: return launch_relayout<1>(y, out, frames, rows, width, st);
    case 5: return launch_relayout<5>(y, out, frames, rows, width, st);
    case 15: return launch_relayout<15>(y, out, frames, rows, width, st);
    default: return int(cudaErrorInvalidValue);
  }
}

// The launch shape of a mode at `width`: dynamic shared memory per thread
// block (bytes) and thread blocks resident per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Returns a CUDA error.
extern "C" int vfg_probe_relayout_info(int mode, int rchunk, int width,
                                       int* smem, int* blocks_per_sm) {
  if (smem == nullptr || blocks_per_sm == nullptr ||
      !valid(mode, rchunk, 15, width))
    return int(cudaErrorInvalidValue);
  if (mode == kPassthrough) {
    *smem = 0;
    return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, passthrough_kernel, kPassThreads, 0));
  }
  switch (rchunk) {
    case 1: return occupancy_relayout<1>(width, smem, blocks_per_sm);
    case 5: return occupancy_relayout<5>(width, smem, blocks_per_sm);
    case 15: return occupancy_relayout<15>(width, smem, blocks_per_sm);
    default: return int(cudaErrorInvalidValue);
  }
}
