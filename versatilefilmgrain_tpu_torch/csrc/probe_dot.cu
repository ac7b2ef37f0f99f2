// The one-hot dot probes of the grain kernel's window fetch, written for
// Hopper (sm_90a): one source, one template instance per mode.
//
// Replaces two TPU kernels of tools/ (each a `kernel` run by its `main`):
//   K6 tools/probe_dot.py:38       mode none (and gather, below)
//   K7 tools/probe_dot2.py:38      modes none, build
// (K6's int8, bf16 and f32 (TF32) modes, of which int8 is K7's int8 mode
// too, and K7's dotconst mode and K8, the dense product, are persistent
// wgmma kernels in csrc/probe_dotconst.cu.)
// For every (frame f, 16-line block row r) of a (F, 16R, W) uint16 plane y
// they compute, with `hi` = 4092,
//   out[f, 16r + i, w] = clip(y[f, 16r + i, w] + s[i, w], 0, hi),  i < 16,
//   s[i, w] = sum over slices p < 8 of cand[18 p + i, w],
// where cand is
//   gather:       pat(144 x 768 int8) @ onehot(768 x W),
//                 onehot[k, w] = (k == t[f, r, w]), so cand[m, w] = pat[m, t];
//   build:        no product: s8[j, w] = sum_{q<8} onehot[96 q + j, w],
//                 s[i] = sum_{p<8} s8[(i + 2p) mod 16] (the TPU build mode's
//                 nine stacked copies of s8 read at rows 18p + i);
//   none:         s = 0.
// `gather` is not a TPU mode: it reads pat[18p + i, t] straight from the
// bank in shared memory (K1's way) and equals int8 byte for byte.
//
// What bounds it on this card, per 8-frame 3840x2160 step (computed from the
// H100 SXM data sheet, not measured): y in and out is 265.4 MB and t 16.6 MB,
// 0.084 ms at 3.35 TB/s (none 0.079 ms): every mode here is bound by bytes.
//
// Design.  A thread block of 8 warps owns 128 columns of `strips` block rows
// of one frame (grid: column tiles x row groups x frames).  The gather stages
// the int8 bank, 144 x 768, 110,592 bytes, whole, once per thread block, in
// rows padded by 16 bytes; a thread takes one column and 8 of the 16 lines,
// and skips the bank where its index matches no row.
//
// build: an int8 m16n8k32 B-fragment build over every K step, with the mma
// replaced by the byte sums of the rows the output reads (K steps 3q hold
// rows 96q .. 96q + 31; the low register holds rows 96q + j, j < 16).  The
// compiler is free to drop the rest, and does: on the H100 (CUDA 12.8) the
// build instance uses 40 registers, and its SASS (cuobjdump; chip_smoke.py
// phase 18 prints the counts) has 432 instructions, 26 ISETP and 17 SEL in
// all, no IMMA.  Of the 96 register builds a thread writes per strip (24 K
// steps x 2 registers x 2 n-tiles) it kept the 16 the output reads: one
// compare per 4 of the 128 one-hot entries per column that the TPU build
// mode sums.  That is the Hopper answer to "what does building cost": only
// the compares whose result is read (0.277 ms per 8-frame 4K step against
// 0.164 ms for none, NVIDIA H100 80GB HBM3 at 700 W).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_kernels.py does this at first use).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 768;
constexpr int kM = 144;                 // pattern rows
constexpr int kStride = 18, kSlices = 8;  // s sums rows 18 p + i, p < 8
constexpr int kThreads = 256;           // 8 warps
constexpr int kCols = 128;              // columns per thread block
constexpr int kSBytes = 16 * kCols * 4; // the int32 tile of s
constexpr int kRowInt8 = kK + 16;       // padded bank row, bytes

// Mode numbers as the wrapper passes them; 1 (int8), 2 (bf16) and 3 (f32)
// run in csrc/probe_dotconst.cu.
enum Mode { kNone = 0, kGather = 4, kBuild = 5 };

__host__ __device__ constexpr int smem_bytes(int mode) {
  return kSBytes + (mode == kGather ? kM * kRowInt8 : 0);
}

// The (m, 768) int8 bank into padded shared rows, 16 bytes a thread.
__device__ __forceinline__ void stage_int8(unsigned char* bank,
                                           const int8_t* pat, int m) {
  const uint4* src = reinterpret_cast<const uint4*>(pat);
  for (int i = threadIdx.x; i < m * (kK / 16); i += kThreads) {
    const int row = i / (kK / 16), piece = i - row * (kK / 16);
    *reinterpret_cast<uint4*>(bank + row * kRowInt8 + piece * 16) =
        __ldg(src + i);
  }
}

// One-hot B registers of an int8 m16n8k32 step at K row k0 (build): the
// thread's rows are k0 + 4 tig + (0..3) and k0 + 16 + 4 tig + (0..3), one
// byte each.
__device__ __forceinline__ void onehot_s8(int tv, int k0, int tig,
                                          unsigned& b0, unsigned& b1) {
  const int d = tv - k0 - 4 * tig;
  b0 = unsigned(d) < 4u ? 1u << (8 * d) : 0u;
  b1 = unsigned(d - 16) < 4u ? 1u << (8 * (d - 16)) : 0u;
}

// out = clip(y + s, 0, hi) over one strip's 16 x kCols tile: s = 0, or
// with kSum build's s[i] = sum_p s8[(i + 2p) mod 16].
template <bool kSum>
__device__ __forceinline__ void store_strip(const unsigned short* ys,
                                            unsigned short* os, const int* s,
                                            int col0, int width, int hi) {
  for (int idx = threadIdx.x; idx < 16 * kCols; idx += kThreads) {
    const int i = idx / kCols, c = idx - i * kCols, col = col0 + c;
    if (col >= width) continue;
    const size_t off = size_t(i) * width + col;
    int v = __ldg(ys + off);
    if constexpr (kSum) {
#pragma unroll
      for (int p = 0; p < 8; ++p) v += s[((i + 2 * p) & 15) * kCols + c];
    }
    os[off] = static_cast<unsigned short>(min(max(v, 0), hi));
  }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
dot_kernel(const unsigned short* __restrict__ y,
           unsigned short* __restrict__ out, const int* __restrict__ t,
           const int8_t* __restrict__ pat, int rows, int width, int strips,
           int hi) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s = reinterpret_cast<int*>(smem);
  unsigned char* bank = smem + kSBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int col0 = blockIdx.x * kCols;
  const int r0 = blockIdx.y * strips, r1 = min(rows, r0 + strips);

  if constexpr (kMode == kGather) stage_int8(bank, pat, kM);
  __syncthreads();

  for (int r = r0; r < r1; ++r) {
    const size_t strip = size_t(blockIdx.z) * rows + r;
    const unsigned short* ys = y + strip * 16 * width;
    unsigned short* os = out + strip * 16 * width;

    if constexpr (kMode == kNone) {
      store_strip<false>(ys, os, s, col0, width, hi);
    } else if constexpr (kMode == kGather) {
      // thread: one column, 8 of the 16 lines
      const int c = threadIdx.x % kCols, half = threadIdx.x / kCols;
      const int col = col0 + c;
      if (col < width) {
        // an index outside [0, 768) matches no one-hot row: s = 0
        const int tv = __ldg(t + strip * width + col);
        const bool hit = unsigned(tv) < unsigned(kK);
        const signed char* bk =
            reinterpret_cast<const signed char*>(bank) + (hit ? tv : 0);
        for (int i = 8 * half; i < 8 * half + 8; ++i) {
          const size_t off = size_t(i) * width + col;
          int v = __ldg(ys + off);
          if (hit) {
#pragma unroll
            for (int p = 0; p < kSlices; ++p)
              v += bk[(p * kStride + i) * kRowInt8];
          }
          os[off] = static_cast<unsigned short>(min(max(v, 0), hi));
        }
      }
    } else if constexpr (kMode == kBuild) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int cl = warp * 16 + nt * 8 + g, col = col0 + cl;
        const int tv = col < width ? __ldg(t + strip * width + col) : -1;
        unsigned s8 = 0;  // four bytes: rows 4 tig + (0..3) of s8
#pragma unroll
        for (int ks = 0; ks < kK / 32; ++ks) {
          unsigned b0, b1;
          onehot_s8(tv, 32 * ks, tig, b0, b1);
          if (ks % 3 == 0) s8 += b0;  // rows 96q + j, j < 16
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[(4 * tig + e) * kCols + cl] = (s8 >> (8 * e)) & 0xffu;
      }
      __syncthreads();
      store_strip<true>(ys, os, s, col0, width, hi);
      __syncthreads();
    }
  }
}

template <int kMode>
int launch(const void* y, void* out, const void* t, const void* pat,
           int frames, int rows, int width, int strips, int hi,
           cudaStream_t st) {
  auto kern = dot_kernel<kMode>;
  constexpr int smem = smem_bytes(kMode);
  static bool configured = false;
  if (smem > 48 * 1024 && !configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return int(e);
    configured = true;
  }
  const dim3 grid((width + kCols - 1) / kCols, (rows + strips - 1) / strips,
                  frames);
  kern<<<grid, kThreads, smem, st>>>(
      static_cast<const unsigned short*>(y), static_cast<unsigned short*>(out),
      static_cast<const int*>(t), static_cast<const int8_t*>(pat), rows,
      width, strips, hi);
  return int(cudaGetLastError());
}

}  // namespace

// One probe step.  `y`, `out`: (frames, 16 rows, width) uint16; `t`:
// (frames, rows, 1, width) int32 (gather, build; an index outside [0, 768)
// matches no one-hot row); `pat`: (144, 768) int8, 16-byte aligned
// (gather); (m, stride, slices) = (144, 18, 8).  Modes: 0 none, 4 gather,
// 5 build (1 int8, 2 bf16 and 3 f32 run in csrc/probe_dotconst.cu and are
// refused here).  A thread block covers 128 columns of `strips` block
// rows.  All pointers are device pointers.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int vfg_probe_dot(int mode, int m, int stride, int slices, int hi,
                             const void* y, void* out, const void* t,
                             const void* pat, int frames, int rows, int width,
                             int strips, void* stream) {
  if (y == nullptr || out == nullptr || frames < 1 || frames > 65535 ||
      rows < 1 || width < 1 || strips < 1 || hi < 0 || hi > 65535)
    return int(cudaErrorInvalidValue);
  const bool needs_t = mode == kGather || mode == kBuild;
  const bool needs_pat = mode != kNone && mode != kBuild;
  if ((needs_t && t == nullptr) || (needs_pat && pat == nullptr) ||
      (needs_pat && reinterpret_cast<uintptr_t>(pat) % 16) || m != kM ||
      stride != kStride || slices != kSlices)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VFG_DOT(MODE) \
  launch<MODE>(y, out, t, pat, frames, rows, width, strips, hi, st)
  switch (mode) {
    case kNone: return VFG_DOT(kNone);
    case kGather: return VFG_DOT(kGather);
    case kBuild: return VFG_DOT(kBuild);
    default: return int(cudaErrorInvalidValue);
  }
#undef VFG_DOT
}
