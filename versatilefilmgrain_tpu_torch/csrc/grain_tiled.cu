// Tiled film-grain strip kernel for one plane of a batch of frames, written
// for Hopper (sm_90a).
//
// Replaces versatilefilmgrain_tpu/ops/grain_pallas.py::_plane_pallas (:189),
// the TPU kernel of the JAX package's tiled engine (--engine pallas).  It
// computes the same integers on the same tiled layout: a (frame, block row)
// strip is (S = bh*bw, C), row s = y*bw + i is the in-block pixel, column c
// the block column, and C is the contiguous axis.  The TPU kernel fetches the
// 8 pattern candidates of each block's window with a one-hot int8 matrix
// product (its stand-in for a gather) and reaches the deblock neighbour with
// lane rolls.  Here each block column's window is staged in shared memory
// and read per pixel, and the deblock exchanges pre-deblock samples between
// neighbouring block columns through shared memory.
//
// Per pixel (reference: vfgs_hw.c:140-312, JAX grain_pallas._plane_kernel):
//   inten   = (x >> bs) & 255
//   acc     = sum_k (inten >= segs[k]) * segd[k];  sc = acc & 511, pi = acc >> 9
//   P       = sign[c] * win[widx[c]][pi][s]
//   overlap rows s < n_ov*bw of block rows r > 0:
//             P = (P*oc1 + Pu*oc2 + 16) >> 5,  Pu = signu[c] * win_up[widxu[c]][pi][s]
//             (oc1, oc2) = (12, 24) / (24, 12) on rows y = 0 / 1, (20, 20) if n_ov = 1
//   deblock i = 0 of columns c > 0:       (l0[c-1] + 3*P + P[i=1] + 2) >> 2
//           i = bw-1 of columns c < C-1:  (P[i=bw-2] + 3*P + r0[c+1] + 2) >> 2
//           all from pre-deblock samples
//   out     = clip(x + ((sc*P + (1 << (ss-1))) >> ss), imin << bs, imax << bs)
// All arithmetic is int32 with arithmetic right shifts, as in the C model.
//
// What bounds it on this card: bytes.  One 8-frame 3840x2160 10-bit 4:2:0
// batch is 199 MB of samples in and 199 MB out of device memory (a computed
// 0.119 ms at the H100 SXM data sheet's 3.35 TB/s).  The window tables
// (320 KB luma + 40 KB luma-up, 80 KB + 10 KB for 4:2:0 chroma) stay in L2,
// but staging a whole window (all 8 candidates) per block reads 9 bytes of
// table per luma pixel from L2, more than the 4 bytes of samples it moves.
// What the design does about it: samples are read and written once, with
// neighbouring threads on neighbouring columns; windows are staged with
// 4-byte loads into a padded shared layout (each block column on its own
// bank), once per block and not per pixel; the LUT pair is evaluated once
// per intensity (256 entries) from the segment chain, so a dense chain costs
// 256 compare-adds per thread block instead of per pixel.  Staging only the
// candidates a column's pixels select is left to a later change.
//
// Grid: one thread block per (frame, block row, group of kGroup block
// columns); 256 threads, thread t owns column t % kGroup of the group and
// rows s = t / kGroup + 16k.  The group's pre-deblock samples go to shared
// memory, plus one halo sample per line from each neighbouring group.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_kernels.py does this at first use).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 16;                          // block columns per block
constexpr int kRowsPerPass = kThreads / kGroup;     // strip rows per pass
static_assert(kThreads == 256, "one thread per intensity builds the LUT");

template <int BH, int BW>
struct Geo {
  static constexpr int S = BH * BW;                 // strip rows
  static constexpr int N_OV = BH == 8 ? 1 : 2;      // overlap lines
  static constexpr int NOV = N_OV * BW;             // overlap strip rows
  static constexpr int WIN = 8 * S;                 // bytes of one window
  static constexpr int WIN_UP = 8 * NOV;            // bytes of one up window
  // One padding word per column: columns fall on distinct banks.
  static constexpr int WSTRIDE = WIN + 4;
  static constexpr int USTRIDE = WIN_UP + 4;
  static constexpr int NP = S / kRowsPerPass;       // samples per thread
  static_assert(S % kRowsPerPass == 0, "strip rows per thread");
};

struct Args {
  const void* in;
  void* out;
  const int* widx;      // (F, R, 1, C) window index of the block
  const int* sign;      // (F, R, 1, C) +1 / -1
  const int* widxu;     // same, of the block row above
  const int* signu;
  const int* segs;      // (nseg,) segment starts
  const int* segd;      // (nseg,) segment deltas
  const int8_t* win;    // (156, 8, bh, bw)
  const int8_t* win_up; // (156, 8, n_ov, bw)
  const int* scale_shift;
  const int* imin;
  const int* imax;
  int nseg, R, C, groups, bs;
};

template <int N_OV>
__device__ __forceinline__ int overlap(int P, int Pu, int y) {
  const int oc1 = N_OV == 1 ? 20 : (y == 0 ? 12 : 24);
  const int oc2 = N_OV == 1 ? 20 : (y == 0 ? 24 : 12);
  return (P * oc1 + Pu * oc2 + 16) >> 5;
}

template <typename T, int BH, int BW>
__global__ void __launch_bounds__(kThreads)
grain_tiled_kernel(const Args a) {
  using G = Geo<BH, BW>;
  __shared__ __align__(16) int8_t s_win[kGroup * G::WSTRIDE];
  __shared__ __align__(16) int8_t s_up[kGroup * G::USTRIDE];
  __shared__ int16_t s_P[G::S * kGroup];    // pre-deblock samples [s][col]
  __shared__ int s_lut[256];                // packed (sc | pi << 9)
  __shared__ int s_halo[2][BH];             // l0 of column c0-1, r0 of c0+G
  __shared__ int s_sign[kGroup], s_signu[kGroup];

  const T* in = static_cast<const T*>(a.in);
  T* out = static_cast<T*>(a.out);
  const int t = threadIdx.x;
  const int fr = blockIdx.x / a.groups;     // f * R + r
  const int c0 = (blockIdx.x - fr * a.groups) * kGroup;
  const int r = fr % a.R;
  const int C = a.C;
  const int ncol = min(kGroup, C - c0);
  const size_t strip = size_t(fr) * G::S * C;
  const size_t cols = size_t(fr) * C;       // this block row's column info

  if (t < ncol) {
    s_sign[t] = __ldg(a.sign + cols + c0 + t);
    s_signu[t] = __ldg(a.signu + cols + c0 + t);
  }
  {
    int acc = 0;
    for (int k = 0; k < a.nseg; ++k)
      acc += t >= __ldg(a.segs + k) ? __ldg(a.segd + k) : 0;
    s_lut[t] = acc;
  }
  constexpr int WW = G::WIN / 4;
  for (int k = t; k < ncol * WW; k += kThreads) {
    const int cl = k / WW;
    const int w = k - cl * WW;
    const int* src = reinterpret_cast<const int*>(
        a.win + size_t(__ldg(a.widx + cols + c0 + cl)) * G::WIN);
    *reinterpret_cast<int*>(s_win + cl * G::WSTRIDE + 4 * w) = __ldg(src + w);
  }
  if (r > 0) {
    constexpr int WU = G::WIN_UP / 4;
    for (int k = t; k < ncol * WU; k += kThreads) {
      const int cl = k / WU;
      const int w = k - cl * WU;
      const int* src = reinterpret_cast<const int*>(
          a.win_up + size_t(__ldg(a.widxu + cols + c0 + cl)) * G::WIN_UP);
      *reinterpret_cast<int*>(s_up + cl * G::USTRIDE + 4 * w) =
          __ldg(src + w);
    }
  }
  __syncthreads();

  // Phase 1: pre-deblock samples of the group into shared memory; each
  // thread keeps its samples and scales in registers for phase 2.
  const int bs = a.bs;
  const int cl = t % kGroup;
  const int row0 = t / kGroup;
  const int c = c0 + cl;
  const bool active = cl < ncol;
  int xv[G::NP], scv[G::NP];
#pragma unroll
  for (int k = 0; k < G::NP; ++k) {
    const int s = row0 + k * kRowsPerPass;
    xv[k] = 0;
    scv[k] = 0;
    if (active) {
      const int x = int(__ldg(in + strip + size_t(s) * C + c));
      const int acc = s_lut[(x >> bs) & 0xFF];
      const int pi = acc >> 9;
      xv[k] = x;
      scv[k] = acc & 511;
      int P = int(s_win[cl * G::WSTRIDE + pi * G::S + s]) * s_sign[cl];
      if (s < G::NOV && r > 0) {
        const int Pu = int(s_up[cl * G::USTRIDE + pi * G::NOV + s]) *
                       s_signu[cl];
        P = overlap<G::N_OV>(P, Pu, s / BW);
      }
      s_P[s * kGroup + cl] = int16_t(P);
    }
  }
  // Halo: the edge sample of each line in the neighbouring groups' columns,
  // with that column's own window, sign and pixel (windows read from L2).
  if (t < 2 * BH) {
    const bool left = t < BH;
    const int y = left ? t : t - BH;
    const int hc = left ? c0 - 1 : c0 + kGroup;
    if (hc >= 0 && hc < C) {
      const int s = y * BW + (left ? BW - 1 : 0);
      const int x = int(__ldg(in + strip + size_t(s) * C + hc));
      const int pi = s_lut[(x >> bs) & 0xFF] >> 9;
      int P = int(__ldg(a.win + size_t(__ldg(a.widx + cols + hc)) * G::WIN +
                        pi * G::S + s)) *
              __ldg(a.sign + cols + hc);
      if (s < G::NOV && r > 0) {
        const int Pu =
            int(__ldg(a.win_up + size_t(__ldg(a.widxu + cols + hc)) *
                                     G::WIN_UP +
                      pi * G::NOV + s)) *
            __ldg(a.signu + cols + hc);
        P = overlap<G::N_OV>(P, Pu, y);
      }
      s_halo[left ? 0 : 1][y] = P;
    }
  }
  __syncthreads();
  if (!active) return;

  // Phase 2: deblock at inner block-column edges, scale, add, clip.
  const int ss = __ldg(a.scale_shift);
  const int bias = 1 << (ss - 1);
  const int lo = __ldg(a.imin) << bs;
  const int hi = __ldg(a.imax) << bs;
#pragma unroll
  for (int k = 0; k < G::NP; ++k) {
    const int s = row0 + k * kRowsPerPass;
    const int i = s % BW;
    int P = s_P[s * kGroup + cl];
    if (i == 0 && c > 0) {
      const int l0 = cl > 0 ? int(s_P[(s + BW - 1) * kGroup + cl - 1])
                            : s_halo[0][s / BW];
      P = (l0 + 3 * P + int(s_P[(s + 1) * kGroup + cl]) + 2) >> 2;
    } else if (i == BW - 1 && c < C - 1) {
      const int r0 = cl < kGroup - 1
                         ? int(s_P[(s - (BW - 1)) * kGroup + cl + 1])
                         : s_halo[1][s / BW];
      P = (int(s_P[(s - 1) * kGroup + cl]) + 3 * P + r0 + 2) >> 2;
    }
    const int v = xv[k] + ((scv[k] * P + bias) >> ss);
    out[strip + size_t(s) * C + c] = T(min(max(v, lo), hi));
  }
}

template <int BH, int BW>
void launch(int elem_bytes, const Args& a, unsigned blocks, cudaStream_t st) {
  if (elem_bytes == 1)
    grain_tiled_kernel<uint8_t, BH, BW><<<blocks, kThreads, 0, st>>>(a);
  else
    grain_tiled_kernel<uint16_t, BH, BW><<<blocks, kThreads, 0, st>>>(a);
}

}  // namespace

// Grain the tiled strips of one plane of F frames.  `in`/`out`: (F, R, S, C)
// samples of `elem_bytes` bytes (1: uint8, 2: uint16), S = bh*bw;
// `widx`/`sign`/`widxu`/`signu`: (F, R, 1, C) int32; `segs`/`segd`: (nseg,)
// int32; `win`: (156, 8, bh, bw) and `win_up`: (156, 8, n_ov, bw) int8, 4-byte
// aligned; `scale_shift`/`imin`/`imax`: one int32 each.  (bh, bw, n_ov) is
// (16, 16, 2), (16, 8, 2) or (8, 8, 1).  All pointers are device pointers.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int vfg_grain_tiled(const void* in, void* out, int elem_bytes,
                               const void* widx, const void* sign,
                               const void* widxu, const void* signu,
                               const void* segs, const void* segd, int nseg,
                               const void* win, const void* win_up,
                               const void* scale_shift, const void* imin,
                               const void* imax, int frames, int rows,
                               int cols, int bh, int bw, int n_ov, int bs,
                               void* stream) {
  if (frames < 1 || rows < 1 || cols < 1 || nseg < 0 || (bs != 0 && bs != 2) ||
      (elem_bytes != 1 && elem_bytes != 2))
    return int(cudaErrorInvalidValue);
  Args a;
  a.in = in;
  a.out = out;
  a.widx = static_cast<const int*>(widx);
  a.sign = static_cast<const int*>(sign);
  a.widxu = static_cast<const int*>(widxu);
  a.signu = static_cast<const int*>(signu);
  a.segs = static_cast<const int*>(segs);
  a.segd = static_cast<const int*>(segd);
  a.win = static_cast<const int8_t*>(win);
  a.win_up = static_cast<const int8_t*>(win_up);
  a.scale_shift = static_cast<const int*>(scale_shift);
  a.imin = static_cast<const int*>(imin);
  a.imax = static_cast<const int*>(imax);
  a.nseg = nseg;
  a.R = rows;
  a.C = cols;
  a.groups = (cols + kGroup - 1) / kGroup;
  a.bs = bs;
  const long long blocks = (long long)frames * rows * a.groups;
  if (blocks > INT_MAX) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bh == 16 && bw == 16 && n_ov == 2)
    launch<16, 16>(elem_bytes, a, unsigned(blocks), st);
  else if (bh == 16 && bw == 8 && n_ov == 2)
    launch<16, 8>(elem_bytes, a, unsigned(blocks), st);
  else if (bh == 8 && bw == 8 && n_ov == 1)
    launch<8, 8>(elem_bytes, a, unsigned(blocks), st);
  else
    return int(cudaErrorInvalidValue);
  return int(cudaGetLastError());
}
