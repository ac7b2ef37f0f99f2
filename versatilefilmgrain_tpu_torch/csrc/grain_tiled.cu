// Tiled-engine film-grain kernel for one plane of a batch of frames, written
// for Hopper (sm_90a).
//
// Replaces versatilefilmgrain_tpu/ops/grain_pallas.py::_plane_pallas (:189),
// the TPU kernel of the JAX package's tiled engine (--engine pallas).  It
// keeps that engine's data model -- per-block window index and sign of the
// block and of the block above (ops/grain_pallas.py::_offset_arrays), the
// run-length segment chain of the packed (scale | pattern) LUT, and the
// (156, 8, bh, bw) / (156, 8, n_ov, bw) int8 window tables -- and computes
// the same integers, but on the natural padded plane (F, R*bh, C*bw) rather
// than the TPU's tiled strips, so the step tiles and untiles nothing.  The
// TPU kernel fetches the 8 pattern candidates of each block's window with a
// one-hot int8 matrix product (its stand-in for a gather) and reaches the
// deblock neighbour with lane rolls; here a thread block stages the
// candidates its LUT can select in shared memory, and the deblock takes a
// neighbour's sample from the lane that computed it.
//
// Per pixel of block row r, block column c, block line j and block column i
// (reference: vfgs_hw.c:140-312, JAX grain_pallas._plane_kernel):
//   inten   = (x >> bs) & 255
//   acc     = sum_k (inten >= segs[k]) * segd[k];  sc = acc & 511, pi = acc >> 9
//   P       = sign[c] * win[widx[c]][pi][j][i]
//   lines j < n_ov of block rows r > 0:
//             P = (P*oc1 + Pu*oc2 + 16) >> 5,  Pu = signu[c] * win_up[widxu[c]][pi][j][i]
//             (oc1, oc2) = (12, 24) / (24, 12) on lines j = 0 / 1, (20, 20) if n_ov = 1
//   deblock i = 0 of columns c > 0:       (l0[c-1] + 3*P + P[i=1] + 2) >> 2
//           i = bw-1 of columns c < C-1:  (P[i=bw-2] + 3*P + r0[c+1] + 2) >> 2
//           all from pre-deblock samples, each with its own block's window,
//           sign and pixel
//   out     = clip(x + ((sc*P + (1 << (ss-1))) >> ss), imin << bs, imax << bs)
// All arithmetic is int32 with arithmetic right shifts, as in the C model.
//
// What bounds it on this card: bytes.  One 8-frame 3840x2160 10-bit 4:2:0
// batch is 199 MB of samples in and 199 MB out of device memory (0.119 ms at
// the H100 SXM data sheet's 3.35 TB/s).  The window tables (320 KB luma + 40
// KB luma-up, 80 KB + 10 KB for 4:2:0 chroma) stay in L2, but a whole window
// is 8 bytes of table per pixel, more than the pixel's own samples.  What the
// design does about it:
//   * a thread moves 8 consecutive samples of a line as one vector (16 bytes
//     of uint16, 8 of uint8), neighbouring lanes on neighbouring runs, reads
//     them once and keeps them in registers until it stores;
//   * the packed LUT is evaluated once per intensity (256 entries) from the
//     segment chain, once per thread block, and gives the candidates the
//     plane can select at all (the default config's luma LUT selects all
//     8, its chroma LUTs 1); the thread block stages those of each of its
//     blocks' windows from L2 with 16-byte loads, while its samples are
//     still on the way from device memory: nothing waits on a pixel before
//     the one barrier.
// On an H100 it runs at about a third of that bound (PERF.md): the bytes
// are not what holds it, but each pixel's two shared-memory reads at
// data-dependent addresses (its LUT entry and its window byte, which meet
// on banks when the pixels are noise) with a score of integer instructions,
// after a barrier that waits for the staging from L2.
//
// Grid: one thread block of 256 threads per (frame, block row, group of 32
// runs of 8 columns).  Lane l owns run l of the group, warp w the block
// row's lines w and w + 8 (bh = 16) or line w (bh = 8); a run lies inside
// one block (bw is 8 or 16), so luma takes 2 lanes a block line and
// subsampled chroma 1.  Lanes past the row's last run repeat it: they take
// part in the shuffles and store nothing.  At the group's two ends the
// deblock neighbour belongs to another thread block: lane 0 also samples
// column x0 - 1 and lane 31 column x0 + 8, that block's window read from L2.
//
// Probe hooks, off in the kernel itself: tools/probe_tiled.py builds
// this file with -DVFG_TILED_MIN_BLOCKS=n (thread blocks per SM asked of
// __launch_bounds__, 4 here) or -DVFG_TILED_PROBE=bit to time variants and
// ablations of it:
//   kAllCandidates   stage all 8 candidates of each window (same output)
//   kNoStaging       stage nothing: window bytes are whatever shared memory
//                    holds (wrong output)
//   kFirstCandidate  every pixel reads candidate 0 of its window, its LUT
//                    entry still read for the scale (wrong output)
//   kCopyOnly        store the samples unchanged: no LUT, staging or grain
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_kernels.py does this at first use).

#include <limits.h>

#include "grain_natural_body.cuh"  // vfg::RunBits, store_run, kRun, kernel_info

#ifndef VFG_TILED_MIN_BLOCKS
#define VFG_TILED_MIN_BLOCKS 4
#endif
#ifndef VFG_TILED_PROBE
#define VFG_TILED_PROBE 0
#endif

namespace {

using vfg::kRun;
using vfg::RunBits;
using vfg::store_run;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroupRuns = 32;  // runs of a thread block, one a lane
static_assert(kThreads == 256, "one thread per intensity builds the LUT");

enum : int {
  kAllCandidates = 1,
  kNoStaging = 2,
  kFirstCandidate = 4,
  kCopyOnly = 8,
};
constexpr int kProbe = VFG_TILED_PROBE;

template <int BH, int BW>
struct Geo {
  static constexpr int S = BH * BW;             // bytes of one candidate
  static constexpr int N_OV = BH == 8 ? 1 : 2;  // overlap lines
  static constexpr int SU = N_OV * BW;          // bytes of one up candidate
  static constexpr int G = kGroupRuns * kRun / BW;  // blocks of a group
  static constexpr int NL = BH / kWarps;        // lines of a thread
  static constexpr int CH = S / 16;             // 16-byte chunks a candidate
  static constexpr int CU = SU / 8;             // 8-byte chunks an up candidate
  // A staged window and its chunk of padding: neighbouring blocks' runs
  // start on different banks.
  static constexpr int WSTRIDE = 8 * S + 16;
  static constexpr int USTRIDE = 8 * SU + 8;
  static_assert(BH % kWarps == 0, "whole lines a warp");
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
  const int8_t* win;    // (156, 8, bh, bw), 16-byte aligned
  const int8_t* win_up; // (156, 8, n_ov, bw), 8-byte aligned
  const int* scale_shift;
  const int* imin;
  const int* imax;
  int nseg, R, C, groups, bs;
};

template <int N_OV>
__device__ __forceinline__ int overlap(int P, int Pu, int j) {
  const int oc1 = N_OV == 1 ? 20 : (j == 0 ? 12 : 24);
  const int oc2 = N_OV == 1 ? 20 : (j == 0 ? 24 : 12);
  return (P * oc1 + Pu * oc2 + 16) >> 5;
}

template <typename T, int BH, int BW>
__global__ void __launch_bounds__(kThreads, VFG_TILED_MIN_BLOCKS)
grain_tiled_kernel(const Args a) {
  using G = Geo<BH, BW>;
  __shared__ __align__(16) int8_t s_win[G::G * G::WSTRIDE];
  __shared__ __align__(16) int8_t s_up[G::G * G::USTRIDE];
  __shared__ int s_lut[256];                // packed (sc | pi << 9)
  __shared__ int s_widx[G::G], s_sign[G::G], s_widxu[G::G], s_signu[G::G];
  __shared__ unsigned s_cand[kWarps];       // candidates the LUT selects

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int fr = blockIdx.x / a.groups;     // f * R + r
  const int grp = blockIdx.x - fr * a.groups;
  const bool blend = fr % a.R > 0;
  const int C = a.C;
  const int Wp = C * BW;
  const int runs = Wp / kRun;
  const int c0 = grp * G::G;                // the group's first block column
  const int q = grp * kGroupRuns + lane;
  const bool live = q < runs;
  const int x0 = min(q, runs - 1) * kRun;
  const int b = x0 / BW - c0;               // the run's block in the group
  const int i0 = x0 % BW;                   // 0, or 8 in a 16-wide block
  const size_t cols = size_t(fr) * C;       // this block row's offsets
  const T* src = static_cast<const T*>(a.in) + size_t(fr) * BH * Wp;
  T* dst = static_cast<T*>(a.out) + size_t(fr) * BH * Wp;
  // The end lanes' neighbour column, in another group.
  const bool edge = (lane == 0 && x0 > 0) ||
                    (lane == kGroupRuns - 1 && x0 + kRun < Wp);
  const int xe = lane == 0 ? x0 - 1 : x0 + kRun;

  RunBits<T> bits[G::NL];
  int pe[G::NL];
#pragma unroll
  for (int m = 0; m < G::NL; ++m) {
    const T* row = src + size_t(warp + kWarps * m) * Wp;
    bits[m].load(row + x0);
    pe[m] = edge ? int(__ldg(row + xe)) : 0;
  }
  if constexpr ((kProbe & kCopyOnly) != 0) {
#pragma unroll
    for (int m = 0; m < G::NL; ++m) {
      int o[kRun];
#pragma unroll
      for (int k = 0; k < kRun; ++k) o[k] = bits[m][k];
      if (live) store_run<T>(dst + size_t(warp + kWarps * m) * Wp + x0, o);
    }
    return;
  }
  {
    int acc = 0;
    for (int k = 0; k < a.nseg; ++k)
      acc += t >= __ldg(a.segs + k) ? __ldg(a.segd + k) : 0;
    s_lut[t] = acc;
    const unsigned cand = __reduce_or_sync(0xFFFFFFFFu, 1u << (acc >> 9));
    if (lane == 0) s_cand[warp] = cand;
  }
  const int nblk = min(G::G, C - c0);       // the group's blocks
  if (t < nblk) {
    s_widx[t] = __ldg(a.widx + cols + c0 + t);
    s_sign[t] = __ldg(a.sign + cols + c0 + t);
    s_widxu[t] = __ldg(a.widxu + cols + c0 + t);
    s_signu[t] = __ldg(a.signu + cols + c0 + t);
  }
  __syncthreads();

  // Stage the candidates the LUT selects of every block of the group, 16
  // bytes (up: 8) a load.
  unsigned cand = (kProbe & kAllCandidates) ? 0xFFu : 0u;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) cand |= s_cand[w];
  if constexpr ((kProbe & kNoStaging) != 0) cand = 0u;
  for (int k = t; k < nblk * 8 * G::CH; k += kThreads) {
    const int blk = k / (8 * G::CH);
    const int part = k - blk * (8 * G::CH);   // candidate * CH + chunk
    if ((cand >> (part / G::CH)) & 1u) {
      const int4* w = reinterpret_cast<const int4*>(
          a.win + size_t(s_widx[blk]) * (8 * G::S));
      *reinterpret_cast<int4*>(s_win + blk * G::WSTRIDE + 16 * part) =
          __ldg(w + part);
    }
  }
  if (blend) {
    for (int k = t; k < nblk * 8 * G::CU; k += kThreads) {
      const int blk = k / (8 * G::CU);
      const int part = k - blk * (8 * G::CU);
      if ((cand >> (part / G::CU)) & 1u) {
        const uint2* w = reinterpret_cast<const uint2*>(
            a.win_up + size_t(s_widxu[blk]) * (8 * G::SU));
        *reinterpret_cast<uint2*>(s_up + blk * G::USTRIDE + 8 * part) =
            __ldg(w + part);
      }
    }
  }
  __syncthreads();

  // Grain samples, overlap, deblock at block edges, scale, add, clip.
  const int bs = a.bs;
  const int ss = __ldg(a.scale_shift);
  const int bias = 1 << (ss - 1);
  const int lo = __ldg(a.imin) << bs;
  const int hi = __ldg(a.imax) << bs;
  const int sg = s_sign[b];
  const int sgu = s_signu[b];
  const int8_t* wv = s_win + b * G::WSTRIDE + i0;
  const int8_t* wu = s_up + b * G::USTRIDE + i0;
  // The end lanes' neighbour block, its window read from L2.
  int sge = 0, sgue = 0;
  const int8_t* we = a.win;
  const int8_t* weu = a.win_up;
  if (edge) {
    const int ce = xe / BW;
    const int ie = xe % BW;
    sge = __ldg(a.sign + cols + ce);
    we += size_t(__ldg(a.widx + cols + ce)) * (8 * G::S) + ie;
    if (blend) {
      sgue = __ldg(a.signu + cols + ce);
      weu += size_t(__ldg(a.widxu + cols + ce)) * (8 * G::SU) + ie;
    }
  }
  const bool left = i0 == 0 && x0 > 0;
  const bool right = i0 + kRun == BW && x0 + kRun < Wp;
#pragma unroll
  for (int m = 0; m < G::NL; ++m) {
    const int j = warp + kWarps * m;
    const bool ov = blend && j < G::N_OV;
    int acc[kRun], P[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      acc[k] = s_lut[(bits[m][k] >> bs) & 0xFF];
      const int pi = (kProbe & kFirstCandidate) ? 0 : acc[k] >> 9;
      P[k] = sg * int(wv[pi * G::S + j * BW + k]);
      if (ov)
        P[k] = overlap<G::N_OV>(
            P[k], sgu * int(wu[pi * G::SU + j * BW + k]), j);
    }
    int Pe = 0;
    if (edge) {
      const int pi = (kProbe & kFirstCandidate)
                         ? 0
                         : s_lut[(pe[m] >> bs) & 0xFF] >> 9;
      Pe = sge * int(__ldg(we + pi * G::S + j * BW));
      if (ov)
        Pe = overlap<G::N_OV>(
            Pe, sgue * int(__ldg(weu + pi * G::SU + j * BW)), j);
    }
    const int from_left = __shfl_up_sync(0xFFFFFFFFu, P[kRun - 1], 1);
    const int from_right = __shfl_down_sync(0xFFFFFFFFu, P[0], 1);
    const int Pl = lane == 0 ? Pe : from_left;
    const int Pr = lane == kGroupRuns - 1 ? Pe : from_right;
    const int first = (Pl + 3 * P[0] + P[1] + 2) >> 2;
    const int last = (P[kRun - 2] + 3 * P[kRun - 1] + Pr + 2) >> 2;
    if (left) P[0] = first;
    if (right) P[kRun - 1] = last;
    int o[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      o[k] = min(max(bits[m][k] + (((acc[k] & 511) * P[k] + bias) >> ss), lo),
                 hi);
    if (live) store_run<T>(dst + size_t(j) * Wp + x0, o);
  }
}

using Kernel = void (*)(Args);

template <typename T>
Kernel instance_of(int bh, int bw) {
  if (bh == 16 && bw == 16) return grain_tiled_kernel<T, 16, 16>;
  if (bh == 16 && bw == 8) return grain_tiled_kernel<T, 16, 8>;
  if (bh == 8 && bw == 8) return grain_tiled_kernel<T, 8, 8>;
  return nullptr;
}

// The instance for `elem_bytes` and block `bh` x `bw`; null if there is none.
Kernel instance(int elem_bytes, int bh, int bw) {
  if (elem_bytes == 1) return instance_of<uint8_t>(bh, bw);
  if (elem_bytes == 2) return instance_of<uint16_t>(bh, bw);
  return nullptr;
}

}  // namespace

// Grain one plane of F frames.  `in`/`out`: (F, R*bh, C*bw) samples of
// `elem_bytes` bytes (1: uint8, 2: uint16), aligned to 8 samples (a thread's
// run); `widx`/`sign`/`widxu`/`signu`: (F, R, 1, C) int32; `segs`/`segd`:
// (nseg,) int32; `win`: (156, 8, bh, bw) int8, 16-byte aligned, and `win_up`:
// (156, 8, n_ov, bw) int8, 8-byte aligned; `scale_shift`/`imin`/`imax`: one
// int32 each.  (bh, bw, n_ov) is (16, 16, 2), (16, 8, 2) or (8, 8, 1).  All
// pointers are device pointers.  Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for an argument out of range
// or a misaligned pointer.
extern "C" int vfg_grain_tiled(const void* in, void* out, int elem_bytes,
                               const void* widx, const void* sign,
                               const void* widxu, const void* signu,
                               const void* segs, const void* segd, int nseg,
                               const void* win, const void* win_up,
                               const void* scale_shift, const void* imin,
                               const void* imax, int frames, int rows,
                               int cols, int bh, int bw, int n_ov, int bs,
                               void* stream) {
  const Kernel k = instance(elem_bytes, bh, bw);
  if (k == nullptr || n_ov != (bh == 8 ? 1 : 2) || frames < 1 || rows < 1 ||
      cols < 1 || nseg < 0 || (bs != 0 && bs != 2))
    return int(cudaErrorInvalidValue);
  const uintptr_t planes =
      reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out);
  if (planes % (kRun * elem_bytes) || reinterpret_cast<uintptr_t>(win) % 16 ||
      reinterpret_cast<uintptr_t>(win_up) % 8)
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
  const int runs = cols * bw / kRun;
  a.groups = (runs + kGroupRuns - 1) / kGroupRuns;
  a.bs = bs;
  const long long blocks = (long long)frames * rows * a.groups;
  if (blocks > INT_MAX) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  k<<<unsigned(blocks), kThreads, 0, st>>>(a);
  return int(cudaGetLastError());
}

// Registers per thread, static shared memory bytes per thread block, local
// memory bytes per thread (stack and spills) and thread blocks per SM (the
// occupancy calculator, at kThreads threads) of the instance for
// `elem_bytes` and block `bh` x `bw`.  Returns the first CUDA error, or
// cudaSuccess.
extern "C" int vfg_grain_tiled_info(int elem_bytes, int bh, int bw,
                                    int* regs, int* smem, int* local,
                                    int* blocks) {
  const Kernel k = instance(elem_bytes, bh, bw);
  if (k == nullptr) return int(cudaErrorInvalidValue);
  return vfg::kernel_info(k, kThreads, regs, smem, local, blocks);
}
