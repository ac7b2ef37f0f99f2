// The device code of the natural-layout grain kernel (K1), shared by
// grain_natural.cu (K1 itself) and the two probes that fork it:
// probe_budget.cu (per-stage budget, K5, which instantiates K1's kernel
// with a stage mask) and probe_pipe.cu (persistent pipeline, K4, which runs
// K1's per-line body grain_line in its own schedule, on pixels that bulk
// copies bring into shared memory).  A probe that includes this header
// cannot drift from the shipped kernel.
//
// Per pixel (f, y, x) of plane c, block row r = y / bh, block column
// b = x / bw (reference: vfgs_hw.c:140-312, JAX ops/grain_jnp.py):
//   (s, ox, oy)  = block_offsets(lat[f, r, b])            (vfgs_hw.c:99-138)
//   pi, sc       = plut[c][inten] >> 4, slut[c][inten]    inten = (pix>>bs)&255
//   P            = s * pattern[pi][oy + y%bh][ox + x%bw]
//   overlap      rows y%bh < n_ov of block rows r > 0 blend with the upper
//                block's samples, pattern rows oy_up + bh + y%bh at the upper
//                block's offsets and sign and this pixel's pi
//   deblock      (P[x-1] + 3P[x] + P[x+1] + 2) >> 2 at x%bw in {0, bw-1},
//                except x = 0 and x = Wp-1, on the blended P of each
//                neighbour (each with its own block, sign and pi)
//   out          clip(pix + ((sc*P + (1 << (ss-1))) >> ss), imin<<bs, imax<<bs)
// All arithmetic is int32 with arithmetic right shifts, as in the C model.
// Padded rows and columns are grained like real ones.
//
// Stage mask kSkip (0 in K1).  Each bit removes one stage, as the JAX
// probe's `skip` set does (tools/probe_budget.py:55-131); the output is then
// wrong on purpose but deterministic, and every input the full kernel reads
// stays live unless the removed stage was its only reader:
//   kNoLut       sc = inten, pi = inten & pat_mask (no LUT reads)
//   kNoBlend     overlap rows keep their own sample (no upper-row words)
//   kNoDeblock   no 3-tap at block edges (no neighbour samples)
//   kNoEpilogue  out = T(pix + P), wrapping (no scale, round, clip)
//   kNoSelect    pattern 0 for every pixel (no pattern LUT read)
//   kNoFetch     the sample is the low byte of (row*64 + col + pi), signed,
//                in place of the shared-memory pattern read
//   kNoStage     bank and LUTs read from global memory through __ldg, not
//                staged in shared memory (same output as kSkip = 0)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vfg {

constexpr int kThreads = 256;
constexpr int kPatternBytes = 8 * 64 * 64;

enum : int {
  kNoLut = 1,
  kNoBlend = 2,
  kNoDeblock = 4,
  kNoEpilogue = 8,
  kNoSelect = 16,
  kNoFetch = 32,
  kNoStage = 64,
};

struct Plane {
  int c, bs;
  int bh, bw, lbw, n_ov;
  int xmul, ymul;
  int lkc;       // log2 of KC = 16 * xmul, the lane word's pattern-column range
  int pat_mask;  // kNoLut's pattern index mask, n_pat - 1 (unread otherwise)
};

// Plane geometry of component c; false if an argument is out of range.
inline bool make_plane(int c, int csubx, int csuby, int bs, Plane& g) {
  if (c < 0 || c > 2 || (csubx != 1 && csubx != 2) ||
      (csuby != 1 && csuby != 2) || (bs != 0 && bs != 2))
    return false;
  const int subx = c ? csubx : 1;
  const int suby = c ? csuby : 1;
  g.c = c;
  g.bs = bs;
  g.bh = 16 / suby;
  g.bw = 16 / subx;
  g.lbw = subx == 2 ? 3 : 4;
  g.n_ov = suby == 2 ? 1 : 2;
  g.xmul = c ? 4 / csubx : 4;
  g.ymul = c ? 4 / csuby : 4;
  g.lkc = g.xmul == 4 ? 6 : 5;
  g.pat_mask = 0;
  return true;
}

// A table read: shared memory, or device memory under kNoStage.
template <int kSkip, typename U>
__device__ __forceinline__ U tab(const U* t, int i) {
  if constexpr ((kSkip & kNoStage) != 0)
    return __ldg(t + i);
  else
    return t[i];
}

__device__ __forceinline__ void block_offsets(uint32_t val, const Plane& g,
                                              int& s, int& ox, int& oy) {
  uint32_t sign_bit, xbf, ybf;
  if (g.c == 0) {
    sign_bit = (val >> 31) & 1u;
    xbf = val & 0x3FFu;
    ybf = (val >> 14) & 0x3FFu;
  } else if (g.c == 1) {
    sign_bit = (val >> 2) & 1u;
    xbf = (val >> 10) & 0x3FFu;
    ybf = ((val >> 24) & 0x0FFu) | ((val << 8) & 0x300u);
  } else {
    sign_bit = (val >> 15) & 1u;
    xbf = (val >> 20) & 0x3FFu;
    ybf = (val >> 4) & 0x3FFu;
  }
  s = 1 - 2 * int(sign_bit);
  ox = int((xbf * 13u) >> 10) * g.xmul;
  oy = int((ybf * 12u) >> 10) * g.ymul;
}

// Sign s, pattern column col = ox + x % bw and pattern row oy of column x,
// from the word `w` that holds them: its block's lattice word, or its own
// lane word.
template <bool kLane>
__device__ __forceinline__ void word_offsets(uint32_t w, int x,
                                             const Plane& g, int& s,
                                             int& col, int& oy) {
  if constexpr (kLane) {
    const int t = int(w & 0x3FFu);
    s = 1 - 2 * int((w >> 10) & 1u);
    col = t & (16 * g.xmul - 1);
    oy = (t >> g.lkc) * g.ymul;
  } else {
    int ox;
    block_offsets(w, g, s, ox, oy);
    col = ox + (x & (g.bw - 1));
  }
}

// The same from one block row's words (lattice or lane words), read from
// device memory through the read-only path.
template <bool kLane>
__device__ __forceinline__ void offsets_at(const uint32_t* __restrict__ words,
                                           int x, const Plane& g, int& s,
                                           int& col, int& oy) {
  word_offsets<kLane>(__ldg(words + (kLane ? x : x >> g.lbw)), x, g, s, col,
                      oy);
}

// Pattern index pi of a pixel of intensity `inten`.
template <int kSkip>
__device__ __forceinline__ int pattern_of(int inten, const uint8_t* plut,
                                          const Plane& g) {
  if constexpr ((kSkip & kNoLut) != 0)
    return inten & g.pat_mask;
  else if constexpr ((kSkip & kNoSelect) != 0)
    return 0;
  else
    return tab<kSkip>(plut, inten) >> 4;
}

// Sample at the flat index idx = row * 64 + col of the bank's pattern pi,
// or its stand-in under kNoFetch.
template <int kSkip>
__device__ __forceinline__ int fetch_at(const int8_t* pat, int pi, int idx) {
  if constexpr ((kSkip & kNoFetch) != 0)
    return (((idx + pi) & 0xFF) ^ 0x80) - 0x80;
  else
    return int(tab<kSkip>(pat, pi * (64 * 64) + idx));
}

// ---------------------------------------------------------------------------
// K1's kernel
//
// One thread block of kThreads threads per (frame, block row): grid.x =
// F * R.  The plane class's pattern bank (32 KB) and the component's two
// LUTs are staged in shared memory (read from device memory under
// kNoStage).
//
// Columns are owned, not strided.  A thread owns runs of kRun = 8
// consecutive columns (Wp = C * bw is a multiple of 8, so no run is
// ragged); the lanes of a warp hold consecutive runs; the thread walks the
// block row's bh lines with its run in registers, column outside, line
// inside.  A run lies inside one block (bw is 8 or 16), so the thread
// decodes its block's word, and where the row blends the upper block's,
// once per block row (lane words: its 8 columns' words); a line only adds
// j * 64 to the pattern indexes.  Pixels move as one vector a line per
// thread, 16 bytes of uint16 or 8 bytes of uint8: rows are Wp samples
// apart, a multiple of the vector, so a plane whose pointer is aligned to
// a run (the caller's to ensure) keeps every run aligned.
//
// Each pixel's blended sample is computed once a line, and the deblock
// reads a neighbour's from the lane that computed it: inside a run from the
// thread's own registers (a run's interior columns are never block edges),
// across runs by __shfl_up_sync / __shfl_down_sync.  At a warp's two ends
// the neighbour run belongs to another warp, so lane 0 also samples column
// x0 - 1 and lane 31 column x0 + 8, from that column's pixel and its
// block's offsets, decoded once per block row like its own: 8 samples per
// run and line, and one more per warp end.

constexpr int kRun = 8;  // columns a thread owns, consecutive

// Sign and flat pattern index (row * 64 + col on line 0 of the block row,
// `drow` rows down) of kN consecutive columns from x, decoded from one
// block row's words.  kN = 1 with lattice words stands for a whole run:
// its columns share the block's sign, and column k's index is idx + k.
template <bool kLane, int kN>
struct Offsets {
  int s[kN], idx[kN];

  __device__ __forceinline__ void decode(const uint32_t* __restrict__ words,
                                         int x, int drow, const Plane& g) {
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      int col, oy;
      offsets_at<kLane>(words, x + k, g, s[k], col, oy);
      idx[k] = (oy + drow) * 64 + col;
    }
  }
  // kN = 1: from the word `w` that holds column x's offsets, already read.
  __device__ __forceinline__ void from_word(uint32_t w, int x, int drow,
                                            const Plane& g) {
    static_assert(kN == 1, "one word decodes one column (or lattice run)");
    int col, oy;
    word_offsets<kLane>(w, x, g, s[0], col, oy);
    idx[0] = (oy + drow) * 64 + col;
  }
  // The same columns' offsets `drow` rows further down the pattern.
  __device__ __forceinline__ void shift_rows(const Offsets& o, int drow) {
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      s[k] = o.s[k];
      idx[k] = o.idx[k] + drow * 64;
    }
  }
  __device__ __forceinline__ int sign(int k) const {
    return s[kN == 1 ? 0 : k];
  }
  __device__ __forceinline__ int at(int k) const {
    return kN == 1 ? idx[0] + k : idx[k];
  }
};

// Blended, pre-deblock sample on the line j64 / 64 of a pixel of pattern
// pi: own block's sign s and index idx, and under kBlend the upper block's
// su and idxu with the line's weights w1, w2.
template <int kSkip, bool kBlend>
__device__ __forceinline__ int sample_at(const int8_t* pat, int pi, int s,
                                         int idx, int su, int idxu, int j64,
                                         int w1, int w2) {
  int P = s * fetch_at<kSkip>(pat, pi, idx + j64);
  if constexpr (kBlend) {
    const int Pu = su * fetch_at<kSkip>(pat, pi, idxu + j64);
    P = (P * w1 + Pu * w2 + 16) >> 5;
  }
  return P;
}

// The kRun samples of a run from p as loaded: one 16-byte (uint16) or
// 8-byte (uint8) vector.
template <typename T>
struct RunBits;

template <>
struct RunBits<uint16_t> {
  uint4 w;
  __device__ __forceinline__ void load(const uint16_t* __restrict__ p) {
    w = __ldg(reinterpret_cast<const uint4*>(p));
  }
  // from shared memory (a bulk copy's destination), 16-byte aligned
  __device__ __forceinline__ void load_shared(const uint16_t* p) {
    w = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ int operator[](int k) const {
    const uint32_t u = k < 2 ? w.x : k < 4 ? w.y : k < 6 ? w.z : w.w;
    return int((u >> (16 * (k & 1))) & 0xFFFFu);
  }
};

template <>
struct RunBits<uint8_t> {
  uint2 w;
  __device__ __forceinline__ void load(const uint8_t* __restrict__ p) {
    w = __ldg(reinterpret_cast<const uint2*>(p));
  }
  __device__ __forceinline__ int operator[](int k) const {
    return int(((k < 4 ? w.x : w.y) >> (8 * (k & 3))) & 0xFFu);
  }
};

// Store kRun samples from p, as RunBits loads them; a sample keeps its low
// bits, as the conversion to T does.
template <typename T>
__device__ __forceinline__ void store_run(T* p, const int (&v)[kRun]) {
  if constexpr (sizeof(T) == 2) {
    uint32_t u[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      u[k] = (uint32_t(v[2 * k]) & 0xFFFFu) | (uint32_t(v[2 * k + 1]) << 16);
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  } else {
    uint32_t u[2] = {0u, 0u};
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      u[k >> 2] |= (uint32_t(v[k]) & 0xFFu) << (8 * (k & 3));
    *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
  }
}

// Line j of a block row for the run of kRun columns at x0 that this lane
// holds (K1's per-line body; K4 runs it too): `bits` are the run's pixels
// on the line and, at an end lane, `pe` the extra column's; own / upper
// (kBlend) / ext / ext_up the offsets decoded once per block row; `dst` the
// block row's first output line, Wp samples a line.  The blended samples
// of the run's columns, the deblock at block edges (`left`, `right`) with
// the neighbour runs' samples by shuffles and the end lanes' extra sample,
// then scale, round, add and clip; stores the run where it is `live`.
template <int kSkip, bool kBlend, typename T, class Own, class Ext>
__device__ __forceinline__ void grain_line(
    T* dst, int Wp, int x0, int j, const RunBits<T>& bits, int pe,
    const Own& own, const Own& upper, const Ext& ext, const Ext& ext_up,
    const int8_t* pat, const uint8_t* pl, const uint8_t* sl, const Plane& g,
    int bias, int ss, int imin, int imax, int lane, bool end_lane, bool left,
    bool right, bool live) {
  constexpr bool kDeblock = (kSkip & kNoDeblock) == 0;
  const int w1 = g.n_ov == 1 ? 20 : (j == 0 ? 12 : 24);
  const int w2 = g.n_ov == 1 ? 20 : (j == 0 ? 24 : 12);
  const int j64 = j * 64;
  int pix[kRun], inten[kRun], P[kRun];
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    pix[k] = bits[k];
    inten[k] = (pix[k] >> g.bs) & 0xFF;
    P[k] = sample_at<kSkip, kBlend>(
        pat, pattern_of<kSkip>(inten[k], pl, g), own.sign(k), own.at(k),
        upper.sign(k), upper.at(k), j64, w1, w2);
  }
  if constexpr (kDeblock) {
    int Pe = 0;
    if (end_lane) {
      const int ie = (pe >> g.bs) & 0xFF;
      Pe = sample_at<kSkip, kBlend>(pat, pattern_of<kSkip>(ie, pl, g),
                                    ext.sign(0), ext.at(0), ext_up.sign(0),
                                    ext_up.at(0), j64, w1, w2);
    }
    const int from_left = __shfl_up_sync(0xFFFFFFFFu, P[kRun - 1], 1);
    const int from_right = __shfl_down_sync(0xFFFFFFFFu, P[0], 1);
    const int Pl = lane == 0 ? Pe : from_left;
    const int Pr = lane == 31 ? Pe : from_right;
    const int first = (Pl + 3 * P[0] + P[1] + 2) >> 2;
    const int last = (P[kRun - 2] + 3 * P[kRun - 1] + Pr + 2) >> 2;
    if (left) P[0] = first;
    if (right) P[kRun - 1] = last;
  }
  int o[kRun];
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    if constexpr ((kSkip & kNoEpilogue) != 0) {
      o[k] = pix[k] + P[k];
    } else {
      int sc;
      if constexpr ((kSkip & kNoLut) != 0)
        sc = inten[k];
      else
        sc = tab<kSkip>(sl, inten[k]);
      o[k] = min(max(pix[k] + ((sc * P[k] + bias) >> ss), imin), imax);
    }
  }
  if (live) store_run<T>(dst + size_t(j) * Wp + x0, o);
}

// The lattice instance is held to 64 registers, 4 thread blocks per SM; the
// lane-word instance keeps its 8 columns' offsets in registers and takes
// what it needs (2 blocks per SM).
template <typename T, bool kLane, int kSkip>
__global__ void __launch_bounds__(kThreads, kLane ? 1 : 4)
grain_plane_kernel(const T* __restrict__ in, T* __restrict__ out,
                   const uint32_t* __restrict__ words,
                   const uint32_t* __restrict__ up0,
                   const int8_t* __restrict__ pattern,
                   const uint8_t* __restrict__ slut,
                   const uint8_t* __restrict__ plut,
                   const int* __restrict__ scalars, int R, int C, Plane g,
                   int zero_scale, int blend0) {
  const int fr = blockIdx.x;  // f * R + r
  const int r = fr % R;
  const int Wp = C * g.bw;
  const int runs = Wp / kRun;
  const T* src = in + size_t(fr) * g.bh * Wp;
  T* dst = out + size_t(fr) * g.bh * Wp;
  const int imin = __ldg(scalars + (g.c ? 3 : 1)) << g.bs;
  const int imax = __ldg(scalars + (g.c ? 4 : 2)) << g.bs;

  if (zero_scale) {
    // Identically zero scale LUT: the grain is exactly 0, only the clip is
    // left (the C model still runs its per-pixel loop, vfgs_hw.c:266-276).
    for (int q = threadIdx.x; q < runs; q += kThreads)
      for (int j = 0; j < g.bh; ++j) {
        RunBits<T> bits;
        bits.load(src + size_t(j) * Wp + q * kRun);
        int v[kRun];
#pragma unroll
        for (int k = 0; k < kRun; ++k) v[k] = min(max(bits[k], imin), imax);
        store_run<T>(dst + size_t(j) * Wp + q * kRun, v);
      }
    return;
  }

  const int8_t* pat = pattern;
  const uint8_t* sl = slut;
  const uint8_t* pl = plut;
  if constexpr ((kSkip & kNoStage) == 0) {
    __shared__ __align__(16) int8_t s_pat[kPatternBytes];
    __shared__ uint8_t s_slut[256];
    __shared__ uint8_t s_plut[256];
    const int4* bank = reinterpret_cast<const int4*>(pattern);
    int4* sbank = reinterpret_cast<int4*>(s_pat);
    for (int k = threadIdx.x; k < kPatternBytes / 16; k += kThreads)
      sbank[k] = __ldg(bank + k);
    s_slut[threadIdx.x] = slut[threadIdx.x];
    s_plut[threadIdx.x] = plut[threadIdx.x];
    __syncthreads();
    pat = s_pat;
    sl = s_slut;
    pl = s_plut;
  }

  const int ss = __ldg(scalars);
  const int bias = 1 << (ss - 1);
  const int stride = kLane ? Wp : C;  // words per block row
  const uint32_t* lrow = words + size_t(fr) * stride;
  const uint32_t* up = r > 0    ? lrow - stride
                       : blend0 ? up0 + size_t(fr / R) * stride
                                : nullptr;
  constexpr bool kDeblock = (kSkip & kNoDeblock) == 0;
  // lines loaded ahead of the one computed (bh is at least 8)
  constexpr int kAhead = kLane ? 1 : 2;
  // lines of the block row that blend with the upper block row
  const int n_bl = ((kSkip & kNoBlend) == 0 && up != nullptr) ? g.n_ov : 0;
  const int lane = threadIdx.x & 31;
  const bool end_lane = lane == 0 || lane == 31;

  // The warp's runs q0 .. q0 + 31, q0 warp-uniform: lanes past the row's
  // last run repeat it (they take part in the shuffles) and store nothing.
  for (int q0 = threadIdx.x - lane; q0 < runs; q0 += kThreads) {
    const bool live = q0 + lane < runs;
    const int x0 = min(q0 + lane, runs - 1) * kRun;
    // block edges of the run (columns 0 and Wp - 1 do not deblock)
    const bool left = (x0 & (g.bw - 1)) == 0 && x0 > 0;
    const bool right = ((x0 + kRun) & (g.bw - 1)) == 0 && x0 + kRun < Wp;
    // the end lanes' extra column, clamped into the plane where it is
    // outside (and then unused)
    const int xe = lane == 0 ? max(x0 - 1, 0) : min(x0 + kRun, Wp - 1);
    Offsets<kLane, kLane ? kRun : 1> own, upper;
    Offsets<kLane, 1> ext, ext_up;
    own.decode(lrow, x0, 0, g);
    if (kDeblock && end_lane) ext.decode(lrow, xe, 0, g);
    if (n_bl > 0) {
      upper.decode(up, x0, g.bh, g);
      if (kDeblock && end_lane) ext_up.decode(up, xe, g.bh, g);
    }

    // Each line's pixels are loaded kAhead lines ahead, in flight while
    // the lines before are computed (ring[0] is line j's).
    RunBits<T> ring[kAhead + 1];
    int pe[kAhead + 1] = {};
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      ring[a].load(src + size_t(a) * Wp + x0);
      if (kDeblock && end_lane) pe[a] = int(__ldg(src + size_t(a) * Wp + xe));
    }
    for (int j = 0; j < g.bh; ++j) {
      if (j + kAhead < g.bh) {
        const T* row = src + size_t(j + kAhead) * Wp;
        ring[kAhead].load(row + x0);
        if (kDeblock && end_lane) pe[kAhead] = int(__ldg(row + xe));
      }
      if (j < n_bl)
        grain_line<kSkip, true>(dst, Wp, x0, j, ring[0], pe[0], own, upper,
                                ext, ext_up, pat, pl, sl, g, bias, ss, imin,
                                imax, lane, end_lane, left, right, live);
      else
        grain_line<kSkip, false>(dst, Wp, x0, j, ring[0], pe[0], own, upper,
                                 ext, ext_up, pat, pl, sl, g, bias, ss, imin,
                                 imax, lane, end_lane, left, right, live);
#pragma unroll
      for (int a = 0; a < kAhead; ++a) {
        ring[a] = ring[a + 1];
        pe[a] = pe[a + 1];
      }
    }
  }
}

// Launch K1's kernel with stage mask kSkip on one plane (arguments as
// grain_plane_kernel's; `frames` x `rows` block rows).  `in` and `out` must
// be aligned to a run of samples (kRun * sizeof(T) bytes).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unaligned plane.
template <typename T, bool kLane, int kSkip>
int launch_grain_plane(const T* in, T* out, const uint32_t* words,
                       const uint32_t* up0, const int8_t* p,
                       const uint8_t* sl, const uint8_t* pl, const int* sc,
                       int frames, int rows, int cols, const Plane& g,
                       int zero_scale, int blend0, cudaStream_t st) {
  const dim3 grid(unsigned(frames) * unsigned(rows));
  const uintptr_t a =
      reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out);
  if (a % (kRun * sizeof(T)) != 0) return int(cudaErrorInvalidValue);
  grain_plane_kernel<T, kLane, kSkip><<<grid, kThreads, 0, st>>>(
      in, out, words, up0, p, sl, pl, sc, rows, cols, g, zero_scale, blend0);
  return int(cudaGetLastError());
}

// Registers per thread, static shared memory bytes per thread block, local
// memory bytes per thread (stack and spills) and thread blocks per SM (the
// occupancy calculator, at `threads` threads and `dyn_smem` bytes of
// dynamic shared memory) of the kernel `fn`.  Returns the first CUDA
// error, or cudaSuccess.  The info entry points of K1, K3 and K4
// (grain_natural.cu, grain_tiled.cu, probe_pipe.cu).
template <typename Fn>
int kernel_info(Fn fn, int threads, int* regs, int* smem, int* local,
                int* blocks, int dyn_smem = 0) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return int(e);
  *regs = a.numRegs;
  *smem = int(a.sharedSizeBytes);
  *local = int(a.localSizeBytes);
  return int(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn,
                                                           threads,
                                                           dyn_smem));
}

}  // namespace vfg
