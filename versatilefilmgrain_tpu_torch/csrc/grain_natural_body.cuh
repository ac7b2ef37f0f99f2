// The device code of the natural-layout grain kernel (K1), shared by
// grain_natural.cu (K1 itself) and the two probes that fork it:
// probe_budget.cu (per-stage budget, K5) and probe_pipe.cu (prefetch
// pipeline, K4).  A probe that includes this header cannot drift from the
// shipped kernel.
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

// Where a block row's words are read from: device memory through the
// read-only path, or shared memory (a probe that stages them).
struct GlobalWords {
  static __device__ __forceinline__ uint32_t ld(const uint32_t* p) {
    return __ldg(p);
  }
};
struct SharedWords {
  static __device__ __forceinline__ uint32_t ld(const uint32_t* p) {
    return *p;
  }
};

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
// from one block row's words (lattice or lane words).
template <bool kLane, class Ld>
__device__ __forceinline__ void offsets_at(const uint32_t* __restrict__ words,
                                           int x, const Plane& g, int& s,
                                           int& col, int& oy) {
  if constexpr (kLane) {
    const uint32_t w = Ld::ld(words + x);
    const int t = int(w & 0x3FFu);
    s = 1 - 2 * int((w >> 10) & 1u);
    col = t & (16 * g.xmul - 1);
    oy = (t >> g.lkc) * g.ymul;
  } else {
    int ox;
    block_offsets(Ld::ld(words + (x >> g.lbw)), g, s, ox, oy);
    col = ox + (x & (g.bw - 1));
  }
}

// Pattern sample at row `row`, column `col` of the pattern `p` (pattern
// index pi), or its stand-in under kNoFetch.
template <int kSkip>
__device__ __forceinline__ int fetch(const int8_t* p, int pi, int row,
                                     int col) {
  if constexpr ((kSkip & kNoFetch) != 0)
    return (((row * 64 + col + pi) & 0xFF) ^ 0x80) - 0x80;
  else
    return int(tab<kSkip>(p, row * 64 + col));
}

// Blended, pre-deblock grain sample of column x on line j of the block row.
// `up` is the upper block row's words, or null where the row does not blend
// (a frame's first block row, a shard's first without blend0).
template <int kSkip, bool kLane, class Ld, typename T>
__device__ __forceinline__ int grain_sample(const T* __restrict__ row,
                                            const uint32_t* __restrict__ words,
                                            const uint32_t* __restrict__ up,
                                            const int8_t* pat,
                                            const uint8_t* plut, int x, int j,
                                            const Plane& g) {
  const int inten = (int(row[x]) >> g.bs) & 0xFF;
  int pi;
  if constexpr ((kSkip & kNoLut) != 0)
    pi = inten & g.pat_mask;
  else if constexpr ((kSkip & kNoSelect) != 0)
    pi = 0;
  else
    pi = tab<kSkip>(plut, inten) >> 4;
  const int8_t* p = pat + pi * (64 * 64);
  int s, col, oy;
  offsets_at<kLane, Ld>(words, x, g, s, col, oy);
  int P = s * fetch<kSkip>(p, pi, oy + j, col);
  if ((kSkip & kNoBlend) == 0 && up != nullptr && j < g.n_ov) {
    int su, colu, oyu;
    offsets_at<kLane, Ld>(up, x, g, su, colu, oyu);
    const int Pu = su * fetch<kSkip>(p, pi, oyu + g.bh + j, colu);
    const int oc1 = g.n_ov == 1 ? 20 : (j == 0 ? 12 : 24);
    const int oc2 = g.n_ov == 1 ? 20 : (j == 0 ? 24 : 12);
    P = (P * oc1 + Pu * oc2 + 16) >> 5;
  }
  return P;
}

// Output sample of column x on line j of a block row: grain sample,
// deblock, scale, add, clip.  `row` is the line's input samples, indexed by
// plane column; `Wp` the plane width; `bias`/`ss` the rounding bias and
// scale shift; `imin`/`imax` the clip range shifted by bs.
template <int kSkip, bool kLane, class Ld, typename T>
__device__ __forceinline__ T grain_pixel(const T* __restrict__ row,
                                         const uint32_t* __restrict__ words,
                                         const uint32_t* __restrict__ up,
                                         const int8_t* pat,
                                         const uint8_t* slut,
                                         const uint8_t* plut, int x, int j,
                                         int Wp, int bias, int ss, int imin,
                                         int imax, const Plane& g) {
  const int pix = int(row[x]);
  int P = grain_sample<kSkip, kLane, Ld>(row, words, up, pat, plut, x, j, g);
  if constexpr ((kSkip & kNoDeblock) == 0) {
    const int i = x & (g.bw - 1);
    if ((i == 0 && x > 0) || (i == g.bw - 1 && x < Wp - 1)) {
      const int Pl =
          grain_sample<kSkip, kLane, Ld>(row, words, up, pat, plut, x - 1, j,
                                         g);
      const int Pr =
          grain_sample<kSkip, kLane, Ld>(row, words, up, pat, plut, x + 1, j,
                                         g);
      P = (Pl + 3 * P + Pr + 2) >> 2;
    }
  }
  if constexpr ((kSkip & kNoEpilogue) != 0) {
    return T(pix + P);
  } else {
    const int inten = (pix >> g.bs) & 0xFF;
    int sc;
    if constexpr ((kSkip & kNoLut) != 0)
      sc = inten;
    else
      sc = tab<kSkip>(slut, inten);
    const int v = pix + ((sc * P + bias) >> ss);
    return T(min(max(v, imin), imax));
  }
}

// One thread block per (frame, block row): grid.x = F * R.  Threads stride
// over the columns of each of the block row's bh lines.  The plane class's
// pattern bank and the component's two LUTs are staged in shared memory
// (read from device memory under kNoStage).
template <typename T, bool kLane, int kSkip>
__global__ void __launch_bounds__(kThreads)
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
  const size_t base = size_t(fr) * g.bh * Wp;
  const int imin = __ldg(scalars + (g.c ? 3 : 1)) << g.bs;
  const int imax = __ldg(scalars + (g.c ? 4 : 2)) << g.bs;

  if (zero_scale) {
    // Identically zero scale LUT: the grain is exactly 0, only the clip is
    // left (the C model still runs its per-pixel loop, vfgs_hw.c:266-276).
    for (int j = 0; j < g.bh; ++j) {
      const T* row = in + base + size_t(j) * Wp;
      T* orow = out + base + size_t(j) * Wp;
      for (int x = threadIdx.x; x < Wp; x += kThreads)
        orow[x] = T(min(max(int(row[x]), imin), imax));
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
    const int4* src = reinterpret_cast<const int4*>(pattern);
    int4* dst = reinterpret_cast<int4*>(s_pat);
    for (int k = threadIdx.x; k < kPatternBytes / 16; k += kThreads)
      dst[k] = __ldg(src + k);
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
  for (int j = 0; j < g.bh; ++j) {
    const T* row = in + base + size_t(j) * Wp;
    T* orow = out + base + size_t(j) * Wp;
    for (int x = threadIdx.x; x < Wp; x += kThreads)
      orow[x] = grain_pixel<kSkip, kLane, GlobalWords>(
          row, lrow, up, pat, sl, pl, x, j, Wp, bias, ss, imin, imax, g);
  }
}

}  // namespace vfg
