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
// What bounds it on this card: bytes.  A 3840x2160 10-bit 4:2:0 frame is
// 24,883,200 bytes, read once and written once; at the H100 SXM data-sheet
// 3.35 TB/s that is a computed ceiling of about 67k frames/s (arithmetic,
// not a measurement).  The design moves each pixel once in and once out and
// keeps every table on chip: the plane class's pattern bank (8 x 64 x 64
// int8, 32 KB) and the scale/pattern LUT pair (512 B) sit in static shared
// memory, the per-block lattice words (4 bytes per 16x16 luma block) come
// from L2.  Lane words add 4 bytes per column and block row (33 MB per 4K
// batch of 8 frames), read under the arithmetic: the kernel is bound by its
// integer instructions, and the lane decode is shorter than the lattice's.
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
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_kernels.py does this at first use).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPatternBytes = 8 * 64 * 64;

struct Plane {
  int c, bs;
  int bh, bw, lbw, n_ov;
  int xmul, ymul;
  int lkc;  // log2 of KC = 16 * xmul, the lane word's pattern-column range
};

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
template <bool kLane>
__device__ __forceinline__ void offsets_at(const uint32_t* __restrict__ words,
                                           int x, const Plane& g, int& s,
                                           int& col, int& oy) {
  if constexpr (kLane) {
    const uint32_t w = __ldg(words + x);
    const int t = int(w & 0x3FFu);
    s = 1 - 2 * int((w >> 10) & 1u);
    col = t & (16 * g.xmul - 1);
    oy = (t >> g.lkc) * g.ymul;
  } else {
    int ox;
    block_offsets(__ldg(words + (x >> g.lbw)), g, s, ox, oy);
    col = ox + (x & (g.bw - 1));
  }
}

// Blended, pre-deblock grain sample of column x on line j of the block row.
// `up` is the upper block row's words, or null where the row does not blend
// (a frame's first block row, a shard's first without blend0).
template <bool kLane, typename T>
__device__ __forceinline__ int grain_sample(const T* __restrict__ row,
                                            const uint32_t* __restrict__ words,
                                            const uint32_t* __restrict__ up,
                                            const int8_t* pat,
                                            const uint8_t* plut, int x, int j,
                                            const Plane& g) {
  const int inten = (int(row[x]) >> g.bs) & 0xFF;
  const int8_t* p = pat + (plut[inten] >> 4) * (64 * 64);
  int s, col, oy;
  offsets_at<kLane>(words, x, g, s, col, oy);
  int P = s * int(p[(oy + j) * 64 + col]);
  if (up != nullptr && j < g.n_ov) {
    int su, colu, oyu;
    offsets_at<kLane>(up, x, g, su, colu, oyu);
    const int Pu = su * int(p[(oyu + g.bh + j) * 64 + colu]);
    const int oc1 = g.n_ov == 1 ? 20 : (j == 0 ? 12 : 24);
    const int oc2 = g.n_ov == 1 ? 20 : (j == 0 ? 24 : 12);
    P = (P * oc1 + Pu * oc2 + 16) >> 5;
  }
  return P;
}

// One thread block per (frame, block row): grid.x = F * R.  Threads stride
// over the columns of each of the block row's bh lines.
template <typename T, bool kLane>
__global__ void __launch_bounds__(kThreads)
grain_plane_kernel(const T* __restrict__ in, T* __restrict__ out,
                   const uint32_t* __restrict__ words,
                   const uint32_t* __restrict__ up0,
                   const int8_t* __restrict__ pattern,
                   const uint8_t* __restrict__ slut,
                   const uint8_t* __restrict__ plut,
                   const int* __restrict__ scalars, int R, int C, Plane g,
                   int zero_scale, int blend0) {
  __shared__ __align__(16) int8_t s_pat[kPatternBytes];
  __shared__ uint8_t s_slut[256];
  __shared__ uint8_t s_plut[256];

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

  const int4* src = reinterpret_cast<const int4*>(pattern);
  int4* dst = reinterpret_cast<int4*>(s_pat);
  for (int k = threadIdx.x; k < kPatternBytes / 16; k += kThreads)
    dst[k] = __ldg(src + k);
  s_slut[threadIdx.x] = slut[threadIdx.x];
  s_plut[threadIdx.x] = plut[threadIdx.x];
  __syncthreads();

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
    for (int x = threadIdx.x; x < Wp; x += kThreads) {
      const int pix = int(row[x]);
      int P = grain_sample<kLane>(row, lrow, up, s_pat, s_plut, x, j, g);
      const int i = x & (g.bw - 1);
      if ((i == 0 && x > 0) || (i == g.bw - 1 && x < Wp - 1)) {
        const int Pl =
            grain_sample<kLane>(row, lrow, up, s_pat, s_plut, x - 1, j, g);
        const int Pr =
            grain_sample<kLane>(row, lrow, up, s_pat, s_plut, x + 1, j, g);
        P = (Pl + 3 * P + Pr + 2) >> 2;
      }
      const int sc = s_slut[(pix >> g.bs) & 0xFF];
      const int v = pix + ((sc * P + bias) >> ss);
      orow[x] = T(min(max(v, imin), imax));
    }
  }
}

// Launch one kernel instance for a sample type and a word input.
template <typename T>
void launch(const void* in, void* out, const uint32_t* words,
            const uint32_t* up0, int lane, const int8_t* p, const uint8_t* sl,
            const uint8_t* pl, const int* sc, int frames, int rows, int cols,
            const Plane& g, int zero_scale, int blend0, cudaStream_t st) {
  const dim3 grid(unsigned(frames) * unsigned(rows));
  const T* i = static_cast<const T*>(in);
  T* o = static_cast<T*>(out);
  if (lane)
    grain_plane_kernel<T, true><<<grid, kThreads, 0, st>>>(
        i, o, words, up0, p, sl, pl, sc, rows, cols, g, zero_scale, blend0);
  else
    grain_plane_kernel<T, false><<<grid, kThreads, 0, st>>>(
        i, o, words, up0, p, sl, pl, sc, rows, cols, g, zero_scale, blend0);
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
// pointers are device pointers.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int vfg_grain_plane(const void* in, void* out, int elem_bytes,
                               const void* words, int lane, const void* up0,
                               int blend0, const void* pattern,
                               const void* slut, const void* plut,
                               const void* scalars, int frames, int rows,
                               int cols, int c, int csubx, int csuby, int bs,
                               int zero_scale, void* stream) {
  if (frames < 1 || rows < 1 || cols < 1 || c < 0 || c > 2 ||
      (csubx != 1 && csubx != 2) || (csuby != 1 && csuby != 2) ||
      (bs != 0 && bs != 2) || (elem_bytes != 1 && elem_bytes != 2) ||
      (lane != 0 && lane != 1) || (blend0 != 0 && blend0 != 1) ||
      (blend0 && up0 == nullptr))
    return int(cudaErrorInvalidValue);
  const int subx = c ? csubx : 1;
  const int suby = c ? csuby : 1;
  Plane g;
  g.c = c;
  g.bs = bs;
  g.bh = 16 / suby;
  g.bw = 16 / subx;
  g.lbw = subx == 2 ? 3 : 4;
  g.n_ov = suby == 2 ? 1 : 2;
  g.xmul = c ? 4 / csubx : 4;
  g.ymul = c ? 4 / csuby : 4;
  g.lkc = g.xmul == 4 ? 6 : 5;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  const uint32_t* u = static_cast<const uint32_t*>(up0);
  const int8_t* p = static_cast<const int8_t*>(pattern);
  const uint8_t* sl = static_cast<const uint8_t*>(slut);
  const uint8_t* pl = static_cast<const uint8_t*>(plut);
  const int* sc = static_cast<const int*>(scalars);
  if (elem_bytes == 1)
    launch<uint8_t>(in, out, w, u, lane, p, sl, pl, sc, frames, rows, cols, g,
                    zero_scale, blend0, st);
  else
    launch<uint16_t>(in, out, w, u, lane, p, sl, pl, sc, frames, rows, cols,
                     g, zero_scale, blend0, st);
  return int(cudaGetLastError());
}
