// Persistent pipeline probe of the grain kernel (K1), written for Hopper
// (sm_90a).
//
// Replaces tools/probe_ohpipe.py::_fused_pipe, the JAX package's probe that
// builds the next strip's one-hot while the current strip's matrix product
// runs.  The Hopper question is the same one in the card's terms: can a
// schedule other than K1's one thread block per (frame, block row) bring
// K1's own body nearer its bound?  K1 stages the 32 KB pattern bank once per
// block row (3,240 thread blocks, about 106 MB of L2-to-shared traffic per
// 8-frame 4K step, computed), and its luma launch is 2.05 waves at 4 blocks
// per SM.  This kernel computes exactly what K1 computes, with K1's per-line
// body (grain_natural_body.cuh: grain_line, 8 columns a thread, one vector
// a line, the deblock by shuffles), in another schedule:
//
//   grid     persistent: at most N thread blocks per SM (the plan's), each
//            with a contiguous range of lines of the plane, split by work;
//            lines are ordered tile, then strip (frame, block row), then
//            line, so a block walks down a column of tiles;
//   staging  the pattern bank and both LUTs once per thread block, by bulk
//            copy;
//   words    each strip's own words read once (one strip ahead, into
//            registers) and decoded once; the upper row's offsets are the
//            previous strip's own, carried in registers, so they are read
//            from device memory only at the block's first strip (and never
//            at a frame's first block row, which does not blend);
//   pixels   a ring of S stages of L lines in shared memory, filled by a
//            producer warp: one cp.async.bulk per staged line (the tile's
//            columns and an 8-sample halo on each side for the end lanes'
//            extra column; 16-byte aligned sources, sizes a multiple of 16),
//            completing on the stage's "full" mbarrier (expect_tx); the
//            compute warps release a stage on its "empty" mbarrier;
//   compute  eight warps, a thread per run of 8 columns of the tile (a tile
//            is at most 2,048 columns; every tile but a row's last is a
//            whole number of warps, so a warp's lane 31 finds its extra
//            column in the halo); each line's output goes from registers to
//            device memory as one 16-byte vector (store_run), as K1's does.
//
// What bounds it: what bounds K1 (its shared-memory and integer
// instructions, above the bytes: 199 MB read and written per 8-frame 4K
// step is 0.119 ms at 3.35 TB/s, computed).  Persistence removes the bank
// restaging and the wave tail; the ring hides the pixels' load latency
// behind the lines before; the price is fewer warps per SM than K1's 32.
//
// uint16 samples and lattice words only.  The plane must be 16-byte
// aligned (the wrapper copies one that is not).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_kernels.py does this at first use).

#include "grain_natural_body.cuh"

namespace {

using namespace vfg;

constexpr int kWarps = kThreads / 32;             // compute warps
constexpr int kBlockThreads = kThreads + 32;      // and one producer warp
constexpr int kHalo = kRun;                       // staged samples a side
constexpr int kMaxTile = kThreads * kRun;         // columns of a tile
constexpr int kMaxStages = 16;
constexpr int kBarBytes = 272;  // 2 * kMaxStages + 1 mbarriers, 16-aligned
constexpr int kTableBytes = kPatternBytes + 512;  // bank, slut, plut
constexpr int kMaxSmem = 232448;                  // per block (227 KB)

// Bytes of one staged line of a tile of `tile` columns (uint16).
__host__ __device__ constexpr int line_bytes(int tile) {
  return (tile + 2 * kHalo) * 2;
}

// Dynamic shared memory of the plan: mbarriers, bank and LUTs, the ring.
constexpr size_t smem_bytes(int tile, int lines, int stages) {
  return size_t(kBarBytes) + kTableBytes +
         size_t(stages) * lines * line_bytes(tile);
}

// First line of block b of B: lines are ordered (tile, strip, line), LT
// per tile; a line of a full tile is `tile` columns of work, one of the
// last tile Wp - (nt - 1) * tile.  Block b starts at the first line whose
// work before it reaches b / B of the whole (the wrapper's block_lines,
// versatilefilmgrain_tpu_torch/tools/probe_ohpipe.py, splits the same way).
__device__ __forceinline__ long long split_line(int b, int B, long long LT,
                                                int Wp, int tile, int nt) {
  const long long target = LT * Wp * b / B;
  const long long full = (long long)(nt - 1) * LT * tile;
  if (target <= full) return (target + tile - 1) / tile;
  const int last = Wp - (nt - 1) * tile;
  return (nt - 1) * LT + (target - full + last - 1) / last;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from device memory at `src` to shared memory
// at `dst` (both 16-byte aligned), completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A line's place in the (tile, strip, line) order and its tile's columns.
struct Cursor {
  int t, s, j;  // tile, strip (f * R + r), line of the strip
  int r;        // block row of the strip
  int x_t, w_t; // the tile's first column and width

  __device__ __forceinline__ void seek(long long l, int G, int R, int bh,
                                       int Wp, int tile) {
    const long long LT = (long long)G * bh;
    t = int(l / LT);
    const long long rem = l - t * LT;
    s = int(rem / bh);
    j = int(rem - (long long)s * bh);
    r = s % R;
    set_tile(Wp, tile);
  }
  __device__ __forceinline__ void set_tile(int Wp, int tile) {
    x_t = t * tile;
    w_t = min(tile, Wp - x_t);
  }
  __device__ __forceinline__ void next(int G, int R, int bh, int Wp,
                                       int tile) {
    if (++j < bh) return;
    j = 0;
    r = r + 1 == R ? 0 : r + 1;
    if (++s < G) return;
    s = 0;
    r = 0;
    ++t;
    set_tile(Wp, tile);
  }
};

// One plane, G = F * R strips of bh lines, tiles of `tile` columns, a ring
// of `stages` stages of `lines` lines.  Threads 0..255 compute; warp 8
// (its lane 0) issues every bulk copy.  kRing false is the probe's
// ablation: the same schedule with no ring, each thread loading its pixels
// from device memory one line ahead, as K1 does (the producer copies only
// the tables).
template <int kMinBlocks, bool kRing>
__global__ void __launch_bounds__(kBlockThreads, kMinBlocks)
pipe_plane_kernel(const uint16_t* __restrict__ in, uint16_t* __restrict__ out,
                  const uint32_t* __restrict__ words,
                  const int8_t* __restrict__ pattern,
                  const uint8_t* __restrict__ slut,
                  const uint8_t* __restrict__ plut,
                  const int* __restrict__ scalars, int G, int R, int C,
                  Plane g, int zero_scale, int tile, int lines, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = smem_addr(smem);  // full[S], empty[S], bank
  const uint32_t bank_bar = bars + 8 * 2 * stages;
  int8_t* s_pat = reinterpret_cast<int8_t*>(smem + kBarBytes);
  uint8_t* s_slut = reinterpret_cast<uint8_t*>(s_pat + kPatternBytes);
  uint8_t* s_plut = s_slut + 256;
  unsigned char* ring = smem + kBarBytes + kTableBytes;
  const int LS = line_bytes(tile);

  const int Wp = C * g.bw;
  const int nt = (Wp + tile - 1) / tile;
  const long long LT = (long long)G * g.bh;
  const long long l0 = split_line(blockIdx.x, gridDim.x, LT, Wp, tile, nt);
  const long long l1 =
      split_line(blockIdx.x + 1, gridDim.x, LT, Wp, tile, nt);
  const int n_lines = int(l1 - l0);
  const int n_groups = (n_lines + lines - 1) / lines;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int k = 0; k < stages; ++k) {
      mbar_init(bars + 8 * k, 1);                  // full: the producer
      mbar_init(bars + 8 * (stages + k), kWarps);  // empty: every warp
    }
    mbar_init(bank_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (n_lines <= 0) return;

  if (warp == kWarps) {
    // The producer: the tables, then every line of the range in order,
    // `lines` lines a stage.
    if (lane != 0) return;
    if (!zero_scale) {
      mbar_expect_tx(bank_bar, kTableBytes);
      bulk_copy(smem_addr(s_pat), pattern, kPatternBytes, bank_bar);
      bulk_copy(smem_addr(s_slut), slut, 256, bank_bar);
      bulk_copy(smem_addr(s_plut), plut, 256, bank_bar);
      mbar_arrive(bank_bar);
    }
    if constexpr (!kRing) return;
    Cursor cur;
    cur.seek(l0, G, R, g.bh, Wp, tile);
    int left = n_lines;
    for (int grp = 0, k = 0, round = 0; grp < n_groups; ++grp) {
      if (round > 0) mbar_wait(bars + 8 * (stages + k), (round - 1) & 1);
      const uint32_t full = bars + 8 * k;
      const uint32_t stage = smem_addr(ring + size_t(k) * lines * LS);
      const int n = min(lines, left);
      for (int i = 0; i < n; ++i) {
        // the tile's columns and the halo on each side that lies in the row
        const int xa = max(cur.x_t - kHalo, 0);
        const int xb = min(cur.x_t + cur.w_t + kHalo, Wp);
        const int bytes = (xb - xa) * 2;
        mbar_expect_tx(full, bytes);
        bulk_copy(stage + i * LS + (xa - cur.x_t + kHalo) * 2,
                  in + (size_t(cur.s) * g.bh + cur.j) * Wp + xa, bytes,
                  full);
        cur.next(G, R, g.bh, Wp, tile);
      }
      mbar_arrive(full);
      left -= n;
      if (++k == stages) {
        k = 0;
        ++round;
      }
    }
    return;
  }

  // The compute warps.
  const int imin = __ldg(scalars + (g.c ? 3 : 1)) << g.bs;
  const int imax = __ldg(scalars + (g.c ? 4 : 2)) << g.bs;
  const int ss = __ldg(scalars);
  const int bias = 1 << (ss - 1);
  const bool end_lane = lane == 0 || lane == 31;
  if (!zero_scale) mbar_wait(bank_bar, 0);

  Cursor cur;
  cur.seek(l0, G, R, g.bh, Wp, tile);
  // the thread's run in the current tile and its flags
  bool live = false, wlive = false, left = false, right = false;
  int x0 = 0, xe = 0;
  // offsets of the current strip (own) and the row above (upper), and of
  // the end lanes' extra column; the next strip's words, read ahead
  Offsets<false, 1> own, upper, ext, ext_up;
  bool have_prev = false;  // own / ext hold strip s - 1 of this tile
  bool ahead = false;      // wn / wen hold strip s's words
  uint32_t wn = 0, wen = 0;
  int n_bl = 0;
  RunBits<uint16_t> nbits;  // without the ring: the next line's pixels
  int npe = 0;
  bool ahead_px = false;

  for (int grp = 0, k = 0, round = 0, first = 1; grp < n_groups; ++grp) {
    if constexpr (kRing) mbar_wait(bars + 8 * k, round & 1);
    const unsigned char* stage = ring + size_t(k) * lines * LS;
    const int n = min(lines, n_lines - grp * lines);
    for (int i = 0; i < n; ++i) {
      if (cur.j == 0 || first) {
        // a new strip (or the block's first line, inside one)
        if (first || cur.s == 0) {
          // a new tile: this thread's run in it
          const int runs = cur.w_t / kRun;
          const int q0 = warp * 32;
          wlive = q0 < runs;
          live = q0 + lane < runs;
          x0 = cur.x_t + min(q0 + lane, runs - 1) * kRun;
          left = (x0 & (g.bw - 1)) == 0 && x0 > 0;
          right = ((x0 + kRun) & (g.bw - 1)) == 0 && x0 + kRun < Wp;
          xe = lane == 0 ? max(x0 - 1, 0) : min(x0 + kRun, Wp - 1);
          have_prev = ahead = false;
        }
        first = 0;
        n_bl = cur.r > 0 ? g.n_ov : 0;
        if (wlive && !zero_scale) {
          const uint32_t* row = words + size_t(cur.s) * C;
          if (n_bl > 0) {
            if (have_prev) {
              upper.shift_rows(own, g.bh);
              ext_up.shift_rows(ext, g.bh);
            } else {
              upper.decode(row - C, x0, g.bh, g);
              if (end_lane) ext_up.decode(row - C, xe, g.bh, g);
            }
          }
          if (!ahead) {
            wn = __ldg(row + (x0 >> g.lbw));
            if (end_lane) wen = __ldg(row + (xe >> g.lbw));
          }
          own.from_word(wn, x0, 0, g);
          if (end_lane) ext.from_word(wen, xe, 0, g);
          ahead = cur.s + 1 < G;
          if (ahead) {  // the next strip's words, in flight meanwhile
            wn = __ldg(row + C + (x0 >> g.lbw));
            if (end_lane) wen = __ldg(row + C + (xe >> g.lbw));
          }
          have_prev = true;
        }
      }
      if (wlive) {
        RunBits<uint16_t> bits;
        int pe = 0;
        if constexpr (kRing) {
          // the staged line: column x at x - x_t + kHalo
          const uint16_t* lp =
              reinterpret_cast<const uint16_t*>(stage + i * LS) + kHalo -
              cur.x_t;
          bits.load_shared(lp + x0);
          if (end_lane) pe = int(lp[xe]);
        } else {
          const uint16_t* row = in + (size_t(cur.s) * g.bh + cur.j) * Wp;
          if (ahead_px) {
            bits = nbits;
            pe = npe;
          } else {
            bits.load(row + x0);
            if (end_lane) pe = int(__ldg(row + xe));
          }
          // the next line, in this tile and range: Wp samples on
          ahead_px = grp * lines + i + 1 < n_lines &&
                     !(cur.s == G - 1 && cur.j == g.bh - 1);
          if (ahead_px) {
            nbits.load(row + Wp + x0);
            if (end_lane) npe = int(__ldg(row + Wp + xe));
          }
        }
        uint16_t* dst = out + size_t(cur.s) * g.bh * Wp;
        if (zero_scale) {
          int v[kRun];
#pragma unroll
          for (int q = 0; q < kRun; ++q) v[q] = min(max(bits[q], imin), imax);
          if (live) store_run<uint16_t>(dst + size_t(cur.j) * Wp + x0, v);
        } else {
          if (cur.j < n_bl)
            grain_line<0, true>(dst, Wp, x0, cur.j, bits, pe, own, upper,
                                ext, ext_up, s_pat, s_plut, s_slut, g, bias,
                                ss, imin, imax, lane, end_lane, left, right,
                                live);
          else
            grain_line<0, false>(dst, Wp, x0, cur.j, bits, pe, own, upper,
                                 ext, ext_up, s_pat, s_plut, s_slut, g, bias,
                                 ss, imin, imax, lane, end_lane, left, right,
                                 live);
        }
      }
      cur.next(G, R, g.bh, Wp, tile);
    }
    if constexpr (kRing) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (stages + k));
    }
    if (++k == stages) {
      k = 0;
      ++round;
    }
  }
}

using Kernel = void (*)(const uint16_t*, uint16_t*, const uint32_t*,
                        const int8_t*, const uint8_t*, const uint8_t*,
                        const int*, int, int, int, Plane, int, int, int, int);

// The instance for at most `blocks_per_sm` blocks per SM, with or without
// the ring: held to 112 registers, so two blocks of 288 threads fit.  A
// cap for three (72 registers) spills.
Kernel instance(int blocks_per_sm, int ring) {
  if (blocks_per_sm != 1 && blocks_per_sm != 2) return nullptr;
  return ring ? pipe_plane_kernel<2, true> : pipe_plane_kernel<2, false>;
}

// Dynamic shared memory of a launch: the ring's only with it.
size_t launch_smem(int ring, int tile, int lines, int stages) {
  return ring ? smem_bytes(tile, lines, stages) : smem_bytes(tile, 0, 0);
}

}  // namespace

// Grain one plane of F frames, as vfg_grain_plane does for uint16 samples
// and lattice words (same arguments), on the plan's persistent grid:
// `blocks` thread blocks (at most `blocks_per_sm` per SM), tiles of `tile`
// columns (at most 2,048, a multiple of 256 unless it is the whole row),
// with `ring` 1 a ring of `stages` stages (2-16) of `lines` lines (1-16),
// with `ring` 0 none (the ablation; lines still group the loop).  `in`,
// `out` and the tables 16-byte aligned.  Launches on `stream` and returns the
// first CUDA error, or cudaErrorInvalidValue for a plan or argument out of
// range (the wrapper's pipe_plan makes the plan).
extern "C" int vfg_probe_pipe(const void* in, void* out, const void* words,
                              const void* pattern, const void* slut,
                              const void* plut, const void* scalars,
                              int frames, int rows, int cols, int c,
                              int csubx, int csuby, int bs, int zero_scale,
                              int blocks_per_sm, int blocks, int ring,
                              int tile, int lines, int stages,
                              void* stream) {
  Plane g;
  const uintptr_t a = reinterpret_cast<uintptr_t>(in) |
                      reinterpret_cast<uintptr_t>(out) |
                      reinterpret_cast<uintptr_t>(pattern) |
                      reinterpret_cast<uintptr_t>(slut) |
                      reinterpret_cast<uintptr_t>(plut);
  const Kernel k = instance(blocks_per_sm, ring);
  if (frames < 1 || rows < 1 || cols < 1 || k == nullptr ||
      !make_plane(c, csubx, csuby, bs, g) || a % 16 || blocks < 1)
    return int(cudaErrorInvalidValue);
  const int Wp = cols * g.bw;
  if (tile < kRun || tile % kRun || tile > kMaxTile ||
      (tile < Wp && tile % 256) || lines < 1 || lines > 16 || stages < 2 ||
      stages > kMaxStages)
    return int(cudaErrorInvalidValue);
  const size_t smem = launch_smem(ring, tile, lines, stages);
  if (smem > size_t(kMaxSmem)) return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  k<<<blocks, kBlockThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(in), static_cast<uint16_t*>(out),
      static_cast<const uint32_t*>(words),
      static_cast<const int8_t*>(pattern), static_cast<const uint8_t*>(slut),
      static_cast<const uint8_t*>(plut), static_cast<const int*>(scalars),
      frames * rows, rows, cols, g, zero_scale, tile, lines, stages);
  return int(cudaGetLastError());
}

// Registers per thread, static shared memory bytes, local memory bytes per
// thread (stack and spills) and thread blocks per SM (occupancy calculator,
// at 288 threads and `dyn_smem` bytes of dynamic shared memory) of the
// instance for `blocks_per_sm` and `ring`.  Returns the first CUDA error,
// or cudaSuccess.
extern "C" int vfg_probe_pipe_info(int blocks_per_sm, int ring, int dyn_smem,
                                   int* regs, int* smem, int* local,
                                   int* blocks) {
  const Kernel k = instance(blocks_per_sm, ring);
  if (k == nullptr || dyn_smem < 0 || dyn_smem > kMaxSmem)
    return int(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn_smem);
  if (e != cudaSuccess) return int(e);
  return kernel_info(k, kBlockThreads, regs, smem, local, blocks, dyn_smem);
}
