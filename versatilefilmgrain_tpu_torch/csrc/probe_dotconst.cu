// The persistent products of the one-hot dot probes, written for Hopper
// (sm_90a): a warpgroup-MMA (wgmma) kernel, one template instance per
// (M, stride, slices, source of A).
//
// Replaces the tensor-core products of three TPU kernels of tools/:
//   K7 tools/probe_dot2.py:38      dotconst mode: M = 144, stride 18, 8 slices
//   K8 tools/probe_dotscale.py:22  M = 16, 64, 128, 144, 160, 256, stride 16,
//                                  M / 16 slices
//   K6 tools/probe_dot.py:38       modes int8, bf16 and f32 (TF32) (and
//                                  K7's int8 mode, the same product):
//                                  M = 144, stride 18, 8 slices
// For every (frame f, 16-line block row r) of a (F, 16R, W) uint16 plane y,
//   out[f, 16r + i, w] = clip(y[f, 16r + i, w] + s[i, w], 0, hi),  i < 16,
//   s[i, w] = sum over slices p of (pat @ oh)[p * stride + i, w],
// with pat (M, 768) int8 and oh (768, W) 0/1, read here as its (W, 768)
// transpose.  For dotconst and K8 that is oh_t, a constant int8 matrix, the
// same for every (f, r).  For K6 it is the one-hot of the block row's
// indices, oh[k, w] = (k == t[f, r, w]) (an index outside [0, 768) matches
// no row), so the product gathers pat[:, t]; the probe asks what that costs
// on the tensor cores, as the TPU's dot computed it, so every strip runs all
// 2 M 768 W operations, every K step, in int8, bf16 or TF32 (exact: each
// entry of the product is one value of pat, or 0).
//
// What bounds it on this card, per 8-frame 3840x2160 step (computed from the
// H100 SXM data sheet, not measured): y in and out is 265.4 MB, 0.079 ms at
// 3.35 TB/s (with K6's t, 16.6 MB more, 0.084 ms); the product is 6.37 G
// operations x M, 0.4635 ms at M = 144 and 0.824 ms at M = 256 at 1,979
// int8 TOPS, 0.927 ms at M = 144 at 989 bf16 TFLOP/s, 1.853 ms at M = 144
// at 495 TF32 TFLOP/s.  M >= 32 is bound by operations, M = 16 by bytes.
//
// Design.  One thread block per SM (the occupancy calculator's count) walks
// a contiguous range of the (64-column tile, strip) work items, ordered
// column tile first, so a range crosses few tile boundaries.  The block
// stages pat once, in wgmma's core-matrix order (8 rows x 16 bytes, no
// swizzle; K-adjacent core matrices 128 bytes apart, 8-row groups one
// bank row of core matrices apart: 6,144 bytes in int8, 12,288 in bf16,
// 24,576 in TF32), and its warpgroups (two; three at M <= 64, where
// registers allow) take the range's items in turn.  A warpgroup computes,
// per strip,
//   D (64 columns of W x N) = oh_t tile (64 x 768) . pat^T (768 x N)
// with wgmma.m64nNk32.s32.s8.s8 (or m64n144k16.f32.bf16.bf16, or
// m64n72k8.f32.tf32.tf32) in its RS form: A lives in registers (96 a
// thread, 24 K steps x 4) and B is the staged pat, its descriptor computed
// once and stepped by an add per K step, which keeps the start of a
// product short.  A is loaded from device memory once per column tile
// (dotconst, K8), or built per item from the thread's two indices of t
// (K6), with one subtract and one clamping shift a register: the register
// holds K rows k0 + (0..3) (int8; 1 << 8 (t - k0)), k0 + (0, 1) (bf16;
// 0x3F80 << 16 (t - k0)) or k0 (TF32; 0x3F800000 << 32 (t - k0)), and a
// shift past 31 leaves 0.  bf16's 48 K steps would take 192 registers of A
// on top of its 72 of D, TF32's 96 steps 384, so A is built and started in
// parts of 24 steps (two in bf16, four in TF32): a part's registers are
// written only once the part before's products are done (wait_group), and
// the other warpgroup's part keeps the tensor cores busy meanwhile.  A
// 221,184-byte bank (bf16, TF32) leaves room for one s tile a warpgroup,
// not two.
// TF32's bank, 144 x 768 x 4 = 442,368 bytes, exceeds shared memory, so it
// is staged in two row groups of 72 by line, one after the other: group 0
// holds the rows 18 p + i of lines i = 0..8, group 1 those of i = 9..17
// (lines 16 and 17 are computed, as the TPU computed them, and dropped).
// A thread block stages group 0, walks its range, restages the bank with
// group 1 and walks the same range again, in one launch; each group makes
// whole lines of every strip, so no partial sum leaves the chip.  Only t is
// read twice and the one-hot built twice; the operations are the same.
// N = M up to 160; M = 256 runs as two N = 128 halves, so the accumulator
// stays at 64 registers.  Both operands stay on chip: device memory sees
// y, out (and t) only.  The warpgroups issue their products strictly in
// item order (a ring of named barriers, one turn per item and part), so
// the tensor cores finish one warpgroup's product before the next one's
// and each fold and store overlaps another warpgroup's product; left to
// the hardware, the products of all warpgroups run interleaved, end
// together, and the tensor cores idle through the folds, K7's with its
// shuffles the longest.  Each thread's 16-byte vector of y (and its two
// indices of t) are loaded one item ahead.
//
// The fold has no atomics.  The thread with warp w, lane 4g + tig holds D
// rows 16w + g and 16w + g + 8 (two columns of W) and D columns 8j + 2tig +
// {0, 1} (pattern rows n).  Row n = stride p + i is summed into the thread
// that owns i, the one with tig = (i mod 8) / 2: for stride 16 that is the
// thread itself; for stride 18 it is tig - p mod 4, reached by three quad
// shuffles of the per-rotation sums.  Rows outside every slice are dropped.
// bf16's D entries are exact integers in f32 (each is one value of pat or
// 0), converted with __float2int_rn before the same fold.  TF32 stages its
// group's rows in its own order: bank row n = 8 i' + p holds pattern row
// 18 p + 9 grp + i', so a thread's D columns 8j + 2tig + {0, 1} are slices
// of one line, 9 grp + j, and a line's s is two adds and two quad shuffles
// (no rotation); lines past 15 fold nowhere.
// Each thread ends with 8 values of s (2 columns x 4 values of i; TF32 2
// columns of its group's lines j = tig mod 4), written to a 16 x 64 int32
// tile in shared memory (rows padded to 68 words: no bank conflict), then
// each thread adds its vector of y, clips and stores it (TF32: the lines of
// the group).  A strip row of a tile is 128 bytes: y and out move as whole
// rows.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (ops/_kernels.py does this at first use).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kK = 768;                  // product depth
// Where A comes from: the constant oh_t (dotconst, K8), or the one-hot of
// t built in registers, in int8, bf16 or TF32 (K6).
enum Src { kConst = 0, kOneHotS8 = 1, kOneHotBf16 = 2, kOneHotTf32 = 3 };
// Consumer warpgroups of a thread block: three where the product is short
// (M <= 64, 130-160 registers a thread), two where the registers allow no
// more (188-254).
__host__ __device__ constexpr int warpgroups(int m) {
  return m <= 64 ? 3 : 2;
}
constexpr int kCols = 64;                // columns of W per work item
constexpr int kLBO = 128;                // K-adjacent core matrices
constexpr int kSRow = 68;                // s tile row, int32 (padded)
constexpr int kSTile = 16 * kSRow;       // one s tile, int32
constexpr int kSmemMax = 232448;         // opt-in dynamic shared memory

__host__ __device__ constexpr int row_bytes(int src) {
  return kK * (src == kOneHotTf32 ? 4 : src == kOneHotBf16 ? 2 : 1);
}
// Banks staged in turn: TF32's 144 rows (442,368 bytes) exceed shared
// memory, so it stages two row groups of 72; the others all M rows at once.
__host__ __device__ constexpr int groups(int src) {
  return src == kOneHotTf32 ? 2 : 1;
}
__host__ __device__ constexpr int bank_bytes(int m, int src) {
  return m / groups(src) * row_bytes(src);
}
// s tiles a warpgroup: two, so that one item's fold never waits for the
// epilogue of the one before; one where the bank leaves no room (bf16,
// TF32).
__host__ __device__ constexpr int stiles(int m, int src) {
  return bank_bytes(m, src) + warpgroups(m) * 2 * kSTile * 4 <= kSmemMax ? 2
                                                                         : 1;
}
__host__ __device__ constexpr int smem_bytes(int m, int src) {
  return bank_bytes(m, src) + warpgroups(m) * stiles(m, src) * kSTile * 4;
}

template <int N>
__device__ __forceinline__ void wgmma_rs(int (&d)[N / 2],
                                         const unsigned (&a)[4],
                                         uint64_t desc_b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_rs<16>(
    int (&d)[8], const unsigned (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(
    int (&d)[32], const unsigned (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(
    int (&d)[64], const unsigned (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<144>(
    int (&d)[72], const unsigned (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71"
      "}, {%72, %73, %74, %75}, %76, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<160>(
    int (&d)[80], const unsigned (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, {%80, %81, %82, %83}, %84, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// bf16 with f32 accumulators, N = 144 (K6's bf16 mode); B not transposed.
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[72],
                                              const unsigned (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %77, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71"
      "}, {%72, %73, %74, %75}, %76, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// TF32 with f32 accumulators, N = 72 (K6's f32 mode, one row group); A
// and B K-major, the only order TF32 takes.
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[36],
                                              const unsigned (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35"
      "}, {%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of ``r`` across the asynchronous
// product.
template <typename T>
__device__ __forceinline__ void pin(T& r) {
  if constexpr (std::is_same<T, float>::value)
    asm volatile("" : "+f"(r)::"memory");
  else
    asm volatile("" : "+r"(r)::"memory");
}

// v << s, 0 for any s outside [0, 32) (PTX clamps the shift amount).
__device__ __forceinline__ unsigned shl_clamp(unsigned v, int s) {
  unsigned r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(v), "r"(s));
  return r;
}

// bf16 bits of the int8 bytes j and j + 1 of w, low half first (exact).
__device__ __forceinline__ unsigned bf16_pair(unsigned w, int j) {
  const float lo = static_cast<int8_t>(w >> (8 * j));
  const float hi = static_cast<int8_t>(w >> (8 * j + 8));
  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & 0xFFFF0000u);
}

// Shared-memory matrix descriptor, no swizzle; `sbo`: 8-row groups.
__device__ __forceinline__ uint64_t desc_of(uint32_t saddr, int sbo) {
  return uint64_t((saddr & 0x3FFFF) >> 4) |
         (uint64_t(kLBO >> 4) << 16) | (uint64_t(sbo >> 4) << 32);
}

// Adds chunk [kN0, kN0 + kNc) of D into the per-rotation sums rot[k][h][e]
// [row]: the slice rows stride p + 8h + (0..7) whose owner is tig - k mod 4.
template <int kStride, int kSlices, int kN0, int kNc>
__device__ __forceinline__ void fold(const int (&d)[kNc / 2],
                                     int (&rot)[4][2][2][2], int tig) {
#pragma unroll
  for (int p = 0; p < kSlices; ++p) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int base = kStride * p + 8 * h;
      if (base < kN0 || base >= kN0 + kNc) continue;
      const int k = (base / 2) & 3;
      const int j0 = (base - kN0) / 8;
      const int j1 = j0 + 1 < kNc / 8 ? j0 + 1 : j0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // the thread's row of this 8-row range: n = base + off
        const int off = (2 * tig + e - base) & 7;
        const bool up = (base & 7) + off >= 8;
#pragma unroll
        for (int row = 0; row < 2; ++row)
          rot[k][h][e][row] += up ? d[4 * j1 + 2 * row + e]
                                  : d[4 * j0 + 2 * row + e];
      }
    }
  }
}

template <int kM, int kStride, int kSlices, int kSrc>
__global__ void __launch_bounds__(128 * warpgroups(kM), 1)
dotconst_kernel(const unsigned short* __restrict__ y,
                unsigned short* __restrict__ out,
                const int8_t* __restrict__ pat,
                const void* __restrict__ src_a, int strips, int width,
                int hi) {
  constexpr bool kOneHot = kSrc != kConst, kBf16 = kSrc == kOneHotBf16;
  constexpr bool kTf32 = kSrc == kOneHotTf32;
  constexpr int kGroups = groups(kSrc);          // banks staged in turn
  constexpr int kN = kM / kGroups;               // pattern rows a bank
  constexpr int kLines = kN / kSlices;           // TF32: lines a group
  constexpr int kChunkN = kN > 160 ? 128 : kN;
  constexpr int kChunks = kN / kChunkN;
  constexpr bool kRotate = kStride % 8 != 0;
  constexpr int kWG = warpgroups(kM), kThreads = 128 * kWG;
  constexpr int kPieces = row_bytes(kSrc) / 16;  // core matrices along K
  constexpr int kSBO = kPieces * 128;            // 8-row groups
  // k32 (s8), k16 (bf16) or k8 (TF32) steps
  constexpr int kSteps = row_bytes(kSrc) / 32;
  constexpr int kParts = kTf32 ? 4 : kBf16 ? 2 : 1;  // A held a part at a time
  constexpr int kStepsA = kSteps / kParts;
  constexpr int kTiles = stiles(kM, kSrc);
  using Acc = typename std::conditional<kBf16 || kTf32, float, int>::type;
  static_assert(!kOneHot || (kM == 144 && kChunks == 1),
                "the one-hot product has one instance, M = 144");
  static_assert(!kTf32 || (kGroups * kLines == kStride && kLines == 9),
                "TF32's two row groups hold lines 0-8 and 9-17 of K6");
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = tid & 31, g = lane >> 2, tig = lane & 3;
  const int8_t* oh_t = static_cast<const int8_t*>(src_a);
  const int* tix = static_cast<const int*>(src_a);

#pragma unroll 1
  for (int grp = 0; grp < kGroups; ++grp) {
    // every product that reads the last bank is done (wait_group 0)
    if (grp > 0) __syncthreads();
    // pat into core-matrix order: 16-byte piece i = ((n / 8) * kPieces + kc)
    // * 8 + n % 8 of bank row n lands at byte 16 i; bf16 and TF32 converted
    // on the way.  TF32: bank row n = 8 i' + p is pattern row 18 p + 9 grp +
    // i', line 9 grp + i' of slice p.
    for (int i = tid; i < kN * kPieces; i += kThreads) {
      const int r8 = i / (8 * kPieces), rem = i - r8 * 8 * kPieces;
      const int kc = rem >> 3, n = r8 * 8 + (rem & 7);
      const int row = kTf32 ? kStride * (n & 7) + kLines * grp + (n >> 3) : n;
      uint4 v;
      if constexpr (kTf32) {
        const unsigned b =
            __ldg(reinterpret_cast<const unsigned*>(pat + row * kK + kc * 4));
        v = make_uint4(__float_as_uint(float(static_cast<int8_t>(b))),
                       __float_as_uint(float(static_cast<int8_t>(b >> 8))),
                       __float_as_uint(float(static_cast<int8_t>(b >> 16))),
                       __float_as_uint(float(static_cast<int8_t>(b >> 24))));
      } else if constexpr (kBf16) {
        const uint2 b =
            __ldg(reinterpret_cast<const uint2*>(pat + row * kK + kc * 8));
        v = make_uint4(bf16_pair(b.x, 0), bf16_pair(b.x, 2), bf16_pair(b.y, 0),
                       bf16_pair(b.y, 2));
      } else {
        v = __ldg(reinterpret_cast<const uint4*>(pat + row * kK + kc * 16));
      }
      *reinterpret_cast<uint4*>(smem + 16 * i) = v;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // the bank's descriptor; a K step or an N chunk further on adds its byte
    // offset / 16 to the address field, which no offset here carries out of
    const uint64_t bank = desc_of(
        static_cast<uint32_t>(__cvta_generic_to_shared(smem)), kSBO);
    int* stile = reinterpret_cast<int*>(smem + bank_bytes(kM, kSrc)) +
                 wg * kTiles * kSTile;
    const int tiles = (width + kCols - 1) / kCols;
    const long long total = static_cast<long long>(tiles) * strips;
    const int lo = static_cast<int>(total * blockIdx.x / gridDim.x);
    const int end = static_cast<int>(total * (blockIdx.x + 1) / gridDim.x);
    const int ei = t >> 3, ev = t & 7;   // epilogue: line, 8-column vector
    // TF32: the epilogue's line is this group's (9 grp .. 9 grp + 8)
    const bool mine = !kTf32 || unsigned(ei - kLines * grp) < unsigned(kLines);
    unsigned a[kStepsA][4];
    int cur = -1, parity = 0;
    // the warpgroup's items lo + wg, lo + wg + kWG, ... as (tile, strip);
    // the y vector (and the two indices of t) of the next one are in flight
    // while this one runs
    int tile = (lo + wg) / strips, strip = lo + wg - tile * strips;
    uint4 ynext = make_uint4(0, 0, 0, 0);
    int tnext[2] = {-1, -1};
    const auto prefetch = [&](bool valid) {
      if (valid && mine && tile * kCols + 8 * ev < width)
        ynext = __ldg(reinterpret_cast<const uint4*>(
            y + (static_cast<size_t>(strip) * 16 + ei) * width + tile * kCols +
            8 * ev));
      if constexpr (kOneHot) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          // A rows: columns col0 + 16 warp + g (+8); past W, no K row
          const int col = tile * kCols + 16 * warp + g + 8 * r;
          tnext[r] = valid && col < width
                         ? __ldg(tix + static_cast<size_t>(strip) * width + col)
                         : -1;
        }
      }
    };
    prefetch(lo + wg < end);

    for (int item = lo + wg; item < end; item += kWG) {
      const int col0 = tile * kCols;
      // one-hot: the register of A for K rows k0 + (0..3) (int8) or k0 +
      // (0, 1) (bf16) or k0 (TF32) of a column with index tv is one << (x -
      // c), x = 8 (tv - 4 tig), 16 (tv - 2 tig) or 32 (tv - tig), c = 256 ks
      // + 128 (q >> 1); an index outside [0, 768) becomes -1024, whose x - c
      // is negative: no row
      int x[2] = {0, 0};
      if constexpr (kOneHot) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int tv = unsigned(tnext[r]) < unsigned(kK) ? tnext[r] : -1024;
          x[r] = kTf32   ? 32 * (tv - tig)
                 : kBf16 ? 16 * (tv - 2 * tig)
                         : 8 * (tv - 4 * tig);
        }
      } else if (tile != cur) {
        // A fragments of this tile: rows col0 + 16 warp + g (+8), K bytes
        // 32 ks + 4 tig (+16); rows past W are zero
        cur = tile;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = col0 + 16 * warp + g + 8 * (q & 1);
          const unsigned* src = reinterpret_cast<const unsigned*>(
              oh_t + static_cast<size_t>(col < width ? col : 0) * kK +
              16 * (q >> 1) + 4 * tig);
#pragma unroll
          for (int ks = 0; ks < kSteps; ++ks)
            a[ks][q] = col < width ? __ldg(src + 8 * ks) : 0u;
        }
        // Wait for the fragments here, by storing their OR to a padding
        // word of the s tile that nothing reads: left to the product's fence,
        // that wait also covers the next item's y, loaded after them on the
        // same scoreboard, a trip to device memory before every product.
        unsigned any = 0;
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks)
#pragma unroll
          for (int q = 0; q < 4; ++q) any |= a[ks][q];
        stile[(t & 15) * kSRow + 64] = static_cast<int>(any);
      }
      const int col = col0 + 8 * ev;
      const bool live = mine && col < width;
      const size_t off = (static_cast<size_t>(strip) * 16 + ei) * width + col;
      strip += kWG;
      while (strip >= strips) {
        strip -= strips;
        ++tile;
      }
      const uint4 yv = ynext;
      // dotconst and K8 load the next item's y before this product, K6 its
      // indices and y just after issuing it: on the H100 each order timed
      // faster for its kernel (M = 16 and K6 int8 the most).
      if constexpr (!kOneHot) prefetch(item + kWG < end);

      int rot[4][2][2][2];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) rot[k][h][e][0] = rot[k][h][e][1] = 0;
      int lines[kTf32 ? kLines : 1][2];  // TF32: s of line kLines grp + j
      // The warpgroups start their products in item order, each after the
      // one before it has started its own (named barriers 1 + kWG + wg): the
      // tensor cores then run one product at a time, and the other
      // warpgroups' folds and stores overlap it.  bf16 and TF32 take a turn
      // per part: (item, part 0) of every warpgroup, then (item, part 1) of
      // every one, and so on.  ``alone``: the range's last turn round holds
      // this item only, so no other warpgroup's turn comes between its parts.
      const bool alone = wg == 0 && item + 1 >= end;
      const int next = item + 1 < end && wg + 1 < kWG ? wg + 1 : 0;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        Acc d[kChunkN / 2];
#pragma unroll
        for (int j = 0; j < kChunkN / 2; ++j) {
          d[j] = Acc(0);
          pin(d[j]);
        }
#pragma unroll
        for (int h = 0; h < kParts; ++h) {
          if constexpr (kOneHot) {
            // the previous part's products are done: A may be rewritten
#pragma unroll
            for (int ks = 0; ks < kStepsA; ++ks)
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                a[ks][q] = shl_clamp(kTf32   ? 0x3F800000u
                                     : kBf16 ? 0x3F80u
                                             : 1u,
                                     x[q & 1] - 256 * (h * kStepsA + ks) -
                                         128 * (q >> 1));
                pin(a[ks][q]);
              }
          }
          wgmma_fence();
          if (c == 0 && (h == 0 ? item > lo : !alone))
            asm volatile("bar.sync %0, %1;\n" ::"r"(1 + kWG + wg), "n"(256)
                         : "memory");
#pragma unroll
          for (int ks = 0; ks < kStepsA; ++ks) {  // two core matrices of K
            const uint64_t desc =
                bank + ((c * (kChunkN / 8) * kSBO +
                         2 * kLBO * (h * kStepsA + ks)) >> 4);
            if constexpr (kTf32)
              wgmma_rs_tf32(d, a[ks], desc, h > 0 || ks > 0);
            else if constexpr (kBf16)
              wgmma_rs_bf16(d, a[ks], desc, h > 0 || ks > 0);
            else
              wgmma_rs<kChunkN>(d, a[ks], desc, ks > 0);
          }
          asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
          if (c == 0 && (h < kParts - 1 ? !alone : item + 1 < end))
            asm volatile("bar.arrive %0, %1;\n" ::"r"(1 + kWG + next), "n"(256)
                         : "memory");
          if constexpr (kOneHot)
            if (c == 0 && h == kParts - 1) prefetch(item + kWG < end);
          asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        }
#pragma unroll
        for (int j = 0; j < kChunkN / 2; ++j) pin(d[j]);
        if constexpr (kTf32) {
          // D columns 8j + 2tig + {0, 1}: slices 2tig, 2tig + 1 of line
          // kLines grp + j; the quad's four threads hold its eight (exact
          // integers in f32)
#pragma unroll
          for (int j = 0; j < kLines; ++j)
#pragma unroll
            for (int row = 0; row < 2; ++row) {
              int v = __float2int_rn(d[4 * j + 2 * row]) +
                      __float2int_rn(d[4 * j + 2 * row + 1]);
              v += __shfl_xor_sync(0xffffffffu, v, 1);
              lines[j][row] = v + __shfl_xor_sync(0xffffffffu, v, 2);
            }
        } else if constexpr (kBf16) {
          int di[kChunkN / 2];  // exact: each entry is one value of pat, or 0
#pragma unroll
          for (int j = 0; j < kChunkN / 2; ++j) di[j] = __float2int_rn(d[j]);
          fold<kStride, kSlices, 0, kChunkN>(di, rot, tig);
        } else if (c == 0) {
          fold<kStride, kSlices, 0, kChunkN>(d, rot, tig);
        } else {
          fold<kStride, kSlices, kChunkN, kChunkN>(d, rot, tig);
        }
      }

      int* s = stile + (kTiles == 2 ? parity : 0) * kSTile;
      // one tile: every thread has read the previous item's s
      if constexpr (kTiles == 1)
        asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      if constexpr (kTf32) {
        // thread tig writes the lines j = tig mod 4; lines past 15 nowhere
#pragma unroll
        for (int j = 0; j < kLines; ++j) {
          if ((j & 3) != tig || kLines * grp + j >= 16) continue;
          s[(kLines * grp + j) * kSRow + 16 * warp + g] = lines[j][0];
          s[(kLines * grp + j) * kSRow + 16 * warp + g + 8] = lines[j][1];
        }
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int row = 0; row < 2; ++row) {
              int v = rot[0][h][e][row];
              if constexpr (kRotate) {
#pragma unroll
                for (int k = 1; k < 4; ++k)
                  v += __shfl_sync(0xffffffffu, rot[k][h][e][row],
                                   (lane & ~3) | ((tig + k) & 3));
              }
              s[(8 * h + 2 * tig + e) * kSRow + 16 * warp + g + 8 * row] = v;
            }
      }
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      if (live) {
        const int4* sp = reinterpret_cast<const int4*>(s + ei * kSRow + 8 * ev);
        const int4 s0 = sp[0], s1 = sp[1];
        const int sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        const unsigned yw[4] = {yv.x, yv.y, yv.z, yv.w};
        unsigned ow[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int v0 = min(max(int(yw[q] & 0xffffu) + sv[2 * q], 0), hi);
          const int v1 = min(max(int(yw[q] >> 16) + sv[2 * q + 1], 0), hi);
          ow[q] = unsigned(v0) | (unsigned(v1) << 16);
        }
        *reinterpret_cast<uint4*>(out + off) =
            make_uint4(ow[0], ow[1], ow[2], ow[3]);
      }
      parity ^= 1;
    }
  }
}

template <int kM, int kStride, int kSlices, int kSrc>
cudaError_t configure(int* blocks_per_sm) {
  auto kern = dotconst_kernel<kM, kStride, kSlices, kSrc>;
  static int blocks = 0;
  if (blocks == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes(kM, kSrc));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kern, 128 * warpgroups(kM), smem_bytes(kM, kSrc));
    if (e != cudaSuccess) return e;
    if (blocks < 1) return cudaErrorInvalidConfiguration;
  }
  *blocks_per_sm = blocks;
  return cudaSuccess;
}

template <int kM, int kStride, int kSlices, int kSrc>
int launch(const void* y, void* out, const void* pat, const void* a,
           int frames, int rows, int width, int hi, cudaStream_t st) {
  int blocks = 0, dev = 0, sms = 0;
  cudaError_t e = configure<kM, kStride, kSlices, kSrc>(&blocks);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return int(e);
  const int strips = frames * rows;
  const long long total =
      static_cast<long long>((width + kCols - 1) / kCols) * strips;
  const int grid = static_cast<int>(
      total < static_cast<long long>(sms) * blocks ? total : sms * blocks);
  dotconst_kernel<kM, kStride, kSlices, kSrc><<<
      grid, 128 * warpgroups(kM), smem_bytes(kM, kSrc), st>>>(
      static_cast<const unsigned short*>(y), static_cast<unsigned short*>(out),
      static_cast<const int8_t*>(pat), a, strips, width, hi);
  return int(cudaGetLastError());
}

template <int kM, int kStride, int kSlices, int kSrc>
int info(int* regs, int* smem, int* local, int* blocks) {
  cudaFuncAttributes fa;
  cudaError_t e = configure<kM, kStride, kSlices, kSrc>(blocks);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&fa,
                              dotconst_kernel<kM, kStride, kSlices, kSrc>);
  if (e != cudaSuccess) return int(e);
  *regs = fa.numRegs;
  *smem = smem_bytes(kM, kSrc);
  *local = static_cast<int>(fa.localSizeBytes);
  return 0;
}

}  // namespace

#define VFG_DOTCONST_DISPATCH(CALL)                                        \
  if (src == kOneHotS8 || src == kOneHotBf16 || src == kOneHotTf32) {      \
    if (m != 144 || stride != 18 || slices != 8)                           \
      return int(cudaErrorInvalidValue);                                   \
    return src == kOneHotS8     ? CALL(144, 18, 8, kOneHotS8)              \
           : src == kOneHotBf16 ? CALL(144, 18, 8, kOneHotBf16)            \
                                : CALL(144, 18, 8, kOneHotTf32);           \
  }                                                                        \
  if (src != kConst) return int(cudaErrorInvalidValue);                    \
  if (m == 144 && stride == 18 && slices == 8)                             \
    return CALL(144, 18, 8, kConst);                                       \
  if (stride != 16 || slices * 16 != m) return int(cudaErrorInvalidValue); \
  switch (m) {                                                             \
    case 16: return CALL(16, 16, 1, kConst);                               \
    case 64: return CALL(64, 16, 4, kConst);                               \
    case 128: return CALL(128, 16, 8, kConst);                             \
    case 144: return CALL(144, 16, 9, kConst);                             \
    case 160: return CALL(160, 16, 10, kConst);                            \
    case 256: return CALL(256, 16, 16, kConst);                            \
    default: return int(cudaErrorInvalidValue);                            \
  }

// One probe step.  `src`: 0 the constant product (dotconst, K8), `a` =
// oh_t, (width, 768) int8, 16-byte aligned; 1, 2 or 3 K6's one-hot product
// in int8, bf16 or TF32, `a` = t, (frames, rows, 1, width) int32 (an index
// outside [0, 768) matches no one-hot row).  `y`, `out`: (frames, 16 rows,
// width) uint16, 16-byte aligned, width a multiple of 8; `pat`: (m, 768)
// int8, 16-byte aligned; (m, stride, slices) = (144, 18, 8), or for src 0
// (m, 16, m / 16) for m in 16, 64, 128, 144, 160, 256.  One thread block
// per SM at most as many as the occupancy calculator allows.  All pointers
// are device pointers.  Launches on `stream` and returns cudaGetLastError().
extern "C" int vfg_probe_dotconst(int src, int m, int stride, int slices,
                                  int hi, const void* y, void* out,
                                  const void* pat, const void* a, int frames,
                                  int rows, int width, void* stream) {
  const auto misaligned = [](const void* p, int n) {
    return reinterpret_cast<uintptr_t>(p) % n != 0;
  };
  if (y == nullptr || out == nullptr || pat == nullptr || a == nullptr ||
      misaligned(y, 16) || misaligned(out, 16) || misaligned(pat, 16) ||
      misaligned(a, src == kConst ? 16 : 4) || frames < 1 || rows < 1 ||
      width < 8 || width % 8 || hi < 0 || hi > 65535 ||
      static_cast<long long>(frames) * rows * ((width + kCols - 1) / kCols) >=
          (1LL << 30))
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VFG_LAUNCH(M, STRIDE, SLICES, SRC)                                \
  launch<M, STRIDE, SLICES, SRC>(y, out, pat, a, frames, rows, width, hi, \
                                 st)
  VFG_DOTCONST_DISPATCH(VFG_LAUNCH)
#undef VFG_LAUNCH
}

// Registers a thread, dynamic shared memory bytes, local memory bytes a
// thread and thread blocks per SM of one instance; returns a CUDA error.
extern "C" int vfg_probe_dotconst_info(int src, int m, int stride,
                                       int slices, int* regs, int* smem,
                                       int* local, int* blocks) {
#define VFG_INFO(M, STRIDE, SLICES, SRC) \
  info<M, STRIDE, SLICES, SRC>(regs, smem, local, blocks)
  VFG_DOTCONST_DISPATCH(VFG_INFO)
#undef VFG_INFO
}
