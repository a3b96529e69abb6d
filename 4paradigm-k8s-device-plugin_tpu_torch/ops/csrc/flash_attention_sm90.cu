// Fused attention forward for Hopper (sm_90a), the bf16 route at head_dim
// 64 and 128: TMA-fed wgmma, with the softmax and the output in registers.
//
// Replaces the Pallas TPU kernel `_attn_kernel` of
// 4paradigm-k8s-device-plugin_tpu/ops/flash_attention.py:39 (its
// pallas_call at :86), for the calls the serving path makes.
// flash_attention.cu stays the route for f32 and for head_dim 16 and 32.
// Same function and layout: q, k, v and the output are contiguous
// [bh, s, d] bf16 with K/V already repeated per head; scores, mask and
// softmax in f32; probabilities cast to bf16 before the p·v product, which
// accumulates in f32; output in bf16.
//
// What bounds it on an H100.  The kernel must read q, k, v once and write
// o once (8·bh·s·d bytes) and do 4·d flops per unmasked (query, key) pair:
// s/4 flops per byte when causal, s/2 when not, against the card's ~295
// flops per byte balance point (989 TFLOP/s bf16 over 3.35 TB/s).  At the
// serving shapes (d = 128, causal) s = 512 is bound by memory and
// s = 2048 by the tensor cores.  The first kernel (flash_attention.cu)
// reached 5-8% of that bound: WMMA fragments loaded from shared memory,
// scores and the running output round-tripping through shared memory, a
// serial softmax per warp, and no load overlapping the math.
//
// What the design does about it.
// - A block of 384 threads owns 128 query rows of one (batch·head): two
//   consumer warpgroups of 64 rows each (warps 0-7: wgmma needs
//   warpgroup-aligned warps) and a producer warpgroup in which one thread
//   issues every load and the rest exit.  setmaxnreg hands registers from
//   the producer (24) to the consumers (240).  The consumer branch comes
//   first in the kernel's one if/else: with the producer branch first,
//   ptxas allocated the d = 128 non-causal instance badly (it spilled
//   and serialised every wgmma) though the consumers fit in the budget.
// - TMA brings Q in once, then K and V in 128-key tiles through a ring of
//   kStages (3) shared-memory stages with a full and an empty mbarrier
//   each, so loads run ahead of the math.  The tensor maps are 3-D over
//   [bh, s, d]: a box that runs past row s of one head is zero-filled
//   rather than reading the next head's rows (a 2-D map over [bh·s, d]
//   would read them).  Boxes use the 128-byte swizzle, whose span is 64
//   bf16 columns, so a 128-column row tile arrives as two 64-column boxes
//   and the wgmma descriptors walk k across them.
// - S = Q·Kᵀ is m64n128k16 wgmma with both operands read from shared
//   memory (both K-major: d is contiguous in Q and in K), f32 in
//   registers.  The online softmax runs on those registers: each row of
//   the m64 fragment lies in the 4 threads of a quad, so a row max is two
//   shuffles; the running max is kept in the exp2 domain with
//   scale·log2(e) folded into one multiply-add; the running sum is kept
//   per thread and reduced over the quad once, at the end.
// - P is cast to bf16 in registers and fed to wgmma as the A operand
//   (the f32 accumulator layout of m64nNk16 is the A fragment layout of
//   the k16 slices).  V is the B operand, described MN-major because d is
//   contiguous in V.  O stays in registers (64 f32 per thread at d = 128),
//   is rescaled there and divided by the row sum at the end.
// - The tensor cores are kept busy through the softmax twice over.  In a
//   warpgroup, the scores of tile t are issued together with P·V of tile
//   t - 1, and tile t's softmax runs while that P·V finishes.  Between
//   the two warpgroups, two named barriers make them take turns issuing,
//   so one's softmax meets the other's products.
// - Only the tiles that cross the diagonal or run past s are masked;
//   tiles wholly above the diagonal are never loaded.  Within a head the
//   heaviest query tiles start first.
//
// Numerics are those of flash_attention.cu: the unnormalised
// probabilities are cast to bf16 and the f32 sum divides at the end
// (the Pallas kernel normalises and then casts; both agree within bf16
// rounding, 3e-2).
//
// Built by ops/_build.py with nvcc into a shared library with a plain C
// interface.  cuTensorMapEncodeTiled is reached through the runtime's
// driver entry point, so the library needs no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;        // query rows per block
constexpr int kBN = 128;        // keys per K/V tile
constexpr int kWgRows = 64;     // query rows per consumer warpgroup
constexpr int kConsumers = kBM / kWgRows;
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kStages = 3;      // depth of the K/V ring
constexpr int kBox = 64;        // columns per TMA box: the 128-byte swizzle span
constexpr int kRowBytes = kBox * 2;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, from a base aligned to 1024 bytes (the 128-byte swizzle
// repeats every 8 rows of 128 bytes).  Each tile holds d/64 boxes of 128
// rows x 128 bytes, one after the other.
template <int D>
struct Smem {
  static constexpr int kTile = kBN * D * 2;   // one 128-row tile of q, k or v
  static constexpr int kBoxBytes = kBN * kRowBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;  // q, full[], empty[]
  static constexpr int kAlloc = kBar + 8 * (1 + 2 * kStages) + 1024;
};
static_assert(kBM == kBN, "q and k/v tiles share one tensor-map box");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the phase of `bar` with this parity has completed.  A wait
// that never ends (a lost arrival) traps, so it fails the launch instead
// of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, tries = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (!done && ++tries == (1u << 28)) __trap();
  } while (!done);
}

// One box {64 columns, 128 rows, 1 head} at (col, row, head) into `dst`;
// completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(col), "r"(row), "r"(head)
      : "memory");
}

// wgmma descriptors of tiles in the 128-byte swizzle layout TMA writes:
// rows of 128 bytes, 8-row groups 1024 bytes apart (the stride byte
// offset).  The high word holds that stride and the swizzle mode, and is
// the same for every operand here.  The low word holds the start address
// and the leading byte offset `lbo`: unused by K-major operands, and for
// an MN-major one the distance between its 64-column boxes.  A k-step
// moves the start address by a constant, so the wgmma wrappers take one
// low word per operand and add each step's offset (in 16-byte units) as
// an immediate, which keeps the descriptors out of the register budget.
constexpr uint32_t kDescHi = (1024 >> 4) | (1u << 30);

__device__ __forceinline__ uint32_t desc_lo(uint32_t addr, uint32_t lbo) {
  return ((addr & 0x3FFFF) >> 4) | (((lbo >> 4) & 0x3FFF) << 16);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of register array `d`
// across this point.  After a wgmma wait, later reads see what the
// finished wgmma wrote; before wgmma.fence, earlier writes land before
// the fence, as wgmma requires of registers it reads.
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d[64] (+)= A[64x16] · B[16x128], A and B from shared memory, K-major,
// at `off` 16-byte units past the low descriptor words a and b.
template <uint32_t off>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint32_t a,
                                              uint32_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 al, bl;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "add.u32 al, %64, %67;\nadd.u32 bl, %65, %67;\n"
      "mov.b64 da, {al, %68};\nmov.b64 db, {bl, %68};\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a), "r"(b), "r"(accumulate), "n"(off), "r"(kDescHi));
}

// d[64] += A[64x16] · B[16x128], A from registers, B MN-major in shared
// memory at `off` 16-byte units past the low descriptor word b.
template <uint32_t off>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 bl;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "add.u32 bl, %68, %70;\nmov.b64 db, {bl, %71};\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b), "r"(1), "n"(off),
        "r"(kDescHi));
}

// d[32] += A[64x16] · B[16x64], as above at head_dim 64.
template <uint32_t off>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 bl;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "add.u32 bl, %36, %38;\nmov.b64 db, {bl, %39};\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, db, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b), "r"(1), "n"(off),
        "r"(kDescHi));
}

// Named barriers 1 and 2 order the two consumer warpgroups' wgmma issue:
// warpgroup w issues only after the other one has signalled barrier
// 1 + w, so one warpgroup's softmax runs while the other's products use
// the tensor cores.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(kConsumers * 128)
               : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(1 + (wg ^ 1)),
               "n"(kConsumers * 128) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// This thread's two rows of the online softmax (a: row r, b: row r + 8):
// the running maxima, in units of log2, and its share of the running sums.
struct Rows {
  float max_a, max_b, sum_a, sum_b;
};

// Issues S = Q·Kᵀ for one tile without waiting: d/16 k-steps of 32 bytes,
// four inside each 128-byte box.
template <int D, int kk = 0>
__device__ __forceinline__ void issue_scores(float (&sc)[64], uint32_t q_lo,
                                             uint32_t k_lo) {
  if constexpr (kk < D / 16) {
    constexpr uint32_t off = (kk / 4) * Smem<D>::kBoxBytes + (kk % 4) * 32;
    wgmma_ss_n128<off / 16>(sc, q_lo, k_lo, kk > 0);
    issue_scores<D, kk + 1>(sc, q_lo, k_lo);
  }
}

// Issues O += P·V for one tile without waiting: 8 k-steps of 16 keys,
// 2048 bytes apart in each box.
template <int D, int kk = 0>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[kBN / 4],
                                         uint32_t v_lo) {
  if constexpr (kk < kBN / 16) {
    wgmma_rs<kk * 16 * kRowBytes / 16>(acc, pa[4 * kk], pa[4 * kk + 1],
                                       pa[4 * kk + 2], pa[4 * kk + 3], v_lo);
    issue_pv<D, kk + 1>(acc, pa, v_lo);
  }
}

// The online softmax of one score tile whose first key is n0, in place:
// masks the tile if it crosses the diagonal or runs past s (`edge`),
// moves the running maxima and sums, and leaves the unnormalised
// probabilities in `sc`.  Returns the factors (row a, row b) by which the
// output must be rescaled.  Every row's first tile holds its key 0, so
// the new maxima are finite and the factors are 0 on the first tile.
template <bool kCausal>
__device__ __forceinline__ float2 softmax_tile(float (&sc)[64], Rows& r,
                                               bool edge, int n0, int s,
                                               int row_a, int col0,
                                               float scale_log2) {
  if (edge) {
    // Key n0 + 8j + col0 + e is live for a row while 8j + e <= its limit.
    const int last_a = kCausal ? min(s - 1, row_a) : s - 1;
    const int last_b = kCausal ? min(s - 1, row_a + 8) : s - 1;
    const int lim_a = last_a - n0 - col0, lim_b = last_b - n0 - col0;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (8 * j + e > lim_a) sc[4 * j + e] = -INFINITY;
        if (8 * j + e > lim_b) sc[4 * j + 2 + e] = -INFINITY;
      }
    }
  }
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  const float new_a = fmaxf(r.max_a, quad_max(mx_a) * scale_log2);
  const float new_b = fmaxf(r.max_b, quad_max(mx_b) * scale_log2);
  const float2 alpha = make_float2(ex2(r.max_a - new_a), ex2(r.max_b - new_b));
  r.max_a = new_a;
  r.max_b = new_b;
  float add_a = 0.0f, add_b = 0.0f;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    sc[4 * j] = ex2(fmaf(sc[4 * j], scale_log2, -new_a));
    sc[4 * j + 1] = ex2(fmaf(sc[4 * j + 1], scale_log2, -new_a));
    sc[4 * j + 2] = ex2(fmaf(sc[4 * j + 2], scale_log2, -new_b));
    sc[4 * j + 3] = ex2(fmaf(sc[4 * j + 3], scale_log2, -new_b));
    add_a += sc[4 * j] + sc[4 * j + 1];
    add_b += sc[4 * j + 2] + sc[4 * j + 3];
  }
  r.sum_a = r.sum_a * alpha.x + add_a;
  r.sum_b = r.sum_b * alpha.y + add_b;
  return alpha;
}

// P in bf16, laid out as the A fragments of the 8 k16 slices: the f32
// accumulator layout of m64nNk16 is their layout.
__device__ __forceinline__ void to_a_fragments(const float (&sc)[64],
                                               uint32_t (&pa)[kBN / 4]) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    pa[2 * j] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    pa[2 * j + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

// One block: kBM query rows of one (batch·head) against all its keys.
//
// Fragment layout of an m64nN f32 accumulator, thread t of a warpgroup:
// d[4j + e] is (row r, column 8j + 2(t%4) + e) and d[4j + 2 + e] is
// (row r + 8, the same column), with r = 16(t/32) + (t%32)/4, e in {0, 1}.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kThreads, 1)
    attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         bf16* __restrict__ o, int s, float scale_log2) {
  using L = Smem<D>;
  constexpr int kBoxes = D / kBox;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBar;
  auto bar_full = [&](int st) { return bar_q + 8u * (1 + st); };
  auto bar_empty = [&](int st) { return bar_q + 8u * (1 + kStages + st); };

  const int n_qt = (s + kBM - 1) / kBM;
  const int bh = blockIdx.x / n_qt;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x % n_qt);
  const int m0 = qt * kBM;
  // Causal: the tiles up to the one holding key m0 + kBM - 1 (or s - 1).
  const int n_tiles = kCausal ? qt + 1 : (s + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full(st), 1);
      mbar_init(bar_empty(st), kConsumers * 4);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg < kConsumers) {
    // Consumer warpgroup wg: query rows m0 + 64·wg .. + 63.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32;
    const int row_a = m0 + wg * kWgRows + (tid / 32) * 16 + lane / 4;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_rows = base + L::kQ + wg * kWgRows * kRowBytes;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    Rows rows{-INFINITY, -INFINITY, 0.0f, 0.0f};
    uint32_t pa[kBN / 4];
    const uint32_t q_lo = desc_lo(q_rows, 16);
    auto k_lo = [&](int st) { return desc_lo(base + L::kK + st * L::kTile, 16); };
    auto v_lo = [&](int st) {
      return desc_lo(base + L::kV + st * L::kTile, L::kBoxBytes);
    };
    const int wg_row0 = m0 + wg * kWgRows;
    auto edge = [&](int t) {
      return (t + 1) * kBN > s || (kCausal && (t + 1) * kBN - 1 > wg_row0);
    };

    // Tile 0: its scores and softmax (the output is still zero).
    // Warpgroup 0 issues first.
    if (wg == 1) turn_pass(wg);
    mbar_wait(bar_q, 0);
    mbar_wait(bar_full(0), 0);
    __syncwarp();  // wgmma wants the warp converged
    {
      float sc[64];
      turn_wait(wg);
      wg_fence();
      issue_scores<D>(sc, q_lo, k_lo(0));
      wg_commit();
      turn_pass(wg);
      wg_wait<0>();
      pin(sc);
      softmax_tile<kCausal>(sc, rows, edge(0), 0, s, row_a, col0,
                            scale_log2);
      to_a_fragments(sc, pa);
    }
    // Tile t: its scores run on the tensor cores beside P·V of tile t - 1,
    // and its softmax while that P·V finishes.  Nothing the running P·V
    // reads (its A fragments, the output) is written before it is waited
    // for.
#pragma unroll 1
    for (int t = 1; t < n_tiles; ++t) {
      const int st = t % kStages;
      const int prev = (t - 1) % kStages;
      mbar_wait(bar_full(st), (t / kStages) & 1);
      __syncwarp();
      float sc[64];
      pin(acc);
      pin(pa);
      turn_wait(wg);
      wg_fence();
      issue_scores<D>(sc, q_lo, k_lo(st));
      wg_commit();
      issue_pv<D>(acc, pa, v_lo(prev));
      wg_commit();
      turn_pass(wg);
      wg_wait<1>();  // the scores are in; P·V may still run
      pin(sc);
      const float2 alpha = softmax_tile<kCausal>(
          sc, rows, edge(t), t * kBN, s, row_a, col0, scale_log2);
      wg_wait<0>();
      pin(acc);
      if (lane == 0) mbar_arrive(bar_empty(prev));
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha.x;
        acc[4 * j + 1] *= alpha.x;
        acc[4 * j + 2] *= alpha.y;
        acc[4 * j + 3] *= alpha.y;
      }
      to_a_fragments(sc, pa);
    }
    pin(acc);
    pin(pa);
    turn_wait(wg);
    wg_fence();
    issue_pv<D>(acc, pa, v_lo((n_tiles - 1) % kStages));
    wg_commit();
    if (wg == 0) turn_pass(wg);  // warpgroup 1 issues last
    wg_wait<0>();
    pin(acc);

    const float inv_a = 1.0f / quad_sum(rows.sum_a);
    const float inv_b = 1.0f / quad_sum(rows.sum_b);
    bf16* out = o + static_cast<size_t>(bh) * s * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + col0;
      if (row_a < s)
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<size_t>(row_a) * D + col) =
            __floats2bfloat162_rn(acc[4 * j] * inv_a, acc[4 * j + 1] * inv_a);
      if (row_a + 8 < s)
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<size_t>(row_a + 8) * D + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] * inv_b, acc[4 * j + 3] * inv_b);
    }
  } else {
    // Producer: one thread keeps the ring full; the others leave.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(bar_q, L::kTile);
#pragma unroll
      for (int c = 0; c < kBoxes; ++c)
        tma_load(base + L::kQ + c * L::kBoxBytes, &map_q, bar_q, c * kBox,
                 m0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(bar_empty(st), (t / kStages - 1) & 1);
        mbar_expect_tx(bar_full(st), 2 * L::kTile);
        const uint32_t k_dst = base + L::kK + st * L::kTile;
        const uint32_t v_dst = base + L::kV + st * L::kTile;
#pragma unroll
        for (int c = 0; c < kBoxes; ++c) {
          tma_load(k_dst + c * L::kBoxBytes, &map_k, bar_full(st), c * kBox,
                   t * kBN, bh);
          tma_load(v_dst + c * L::kBoxBytes, &map_v, bar_full(st), c * kBox,
                   t * kBN, bh);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over [bh, s, d] bf16 (innermost first) with {64, 128, 1}
// boxes in the 128-byte swizzle; reads past s or d are zero-filled.
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int bh,
              int s, int d) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(s) * d * 2};
  const cuuint32_t box[3] = {kBox, kBN, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool kCausal>
cudaError_t launch(const CUtensorMap& mq, const CUtensorMap& mk,
                   const CUtensorMap& mv, void* o, int bh, int s, float scale,
                   cudaStream_t stream) {
  auto kernel = attn_fwd_sm90_kernel<D, kCausal>;
  constexpr int smem = Smem<D>::kAlloc;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>(bh) * ((s + kBM - 1) / kBM);
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(o), s, scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_causal(int causal, const CUtensorMap& mq,
                          const CUtensorMap& mk, const CUtensorMap& mv,
                          void* o, int bh, int s, float scale,
                          cudaStream_t stream) {
  return causal ? launch<D, true>(mq, mk, mv, o, bh, s, scale, stream)
                : launch<D, false>(mq, mk, mv, o, bh, s, scale, stream);
}

}  // namespace

// The arguments of vtpu_flash_attention_fwd; takes dtype 1 (bfloat16) and
// d = 64 or 128 only.  Launches on `stream`, allocates nothing, does not
// synchronise; returns the launch's cudaError_t.
extern "C" int vtpu_flash_attention_fwd_sm90(const void* q, const void* k,
                                             const void* v, void* o, int bh,
                                             int s, int d, int dtype,
                                             int causal, float scale,
                                             void* stream) {
  if (dtype != 1 || (d != 64 && d != 128) || bh <= 0 || s <= 0)
    return cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!make_map(encode, &mq, q, bh, s, d) ||
      !make_map(encode, &mk, k, bh, s, d) ||
      !make_map(encode, &mv, v, bh, s, d))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return d == 64
             ? launch_causal<64>(causal, mq, mk, mv, o, bh, s, scale, st)
             : launch_causal<128>(causal, mq, mk, mv, o, bh, s, scale, st);
}
