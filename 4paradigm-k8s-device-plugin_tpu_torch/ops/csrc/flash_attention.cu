// Fused attention forward for Hopper (sm_90a): softmax(q·kᵀ·d^-½)·v.
//
// Replaces the Pallas TPU kernel `_attn_kernel` of
// 4paradigm-k8s-device-plugin_tpu/ops/flash_attention.py (driven by the
// jitted `flash_attention` there).  Same function, same layout: q, k, v and
// the output are contiguous [bh, s, d] with K/V already repeated per head;
// scores, mask and softmax in f32; the probabilities cast to the input type
// before the p·v product, which accumulates in f32; output in the input
// type.
//
// What bounds it on an H100.  Per (bh) row block the kernel reads q, k, v
// once and writes o once (4·bh·s·d elements) and does 4·d flops per
// unmasked (query, key) pair.  At d = 128 in bf16 that is s/2 flops per
// byte for causal attention against the card's ~295 flops per byte
// balance point: short sequences (s = 512) are bound by memory, long ones
// (s = 2048) by the tensor cores.
//
// What the design does about it.  The Pallas kernel keeps a whole K/V row
// in VMEM (1 MB at s = 2048, d = 128 in bf16), which does not fit the
// 227 KB of shared memory a block may use.  So each block owns 64 query
// rows (16 per warp), streams K/V through shared memory in 64-key tiles,
// and keeps an online softmax (running max and sum per row in f32
// registers), normalising once at the end: q, k, v are read from device
// memory once per query tile and no score ever reaches device memory.
// Causal tiles wholly above the diagonal are skipped, and the heaviest
// query tiles are scheduled first.  bf16 products run on the tensor cores
// through WMMA (16x16x16, f32 accumulate); f32 inputs take a scalar FMA
// path with the same blocking.  This is the simple first version: no TMA,
// no wgmma, no overlap of loads with math, and the running output sits in
// shared memory rather than registers.
//
// Numerics against the Pallas kernel: that kernel normalises the
// probabilities and then casts them to bf16; this one casts the
// unnormalised probabilities and divides the f32 sum at the end.  The
// two agree within bf16 rounding (3e-2); in f32 they differ only by
// summation order.
//
// Built by ops/_build.py with nvcc into a shared library with a plain C
// interface; conversions go only through the bf16 intrinsics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBM = 64;  // query rows per block, 16 per warp
constexpr int kBN = 64;  // keys per K/V tile
constexpr int kWarps = kBM / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kLds = kBN + 4;  // f32 score tile row stride

using bf16 = __nv_bfloat16;

template <typename T>
__host__ __device__ constexpr int pad() { return 16 / static_cast<int>(sizeof(T)); }
template <typename T, int D>
__host__ __device__ constexpr int ldk() { return D + pad<T>(); }  // q/k/v tile row stride
template <typename T>
__host__ __device__ constexpr int ldp() { return kBN + pad<T>(); }  // probability tile stride
template <int D>
__host__ __device__ constexpr int ldo() { return D + 4; }  // f32 output tile row stride

template <typename T, int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return static_cast<size_t>(kBM + 2 * kBN) * ldk<T, D>() * sizeof(T) +
         static_cast<size_t>(kBM) * kLds * sizeof(float) +
         static_cast<size_t>(kBM) * ldp<T>() * sizeof(T) +
         static_cast<size_t>(kBM) * ldo<D>() * sizeof(float);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy rows [row0, row0 + kRows) of a [s, D] matrix into a shared tile in
// 16-byte pieces; rows at or past s are zero-filled.
template <typename T, int D, int kRows>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0,
                                          int s) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int c = threadIdx.x; c < kRows * kPerRow; c += kThreads) {
    const int r = c / kPerRow;
    const int col = (c % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < s)
      val = *reinterpret_cast<const uint4*>(
          src + static_cast<size_t>(row0 + r) * D + col);
    *reinterpret_cast<uint4*>(dst + r * ldk<T, D>() + col) = val;
  }
}

// S[wrow:wrow+16, 0:kBN] = Q[wrow:wrow+16] · K_tileᵀ (f32, unscaled).
template <typename T, int D>
__device__ __forceinline__ void tile_scores(const T* Qs, const T* Ks,
                                            float* Ss, int wrow, int lane) {
  constexpr int kLd = ldk<T, D>();
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[D / 16];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wmma::load_matrix_sync(a[kk], Qs + wrow * kLd + kk * 16, kLd);
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, Ks + j * 16 * kLd + kk * 16, kLd);
        wmma::mma_sync(acc, a[kk], b, acc);
      }
      wmma::store_matrix_sync(Ss + wrow * kLds + j * 16, acc, kLds,
                              wmma::mem_row_major);
    }
  } else {
    for (int r = 0; r < 16; ++r) {
      const T* qr = Qs + (wrow + r) * kLd;
      const T* k0 = Ks + lane * kLd;
      const T* k1 = Ks + (lane + 32) * kLd;
      float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        const float qd = to_f32(qr[d]);
        a0 = fmaf(qd, to_f32(k0[d]), a0);
        a1 = fmaf(qd, to_f32(k1[d]), a1);
      }
      Ss[(wrow + r) * kLds + lane] = a0;
      Ss[(wrow + r) * kLds + lane + 32] = a1;
    }
  }
}

// O[wrow:wrow+16, :] += P[wrow:wrow+16, 0:kBN] · V_tile (f32 accumulate).
template <typename T, int D>
__device__ __forceinline__ void tile_pv(const T* Ps, const T* Vs, float* Os,
                                        int wrow, int lane) {
  constexpr int kLd = ldk<T, D>();
  constexpr int kLdp = ldp<T>();
  constexpr int kLdo = ldo<D>();
  if constexpr (std::is_same<T, bf16>::value) {
    using namespace nvcuda;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[kBN / 16];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wmma::load_matrix_sync(a[kk], Ps + wrow * kLdp + kk * 16, kLdp);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, Os + wrow * kLdo + j * 16, kLdo,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Vs + kk * 16 * kLd + j * 16, kLd);
        wmma::mma_sync(acc, a[kk], b, acc);
      }
      wmma::store_matrix_sync(Os + wrow * kLdo + j * 16, acc, kLdo,
                              wmma::mem_row_major);
    }
  } else {
    for (int r = 0; r < 16; ++r) {
      const int row = wrow + r;
      for (int c = lane; c < D; c += 32) {
        float acc = Os[row * kLdo + c];
#pragma unroll 8
        for (int n = 0; n < kBN; ++n)
          acc = fmaf(to_f32(Ps[row * kLdp + n]), to_f32(Vs[n * kLd + c]), acc);
        Os[row * kLdo + c] = acc;
      }
    }
  }
}

// One block: kBM query rows of one (batch·head) against all its keys.
template <typename T, int D, bool kCausal>
__global__ void __launch_bounds__(kThreads)
    attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int s,
                    float scale) {
  constexpr int kLd = ldk<T, D>();
  constexpr int kLdp = ldp<T>();
  constexpr int kLdo = ldo<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  // Every region's size is a multiple of 128 bytes, so each stays aligned
  // for 16-byte copies and WMMA's 32-byte fragment loads.
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBM * kLd;
  T* Vs = Ks + kBN * kLd;
  float* Ss = reinterpret_cast<float*>(Vs + kBN * kLd);
  T* Ps = reinterpret_cast<T*>(Ss + kBM * kLds);
  float* Os = reinterpret_cast<float*>(Ps + kBM * kLdp);

  const int n_qt = (s + kBM - 1) / kBM;
  const int bh = blockIdx.x / n_qt;
  const int m0 = (n_qt - 1 - static_cast<int>(blockIdx.x % n_qt)) * kBM;
  const size_t base = static_cast<size_t>(bh) * s * D;
  const int lane = threadIdx.x & 31;
  const int wrow = (threadIdx.x >> 5) * 16;

  load_tile<T, D, kBM>(Qs, q + base, m0, s);
  for (int i = threadIdx.x; i < kBM * kLdo; i += kThreads) Os[i] = 0.0f;
  float m_r[16], l_r[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_r[r] = -INFINITY;
    l_r[r] = 0.0f;
  }

  const int n_end = kCausal ? min(s, m0 + kBM) : s;
  for (int n0 = 0; n0 < n_end; n0 += kBN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, D, kBN>(Ks, k + base, n0, s);
    load_tile<T, D, kBN>(Vs, v + base, n0, s);
    __syncthreads();
    tile_scores<T, D>(Qs, Ks, Ss, wrow, lane);
    __syncwarp();
    // Online softmax over this warp's rows: lane owns keys lane, lane+32.
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int row = wrow + r;
      const int qpos = m0 + row;
      const int k0 = n0 + lane, k1 = n0 + lane + 32;
      const bool ok0 = k0 < s && (!kCausal || k0 <= qpos);
      const bool ok1 = k1 < s && (!kCausal || k1 <= qpos);
      const float x0 = ok0 ? Ss[row * kLds + lane] * scale : -INFINITY;
      const float x1 = ok1 ? Ss[row * kLds + lane + 32] * scale : -INFINITY;
      const float m_new = fmaxf(m_r[r], warp_max(fmaxf(x0, x1)));
      float p0 = 0.0f, p1 = 0.0f, alpha = 1.0f;
      if (m_new != -INFINITY) {  // uniform across the warp
        p0 = ok0 ? __expf(x0 - m_new) : 0.0f;
        p1 = ok1 ? __expf(x1 - m_new) : 0.0f;
        alpha = __expf(m_r[r] - m_new);  // 0 on the first live tile
      }
      l_r[r] = l_r[r] * alpha + warp_sum(p0 + p1);
      m_r[r] = m_new;
      Ps[row * kLdp + lane] = from_f32<T>(p0);
      Ps[row * kLdp + lane + 32] = from_f32<T>(p1);
      for (int c = lane; c < D; c += 32) Os[row * kLdo + c] *= alpha;
    }
    __syncwarp();
    tile_pv<T, D>(Ps, Vs, Os, wrow, lane);
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = wrow + r;
    if (m0 + row >= s) continue;
    const float inv = 1.0f / l_r[r];
    T* dst = o + base + static_cast<size_t>(m0 + row) * D;
    for (int c = lane; c < D; c += 32)
      dst[c] = from_f32<T>(Os[row * kLdo + c] * inv);
  }
}

template <typename T, int D, bool kCausal>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int s, float scale, cudaStream_t stream) {
  auto kernel = attn_fwd_kernel<T, D, kCausal>;
  constexpr size_t smem = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks =
      static_cast<long long>(bh) * ((s + kBM - 1) / kBM);
  if (blocks <= 0 || blocks > INT_MAX) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_causal(int causal, const void* q, const void* k,
                          const void* v, void* o, int bh, int s, float scale,
                          cudaStream_t stream) {
  return causal ? launch<T, D, true>(q, k, v, o, bh, s, scale, stream)
                : launch<T, D, false>(q, k, v, o, bh, s, scale, stream);
}

template <typename T>
cudaError_t launch_dim(int d, int causal, const void* q, const void* k,
                       const void* v, void* o, int bh, int s, float scale,
                       cudaStream_t stream) {
  switch (d) {
    case 16: return launch_causal<T, 16>(causal, q, k, v, o, bh, s, scale, stream);
    case 32: return launch_causal<T, 32>(causal, q, k, v, o, bh, s, scale, stream);
    case 64: return launch_causal<T, 64>(causal, q, k, v, o, bh, s, scale, stream);
    case 128: return launch_causal<T, 128>(causal, q, k, v, o, bh, s, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Launches on `stream`, allocates
// nothing, does not synchronise; returns the launch's cudaError_t.
extern "C" int vtpu_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, int bh, int s,
                                        int d, int dtype, int causal,
                                        float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_dim<float>(d, causal, q, k, v, o, bh, s, scale, st);
    case 1: return launch_dim<bf16>(d, causal, q, k, v, o, bh, s, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
