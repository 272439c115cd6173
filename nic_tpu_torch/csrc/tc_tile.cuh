// Tensor-core building blocks shared by K1 (gdn.cu) and K2 (convt_igdn.cu),
// for NVIDIA Hopper (sm_90a) through the warp-level `mma.sync` path.
//
// One operand policy per dtype, chosen by a template parameter:
//   Bf16Ops   - bfloat16 operands, `mma.m16n8k16` bf16 x bf16 -> fp32, one
//               MMA per fragment pair; fragments read with `ldmatrix`.
//   Tf32x3Ops - float32 operands, each split as v = hi + lo with hi and lo
//               TF32 values (`cvt.rna.tf32.f32`; see split_tf32), and the
//               product taken as hi*hi + hi*lo + lo*hi in fp32 accumulators
//               (`mma.m16n8k8` tf32 x tf32 -> fp32, three per fragment pair).
//               The dropped lo*lo term and the rounding of lo are ~2^-22 of
//               |a||b|, so the result keeps fp32-level accuracy at TF32
//               tensor-core rate.
// Both expose the same interface, so a kernel is written once over a warp
// tile of MT x 16 rows and NT x 8 columns:
//   Ops::kK                  - depth of one MMA step (16 or 8);
//   Ops::AFrag / Ops::BFrag  - one 16 x kK A fragment / two kK x 8 B fragments;
//   Ops::load_a(...)         - A from a row-major shared tile ([row][k]),
//                              optionally squared elementwise first;
//   Ops::load_b2(...)        - B of two neighbouring n8 tiles from a
//                              row-major shared tile ([k][n]);
//   Ops::mma_chain<KS>(acc, a, b, j) - acc += sum_ks a[ks] @ b[ks] (n tile
//                              j = 0, 1 of the pair);
//   warp_mma_chunk(...)      - a warp's MT x NT tile over KS steps of depth.
// Accumulator layout (both): acc[0..1] at (row g, cols 2t, 2t+1), acc[2..3]
// at (row g + 8, the same cols), with g = lane / 4 and t = lane % 4.
//
// Also: `cp.async` 16-byte copies global -> shared with zero fill (for
// masked rows and halo pixels), commit and wait.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nic_tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; `valid` false writes 16 zero
// bytes and reads nothing (src-size 0), so `src` need only be a valid
// pointer of the tensor.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int src_size = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_size)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending committed groups are still in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = hi + lo, both TF32. lo = v - hi is exact before it is rounded (cvt.rna,
// to nearest, ties away). kRoundHi rounds hi the same way, so |v - hi - lo|
// <= 2^-22 |v|; otherwise hi is v with its low 13 bits cleared, one logic
// instruction instead of a cvt, and the error is at most 2^-21 |v|.
template <bool kRoundHi>
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = kRoundHi ? to_tf32(v) : (__float_as_uint(v) & 0xffffe000u);
  lo = to_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32_1688(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same with C = 0: d = a @ b.
__device__ __forceinline__ void mma_tf32_1688_zero_c(float (&d)[4], const uint32_t (&a)[4],
                                                     uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

__device__ __forceinline__ uint32_t square_bf16x2(uint32_t v) {
  // Exact product of two bf16 values, rounded once to bf16 (round to
  // nearest even), as jnp.square does in bfloat16.
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  h = __hmul2(h, h);
  return *reinterpret_cast<uint32_t*>(&h);
}

struct Bf16Ops {
  using T = __nv_bfloat16;
  static constexpr int kK = 16;
  struct AFrag { uint32_t r[4]; };
  struct BFrag { uint32_t r[4]; };  // b0, b1 of n tile 0, then of n tile 1

  // A rows [row0, row0 + 16) x k [k0, k0 + 16) of a [row][k] tile.
  template <bool kSquare>
  static __device__ __forceinline__ void load_a(AFrag& f, const T* s, int stride, int row0,
                                                int k0, int lane) {
    ldmatrix_x4(f.r, s + (row0 + (lane & 15)) * stride + k0 + (lane >> 4) * 8);
    if (kSquare) {
#pragma unroll
      for (int i = 0; i < 4; ++i) f.r[i] = square_bf16x2(f.r[i]);
    }
  }

  // B of n tiles [n0, n0 + 8) and [n0 + 8, n0 + 16), k [k0, k0 + 16), of a
  // [k][n] tile.
  static __device__ __forceinline__ void load_b2(BFrag& f, const T* s, int stride, int k0,
                                                 int n0, int lane) {
    ldmatrix_x4_trans(f.r, s + (k0 + (lane & 15)) * stride + n0 + (lane >> 4) * 8);
  }

  // acc += sum over the KS depth steps of a[ks] @ b[ks] (n tile j).
  template <int KS>
  static __device__ __forceinline__ void mma_chain(float (&acc)[4], const AFrag (&a)[KS],
                                                   const BFrag (&b)[KS], int j) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) mma_bf16_16816(acc, a[ks].r, b[ks].r[2 * j], b[ks].r[2 * j + 1]);
  }
};

template <bool kRoundHi>
struct Tf32x3Ops {
  using T = float;
  static constexpr int kK = 8;
  struct AFrag { uint32_t hi[4], lo[4]; };
  struct BFrag { uint32_t hi[4], lo[4]; };

  static __device__ __forceinline__ void split_a(AFrag& f, const float (&v)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32<kRoundHi>(v[i], f.hi[i], f.lo[i]);
  }

  // Element i of the m16n8k8 A fragment sits at (row g + 8 (i & 1), col
  // t + 4 (i >> 1)).
  template <bool kSquare>
  static __device__ __forceinline__ void load_a(AFrag& f, const float* s, int stride,
                                                int row0, int k0, int lane) {
    const int g = lane >> 2, t = lane & 3;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[i] = s[(row0 + g + (i & 1) * 8) * stride + k0 + t + (i >> 1) * 4];
      if (kSquare) v[i] *= v[i];
    }
    split_a(f, v);
  }

  // Element (j, i) of the B fragments: k = k0 + t + 4 i, n = n0 + 8 j + g.
  static __device__ __forceinline__ void load_b2(BFrag& f, const float* s, int stride, int k0,
                                                 int n0, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        split_tf32<kRoundHi>(s[(k0 + t + 4 * i) * stride + n0 + 8 * j + g], f.hi[2 * j + i],
                   f.lo[2 * j + i]);
  }

  // acc += sum over the KS depth steps of a[ks] @ b[ks] (n tile j): the
  // 3 x KS products go into a temporary that starts from zero (the first MMA
  // takes C = 0), small terms first, and the temporary into acc with one
  // fp32 add (round to nearest). The tensor cores' own accumulation
  // truncates: chained over K = 1728 (K2's 9 taps x 192) straight into acc,
  // that bias took K2's fp32 route past its 1e-5 tolerance.
  template <int KS>
  static __device__ __forceinline__ void mma_chain(float (&acc)[4], const AFrag (&a)[KS],
                                                   const BFrag (&b)[KS], int j) {
    float d[4];
    mma_tf32_1688_zero_c(d, a[0].lo, b[0].hi[2 * j], b[0].hi[2 * j + 1]);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks > 0) mma_tf32_1688(d, a[ks].lo, b[ks].hi[2 * j], b[ks].hi[2 * j + 1]);
      mma_tf32_1688(d, a[ks].hi, b[ks].lo[2 * j], b[ks].lo[2 * j + 1]);
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      mma_tf32_1688(d, a[ks].hi, b[ks].hi[2 * j], b[ks].hi[2 * j + 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += d[i];
  }
};

// Where a warp's A operand comes from: a [row][k] tile of Ops::T, as it is
// or squared elementwise (K1's x^2, K2's z*z).
enum class ASrc { kTile, kTileSquared };

// KS MMA steps over depth [k0, k0 + KS * Ops::kK) for a warp tile of
// MT x 16 rows (from row a_row0 of the A tile) by NT x 8 columns (from
// column b_col0 of a [k][n] B tile). All of the chunk's A fragments are
// loaded first, then the B fragments of each pair of n8 tiles, so each
// accumulator takes one chain of KS steps.
template <class Ops, int MT, int NT, int KS, ASrc kA>
__device__ __forceinline__ void warp_mma_chunk(float (&acc)[MT][NT][4],
                                               const typename Ops::T* a_s,
                                               int a_stride, int a_row0,
                                               const typename Ops::T* b_s, int b_stride,
                                               int b_col0, int k0, int lane) {
  static_assert(NT % 2 == 0, "B fragments come in pairs of n8 tiles");
  typename Ops::AFrag a[MT][KS];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      Ops::template load_a<kA == ASrc::kTileSquared>(a[mt][ks], a_s, a_stride,
                                                     a_row0 + 16 * mt, k0 + ks * Ops::kK, lane);
    }
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    typename Ops::BFrag b[KS];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      Ops::load_b2(b[ks], b_s, b_stride, k0 + ks * Ops::kK, b_col0 + 16 * np, lane);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      Ops::template mma_chain<KS>(acc[mt][2 * np], a[mt], b, 0);
      Ops::template mma_chain<KS>(acc[mt][2 * np + 1], a[mt], b, 1);
    }
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int kMaxDevices = 64;

// The current device's SM count and opt-in shared memory per block, read
// once per device (host code).
inline cudaError_t device_limits(int* sms, int* smem_max) {
  static int cached_sms[kMaxDevices], cached_smem[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached_sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&cached_smem[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached_sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cached_sms[dev];
  *smem_max = cached_smem[dev];
  return cudaSuccess;
}

}  // namespace nic_tc
