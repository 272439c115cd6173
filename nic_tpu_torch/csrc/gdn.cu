// Fused GDN / IGDN forward for NVIDIA Hopper (sm_90a) on the tensor cores,
// plain C interface.
//
// Replaces the Pallas TPU kernel `_gdn_kernel` of nic_tpu/ops/pallas_gdn.py
// (launched by `_gdn_pallas_fwd_impl`). Over the rows of a (M, C) matrix:
//
//   n[m, j] = beta[j] + sum_i x[m, i]^2 * gamma[i, j]      (fp32 accumulation)
//   GDN:  y = x * rsqrt(n)        IGDN: y = x * sqrt(n)
//
// x and y are float32 or bfloat16, gamma has x's type, beta is float32.
// In bfloat16, x^2 is rounded to bfloat16 before the product, as
// `_gdn_kernel`'s jnp.square does; in float32 the product is fp32-accurate
// through 3xTF32 (tc_tile.cuh).
//
// What bounds it on this card: 2*M*C^2 FLOPs against 2*M*C elements moved.
// At C = 192 that is 192 FLOP per byte in bf16, under the H100's ~295
// FLOP/byte ridge, so bf16 is bound by HBM bytes; in fp32 the three TF32
// products per fp32 product (3 x 2*M*C^2 at 495 TFLOP/s) are the bound.
//
// The design. Persistent blocks, one per SM, walk over tiles of rows: 16
// warps (4 x 4) over 128 rows in bf16, 8 warps (2 x 4) over 32 rows in fp32. gamma (K x N, zero-padded to a
// multiple of 64) and beta stay resident in shared memory for the block's
// whole life; x tiles stream through a ring of two `cp.async` stages, so
// the next tile's copy overlaps this tile's MMAs. Each warp owns a
// (16 MT) x (8 NT) tile of the output: its A fragments are x^2, formed in
// registers from the staged x (ldmatrix in bf16), its B fragments come from
// the resident gamma, and each accumulator takes chains of 32 (bf16) or 64
// (fp32) in depth. The epilogue adds beta, takes (r)sqrt, and multiplies
// by x read from the staged tile at the accumulator's positions, so x is
// read from HBM once and y written once. Rows whose bytes are not a
// multiple of 16 (C = 3 in bf16, say) are staged element by element inside
// the kernel instead of by cp.async. At C = 256 the resident gamma and two
// x stages would not fit in 227 KB, so two blocks split N.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tc_tile.cuh"

namespace {

using nic_tc::Bf16Ops;
using nic_tc::Tf32x3Ops;

constexpr int kMaxChannels = 256;
constexpr int kPadGamma = 8;      // keeps ldmatrix rows / B fragments off one bank
constexpr int kStages = 2;        // x tiles in the cp.async ring

// kWM warps along rows x kWN along columns; each warp owns kMT m16 tiles
// and NT n8 tiles (NT = block columns / (8 kWN), a template argument). fp32
// takes 8 warps: its resident gamma (147 KB) leaves room for 32-row tiles
// only.
template <bool kBf16>
struct Cfg {
  // fp32 takes hi by truncation: each cvt costs instruction slots in this ALU-bound
  // loop (tools/kernel_variants.py, variant round_hi), and the error stays
  // far inside the tolerance (below 1e-6 of the plain version's max).
  using Ops = std::conditional_t<kBf16, Bf16Ops, Tf32x3Ops</*kRoundHi=*/false>>;
  using T = typename Ops::T;
  static constexpr int kWM = kBf16 ? 4 : 2;
  static constexpr int kWN = 4;
  static constexpr int kThreads = 32 * kWM * kWN;
  static constexpr int kMT = kBf16 ? 2 : 1;
  static constexpr int kTileM = 16 * kMT * kWM;    // rows per tile: 128 bf16, 32 fp32
  static constexpr int kPadX = kBf16 ? 8 : 4;      // x row pad, conflict-free A reads
  static constexpr int kKS = kBf16 ? 2 : 8;        // MMA steps per chain (depth 32, 64)
};

template <bool kBf16>
size_t smem_bytes(int cp, int bn) {
  using C = Cfg<kBf16>;
  const size_t e = sizeof(typename C::T);
  return static_cast<size_t>(cp) * (bn + kPadGamma) * e + sizeof(float) * bn +
         static_cast<size_t>(kStages) * C::kTileM * (cp + C::kPadX) * e;
}

// Stage rows [row0, row0 + kTileM) x all cp columns of x; zeros past M and C.
template <bool kBf16>
__device__ __forceinline__ void load_tile(typename Cfg<kBf16>::T* dst, const typename Cfg<kBf16>::T* x,
                                          long long row0, int rows, int c, int cp, int stride,
                                          bool vec, int tid) {
  using C = Cfg<kBf16>;
  using T = typename C::T;
  if (vec) {
    constexpr int kEpp = 16 / sizeof(T);  // elements per 16-byte piece
    const int ppr = cp / kEpp;
    for (int p = tid; p < C::kTileM * ppr; p += C::kThreads) {
      const int r = p / ppr;
      const int col = (p - r * ppr) * kEpp;
      const long long m = row0 + r;
      const bool ok = m < rows && col < c;
      nic_tc::cp_async16(dst + r * stride + col, ok ? x + m * c + col : x, ok);
    }
  } else {
    for (int i = tid; i < C::kTileM * cp; i += C::kThreads) {
      const int r = i / cp;
      const int col = i - r * cp;
      const long long m = row0 + r;
      dst[r * stride + col] =
          (m < rows && col < c) ? x[m * c + col] : nic_tc::from_float<T>(0.0f);
    }
  }
}

// Store rows [row0, row0 + kTileM) x columns [n0, n0 + bn) of a staged
// tile to out, clipped to M and C.
template <bool kBf16>
__device__ __forceinline__ void store_tile(typename Cfg<kBf16>::T* out,
                                           const typename Cfg<kBf16>::T* src, long long row0,
                                           int rows, int c, int n0, int bn, int stride, bool vec,
                                           int tid) {
  using C = Cfg<kBf16>;
  if (vec) {
    constexpr int kEpp = 16 / sizeof(typename C::T);
    const int ppr = bn / kEpp;
    for (int p = tid; p < C::kTileM * ppr; p += C::kThreads) {
      const int r = p / ppr;
      const int col = n0 + (p - r * ppr) * kEpp;
      const long long m = row0 + r;
      if (m < rows && col < c)
        __stcs(reinterpret_cast<uint4*>(out + m * c + col),  // streaming: y is not re-read
               *reinterpret_cast<const uint4*>(src + r * stride + col));
    }
  } else {
    for (int i = tid; i < C::kTileM * bn; i += C::kThreads) {
      const int r = i / bn;
      const int col = n0 + i - r * bn;
      const long long m = row0 + r;
      if (m < rows && col < c) out[m * c + col] = src[r * stride + col];
    }
  }
}

template <bool kBf16, int kNT, bool kInverse>
__global__ void __launch_bounds__(Cfg<kBf16>::kThreads, 1)
gdn_tc_kernel(const typename Cfg<kBf16>::T* __restrict__ x,
              const typename Cfg<kBf16>::T* __restrict__ gamma,
              const float* __restrict__ beta, typename Cfg<kBf16>::T* __restrict__ out,
              int rows, int c, int cp, int vec) {
  using C = Cfg<kBf16>;
  using Ops = typename C::Ops;
  using T = typename C::T;
  constexpr int kBn = C::kWN * 8 * kNT;  // columns of this block
  constexpr int kGStride = kBn + kPadGamma;
  const int x_stride = cp + C::kPadX;
  const int x_tile = C::kTileM * x_stride;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* gs = reinterpret_cast<T*>(smem_raw);                 // [cp][kGStride]
  float* bs = reinterpret_cast<float*>(gs + cp * kGStride);  // [kBn]
  T* xs = reinterpret_cast<T*>(bs + kBn);                 // [kStages][kTileM][x_stride]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / C::kWN;
  const int wn = warp % C::kWN;
  const int n_base = blockIdx.y * kBn;
  const int n_tiles = (rows + C::kTileM - 1) / C::kTileM;

  // Prologue: gamma's columns of this block (resident from now on; in the
  // first cp.async group) and the block's first tile.
  if (vec) {
    constexpr int kEpp = 16 / sizeof(T);
    constexpr int kPpr = kBn / kEpp;
    for (int p = tid; p < cp * kPpr; p += C::kThreads) {
      const int k = p / kPpr;
      const int n = (p - k * kPpr) * kEpp;
      const bool ok = k < c && n_base + n < c;
      nic_tc::cp_async16(gs + k * kGStride + n, ok ? gamma + k * c + n_base + n : gamma, ok);
    }
  } else {
    for (int i = tid; i < cp * kBn; i += C::kThreads) {
      const int k = i / kBn;
      const int n = i - k * kBn;
      gs[k * kGStride + n] =
          (k < c && n_base + n < c) ? gamma[k * c + n_base + n] : nic_tc::from_float<T>(0.0f);
    }
  }
  for (int n = tid; n < kBn; n += C::kThreads) bs[n] = n_base + n < c ? beta[n_base + n] : 1.0f;
  if (blockIdx.x < n_tiles)
    load_tile<kBf16>(xs, x, static_cast<long long>(blockIdx.x) * C::kTileM, rows, c, cp,
                     x_stride, vec, tid);
  nic_tc::cp_async_commit();

  const int g = lane >> 2, t = lane & 3;
  float acc[C::kMT][kNT][4];
  for (int it = 0;; ++it) {
    const int tile = blockIdx.x + it * gridDim.x;
    if (tile >= n_tiles) break;
    nic_tc::cp_async_wait<kStages - 2>();
    __syncthreads();  // this tile landed; the stage refilled below is free
    const int next = tile + (kStages - 1) * gridDim.x;
    if (next < n_tiles)
      load_tile<kBf16>(xs + ((it + kStages - 1) % kStages) * x_tile, x,
                       static_cast<long long>(next) * C::kTileM, rows, c, cp, x_stride, vec,
                       tid);
    nic_tc::cp_async_commit();

    const T* xt = xs + (it % kStages) * x_tile;
    nic_tc::zero_acc(acc);
    for (int k0 = 0; k0 < cp; k0 += C::kKS * Ops::kK)
      nic_tc::warp_mma_chunk<Ops, C::kMT, kNT, C::kKS, nic_tc::ASrc::kTileSquared>(
          acc, xt, x_stride, wm * 16 * C::kMT, gs, kGStride, wn * 8 * kNT, k0, lane);

    // Epilogue: y = x * (r)sqrt(acc + beta), x read from the staged tile and
    // y written over it (each element by its own thread, once every warp is
    // done with the tile's A fragments), then the tile's rows stored with
    // 16-byte coalesced writes.
    __syncthreads();
    T* xw = xs + (it % kStages) * x_tile;
#pragma unroll
    for (int mt = 0; mt < C::kMT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = wm * 16 * C::kMT + mt * 16 + g + 8 * half;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int cl = wn * 8 * kNT + nt * 8 + 2 * t;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float nrm = acc[mt][nt][2 * half + e] + bs[cl + e];
            const float rs = rsqrtf(nrm);
            T& v = xw[rl * x_stride + n_base + cl + e];
            v = nic_tc::from_float<T>(nic_tc::to_float(v) * (kInverse ? nrm * rs : rs));
          }
        }
      }
    }
    __syncthreads();
    const long long row0 = static_cast<long long>(tile) * C::kTileM;
    store_tile<kBf16>(out, xw, row0, rows, c, n_base, kBn, x_stride, vec, tid);
  }
  nic_tc::cp_async_wait<0>();
}

template <bool kBf16, int kNT, bool kInverse>
cudaError_t launch_one(const void* x, const void* gamma, const float* beta, void* out, int rows,
                       int c, int cp, int n_split, size_t smem, int sms,
                       int smem_max, cudaStream_t stream) {
  using C = Cfg<kBf16>;
  using T = typename C::T;
  auto kernel = gdn_tc_kernel<kBf16, kNT, kInverse>;
  // Above 48 KB of shared memory a kernel must opt in, once per device.
  static bool opted_in[nic_tc::kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= nic_tc::kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  // One persistent block per SM: the resident gamma fills its shared memory.
  const int n_tiles = (rows + C::kTileM - 1) / C::kTileM;
  const int blocks = n_tiles < sms ? n_tiles : sms;
  const bool vec = (static_cast<size_t>(c) * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(gamma) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  kernel<<<dim3(blocks, n_split), C::kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma), beta, static_cast<T*>(out), rows,
      c, cp, vec ? 1 : 0);
  return cudaGetLastError();
}

template <bool kBf16, bool kInverse>
cudaError_t launch_nt(const void* x, const void* gamma, const float* beta, void* out, int rows,
                      int c, cudaStream_t stream) {
  using C = Cfg<kBf16>;
  int sms = 0, smem_max = 0;
  const cudaError_t err = nic_tc::device_limits(&sms, &smem_max);
  if (err != cudaSuccess) return err;
  // The fewest column splits whose resident gamma leaves room for the x
  // ring: one up to C = 192, two at C = 256.
  const int cp = (c + 63) / 64 * 64;
  int n_split = 1;
  while (smem_bytes<kBf16>(cp, cp / n_split) > static_cast<size_t>(smem_max)) {
    n_split *= 2;
    if (cp % (n_split * 8 * C::kWN) != 0) return cudaErrorInvalidValue;
  }
  const int bn = cp / n_split;
  const size_t smem = smem_bytes<kBf16>(cp, bn);
#define NIC_K1_LAUNCH(NT)                                                                   \
  return launch_one<kBf16, NT, kInverse>(x, gamma, beta, out, rows, c, cp, n_split, smem, sms, \
                                         smem_max, stream)
  // Column tiles per warp: 2, 4, 6 for C up to 64, 128, 192; 256 in two splits.
  switch (bn / (8 * C::kWN)) {
    case 2: NIC_K1_LAUNCH(2);
    case 4: NIC_K1_LAUNCH(4);
    case 6: NIC_K1_LAUNCH(6);
    default: return cudaErrorInvalidValue;
  }
#undef NIC_K1_LAUNCH
}

template <bool kBf16>
cudaError_t launch(const void* x, const void* gamma, const float* beta, void* out, int rows,
                   int c, int inverse, cudaStream_t stream) {
  if (inverse) return launch_nt<kBf16, true>(x, gamma, beta, out, rows, c, stream);
  return launch_nt<kBf16, false>(x, gamma, beta, out, rows, c, stream);
}

}  // namespace

extern "C" {

// Largest channel count the kernel takes.
int nic_gdn_max_channels() { return kMaxChannels; }

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
int nic_gdn_forward(const void* x, const void* gamma, const void* beta, void* out,
                    int rows, int channels, int inverse, int dtype, void* stream) {
  if (rows < 0 || channels < 1 || channels > kMaxChannels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const float* b = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<false>(x, gamma, b, out, rows, channels, inverse, s));
    case 1:
      return static_cast<int>(launch<true>(x, gamma, b, out, rows, channels, inverse, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
