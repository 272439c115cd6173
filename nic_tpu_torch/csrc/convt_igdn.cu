// Fused 5x5 stride-2 SAME transposed convolution + bias + (I)GDN for
// NVIDIA Hopper (sm_90a) on the tensor cores, plain C interface.
//
// Replaces the Pallas TPU kernel `_kernel` of nic_tpu/ops/pallas_convt.py
// (launched by `conv_transpose_igdn_up2`). x [N, H, W, C] -> out
// [N, 2H, 2W, Co], for the kernel w in the un-flipped HWIO layout of
// `lax.conv_transpose(x, w, (2, 2), "SAME")`:
//
//   out[n, 2i+r, 2j+t, :] = (I)GDN(bias + sum_{a, b} x[n, i-a, j-b, :]
//                                          @ w[3-2a-r, 3-2b-t])
//   a in {1, 0} for r = 0, {1, 0, -1} for r = 1 (likewise b for t)
//   (I)GDN: z * sqrt(beta + (z*z) @ gamma)   (GDN: rsqrt)
//
// so each output parity (r, t) is a GEMM [pixels, taps*C] @ [taps*C, Co]
// with 4, 6, 6 or 9 taps, and x outside the image reads as zero. The
// weights come pre-packed by ops/convt_igdn.py `pack_weights`: the four
// parities' matrices phase_weight_mats(w) one after the other, each tap's
// C rows zero-padded to cpad (a multiple of the K chunk) and Co to cop (a
// multiple of 64), in x's dtype; gamma comes as `pack_gamma` (cop x cop, in
// x's dtype). bias and beta are float32; accumulation is float32.
//
// Rounding. bf16 route: x, w, and for the normalizer z*z and gamma, are
// bfloat16 operands of fp32-accumulated MMAs; z itself is kept in bf16
// between the two GEMMs. Every term of (z*z) @ gamma is >= 0, so rounding
// z, z*z and gamma to bf16 (2^-9 each) moves the normalizer by at most
// ~2^-7 relative and its square root by ~2^-8, and y = z * (r)sqrt(n)
// takes one more rounding of z: about two bf16 ulps of the output. fp32
// route: both GEMMs run as 3xTF32 (tc_tile.cuh), fp32-accurate, and z
// stays fp32.
//
// What bounds it on this card: 2*N*H*W*25*C*Co + 2*N*4HW*Co^2 FLOPs against
// (N*H*W*C + 4*N*H*W*Co) elements moved: ~1200 FLOP per byte at C = Co =
// 192 in bf16, so the tensor cores bound it (989 TFLOP/s bf16; in fp32
// three TF32 products per product at 495 TFLOP/s).
//
// The design: an implicit GEMM per (tile of 64 input-grid pixels, output
// parity); a block of 8 warps keeps all Co <= 192 output channels, because
// the normalizer mixes them. K runs over taps x C in chunks of 32 (bf16) or
// 16 (fp32): A (64 pixels x chunk) is gathered from x by 16-byte cp.async
// with halo pixels zero-filled, B (chunk x cop) is streamed from the packed
// weights, through a cp.async ring (4 stages in bf16, 3 in fp32). Each warp
// owns 32 pixels x cop/4 channels. After the last weight chunk, z = acc +
// bias goes to shared memory (in x's dtype) and the same registers
// accumulate the normalizer (z*z) @ gamma, gamma's chunks streaming through
// the same ring; then y = z * (r)sqrt(n) is written over z and each
// pixel's channels are stored, in 16-byte pieces, at the interleaved
// parity position. Offsets
// fit 32 bits: the wrapper refuses tensors of 2^31 elements or more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tc_tile.cuh"

namespace {

using nic_tc::Bf16Ops;
using nic_tc::Tf32x3Ops;

constexpr int kThreads = 256;  // 8 warps: 2 along pixels x 4 along channels
constexpr int kTileM = 64;     // input-grid pixels per block
constexpr int kMT = 2;         // m16 tiles per warp
constexpr int kMaxCo = 192;
constexpr int kPadB = 8;

template <bool kBf16>
struct Cfg {
  // fp32 rounds hi too: its worst case in chip_smoke.py, GDN at (3, 48, 64,
  // 192), sits within a factor of two of the 1e-5 tolerance, and a
  // truncated hi doubles the split's error bound (tc_tile.cuh).
  using Ops = std::conditional_t<kBf16, Bf16Ops, Tf32x3Ops</*kRoundHi=*/true>>;
  using T = typename Ops::T;
  static constexpr int kChunk = kBf16 ? 32 : 16;         // K per stage (64 bytes)
  static constexpr int kAStride = kChunk + (kBf16 ? 8 : 4);  // conflict-free A reads
  // The z tile (in T) between the two GEMMs: its row pad keeps ldmatrix
  // (bf16) or scalar (fp32) A reads off one bank.
  static constexpr int kPadZ = kBf16 ? 8 : 4;
  // cp.async ring depth: the bf16 z tile (25 KB) leaves room for four stages
  // at two blocks per SM; the fp32 one (50 KB) for three.
  static constexpr int kStages = kBf16 ? 4 : 3;
  // MMA steps per accumulator chain: fp32 keeps 1, with 2 it spills at 128
  // registers (tools/kernel_variants.py, variant chain_2).
  static constexpr int kKS = kBf16 ? 2 : 1;
};

template <bool kBf16>
size_t smem_bytes(int cop) {
  using C = Cfg<kBf16>;
  const size_t stage = (static_cast<size_t>(kTileM) * C::kAStride +
                        static_cast<size_t>(C::kChunk) * (cop + kPadB)) *
                       sizeof(typename C::T);
  return C::kStages * stage + sizeof(typename C::T) * kTileM * (cop + C::kPadZ);
}

template <bool kBf16, int kNT, bool kInverse, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
convt_igdn_tc_kernel(const typename Cfg<kBf16>::T* __restrict__ x,
                     const typename Cfg<kBf16>::T* __restrict__ wp,
                     const float* __restrict__ bias, const float* __restrict__ beta,
                     const typename Cfg<kBf16>::T* __restrict__ gp,
                     typename Cfg<kBf16>::T* __restrict__ out, int n_img, int h, int wd,
                     int c, int cpad, int co, int vec) {
  using C = Cfg<kBf16>;
  using Ops = typename C::Ops;
  using T = typename C::T;
  constexpr int kCop = 4 * 8 * kNT;
  constexpr int kBStride = kCop + kPadB;
  constexpr int kZStride = kCop + C::kPadZ;
  constexpr int kEpp = 16 / sizeof(T);  // elements per 16-byte piece
  constexpr int kStageElems = kTileM * C::kAStride + C::kChunk * kBStride;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kStages = C::kStages;
  T* stages = reinterpret_cast<T*>(smem_raw);  // [kStages][A tile, B tile]
  T* zs = stages + kStages * kStageElems;      // [kTileM][kZStride]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const int parity = 3 - blockIdx.y;  // 9 taps first: the longest blocks start first
  const int r = parity >> 1;
  const int t = parity & 1;
  const int m_total = n_img * h * wd;
  const int m0 = blockIdx.x * kTileM;

  const int taps_b = 2 + t;
  const int taps = (2 + r) * taps_b;
  const int n_kc = cpad / C::kChunk;      // chunks per tap
  const int n1 = taps * n_kc;             // chunks of the conv GEMM
  const int n_total = n1 + kCop / C::kChunk;  // then gamma's chunks
  // Parities (0,0), (0,1), (1,0), (1,1) have 4, 6, 6, 9 taps, packed in order.
  const int tap_base = (parity == 0 ? 0 : parity == 1 ? 4 : parity == 2 ? 10 : 16);
  const T* wpar = wp + static_cast<long long>(tap_base) * cpad * kCop;

  // The pixel and 16-byte piece of the A tile this thread copies.
  const int a_pix = tid >> 2;
  const int a_piece = tid & 3;
  const int a_m = m0 + a_pix;
  const int a_row = a_m / wd;  // n * h + i
  const int a_j = a_m - a_row * wd;
  const int a_i = a_m < m_total ? a_row % h : -4;  // never inside the image

  auto load_chunk = [&](int q, int st) {
    T* as = stages + st * kStageElems;
    T* bs = as + kTileM * C::kAStride;
    const T* bsrc;
    if (q < n1) {
      const int ti = q / n_kc;
      const int c0 = (q - ti * n_kc) * C::kChunk;
      const int a = 1 - ti / taps_b;
      const int b = 1 - ti % taps_b;
      const int ii = a_i - a, jj = a_j - b;
      const bool pix_ok = ii >= 0 && ii < h && jj >= 0 && jj < wd;
      const int col = c0 + a_piece * kEpp;
      const T* src = x + ((a_row - a) * wd + jj) * c + col;
      T* dst = as + a_pix * C::kAStride + a_piece * kEpp;
      if (vec) {
        const bool ok = pix_ok && col < c;
        nic_tc::cp_async16(dst, ok ? src : x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < kEpp; ++e)
          dst[e] = (pix_ok && col + e < c) ? src[e] : nic_tc::from_float<T>(0.0f);
      }
      bsrc = wpar + static_cast<long long>(ti * cpad + c0) * kCop;
    } else {
      bsrc = gp + static_cast<long long>(q - n1) * C::kChunk * kCop;
    }
    constexpr int kPiecesPerRow = kCop / kEpp;
    for (int p = tid; p < C::kChunk * kPiecesPerRow; p += kThreads) {
      const int kr = p / kPiecesPerRow;
      const int col = (p - kr * kPiecesPerRow) * kEpp;
      nic_tc::cp_async16(bs + kr * kBStride + col, bsrc + kr * kCop + col, true);
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_total) load_chunk(s, s);
    nic_tc::cp_async_commit();
  }

  const int g = lane >> 2, tg = lane & 3;
  float acc[kMT][kNT][4];
  nic_tc::zero_acc(acc);
  for (int q = 0; q < n_total; ++q) {
    nic_tc::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk q landed (and zs is written); its stage's last reader is done
    if (q + kStages - 1 < n_total) load_chunk(q + kStages - 1, (q + kStages - 1) % kStages);
    nic_tc::cp_async_commit();

    const T* as = stages + (q % kStages) * kStageElems;
    const T* bs = as + kTileM * C::kAStride;
    if (q < n1) {
#pragma unroll
      for (int k0 = 0; k0 < C::kChunk; k0 += C::kKS * Ops::kK)
        nic_tc::warp_mma_chunk<Ops, kMT, kNT, C::kKS, nic_tc::ASrc::kTile>(
            acc, as, C::kAStride, wm * 32, bs, kBStride, wn * 8 * kNT, k0, lane);
    } else {
#pragma unroll
      for (int k0 = 0; k0 < C::kChunk; k0 += C::kKS * Ops::kK)
        nic_tc::warp_mma_chunk<Ops, kMT, kNT, C::kKS, nic_tc::ASrc::kTileSquared>(
            acc, zs + (q - n1) * C::kChunk, kZStride, wm * 32, bs, kBStride, wn * 8 * kNT, k0,
            lane);
    }
    if (q == n1 - 1) {
      // z = acc + bias to shared memory (in T); the registers now take the
      // normalizer.
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int col = wn * 8 * kNT + nt * 8 + 2 * tg;
          const float b0 = col < co ? bias[col] : 0.0f;
          const float b1 = col + 1 < co ? bias[col + 1] : 0.0f;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int rl = wm * 32 + mt * 16 + g + 8 * half;
            nic_tc::store2(zs + rl * kZStride + col, acc[mt][nt][2 * half] + b0,
                           acc[mt][nt][2 * half + 1] + b1);
            acc[mt][nt][2 * half] = 0.0f;
            acc[mt][nt][2 * half + 1] = 0.0f;
          }
        }
    }
  }
  nic_tc::cp_async_wait<0>();

  // y = z * (r)sqrt(beta + n), written over z in shared memory (each
  // element by its own thread, once every warp is done reading z*z), then
  // each pixel's Co channels stored at out[n, 2i + r, 2j + t, :] with
  // 16-byte coalesced writes.
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = wm * 32 + mt * 16 + g + 8 * half;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int col = wn * 8 * kNT + nt * 8 + 2 * tg;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float nrm = acc[mt][nt][2 * half + e] + (col + e < co ? beta[col + e] : 1.0f);
          const float rs = rsqrtf(nrm);
          T& v = zs[rl * kZStride + col + e];
          v = nic_tc::from_float<T>(nic_tc::to_float(v) * (kInverse ? nrm * rs : rs));
        }
      }
    }
  }
  __syncthreads();
  if (vec) {
    constexpr int kPpp = kCop / kEpp;  // 16-byte pieces per pixel
    for (int p = tid; p < kTileM * kPpp; p += kThreads) {
      const int pix = p / kPpp;
      const int col = (p - pix * kPpp) * kEpp;
      const int m = m0 + pix;
      if (m >= m_total || col >= co) continue;
      const int row = m / wd;  // n * h + i; out row 2 * row + r = n * 2h + 2i + r
      const int j = m - row * wd;
      T* o = out + (static_cast<long long>(2 * row + r) * 2 * wd + 2 * j + t) * co + col;
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(zs + pix * kZStride + col);
    }
  } else {
    for (int i = tid; i < kTileM * co; i += kThreads) {
      const int pix = i / co;
      const int col = i - pix * co;
      const int m = m0 + pix;
      if (m >= m_total) continue;
      const int row = m / wd;
      const int j = m - row * wd;
      out[(static_cast<long long>(2 * row + r) * 2 * wd + 2 * j + t) * co + col] =
          zs[pix * kZStride + col];
    }
  }
}

template <bool kBf16, int kNT, bool kInverse, int kMinBlocks>
cudaError_t launch_one(const void* x, const void* wp, const float* bias, const float* beta,
                       const void* gp, void* out, int n, int h, int wd, int c, int cpad, int co,
                       cudaStream_t stream) {
  using T = typename Cfg<kBf16>::T;
  auto kernel = convt_igdn_tc_kernel<kBf16, kNT, kInverse, kMinBlocks>;
  const size_t smem = smem_bytes<kBf16>(4 * 8 * kNT);
  // Above 48 KB of shared memory a kernel must opt in, once per device.
  static bool opted_in[nic_tc::kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= nic_tc::kMaxDevices) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in[dev] = true;
  }
  const int m_total = n * h * wd;
  // 16-byte copies of x rows and out rows.
  const bool vec = (static_cast<size_t>(c) * sizeof(T)) % 16 == 0 &&
                   (static_cast<size_t>(co) * sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid((m_total + kTileM - 1) / kTileM, 4);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wp), bias, beta,
      static_cast<const T*>(gp), static_cast<T*>(out), n, h, wd, c, cpad, co, vec ? 1 : 0);
  return cudaGetLastError();
}

// A grid of at most two blocks per SM runs the build for one block per SM,
// whose warps may take up to 255 registers: the smallest g_s layer, (3, 24,
// 32, 192), has 144 blocks, and there the build for two blocks per SM in
// 128 registers, which the larger grids need, is slower
// (tools/kernel_variants.py, variant two_blocks_per_sm).
template <bool kBf16, int kNT, bool kInverse>
cudaError_t launch_grid(const void* x, const void* wp, const float* bias, const float* beta,
                        const void* gp, void* out, int n, int h, int wd, int c, int cpad, int co,
                        cudaStream_t stream) {
  int sms = 0, smem_max = 0;
  const cudaError_t err = nic_tc::device_limits(&sms, &smem_max);
  if (err != cudaSuccess) return err;
  const long long blocks = (static_cast<long long>(n) * h * wd + kTileM - 1) / kTileM * 4;
  if (blocks <= 2LL * sms)
    return launch_one<kBf16, kNT, kInverse, 1>(x, wp, bias, beta, gp, out, n, h, wd, c, cpad,
                                               co, stream);
  return launch_one<kBf16, kNT, kInverse, 2>(x, wp, bias, beta, gp, out, n, h, wd, c, cpad, co,
                                             stream);
}

template <bool kBf16, bool kInverse>
cudaError_t launch_nt(const void* x, const void* wp, const float* bias, const float* beta,
                      const void* gp, void* out, int n, int h, int wd, int c, int cpad, int co,
                      int cop, cudaStream_t stream) {
  switch (cop) {
    case 64:
      return launch_grid<kBf16, 2, kInverse>(x, wp, bias, beta, gp, out, n, h, wd, c, cpad, co, stream);
    case 128:
      return launch_grid<kBf16, 4, kInverse>(x, wp, bias, beta, gp, out, n, h, wd, c, cpad, co, stream);
    case 192:
      return launch_grid<kBf16, 6, kInverse>(x, wp, bias, beta, gp, out, n, h, wd, c, cpad, co, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kBf16>
cudaError_t launch(const void* x, const void* wp, const float* bias, const float* beta,
                   const void* gp, void* out, int n, int h, int wd, int c, int cpad, int co,
                   int cop, int inverse, cudaStream_t stream) {
  if (cpad < c || cpad % Cfg<kBf16>::kChunk != 0 || cop < co || cop != (co + 63) / 64 * 64 ||
      reinterpret_cast<uintptr_t>(wp) % 16 != 0 || reinterpret_cast<uintptr_t>(gp) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  if (inverse)
    return launch_nt<kBf16, true>(x, wp, bias, beta, gp, out, n, h, wd, c, cpad, co, cop, stream);
  return launch_nt<kBf16, false>(x, wp, bias, beta, gp, out, n, h, wd, c, cpad, co, cop, stream);
}

}  // namespace

extern "C" {

// Largest output channel count the kernel takes.
int nic_convt_igdn_max_channels() { return kMaxCo; }

// x [n, h, wd, c] of dtype (0 = float32, 1 = bfloat16); wp the packed
// weights [25 * cpad, cop] and gp the packed gamma [cop, cop], both of x's
// dtype; bias and beta [co] float32; out [n, 2h, 2wd, co] of x's dtype; all
// contiguous, cop = co rounded up to 64. Returns the launch's cudaError_t.
int nic_convt_igdn_forward(const void* x, const void* wp, const void* bias, const void* beta,
                           const void* gp, void* out, int n, int h, int wd, int c, int cpad,
                           int co, int cop, int inverse, int dtype, void* stream) {
  if (n < 0 || h < 0 || wd < 0 || c < 1 || co < 1 || co > kMaxCo) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long pixels = static_cast<long long>(n) * h * wd;
  if (pixels == 0) return static_cast<int>(cudaSuccess);
  // 32-bit offsets inside the kernel.
  if (pixels * 4 * (c > co ? c : co) >= (1LL << 31) || 25LL * cpad * cop >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* bi = static_cast<const float*>(bias);
  const float* be = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch<false>(x, wp, bi, be, gp, out, n, h, wd, c, cpad, co, cop, inverse, s));
    case 1:
      return static_cast<int>(
          launch<true>(x, wp, bi, be, gp, out, n, h, wd, c, cpad, co, cop, inverse, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
