// Fused 5x5 stride-2 SAME transposed convolution + bias + (I)GDN for
// NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_kernel` of nic_tpu/ops/pallas_convt.py
// (launched by `conv_transpose_igdn_up2`). x [N, H, W, C] -> out
// [N, 2H, 2W, Co], with the kernel w in the un-flipped HWIO layout of
// `lax.conv_transpose(x, w, (2, 2), "SAME")`:
//
//   out[n, 2i+r, 2j+t, :] = (I)GDN(bias + sum_{a, b} x[n, i-a, j-b, :]
//                                          @ w[3-2a-r, 3-2b-t])
//   a in {1, 0} for r = 0, {1, 0, -1} for r = 1 (likewise b for t)
//   (I)GDN: z * sqrt(beta + (z*z) @ gamma)   (GDN: rsqrt)
//
// so each output parity (r, t) is a GEMM [pixels, taps*C] @ [taps*C, Co]
// with 4, 6, 6 or 9 taps, and x outside the image reads as zero. x, w and
// out are float32 or bfloat16; bias, beta and gamma are float32;
// accumulation and the normalizer are float32.
//
// What bounds it on this card: 2*N*H*W*25*C*Co + 2*N*4HW*Co^2 FLOPs
// against (N*H*W*C + 4*N*H*W*Co) elements moved: at C = Co = 192 that is
// ~600 FLOP per byte in float32, far above HBM's 3.35 TB/s, so the CUDA
// cores' 67 TFLOP/s (float32) are the limit. The bf16 tensor-core bound
// (wgmma) is later work.
//
// The design, simple first. The Pallas kernel's row strips, shifted input
// copies and column split exist for VMEM and Mosaic's 128-lane rule; here
// the kernel reads the input directly and masks the halo at the edges. One
// block of 256 threads per (tile of 64 input-grid pixels, parity): the
// block keeps all Co <= 192 output channels of its pixels, so the
// normalizer sees whole pixel rows. It loops over the parity's taps and C
// in chunks of 16, staged in shared memory as float32 (pixels x 16, and
// 16 x Co of w); each thread owns 4 pixels x 12 channels (three runs of 4
// neighbouring channels), so one float4 of x and three float4s of w from
// shared memory feed 48 FMAs. The epilogue writes z = acc + bias to
// shared memory (Co x 64) and runs the second GEMM (z*z) @ gamma the same
// way, gamma staged in chunks of 16 rows; then it scales z and stores
// out[n, 2i+r, 2j+t, :]. Threads of a warp own neighbouring channels, so
// the w / gamma reads and the output stores are coalesced. Offsets are
// 32-bit: the wrapper refuses tensors of 2^31 elements or more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileM = 64;                      // input-grid pixels per block
constexpr int kMaxCo = 192;                     // output channels per block
constexpr int kChunk = 16;                      // reduction chunk
constexpr int kThreadsN = 16;                   // threads along channels
constexpr int kPixPerThread = 4;                // pixels per thread
constexpr int kChanPerThread = kMaxCo / kThreadsN;  // 12
// Row stride of the pixel-minor tiles: keeps float4 alignment and spreads
// the transposed staging stores over more banks.
constexpr int kStrideM = kTileM + 4;

constexpr int kSmemZ = kMaxCo * kStrideM;       // z, channel-major
constexpr int kSmemA = kChunk * kStrideM;       // x chunk, channel-major
constexpr int kSmemB = kChunk * kMaxCo;         // w or gamma chunk
constexpr size_t kSmemBytes = sizeof(float) * (kSmemZ + kSmemA + kSmemB);

static_assert(kThreadsN * (kTileM / kPixPerThread) == kThreads, "thread grid");
static_assert(kTileM * kChunk == 4 * kThreads, "x staging: 4 values a thread");
static_assert(kChunk * kMaxCo == kChanPerThread * kThreads, "w staging");

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

// Stage rows [k0, k0 + 16) of a (rows, Co) row-major matrix into bs
// (16 x kMaxCo), zero past its edges.
template <typename T>
__device__ __forceinline__ void stage_rows(float* __restrict__ bs, const T* __restrict__ m,
                                           int k0, int rows, int co, int tid) {
#pragma unroll
  for (int e = 0; e < kChanPerThread; ++e) {
    const int idx = tid + e * kThreads;
    const int k = idx / kMaxCo;
    const int c = idx - k * kMaxCo;
    float v = 0.0f;
    if (k0 + k < rows && c < co) v = to_float(m[static_cast<long long>(k0 + k) * co + c]);
    bs[idx] = v;
  }
}

// The channel of a thread's accumulator q: runs of 4 neighbouring channels
// 64 apart, so each run is one float4 of a staged w / gamma row.
__device__ __forceinline__ int channel_of(int tx, int q) {
  return (q / 4) * (kThreadsN * 4) + tx * 4 + (q % 4);
}

// acc[p][q] += sum_k a[k][pixel p] * bs[k][channel q] over one staged chunk;
// `square` squares the a values first (the normalizer's z*z).
template <bool kSquare>
__device__ __forceinline__ void chunk_fma(float (&acc)[kPixPerThread][kChanPerThread],
                                          const float* __restrict__ a, int a_stride,
                                          const float* __restrict__ bs, int tx, int ty) {
#pragma unroll 4
  for (int k = 0; k < kChunk; ++k) {
    float4 av = *reinterpret_cast<const float4*>(&a[k * a_stride + ty * kPixPerThread]);
    if (kSquare) {
      av.x *= av.x;
      av.y *= av.y;
      av.z *= av.z;
      av.w *= av.w;
    }
    float bv[kChanPerThread];
#pragma unroll
    for (int g = 0; g < kChanPerThread / 4; ++g) {
      const float4 b4 =
          *reinterpret_cast<const float4*>(&bs[k * kMaxCo + g * kThreadsN * 4 + tx * 4]);
      bv[4 * g] = b4.x;
      bv[4 * g + 1] = b4.y;
      bv[4 * g + 2] = b4.z;
      bv[4 * g + 3] = b4.w;
    }
#pragma unroll
    for (int q = 0; q < kChanPerThread; ++q) {
      acc[0][q] = fmaf(av.x, bv[q], acc[0][q]);
      acc[1][q] = fmaf(av.y, bv[q], acc[1][q]);
      acc[2][q] = fmaf(av.z, bv[q], acc[2][q]);
      acc[3][q] = fmaf(av.w, bv[q], acc[3][q]);
    }
  }
}

template <typename T, bool kInverse>
__global__ void __launch_bounds__(kThreads, 2)
convt_igdn_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const float* __restrict__ bias, const float* __restrict__ beta,
                  const float* __restrict__ gamma, T* __restrict__ out, int n_img,
                  int h, int wd, int c, int co) {
  extern __shared__ __align__(16) float smem[];
  float* zs = smem;                 // [kMaxCo][kStrideM]
  float* as = zs + kSmemZ;          // [kChunk][kStrideM]
  float* bs = as + kSmemA;          // [kChunk][kMaxCo]

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsN;   // channels channel_of(tx, q)
  const int ty = tid / kThreadsN;   // pixels ty * 4 + p
  const int r = blockIdx.y >> 1;
  const int t = blockIdx.y & 1;
  const int hw = h * wd;
  const int m_total = n_img * hw;
  const int m0 = blockIdx.x * kTileM;

  // The pixels this thread stages: p = tid / 16 + 16 e, channel k = tid % 16;
  // prow = n * h + i, and pi = -4 (never inside the image) past the end.
  const int stage_k = tid % kChunk;
  int prow[4], pi[4], pj[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = m0 + tid / kChunk + 16 * e;
    prow[e] = m / wd;
    pj[e] = m - prow[e] * wd;
    pi[e] = m < m_total ? prow[e] % h : -4;
  }

  float acc[kPixPerThread][kChanPerThread];
#pragma unroll
  for (int p = 0; p < kPixPerThread; ++p)
#pragma unroll
    for (int q = 0; q < kChanPerThread; ++q) acc[p][q] = 0.0f;

  const int taps_a = 2 + r;  // a = 1, 0 (, -1)
  const int taps_b = 2 + t;
  for (int ia = 0; ia < taps_a; ++ia) {
    const int a = 1 - ia;
    const int kh = 3 - 2 * a - r;
    for (int ib = 0; ib < taps_b; ++ib) {
      const int b = 1 - ib;
      const int kw = 3 - 2 * b - t;
      int base[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ii = pi[e] - a;
        const int jj = pj[e] - b;
        const bool ok = ii >= 0 && ii < h && jj >= 0 && jj < wd;
        base[e] = ok ? ((prow[e] - a) * wd + jj) * c : -1;
      }
      const T* wtap = w + (kh * 5 + kw) * c * co;
      for (int c0 = 0; c0 < c; c0 += kChunk) {
        const bool kin = c0 + stage_k < c;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = 0.0f;
          if (kin && base[e] >= 0) v = to_float(x[base[e] + c0 + stage_k]);
          as[stage_k * kStrideM + tid / kChunk + 16 * e] = v;
        }
        stage_rows<T>(bs, wtap, c0, c, co, tid);
        __syncthreads();
        chunk_fma<false>(acc, as, kStrideM, bs, tx, ty);
        __syncthreads();
      }
    }
  }

  // Epilogue: z = acc + bias to shared memory, then n = beta + (z*z) @ gamma.
#pragma unroll
  for (int q = 0; q < kChanPerThread; ++q) {
    const int ch = channel_of(tx, q);
    const float bq = ch < co ? bias[ch] : 0.0f;
    float4 z;
    z.x = acc[0][q] + bq;
    z.y = acc[1][q] + bq;
    z.z = acc[2][q] + bq;
    z.w = acc[3][q] + bq;
    *reinterpret_cast<float4*>(&zs[ch * kStrideM + ty * kPixPerThread]) = z;
#pragma unroll
    for (int p = 0; p < kPixPerThread; ++p) acc[p][q] = 0.0f;
  }
  for (int i0 = 0; i0 < co; i0 += kChunk) {
    stage_rows<float>(bs, gamma, i0, co, co, tid);
    __syncthreads();
    chunk_fma<true>(acc, zs + i0 * kStrideM, kStrideM, bs, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < kPixPerThread; ++p) {
    const int m = m0 + ty * kPixPerThread + p;
    if (m >= m_total) continue;
    const int row = m / wd;  // n * h + i
    const int j = m - row * wd;
    // out row 2 * (n * h + i) + r = (n * 2h + 2i + r)
    T* o = out + ((2 * row + r) * 2 * wd + 2 * j + t) * co;
#pragma unroll
    for (int q = 0; q < kChanPerThread; ++q) {
      const int ch = channel_of(tx, q);
      if (ch < co) {
        const float nrm = acc[p][q] + beta[ch];
        const float scale = kInverse ? sqrtf(nrm) : rsqrtf(nrm);
        o[ch] = from_float<T>(zs[ch * kStrideM + ty * kPixPerThread + p] * scale);
      }
    }
  }
}

template <typename T, bool kInverse>
cudaError_t launch_one(const void* x, const void* w, const float* bias, const float* beta,
                       const float* gamma, void* out, int n, int h, int wd, int c, int co,
                       cudaStream_t stream) {
  auto kernel = convt_igdn_kernel<T, kInverse>;
  // Above 48 KB of shared memory a kernel must opt in (per device, so on
  // every launch: it costs microseconds).
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmemBytes));
  if (attr != cudaSuccess) return attr;
  const int m_total = n * h * wd;
  const dim3 grid((m_total + kTileM - 1) / kTileM, 4);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias, beta, gamma,
      static_cast<T*>(out), n, h, wd, c, co);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const float* bias, const float* beta,
                   const float* gamma, void* out, int n, int h, int wd, int c, int co,
                   int inverse, cudaStream_t stream) {
  if (inverse) {
    return launch_one<T, true>(x, w, bias, beta, gamma, out, n, h, wd, c, co, stream);
  }
  return launch_one<T, false>(x, w, bias, beta, gamma, out, n, h, wd, c, co, stream);
}

}  // namespace

extern "C" {

// Largest output channel count the kernel takes.
int nic_convt_igdn_max_channels() { return kMaxCo; }

// x [n, h, wd, c] and w [5, 5, c, co] of one dtype (0 = float32,
// 1 = bfloat16), bias/beta [co] and gamma [co, co] float32, out
// [n, 2h, 2wd, co] of x's dtype; all contiguous. Returns the launch's
// cudaError_t.
int nic_convt_igdn_forward(const void* x, const void* w, const void* bias,
                           const void* beta, const void* gamma, void* out, int n, int h,
                           int wd, int c, int co, int inverse, int dtype, void* stream) {
  if (n < 0 || h < 0 || wd < 0 || c < 1 || co < 1 || co > kMaxCo) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long pixels = static_cast<long long>(n) * h * wd;
  if (pixels == 0) return static_cast<int>(cudaSuccess);
  // 32-bit offsets inside the kernel.
  if (pixels * 4 * (c > co ? c : co) >= (1LL << 31) || 25LL * c * co >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* bi = static_cast<const float*>(bias);
  const float* be = static_cast<const float*>(beta);
  const float* ga = static_cast<const float*>(gamma);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(
          launch<float>(x, w, bi, be, ga, out, n, h, wd, c, co, inverse, s));
    case 1:
      return static_cast<int>(
          launch<__nv_bfloat16>(x, w, bi, be, ga, out, n, h, wd, c, co, inverse, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
