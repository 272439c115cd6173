// Fused GDN / IGDN forward for NVIDIA Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_gdn_kernel` of nic_tpu/ops/pallas_gdn.py
// (launched by `_gdn_pallas_fwd_impl`). Over the rows of a (M, C) matrix:
//
//   n[m, j] = beta[j] + sum_i x[m, i]^2 * gamma[i, j]      (fp32 accumulation)
//   GDN:  y = x * rsqrt(n)        IGDN: y = x * sqrt(n)
//
// x and y are float32 or bfloat16, gamma has x's type, beta is float32.
//
// What bounds it on this card: 2*M*C^2 multiply-adds against 2*M*C elements
// moved. At C = 192 that is 96 FLOP per byte in fp32 and 192 in bf16: in
// fp32 the CUDA cores' 67 TFLOP/s are the limit (above HBM's 3.35 TB/s);
// in bf16 on the tensor cores (989 TFLOP/s) the bytes would be.
//
// The design, simple first: one block of 256 threads per tile of 32 rows.
// The tile's x^2 is staged once in shared memory as fp32, transposed
// (channel-major) so that a thread reads the 8 rows it owns as two float4
// broadcast loads. Each thread owns one output channel j at a time (threads
// of a warp on neighbouring j, so gamma[i, j] is read coalesced from L1/L2)
// and 8 rows, so every gamma value it loads feeds 8 FMAs. The last tile is
// ragged: rows past M stage zeros and are not written. It runs on the CUDA
// cores in fp32; a wgmma/TMA version for the tensor cores is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileRows = 32;                 // rows per block
constexpr int kRowsPerThread = 8;             // rows per thread
constexpr int kThreadsX = 64;                 // threads along channels
constexpr int kThreadsY = kTileRows / kRowsPerThread;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kMaxChannels = 256;
// Padded row stride of the transposed tile: keeps float4 alignment and
// spreads the staging stores over 8 banks instead of 1.
constexpr int kStride = kTileRows + 4;

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

template <typename T, bool kInverse>
__global__ void __launch_bounds__(kThreads)
gdn_rows_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                const float* __restrict__ beta, T* __restrict__ out, int rows,
                int channels) {
  __shared__ __align__(16) float xsq[kMaxChannels * kStride];

  const long long row0 = static_cast<long long>(blockIdx.x) * kTileRows;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;

  // Stage x^2 of the tile, transposed: xsq[i * kStride + r] = x[row0 + r, i]^2.
  for (int idx = tid; idx < kTileRows * channels; idx += kThreads) {
    const int r = idx / channels;
    const int i = idx - r * channels;
    const long long m = row0 + r;
    const float v = (m < rows) ? to_float(x[m * channels + i]) : 0.0f;
    xsq[i * kStride + r] = v * v;
  }
  __syncthreads();

  const int r0 = threadIdx.y * kRowsPerThread;
  for (int j = threadIdx.x; j < channels; j += kThreadsX) {
    float acc[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.0f;

#pragma unroll 4
    for (int i = 0; i < channels; ++i) {
      const float g = to_float(gamma[i * channels + j]);
      const float4* p = reinterpret_cast<const float4*>(&xsq[i * kStride + r0]);
      const float4 a = p[0];
      const float4 b = p[1];
      acc[0] = fmaf(a.x, g, acc[0]);
      acc[1] = fmaf(a.y, g, acc[1]);
      acc[2] = fmaf(a.z, g, acc[2]);
      acc[3] = fmaf(a.w, g, acc[3]);
      acc[4] = fmaf(b.x, g, acc[4]);
      acc[5] = fmaf(b.y, g, acc[5]);
      acc[6] = fmaf(b.z, g, acc[6]);
      acc[7] = fmaf(b.w, g, acc[7]);
    }

    const float bj = beta[j];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const long long m = row0 + r0 + r;
      if (m < rows) {
        const float n = acc[r] + bj;
        const float scale = kInverse ? sqrtf(n) : rsqrtf(n);
        const long long k = m * channels + j;
        out[k] = from_float<T>(to_float(x[k]) * scale);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, const float* beta, void* out,
                   int rows, int channels, int inverse, cudaStream_t stream) {
  const dim3 block(kThreadsX, kThreadsY);
  const dim3 grid((rows + kTileRows - 1) / kTileRows);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(gamma);
  T* ot = static_cast<T*>(out);
  if (inverse) {
    gdn_rows_kernel<T, true><<<grid, block, 0, stream>>>(xt, gt, beta, ot, rows, channels);
  } else {
    gdn_rows_kernel<T, false><<<grid, block, 0, stream>>>(xt, gt, beta, ot, rows, channels);
  }
  return cudaGetLastError();
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
      return static_cast<int>(launch<float>(x, gamma, b, out, rows, channels, inverse, s));
    case 1:
      return static_cast<int>(
          launch<__nv_bfloat16>(x, gamma, b, out, rows, channels, inverse, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
