// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces src/repro/kernels/rmsnorm/kernel.py:rmsnorm_pallas (body
// _rmsnorm_kernel): per row of x viewed as (rows, D),
//   y = x * rsqrt(mean(x^2) + eps) * (offset + scale)
// in f32, cast back to x's dtype.
//
// Bound: bytes.  Each element is read once and written once with ~4 flops
// between, far below the card's ~295 flops/byte balance point.  Design: one
// block per row, so any row count works (no divisibility rule, unlike the
// TPU wrapper's 256-row tiles); the row's sum of squares is reduced in f32
// with warp shuffles, then the same threads rescale and store the row.  The
// second read of the row hits L1/L2 (a row is at most a few KiB).  At the
// slice's decode shapes (1 row of 1024; 16 and 8 rows of 128) the launch,
// not the bytes, dominates: fusing the norm into its neighbours is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                               T* __restrict__ y, int d, float eps, float offset) {
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f(xr[i]);
    ss += v * v;
  }
  ss = warp_sum(ss);

  __shared__ float warp_sums[32];
  __shared__ float rstd;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    float total = lane < nwarps ? warp_sums[lane] : 0.f;
    total = warp_sum(total);
    if (lane == 0) rstd = rsqrtf(total / static_cast<float>(d) + eps);
  }
  __syncthreads();

  const float r = rstd;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    store(yr + i, to_f(xr[i]) * r * (offset + to_f(scale[i])));
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* scale, void* y, long long rows, int d,
                   float eps, float offset, cudaStream_t stream) {
  const int threads = d >= 256 ? 256 : ((d + 31) / 32) * 32;
  rmsnorm_kernel<T><<<static_cast<unsigned>(rows), threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale), static_cast<T*>(y), d, eps,
      offset);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the launch.
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y, long long rows, int d,
                             float eps, float offset, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? launch<__nv_bfloat16>(x, scale, y, rows, d, eps, offset, s)
      : launch<float>(x, scale, y, rows, d, eps, offset, s);
  return static_cast<int>(err);
}
