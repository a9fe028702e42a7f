// Fused RMSNorm, backward, for Hopper (sm_90a).
//
// Replaces the gradient that JAX's AD derives through
// src/repro/kernels/rmsnorm/kernel.py:rmsnorm_pallas (the reference has no
// backward kernel: its training differentiates the op's body).  Per row of
// x viewed as (rows, D), with r = rsqrt(mean(x^2) + eps), w = offset + scale
// and g = dy * w, all in f32:
//   dx     = r * (g - x r * mean(g * x r))          (in x's dtype)
//   dscale = sum over every row of dy * x r          (in scale's dtype)
//
// Bound: bytes.  dy and x are read and dx written once, ~10 flops an
// element; the training path's shapes (4 x 512 rows of d_model, 32k rows of
// the qk-norm head) move megabytes.
//
// dscale is a sum over all rows, taken deterministically, without atomics,
// so two launches give the same bits:
//   pass 1 (rows_kernel): block b takes rows_per_block consecutive rows
//          (ops.py:rmsnorm_backward_plan, from the shape alone); each of its
//          4 warps takes every 4th row, reduces the row's sum of squares
//          and sum of g x with warp shuffles (one xor butterfly: every lane
//          gets the same bits), writes dx, and adds dy * x r of its columns
//          into its own f32 row of shared memory.  The block then sums its
//          4 warp rows in warp order into partial[b].
//   pass 2 (scale_kernel): 8 threads per column sum partial[0..grid) in
//          fixed strides, then one thread adds their 8 sums in order.
// The row is read twice in pass 1 (the second read hits L1); the loads are
// scalar and coalesced (a warp reads 32 neighbouring elements).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kGroups = 8;  // threads summing one column in pass 2

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
__global__ void __launch_bounds__(kWarps * 32)
rows_kernel(const T* __restrict__ dy, const T* __restrict__ x, const T* __restrict__ scale,
            T* __restrict__ dx, float* __restrict__ partial, long long rows, int d,
            int rows_per_block, float eps, float offset) {
  extern __shared__ float acc[];  // (kWarps, d)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x; c < kWarps * d; c += blockDim.x) acc[c] = 0.f;
  __syncthreads();
  float* mine = acc + warp * d;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  const float inv_d = 1.f / static_cast<float>(d);
  for (long long row = r0 + warp; row < r1; row += kWarps) {
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    float ss = 0.f, gx = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float xv = to_f(xr[c]);
      const float g = to_f(gr[c]) * (offset + to_f(scale[c]));
      ss += xv * xv;
      gx += g * xv;
    }
    ss = warp_sum(ss);
    gx = warp_sum(gx);
    const float r = rsqrtf(ss * inv_d + eps);
    const float c_mean = gx * r * inv_d;  // mean(g * x r)
    T* out = dx + row * d;
    for (int c = lane; c < d; c += 32) {
      const float gv = to_f(gr[c]);
      const float xn = to_f(xr[c]) * r;
      store(out + c, r * (gv * (offset + to_f(scale[c])) - xn * c_mean));
      mine[c] += gv * xn;
    }
  }
  __syncthreads();
  float* part = partial + static_cast<long long>(blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += acc[w * d + c];
    part[c] = s;
  }
}

// block: 32 columns x kGroups threads; thread (group k, column c) sums
// partial rows k, k + kGroups, ... of column c, then group 0 adds the
// kGroups sums in group order
template <typename T>
__global__ void __launch_bounds__(32 * kGroups)
scale_kernel(const float* __restrict__ partial, T* __restrict__ dscale, int blocks, int d) {
  __shared__ float sums[kGroups][32];
  const int col = blockIdx.x * 32 + (threadIdx.x & 31);
  const int group = threadIdx.x >> 5;
  float s = 0.f;
  if (col < d) {
    for (int b = group; b < blocks; b += kGroups) s += partial[static_cast<long long>(b) * d + col];
  }
  sums[group][threadIdx.x & 31] = s;
  __syncthreads();
  if (group == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) t += sums[k][threadIdx.x];
    store(dscale + col, t);
  }
}

template <typename T>
cudaError_t launch(const void* dy, const void* x, const void* scale, void* dx, void* dscale,
                   void* partial, long long rows, int d, float eps, float offset,
                   int rows_per_block, long long grid, cudaStream_t st) {
  if (rows_per_block < 1 || grid < 1 || grid > 0x7fffffffLL ||
      grid != (rows + rows_per_block - 1) / rows_per_block) {
    return cudaErrorInvalidValue;
  }
  const int smem = kWarps * d * static_cast<int>(sizeof(float));
  static bool attr_set = false;   // raise the dynamic shared-memory cap once, to d = 8192's
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kWarps * 8192 * 4);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  rows_kernel<T><<<static_cast<unsigned>(grid), kWarps * 32, smem, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(dx), static_cast<float*>(partial), rows, d, rows_per_block, eps, offset);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scale_kernel<T><<<(d + 31) / 32, 32 * kGroups, 0, st>>>(
      static_cast<const float*>(partial), static_cast<T*>(dscale), static_cast<int>(grid), d);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (dy, x, scale, dx and dscale alike).
// partial: f32 scratch of (grid, d).  rows_per_block and grid come from
// ops.py:rmsnorm_backward_plan; a plan that does not fit the rows returns
// cudaErrorInvalidValue and launches nothing.  d <= 8192 (pass 1 keeps 4
// rows of d floats in shared memory).  Returns cudaGetLastError() after the
// launches.
extern "C" int repro_rmsnorm_backward(const void* dy, const void* x, const void* scale,
                                      void* dx, void* dscale, void* partial, long long rows,
                                      int d, float eps, float offset, int dtype,
                                      int rows_per_block, long long grid, void* stream) {
  if (rows <= 0 || d <= 0 || d > 8192) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = launch<__nv_bfloat16>(dy, x, scale, dx, dscale, partial, rows, d, eps, offset,
                                rows_per_block, grid, s);
  } else if (dtype == 0) {
    err = launch<float>(dy, x, scale, dx, dscale, partial, rows, d, eps, offset,
                        rows_per_block, grid, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
