// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces src/repro/kernels/rmsnorm/kernel.py:rmsnorm_pallas (body
// _rmsnorm_kernel): per row of x viewed as (rows, D),
//   y = x * rsqrt(mean(x^2) + eps) * (offset + scale)
// in f32, cast back to x's dtype.
//
// Bound: bytes.  Each element is read once and written once with ~4 flops
// between, far below the card's ~295 flops/byte balance point.  At the served
// shapes (1 to 64 rows of 128 to 4096) the bytes take nanoseconds and the
// launch and the latency of one dependent chain of loads, a reduction and
// stores take the time, so the design removes steps from that chain.  The
// row lives in registers from one pass of 16-byte loads (8 bf16 or 4 f32 per
// lane per load) and is read from memory once; `offset + scale` is loaded
// with 16-byte loads in the same pass.  Three routes, chosen on the host
// (ops.py:rmsnorm_plan) and passed in:
//
//   warp   (D <= 1024, D a multiple of the vector, 16-byte aligned rows):
//          one warp per row, up to 4 rows per block; the sum of squares is
//          reduced with warp shuffles only: no shared memory, no barrier.
//          qwen3's d_model (1024) and qk-norm rows (16 and 8 rows of 128).
//   block  (larger aligned rows, up to 4 vectors a thread at 512 threads):
//          one block per row, sized so each thread holds 1-4 vectors in
//          registers; one barrier for the cross-warp sum.  zamba2's d_model
//          (2048) and gated-norm width d_inner (4096).
//   scalar (anything else: D not a multiple of the vector, an unaligned
//          pointer, or a row too long for the block route's registers): one
//          block per row, scalar loads, x read twice (the row's second read
//          hits L1/L2), two barriers.
//
// Many rows (prefill, the stateless bucket's 64 rows) take the same routes
// with a grid over rows.  Every route multiplies in the plain version's
// order, (x * r) * (offset + scale); only the order of the sum of squares
// differs between routes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Route { kScalar = 0, kWarp = 1, kBlock = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same bits
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes of T as floats and back
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void load(const uint4& r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void load(const uint4& r, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 v = __bfloat1622float2(h[k]);
      f[2 * k] = v.x;
      f[2 * k + 1] = v.y;
    }
  }
  __device__ static uint4 pack(const float* f) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    return r;
  }
};

// One row held as VPL 16-byte vectors per thread: vector i of the row is
// thread (i % lanes)'s vector i / lanes, where `lanes` threads share the row.
template <typename T, int VPL>
struct RowRegs {
  static constexpr int kN = Vec<T>::kN;
  float v[VPL][kN];
  uint4 s[VPL];

  // load x's vectors and scale's, return this thread's sum of squares
  __device__ float load(const uint4* xr, const uint4* sr, int first, int lanes, int nvec) {
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = first + k * lanes;
      if (i < nvec) {
        Vec<T>::load(__ldg(xr + i), v[k]);
        s[k] = __ldg(sr + i);
      }
    }
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      if (first + k * lanes < nvec) {
#pragma unroll
        for (int e = 0; e < kN; ++e) ss += v[k][e] * v[k][e];
      }
    }
    return ss;
  }

  __device__ void store_row(uint4* yr, int first, int lanes, int nvec, float r, float offset) {
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int i = first + k * lanes;
      if (i < nvec) {
        float w[kN], o[kN];
        Vec<T>::load(s[k], w);
#pragma unroll
        for (int e = 0; e < kN; ++e) o[e] = v[k][e] * r * (offset + w[e]);
        yr[i] = Vec<T>::pack(o);
      }
    }
  }
};

template <typename T, int VPL>
__global__ void __launch_bounds__(256)
rmsnorm_warp(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ y,
             long long rows, int d, float eps, float offset) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= rows) return;  // no barrier below: a whole warp leaves
  const int lane = threadIdx.x & 31;
  const int nvec = d / Vec<T>::kN;
  RowRegs<T, VPL> regs;
  float ss = regs.load(reinterpret_cast<const uint4*>(x + row * d),
                       reinterpret_cast<const uint4*>(scale), lane, 32, nvec);
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  regs.store_row(reinterpret_cast<uint4*>(y + row * d), lane, 32, nvec, r, offset);
}

template <typename T, int VPL>
__global__ void __launch_bounds__(512)
rmsnorm_block(const T* __restrict__ x, const T* __restrict__ scale, T* __restrict__ y, int d,
              float eps, float offset) {
  const long long row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nvec = d / Vec<T>::kN;
  RowRegs<T, VPL> regs;
  float ss = regs.load(reinterpret_cast<const uint4*>(x + row * d),
                       reinterpret_cast<const uint4*>(scale), threadIdx.x, blockDim.x, nvec);
  ss = warp_sum(ss);
  __shared__ float warp_sums[32];
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  // every warp sums the warps' partial sums in the same order
  float total = lane < static_cast<int>(blockDim.x >> 5) ? warp_sums[lane] : 0.f;
  total = warp_sum(total);
  const float r = rsqrtf(total / static_cast<float>(d) + eps);
  regs.store_row(reinterpret_cast<uint4*>(y + row * d), threadIdx.x, blockDim.x, nvec, r, offset);
}

template <typename T>
__global__ void rmsnorm_scalar(const T* __restrict__ x, const T* __restrict__ scale,
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

// the smallest of 1, 2, 4, 8 that is >= v, or 0 if v > 8
__host__ int pow2_vectors(int v) {
  for (int k = 1; k <= 8; k <<= 1) {
    if (v <= k) return k;
  }
  return 0;
}

template <typename T>
cudaError_t launch(const void* xv, const void* sv, void* yv, long long rows, int d, float eps,
                   float offset, int route, int threads, int rows_per_block, long long grid,
                   cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const T* s = static_cast<const T*>(sv);
  T* y = static_cast<T*>(yv);
  constexpr int kN = Vec<T>::kN;
  const int nvec = d / kN;
  if (grid <= 0 || grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned g = static_cast<unsigned>(grid);
  if (route == kWarp) {
    if (d % kN != 0 || rows_per_block < 1 || rows_per_block > 8 ||
        threads != 32 * rows_per_block || grid != (rows + rows_per_block - 1) / rows_per_block) {
      return cudaErrorInvalidValue;
    }
    switch (pow2_vectors((nvec + 31) / 32)) {
      case 1: rmsnorm_warp<T, 1><<<g, threads, 0, st>>>(x, s, y, rows, d, eps, offset); break;
      case 2: rmsnorm_warp<T, 2><<<g, threads, 0, st>>>(x, s, y, rows, d, eps, offset); break;
      case 4: rmsnorm_warp<T, 4><<<g, threads, 0, st>>>(x, s, y, rows, d, eps, offset); break;
      case 8: rmsnorm_warp<T, 8><<<g, threads, 0, st>>>(x, s, y, rows, d, eps, offset); break;
      default: return cudaErrorInvalidValue;
    }
  } else if (route == kBlock) {
    if (d % kN != 0 || rows_per_block != 1 || threads % 32 != 0 || threads < 32 ||
        threads > 512 || grid != rows) {
      return cudaErrorInvalidValue;
    }
    switch (pow2_vectors((nvec + threads - 1) / threads)) {
      case 1: rmsnorm_block<T, 1><<<g, threads, 0, st>>>(x, s, y, d, eps, offset); break;
      case 2: rmsnorm_block<T, 2><<<g, threads, 0, st>>>(x, s, y, d, eps, offset); break;
      case 4: rmsnorm_block<T, 4><<<g, threads, 0, st>>>(x, s, y, d, eps, offset); break;
      default: return cudaErrorInvalidValue;  // 8 would spill at 512 threads
    }
  } else if (route == kScalar) {
    if (rows_per_block != 1 || threads % 32 != 0 || threads < 32 || threads > 1024 ||
        grid != rows) {
      return cudaErrorInvalidValue;
    }
    rmsnorm_scalar<T><<<g, threads, 0, st>>>(x, s, y, d, eps, offset);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  route (0 scalar, 1 warp, 2 block),
// threads, rows_per_block and grid come from ops.py:rmsnorm_plan; a plan
// that does not fit the shape returns cudaErrorInvalidValue and launches
// nothing.  Returns cudaGetLastError() after the launch.
extern "C" int repro_rmsnorm(const void* x, const void* scale, void* y, long long rows, int d,
                             float eps, float offset, int dtype, int route, int threads,
                             int rows_per_block, long long grid, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? launch<__nv_bfloat16>(x, scale, y, rows, d, eps, offset, route, threads,
                              rows_per_block, grid, s)
      : launch<float>(x, scale, y, rows, d, eps, offset, route, threads, rows_per_block, grid,
                      s);
  return static_cast<int>(err);
}
