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
// the qk-norm head) move megabytes.  So each row is read once, into
// registers, with 16-byte loads, and dscale's partial sums stay in
// registers until the block ends.  Two routes, chosen on the host
// (ops.py:rmsnorm_backward_plan, from the shape, the dtype and the
// pointers' alignment) and passed in:
//
//   vector (D a multiple of the vector, 16-byte aligned, D <= 8192):
//          vector_rows_kernel; `lanes` threads share a row, each holding
//          `vecs` vectors of x, dy and w, packed, at fixed columns for
//          every row, so dscale's partial sums stay in its registers; a row
//          group loads two rows before it reduces the first.  Up to D 1024
//          a block has 8 warps and a row's lanes are in one warp (32 from
//          32 vectors up, else the largest power of two <= the row's
//          vectors, so at the qk-norm's D = 128 a warp holds two bf16 rows
//          or one f32 row), its two sums reduced over them with a xor
//          butterfly (every lane gets the same bits).  Beyond, the whole
//          block (4 to 16 warps, 1-4 vectors a thread) shares a row: each
//          warp's butterfly, then the warps' sums added in warp order from
//          shared memory, with a grid of one to four blocks an SM (132-528:
//          about 64 KB of x and dy in flight on each SM;
//          tools/rmsnorm_backward_grids.py times the others), so the
//          (grid, D) f32 partial rows stay a small share of the bytes.
//   scalar (what the vector route does not take: D not a multiple of the
//          vector, or an unaligned pointer): rows_kernel, 4 warps a block,
//          scalar loads, the row read twice (the second read hits L1).
//
// dscale is a sum over all rows, taken deterministically, without atomics,
// so two launches give the same bits.  A lane owns fixed columns and adds
// dy * x r of its rows in registers; the block adds its row groups and
// warps in a fixed order into partial[block] (where the block shares a row
// a thread owns its columns in the whole block and writes its sums as they
// are; a grid of one writes dscale itself), and scale_kernel, a second
// launch, sums the partial rows of each column: 32 threads a column in
// fixed strides (a grid of 128 or 256 gives each 4 or 8 rows), then their
// 32 sums added by a warp's fixed butterfly.
// Finishing that sum inside the one launch (the last block to finish,
// elected by a counter, summing every partial row) was measured slower at
// every training shape: the one block's read of all the partial rows is a
// serial tail (PERF.md, the rmsnorm backward findings).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Route { kScalar = 0, kVector = 1 };

constexpr int kWarps = 4;       // warps of the scalar route's block
constexpr int kGroups = 32;     // threads summing one column in scale_kernel: a warp's lanes
static_assert(kGroups == 32, "scale_kernel's last sum is one warp's butterfly");
constexpr int kVecWarps = 8;    // warps of a vector block whose warps hold whole rows
constexpr int kBlockWarpsMax = 16;  // warps of a vector block that shares a row, at most
constexpr int kDMax = 8192;     // the longest row

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes of T: one element as a float, and floats packed back
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
  // element e (a constant once unrolled) of a packed vector
  __device__ static float at(const uint4& r, int e) { return __uint_as_float((&r.x)[e]); }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static uint4 pack(const float* f) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    return r;
  }
  __device__ static float at(const uint4& r, int e) {
    const uint32_t w = (&r.x)[e >> 1];
    return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

// The compiler may not carry values derived from v across this point: after
// it, the floats a packed vector holds are extracted again, so they are not
// all live at once.
__device__ __forceinline__ void repack(uint4& v) {
  asm volatile("" : "+r"(v.x), "+r"(v.y), "+r"(v.z), "+r"(v.w));
}

// ---------------------------------------------------------------- scalar

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

// block: 32 columns x kGroups (32) warps; thread (group k, column c) sums
// partial rows k, k + kGroups, ... of column c; then warp w adds the
// kGroups sums of column w (lane k holds group k's) with a fixed xor
// butterfly
template <typename T>
__global__ void __launch_bounds__(32 * kGroups)
scale_kernel(const float* __restrict__ partial, T* __restrict__ dscale, int blocks, int d) {
  __shared__ float sums[kGroups][33];  // padded: the transposed read hits 32 banks
  const int lane = threadIdx.x & 31;
  const int group = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < d) {
#pragma unroll 4  // loads ahead; the adds stay in order
    for (int b = group; b < blocks; b += kGroups) s += partial[static_cast<long long>(b) * d + col];
  }
  sums[group][lane] = s;
  __syncthreads();
  float t = sums[lane][group];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  if (lane == 0 && blockIdx.x * 32 + group < d) store(dscale + blockIdx.x * 32 + group, t);
}

// ---------------------------------------------------------------- vector route

// The vector route: `lanes` threads share a row, each holding vectors li,
// li + lanes, ..., li + (V - 1) lanes of it.  Either lanes <= 32, a power
// of two: row groups of `lanes` lanes side by side in a warp, each row's
// sums a xor butterfly over its lanes; or lanes = the block's threads
// (whole warps): one row group, each warp's butterfly, then the warps'
// sums added in warp order from shared memory (one barrier for both rows
// in flight, the slots double buffered so the next pair's writes need no
// second barrier).  Group g takes rows r0 + g, r0 + g + groups, ... of its
// block's rows, two at a time.  The trip count is the block's, so every
// thread takes part in every shuffle and barrier; a row past the block's
// end loads zeros and stores nothing.  x, dy and the scale stay packed in
// registers (converted element by element, `repack` keeping the compiler
// from holding them all as floats), and a thread's columns are the same
// for every row, so dscale's sums stay in its registers.  kSharedRow (the
// block shares each row) is a template argument, so each form is compiled
// alone, without the other's registers: a warp holding whole rows has 8
// warps and up to 8 vectors a thread, a block sharing a row up to 16 warps
// and 4 vectors.
template <typename T, int V, bool kSharedRow>
__global__ void __launch_bounds__(kSharedRow ? kBlockWarpsMax * 32 : kVecWarps * 32)
vector_rows_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                   const T* __restrict__ scale, T* __restrict__ dx, float* __restrict__ partial,
                   T* __restrict__ dscale, long long rows, int d, int lanes, int rows_per_block,
                   float eps, float offset) {
  using Vt = Vec<T>;
  constexpr int E = Vt::kN;
  constexpr int U = 2;  // rows a group has in flight
  // a shared row: each warp's (ss, gx) of both rows, two slots
  __shared__ float rsum[2][kSharedRow ? kBlockWarpsMax : 1][2 * U];
  extern __shared__ float red[];  // rows within a warp: the warps' dscale sums, (warps, d)
  const int nwarps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int span = kSharedRow ? 32 : lanes;  // a row's lanes in one warp
  const int groups = blockDim.x / lanes;
  const int g = threadIdx.x / lanes;
  const int li = threadIdx.x % lanes;
  const int nvec = d / E;
  const float inv_d = 1.f / static_cast<float>(d);

  uint4 wv[V];  // the scale (zeros past the row, where x and dy are zeros too)
  float acc[V][E];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int vi = li + j * lanes;
    wv[j] = vi < nvec ? *reinterpret_cast<const uint4*>(scale + vi * E)
                      : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int e = 0; e < E; ++e) acc[j][e] = 0.f;
  }

  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  int buf = 0;
  for (long long base = r0; base < r1; base += static_cast<long long>(groups) * U) {
    uint4 xv[U][V], gv[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = base + g + static_cast<long long>(u) * groups;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int vi = li + j * lanes;
        if (row < r1 && vi < nvec) {
          xv[u][j] = *reinterpret_cast<const uint4*>(x + row * d + vi * E);
          gv[u][j] = *reinterpret_cast<const uint4*>(dy + row * d + vi * E);
        } else {
          xv[u][j] = gv[u][j] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    // row u's dx from its two sums, and its share of dscale
    auto finish = [&](int u, float ss, float gx) {
      const long long row = base + g + static_cast<long long>(u) * groups;
      const float r = rsqrtf(ss * inv_d + eps);
      const float c_mean = gx * r * inv_d;  // mean(g * x r)
      const bool live = row < r1;           // a row past the block's end adds nothing
#pragma unroll
      for (int j = 0; j < V; ++j) {
        repack(xv[u][j]);
        repack(gv[u][j]);
        repack(wv[j]);
        float out[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float gf = Vt::at(gv[u][j], e);
          const float xn = Vt::at(xv[u][j], e) * r;
          if (live) acc[j][e] += gf * xn;
          out[e] = r * (gf * (offset + Vt::at(wv[j], e)) - xn * c_mean);
        }
        const int vi = li + j * lanes;
        if (live && vi < nvec) *reinterpret_cast<uint4*>(dx + row * d + vi * E) = Vt::pack(out);
      }
    };
    // each row's sums over its lanes (a xor butterfly in each warp); rows
    // within a warp are finished there, one after the other
    float ss[U], gx[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ss[u] = gx[u] = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float xf = Vt::at(xv[u][j], e);
          ss[u] += xf * xf;
          gx[u] += Vt::at(gv[u][j], e) * (offset + Vt::at(wv[j], e)) * xf;
        }
      }
      for (int o = span >> 1; o > 0; o >>= 1) {
        ss[u] += __shfl_xor_sync(0xffffffffu, ss[u], o);
        gx[u] += __shfl_xor_sync(0xffffffffu, gx[u], o);
      }
      if constexpr (!kSharedRow) finish(u, ss[u], gx[u]);
    }
    if constexpr (kSharedRow) {
      // the warps' sums of both rows, then each row's total in warp order
      if (lane == 0) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          rsum[buf][warp][2 * u] = ss[u];
          rsum[buf][warp][2 * u + 1] = gx[u];
        }
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float st = 0.f, gt = 0.f;
        for (int w = 0; w < nwarps; ++w) {  // every thread gets the same bits
          st += rsum[buf][w][2 * u];
          gt += rsum[buf][w][2 * u + 1];
        }
        finish(u, st, gt);
      }
      buf ^= 1;
    }
  }

  float* part = partial + static_cast<long long>(blockIdx.x) * d;
  if constexpr (kSharedRow) {
    // one row group: the thread's columns are its own in the whole block
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int vi = li + j * lanes;
      if (vi < nvec) {
        if (gridDim.x == 1) {
#pragma unroll
          for (int e = 0; e < E; ++e) store(dscale + vi * E + e, acc[j][e]);
        } else {
          float4* pv = reinterpret_cast<float4*>(part + vi * E);
#pragma unroll
          for (int k = 0; k < E / 4; ++k) {
            pv[k] = make_float4(acc[j][4 * k], acc[j][4 * k + 1], acc[j][4 * k + 2],
                                acc[j][4 * k + 3]);
          }
        }
      }
    }
    return;
  }
  // the warp's row groups into its first (a fixed butterfly), then the
  // warps in warp order
  for (int o = lanes; o < 32; o <<= 1) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], o);
    }
  }
  if (lane < lanes) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int vi = li + j * lanes;
      if (vi < nvec) {
#pragma unroll
        for (int e = 0; e < E; ++e) red[warp * d + vi * E + e] = acc[j][e];
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float s = 0.f;
#pragma unroll  // such a block has kVecWarps warps: their loads issued together
    for (int k = 0; k < kVecWarps; ++k) s += red[k * d + c];
    if (gridDim.x == 1) {
      store(dscale + c, s);
    } else {
      part[c] = s;
    }
  }
}

// Only the vector counts a plan can give are built: rows within a warp are
// at most 1024 wide, and a thread of a block that shares a row holds at
// most 4 vectors.
template <typename T, int V, bool kSharedRow>
cudaError_t launch_vector(const T* dy, const T* x, const T* scale, T* dx, float* partial,
                          T* dscale, long long rows, int d, int threads, int lanes, int rpb,
                          long long grid, float eps, float offset, int smem, cudaStream_t st) {
  if constexpr (kSharedRow ? V > 4 : (V - 1) * 32 * Vec<T>::kN >= 1024) {
    return cudaErrorInvalidValue;
  } else {
    vector_rows_kernel<T, V, kSharedRow><<<static_cast<unsigned>(grid), threads, smem, st>>>(
        dy, x, scale, dx, partial, dscale, rows, d, lanes, rpb, eps, offset);
    return cudaGetLastError();
  }
}

template <typename T>
cudaError_t launch(const void* dy_, const void* x_, const void* scale_, void* dx_,
                   void* dscale_, void* partial_, long long rows, int d, float eps,
                   float offset, int route, int threads, int lanes, int vecs,
                   int rows_per_block, long long grid, cudaStream_t st) {
  constexpr int E = Vec<T>::kN;
  const T* dy = static_cast<const T*>(dy_);
  const T* x = static_cast<const T*>(x_);
  const T* scale = static_cast<const T*>(scale_);
  T* dx = static_cast<T*>(dx_);
  T* dscale = static_cast<T*>(dscale_);
  float* partial = static_cast<float*>(partial_);
  if (rows_per_block < 1 || grid < 1 || grid > 0x7fffffffLL ||
      grid != (rows + rows_per_block - 1) / rows_per_block) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err;
  if (route == kVector) {
    const bool in_warp = lanes <= 32;  // else the block shares each row
    const bool pow2 = lanes >= 1 && (lanes & (lanes - 1)) == 0;
    if (d % E != 0 || d > kDMax || vecs < 1 || vecs * lanes * E < d ||
        (vecs - 1) * lanes * E >= d ||
        (in_warp ? !pow2 || threads != kVecWarps * 32
                 : threads != lanes || threads % 32 != 0 || threads > kBlockWarpsMax * 32)) {
      return cudaErrorInvalidValue;
    }
    const int smem = in_warp ? kVecWarps * d * 4 : 0;  // the warps' dscale rows
    switch (vecs) {
#define REPRO_VECTOR_ARGS \
  dy, x, scale, dx, partial, dscale, rows, d, threads, lanes, rows_per_block, grid, eps, offset, \
      smem, st
#define REPRO_VECTOR_CASE(V)                                                     \
  case V:                                                                        \
    err = in_warp ? launch_vector<T, V, false>(REPRO_VECTOR_ARGS)                \
                  : launch_vector<T, V, true>(REPRO_VECTOR_ARGS);                \
    break;
      REPRO_VECTOR_CASE(1)
      REPRO_VECTOR_CASE(2)
      REPRO_VECTOR_CASE(3)
      REPRO_VECTOR_CASE(4)
      REPRO_VECTOR_CASE(5)
      REPRO_VECTOR_CASE(6)
      REPRO_VECTOR_CASE(7)
      REPRO_VECTOR_CASE(8)
#undef REPRO_VECTOR_CASE
#undef REPRO_VECTOR_ARGS
      default:
        return cudaErrorInvalidValue;
    }
  } else if (route == kScalar) {
    if (threads != kWarps * 32 || d > kDMax) {
      return cudaErrorInvalidValue;
    }
    const int smem = kWarps * d * static_cast<int>(sizeof(float));
    static bool attr_set = false;  // raise the dynamic shared-memory cap once, to d = 8192's
    if (!attr_set) {
      err = cudaFuncSetAttribute(rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kWarps * kDMax * 4);
      if (err != cudaSuccess) return err;
      attr_set = true;
    }
    rows_kernel<T><<<static_cast<unsigned>(grid), kWarps * 32, smem, st>>>(
        dy, x, scale, dx, partial, rows, d, rows_per_block, eps, offset);
    err = cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  // the scalar route always sums its partial rows in a second launch; a
  // vector route's grid of one has written dscale itself
  if (route == kScalar || grid > 1) {
    scale_kernel<T><<<(d + 31) / 32, 32 * kGroups, 0, st>>>(partial, dscale,
                                                            static_cast<int>(grid), d);
    err = cudaGetLastError();
  }
  return err;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (dy, x, scale, dx and dscale alike).
// partial: f32 scratch of (grid, d).  route (0 scalar, 1 vector), threads,
// lanes, vecs, rows_per_block and grid come from
// ops.py:rmsnorm_backward_plan; a plan that does not fit the shape returns
// cudaErrorInvalidValue and launches nothing.
// The vector route needs 16-byte aligned dy, x, scale and dx; every route
// takes d <= 8192 (the scalar route keeps 4 rows of d floats in shared
// memory).
// Returns cudaGetLastError() after the launches.
extern "C" int repro_rmsnorm_backward(const void* dy, const void* x, const void* scale,
                                      void* dx, void* dscale, void* partial, long long rows,
                                      int d, float eps, float offset, int dtype, int route,
                                      int threads, int lanes, int vecs, int rows_per_block,
                                      long long grid, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = launch<__nv_bfloat16>(dy, x, scale, dx, dscale, partial, rows, d, eps, offset, route,
                                threads, lanes, vecs, rows_per_block, grid, s);
  } else if (dtype == 0) {
    err = launch<float>(dy, x, scale, dx, dscale, partial, rows, d, eps, offset, route, threads,
                        lanes, vecs, rows_per_block, grid, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
