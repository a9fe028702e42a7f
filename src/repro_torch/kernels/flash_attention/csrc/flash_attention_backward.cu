// Flash attention, backward, for Hopper (sm_90a).
//
// Replaces the gradient that JAX's AD derives through
// src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas (the
// reference has no backward kernel: its training differentiates the op's
// body).  Given q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D), the forward's output o and
// its cotangent dO (B,Sq,Hq,D), it writes dq, dk and dv, with the forward's
// semantics: causal with q_offset (query i at key position q_offset + i),
// optional window (keep k > q - window), optional soft-cap cap*tanh(s/cap)
// (its derivative 1 - tanh^2 taken in the chain), GQA (query head h reads KV
// head h / n_rep; dk and dv sum the group's query heads), rows that see no
// key give zero gradients.  Every product accumulates in f32; bf16 inputs
// are converted as they are staged.
//
// The forward op's schema saves no logsumexp, so the backward recomputes it.
// Two kernels, one launch of the wrapper:
//
//   dq_kernel  one block of 256 threads per 64 queries of one (query head,
//              batch row).  Pass 1 walks the visible key tiles once for each
//              row's logsumexp (an online max / sum per thread, then a fixed
//              xor butterfly over the 16 threads that share a row); it also
//              takes delta = dO . O per row, and writes both to a scratch
//              (stats) for the second kernel.  Pass 2 walks the key tiles
//              again: S = Q K^T and dP = dO V^T, P = exp(S - lse),
//              dS = P (dP - delta) * d(capped S)/d(raw S), then dq += dS K.
//   dkv_kernel one block per 64 keys of one (KV head, batch row): for each
//              query head of the group, in order, and each visible query
//              tile, S^T and dP^T again from the staged tiles, then
//              dv += P^T dO and dk += dS^T Q.
//
// Deterministic: each output element is a sum in a fixed order (key tiles
// in order for dq, heads then query tiles for dk and dv), no atomics, so two
// launches give the same bits.
//
// Bound: operations at the training shapes (qwen3-0.6b: Sq = Sk = 512,
// D = 128, causal; the work grows with Sq Sk, the bytes with Sq + Sk).  This
// first kernel is simple and right before it is fast: it runs on the CUDA
// cores in f32 (the 5 products of the textbook backward plus the 3 the
// recomputed logsumexp and the split into two kernels add), with Q, dO, K
// and V staged as f32 tiles of 64 rows padded by one float (so a warp's
// reads fall in distinct banks) and each thread holding a 4 x 4 block of S
// and dP and 4 rows x D/16 columns of its gradients.  Tensor cores
// (mma.sync or wgmma), a saved logsumexp and larger tiles are ROADMAP queue
// B work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // queries and keys per tile
constexpr int kThreads = 256;  // 16 x 16 threads: 4 x 4 elements of a 64 x 64 tile each
constexpr int kLdS = kTile + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// four neighbouring elements as floats (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}

// rows [r0, r0 + 64) of head h of a (B, S, H, D) tensor into a (64, D + 1)
// f32 tile; rows at or past S are zero
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ src, int b, int r0,
                                          int s, int heads, int h) {
  constexpr int kV = D / 4;
  for (int idx = threadIdx.x; idx < kTile * kV; idx += kThreads) {
    const int r = idx / kV;
    const int c = (idx % kV) * 4;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (r0 + r < s) {
      load4(src + ((static_cast<long long>(b) * s + r0 + r) * heads + h) * D + c, f);
    }
    float* t = tile + r * (D + 1) + c;
    t[0] = f[0];
    t[1] = f[1];
    t[2] = f[2];
    t[3] = f[3];
  }
}

__device__ __forceinline__ bool visible(int kpos, int qpos, int causal, int window) {
  return (!causal || kpos <= qpos) && (window <= 0 || kpos > qpos - window);
}

// the logit of a raw product (scaled, then soft-capped) and its slope
// d logit / d raw
__device__ __forceinline__ void logit(float raw, float scale, float cap, float& s, float& slope) {
  const float z = raw * scale;
  if (cap > 0.f) {
    const float t = tanhf(z / cap);
    s = cap * t;
    slope = (1.f - t * t) * scale;
  } else {
    s = z;
    slope = scale;
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ dout, const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ out, T* __restrict__ dq,
          float* __restrict__ lse_g, float* __restrict__ delta_g, int sq, int sk, int hq,
          int hkv, int causal, int window, float cap, int q_offset, float scale) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;  // gradient columns per thread: tx + 16 c
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + kTile * LD;
  float* ks = dos + kTile * LD;
  float* vs = ks + kTile * LD;
  float* ds = vs + kTile * LD;  // (64, 65)
  __shared__ float delta_s[kTile];

  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (hq / hkv);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<D>(qs, q, b, q0, sq, hq, h);
  load_tile<D>(dos, dout, b, q0, sq, hq, h);
  {  // delta = dO . O of each row, 4 neighbouring threads a row
    const int r = threadIdx.x >> 2;
    const int part = threadIdx.x & 3;
    float acc = 0.f;
    if (q0 + r < sq) {
      const long long off = ((static_cast<long long>(b) * sq + q0 + r) * hq + h) * D;
      for (int c = part; c < D; c += 4) acc += to_f(out[off + c]) * to_f(dout[off + c]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) delta_s[r] = acc;
  }

  // the key range any row of this tile can see
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kTile, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;

  // ---- pass 1: each row's logsumexp
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  for (int t0 = k_begin; t0 < k_end; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_tile<D>(ks, k, b, t0, sk, hkv, g);
    __syncthreads();
    float s[4][4] = {};
    for (int d = 0; d < D; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * kk[j];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float lg[4];
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = t0 + tx + 16 * j;
        ok[j] = kpos < sk && row < sq && visible(kpos, q_offset + row, causal, window);
        float slope;
        logit(s[i][j], scale, cap, lg[j], slope);
        if (ok[j]) mx = fmaxf(mx, lg[j]);
      }
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += ok[j] ? expf(lg[j] - m_new) : 0.f;
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }
  // the 16 threads of a row group are one half-warp: combine their (m, l)
  // in a fixed butterfly (each pair adds the same two terms)
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], o);
      const float mn = fmaxf(m[i], mo);
      l[i] = l[i] * expf(m[i] - mn) + lo * expf(mo - mn);
      m[i] = mn;
    }
  }
  __syncthreads();  // delta_s is written (there may have been no key tile)
  float lse[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse[i] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    dl[i] = delta_s[ty * 4 + i];
    const int row = q0 + ty * 4 + i;
    if (tx == 0 && row < sq) {
      const long long at = (static_cast<long long>(b) * hq + h) * sq + row;
      lse_g[at] = lse[i];
      delta_g[at] = dl[i];
    }
  }

  // ---- pass 2: dq = dS K
  float acc[4][NC] = {};
  for (int t0 = k_begin; t0 < k_end; t0 += kTile) {
    __syncthreads();
    load_tile<D>(ks, k, b, t0, sk, hkv, g);
    load_tile<D>(vs, v, b, t0, sk, hkv, g);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    for (int d = 0; d < D; ++d) {
      float a[4], o[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qs[(ty * 4 + i) * LD + d];
        o[i] = dos[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = ks[(tx + 16 * j) * LD + d];
        vv[j] = vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += a[i] * kk[j];
          dp[i][j] += o[i] * vv[j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = t0 + tx + 16 * j;
        float dsv = 0.f;
        if (kpos < sk && row < sq && visible(kpos, q_offset + row, causal, window)) {
          float lg, slope;
          logit(s[i][j], scale, cap, lg, slope);
          dsv = expf(lg - lse[i]) * (dp[i][j] - dl[i]) * slope;
        }
        ds[(ty * 4 + i) * kLdS + tx + 16 * j] = dsv;
      }
    }
    __syncthreads();
    for (int key = 0; key < kTile; ++key) {
      float kc[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) kc[c] = ks[key * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = ds[(ty * 4 + i) * kLdS + key];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] += w * kc[c];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < sq) {
      T* dst = dq + ((static_cast<long long>(b) * sq + row) * hq + h) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) store(dst + tx + 16 * c, acc[i][c]);
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ dout, const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ dk, T* __restrict__ dv,
           const float* __restrict__ lse_g, const float* __restrict__ delta_g, int sq, int sk,
           int hq, int hkv, int causal, int window, float cap, int q_offset, float scale) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * LD;
  float* qs = vs + kTile * LD;
  float* dos = qs + kTile * LD;
  float* pt = dos + kTile * LD;   // P^T (64 keys, 65)
  float* dst = pt + kTile * kLdS;  // dS^T
  __shared__ float lse_s[kTile], delta_s[kTile];

  const int k0 = blockIdx.x * kTile;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rep = hq / hkv;
  const int tx = threadIdx.x & 15;  // queries tx + 16 j, gradient columns tx + 16 c
  const int ty = threadIdx.x >> 4;  // keys ty * 4 + i

  load_tile<D>(ks, k, b, k0, sk, hkv, g);
  load_tile<D>(vs, v, b, k0, sk, hkv, g);

  // the query range that can see any key of this tile
  const int k_last = min(k0 + kTile, sk) - 1;
  const int i_begin = causal ? max(0, k0 - q_offset) : 0;
  const int i_end = window > 0 ? min(sq, k_last + window - q_offset) : sq;

  float dka[4][NC] = {}, dva[4][NC] = {};
  for (int hh = 0; hh < n_rep; ++hh) {
    const int h = g * n_rep + hh;
    for (int i0 = i_begin; i0 < i_end; i0 += kTile) {
      __syncthreads();  // the previous query tile is consumed
      load_tile<D>(qs, q, b, i0, sq, hq, h);
      load_tile<D>(dos, dout, b, i0, sq, hq, h);
      if (threadIdx.x < kTile) {
        const int row = i0 + threadIdx.x;
        const long long at = (static_cast<long long>(b) * hq + h) * sq + row;
        lse_s[threadIdx.x] = row < sq ? lse_g[at] : INFINITY;
        delta_s[threadIdx.x] = row < sq ? delta_g[at] : 0.f;
      }
      __syncthreads();
      float s[4][4] = {}, dp[4][4] = {};
      for (int d = 0; d < D; ++d) {
        float kk[4], vv[4], a[4], o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kk[i] = ks[(ty * 4 + i) * LD + d];
          vv[i] = vs[(ty * 4 + i) * LD + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[j] = qs[(tx + 16 * j) * LD + d];
          o[j] = dos[(tx + 16 * j) * LD + d];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] += kk[i] * a[j];
            dp[i][j] += vv[i] * o[j];
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = tx + 16 * j;
          const int row = i0 + qi;
          float p = 0.f, dsv = 0.f;
          if (kpos < sk && row < sq && visible(kpos, q_offset + row, causal, window)) {
            float lg, slope;
            logit(s[i][j], scale, cap, lg, slope);
            p = expf(lg - lse_s[qi]);
            dsv = p * (dp[i][j] - delta_s[qi]) * slope;
          }
          pt[(ty * 4 + i) * kLdS + qi] = p;
          dst[(ty * 4 + i) * kLdS + qi] = dsv;
        }
      }
      __syncthreads();
      for (int qi = 0; qi < kTile; ++qi) {
        float oc[NC], qc[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          oc[c] = dos[qi * LD + tx + 16 * c];
          qc[c] = qs[qi * LD + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pw = pt[(ty * 4 + i) * kLdS + qi];
          const float dw = dst[(ty * 4 + i) * kLdS + qi];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            dva[i][c] += pw * oc[c];
            dka[i][c] += dw * qc[c];
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos < sk) {
      const long long off = ((static_cast<long long>(b) * sk + kpos) * hkv + g) * D;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        store(dk + off + tx + 16 * c, dka[i][c]);
        store(dv + off + tx + 16 * c, dva[i][c]);
      }
    }
  }
}

template <int D>
constexpr int dq_smem() {
  return (4 * kTile * (D + 1) + kTile * kLdS) * 4;
}
template <int D>
constexpr int dkv_smem() {
  return (4 * kTile * (D + 1) + 2 * kTile * kLdS) * 4;
}

template <int D, typename T>
cudaError_t launch(const void* dout, const void* q, const void* k, const void* v,
                   const void* out, void* dq, void* dk, void* dv, void* stats, int b, int sq,
                   int sk, int hq, int hkv, int causal, int window, float cap, int q_offset,
                   cudaStream_t st) {
  static bool attr_set = false;  // raise the dynamic shared-memory caps once
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(dq_kernel<D, T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           dq_smem<D>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dkv_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dkv_smem<D>());
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  float* lse = static_cast<float*>(stats);
  float* delta = lse + static_cast<long long>(b) * hq * sq;
  const dim3 grid_dq((sq + kTile - 1) / kTile, hq, b);
  dq_kernel<D, T><<<grid_dq, kThreads, dq_smem<D>(), st>>>(
      static_cast<const T*>(dout), static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(out), static_cast<T*>(dq), lse, delta, sq,
      sk, hq, hkv, causal, window, cap, q_offset, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_dkv((sk + kTile - 1) / kTile, hkv, b);
  dkv_kernel<D, T><<<grid_dkv, kThreads, dkv_smem<D>(), st>>>(
      static_cast<const T*>(dout), static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(dk), static_cast<T*>(dv), lse, delta, sq, sk,
      hq, hkv, causal, window, cap, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* dout, const void* q, const void* k, const void* v,
                     const void* out, void* dq, void* dk, void* dv, void* stats, int b, int sq,
                     int sk, int hq, int hkv, int causal, int window, float cap, int q_offset,
                     cudaStream_t st) {
  switch (d) {
    case 32:
      return launch<32, T>(dout, q, k, v, out, dq, dk, dv, stats, b, sq, sk, hq, hkv, causal,
                           window, cap, q_offset, st);
    case 64:
      return launch<64, T>(dout, q, k, v, out, dq, dk, dv, stats, b, sq, sk, hq, hkv, causal,
                           window, cap, q_offset, st);
    case 96:
      return launch<96, T>(dout, q, k, v, out, dq, dk, dv, stats, b, sq, sk, hq, hkv, causal,
                           window, cap, q_offset, st);
    case 128:
      return launch<128, T>(dout, q, k, v, out, dq, dk, dv, stats, b, sq, sk, hq, hkv, causal,
                            window, cap, q_offset, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// causal: 0/1.  window <= 0: no window.  logit_cap <= 0: no soft-cap.
// dtype: 0 = float32, 1 = bfloat16 (dout, q, k, v, out, dq, dk, dv alike;
// 16-byte aligned).  stats: f32 scratch of (2, b, hq, sq), each query row's
// logsumexp then its dO . O.  d in {32, 64, 96, 128}.  Returns
// cudaGetLastError() after the launches.
extern "C" int repro_flash_attention_backward(const void* dout, const void* q, const void* k,
                                              const void* v, const void* out, void* dq,
                                              void* dk, void* dv, void* stats, int b, int sq,
                                              int sk, int hq, int hkv, int d, int causal,
                                              int window, float logit_cap, int q_offset,
                                              int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || hkv <= 0 || hq % hkv != 0 || hq > 65535 || b > 65535 ||
      q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = launch_d<__nv_bfloat16>(d, dout, q, k, v, out, dq, dk, dv, stats, b, sq, sk, hq, hkv,
                                  causal, window, logit_cap, q_offset, st);
  } else if (dtype == 0) {
    err = launch_d<float>(d, dout, q, k, v, out, dq, dk, dv, stats, b, sq, sk, hq, hkv, causal,
                          window, logit_cap, q_offset, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
