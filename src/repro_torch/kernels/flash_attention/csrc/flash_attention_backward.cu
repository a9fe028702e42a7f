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
// key give zero gradients.
//
// The forward op's schema saves no logsumexp, so the backward recomputes it.
// Two kernels, one launch of the wrapper, each gradient element a sum in a
// fixed order with no atomics (two launches give the same bits): the dq
// kernel walks the key tiles in order, and also writes each query row's
// logsumexp and delta = dO . O to a scratch (stats); the dk/dv kernel then
// walks the group's query heads, then the query tiles (on the bf16 route in
// two interleaved halves added in a fixed order).  That costs eight tile
// products where the textbook backward has five (the logsumexp pass's S,
// and S and dP in both kernels), and buys determinism with no f32 dq
// scratch.
//
// Bound: at qwen3-0.6b's training shape (Sq = Sk = 512, D = 128, causal)
// the inputs read and gradients written once take 15.0 us and the textbook
// count of operations (2.5 times the forward's) 10.9 us in bf16; the work
// grows with Sq Sk, the bytes with Sq + Sk, so longer sequences are bound
// by operations.  The dtype picks the route (ops.py:backward_plan):
//
// bf16, the tensor cores (dq_mma_kernel, dkv_mma_kernel).  Each warp owns
// 16 rows of a 64-row block tile; every product runs on
// mma.sync.m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix from bf16
// tiles in shared memory whose rows are padded by 16 bytes, so ldmatrix's
// eight row addresses fall in distinct banks.
//   dq_mma_kernel: 4 warps per 64 packed (query, head) rows of one (KV
//     head, batch row), as the forward's packed rows (ops.py:packed_row), so
//     each K/V tile is staged once for the group's query heads.  Q and dO
//     stay resident; K tiles (pass 1) and then K and V tiles (pass 2) of 64
//     keys stream through one two-stage ring of 16-byte cp.async copies
//     (tile t+1 in flight while tile t is multiplied).  Pass 1: S = Q K^T
//     and an online max / sum per row (a fixed butterfly over the four
//     lanes of a row) give the logsumexp.  Pass 2: S and dP = dO V^T again,
//     P = exp(S - lse), dS = P (dP - delta) * d(capped S)/d(raw S); dS, in
//     the m16n8 accumulator layout, is rounded to bf16 and reused as the A
//     operand of dQ += dS K (K through ldmatrix.trans) with no trip through
//     shared memory.  A warp holds S and dP for the whole 64-key tile (eight
//     independent accumulator chains a k16 step) beside its D/8 x 4 f32
//     accumulators of dQ.
//   dkv_mma_kernel: 8 warps per 64 keys of one (KV head, batch row), as two
//     groups of 4 that take alternate (head, query tile) iterations, each
//     with its own two-stage ring of Q and dO tiles (and their rows'
//     logsumexp and delta) and its own dK and dV sums for all 64 keys; at
//     the end the second group's sums pass through shared memory and are
//     added after the first's, a fixed order.  K and V stay resident.  With
//     the keys as the M rows, S^T = K Q^T and dP^T = V dO^T come out in the
//     accumulator layout, whose two n8 tiles are one k16 step of the A
//     layout: P^T and dS^T, rounded to bf16, feed dV += P^T dO and
//     dK += dS^T Q (dO and Q through ldmatrix.trans) from registers.  A warp
//     holds 32 query columns at a time, 16 at D = 128, where its two sets of
//     D/8 x 4 accumulators leave no room for more without spilling.
//   Masks are evaluated only on the tiles that straddle a limit (causal,
//   window, ragged Sq or Sk); a tile wholly outside a warp's rows is skipped
//   by that warp, and tiles wholly outside a block's rows are never visited.
//   Under the causal mask key tile 0 sees every query tile and the last key
//   tile one: the grid puts the tile index in its slowest dimension and
//   orders it longest first (dq: the last row tiles; dk/dv: the first key
//   tiles), so the longest blocks are dispatched first, and the dk/dv
//   kernel's two groups halve each block's chain of iterations (at qwen3's
//   training shape, from 16 to 8 for key tile 0).  The gradients leave
//   through the warp's own rows of a resident tile as 16-byte stores.  P and
//   dS are rounded to bf16 before their products (emulated in plain
//   PyTorch by ref.py:attention_backward_bf16_products); exponents are
//   ex2.approx in base 2.  wgmma, a producer warp on TMA and a logsumexp saved by the forward
//   are ROADMAP B 17 / B 18.
//
// f32, the CUDA cores (dq_kernel, dkv_kernel).  A tensor-core product of f32
// runs in TF32, which cannot hold the f32 tolerance of 2e-4, so f32 keeps the
// simple kernels: the same two-kernel split, Q, dO, K and V staged as f32
// tiles of 64 rows padded by one float, each of 256 threads holding a 4 x 4
// block of S and dP and 4 rows x D/16 columns of its gradients.
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
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// four neighbouring elements as floats
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
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

// ------------------------------------------------------------------------
// bf16: the tensor cores (mma.sync)
// ------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kMmaTile = 64;      // rows a block owns and a streamed tile holds
constexpr int kMmaThreads = 128;  // 4 warps, 16 rows each
// warp groups of the dk/dv kernel, taking alternate iterations
constexpr int kDkvGroups = 2;
static_assert(kDkvGroups == 2, "group_sync and the dK / dV merge are written for two groups");

// columns of S and dP a warp holds at once: 32, but 16 in the dk/dv kernel at
// D = 128, whose two sets of D/8 x 4 accumulators would otherwise spill
template <int D>
__host__ __device__ constexpr int dkv_sub() {
  return D >= 128 ? 16 : 32;
}
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared tiles of 64 bf16 rows of D, each row padded by 16 bytes: ldmatrix's
// eight row addresses then fall in eight distinct 16-byte bank groups
// (row strides of 80, 144, 208 and 272 bytes).  dq: Q, dO, two stages of K
// and two of V; dk/dv: K, V, then per warp group two stages of Q and two of
// dO, then per group two stages of the query rows' logsumexp and delta (f32).
template <int D>
struct MmaTiles {
  static constexpr int LD = D + 8;            // bf16 per shared row
  static constexpr int TILE = kMmaTile * LD;  // bf16 per tile
  static constexpr int DQ_BYTES = 6 * TILE * 2;
  static constexpr int DKV_BYTES =
      (2 + 4 * kDkvGroups) * TILE * 2 + kDkvGroups * 4 * kMmaTile * 4;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16- and 4-byte copies, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b on one m16n8k16 tile, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU instruction; 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (lo, hi) rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of rows [row0, row0 + 16) x columns [col0, col0 + 16) of a
// row-major tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int ld, int row0,
                                       int col0, int lane) {
  ldsm_x4(a, tile + (row0 + (lane & 15)) * ld + col0 + ((lane >> 4) << 3));
}
// The B fragments of two n8 tiles whose n index is the tile's rows
// [n0, n0 + 16) and k index its columns [col0, col0 + 16): b[0..1] for rows
// n0.., b[2..3] for rows n0 + 8..
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile, int ld, int n0,
                                       int col0, int lane) {
  ldsm_x4(b, tile + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + col0 +
                 (((lane >> 3) & 1) << 3));
}
// The B fragments of two n8 tiles whose k index is the tile's rows
// [k0, k0 + 16) and n index its columns [n0, n0 + 16) (ldmatrix.trans)
__device__ __forceinline__ void load_b_t(uint32_t (&b)[4], const bf16* tile, int ld, int k0,
                                         int n0, int lane) {
  ldsm_x4_t(b, tile + (k0 + (lane & 15)) * ld + n0 + ((lane >> 4) << 3));
}

// acc = A B^T for the warp's 16 rows of `a` (from row a0) and the SUB rows
// of `b` from n0, over D: S = Q K^T, dP = dO V^T, S^T = K Q^T or dP^T = V dO^T
template <int D, int SUB>
__device__ __forceinline__ void product_abt(float (&acc)[SUB / 8][4], const bf16* a, int a0,
                                            const bf16* b, int n0, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int j = 0; j < SUB / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    load_a(af, a, LD, a0, 16 * kk, lane);
#pragma unroll
    for (int np = 0; np < SUB / 16; ++np) {
      uint32_t bf[4];
      load_b(bf, b, LD, n0 + 16 * np, 16 * kk, lane);
      mma_bf16(acc[2 * np], af, bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// acc += P B for P the warp's 16 x SUB block in A fragments and B the SUB
// rows of `b` from k0 by all D columns: dQ += dS K, dV += P^T dO,
// dK += dS^T Q
template <int D, int SUB>
__device__ __forceinline__ void product_pb(float (&acc)[D / 8][4],
                                           const uint32_t (&p)[SUB / 16][4], const bf16* b,
                                           int k0, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < SUB / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bf[4];
      load_b_t(bf, b, LD, k0 + 16 * kk, 16 * np, lane);
      mma_bf16(acc[2 * np], p[kk], bf[0], bf[1]);
      mma_bf16(acc[2 * np + 1], p[kk], bf[2], bf[3]);
    }
  }
}

// accumulators of SUB columns, rounded to bf16, as A fragments: the m16n8
// C layout of n8 tiles 2kk and 2kk + 1 is the m16n8k16 A layout of k step kk
template <int SUB>
__device__ __forceinline__ void to_a(uint32_t (&a)[SUB / 16][4], const float (&c)[SUB / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < SUB / 16; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// a raw product's logit in base-2 units (scaled, then soft-capped) and its
// slope d logit / d raw in natural units
__device__ __forceinline__ float logit2(float raw, float scale, float cap, float& slope) {
  const float z = raw * scale;
  if (cap > 0.f) {
    const float t = tanhf(z / cap);
    slope = (1.f - t * t) * scale;
    return cap * t * kLog2e;
  }
  slope = scale;
  return z * kLog2e;
}

// the warp's 16 x D accumulators as bf16 into its rows [row0, row0 + 16) of
// a shared tile (the C layout: rows lane/4 and lane/4 + 8, columns
// 8j + 2 (lane % 4) and the next)
template <int D>
__device__ __forceinline__ void stage_rows(bf16* tile, int row0, const float (&acc)[D / 8][4],
                                           int lane) {
  constexpr int LD = D + 8;
  bf16* r0 = tile + (row0 + (lane >> 2)) * LD + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(r0 + 8 * j) = __floats2bfloat162_rn(acc[j][0], acc[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(r0 + 8 * LD + 8 * j) =
        __floats2bfloat162_rn(acc[j][2], acc[j][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
dq_mma_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ q,
              const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ out, bf16* __restrict__ dq, float* __restrict__ lse_g,
              float* __restrict__ delta_g, int sq, int sk, int hq, int hkv, int causal,
              int window, float cap, int q_offset, float scale) {
  using L = MmaTiles<D>;
  constexpr int LD = L::LD;
  constexpr int CH = D / 8;  // 16-byte chunks of a row
  constexpr int SUB = 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dos = qs + L::TILE;
  bf16* ks = dos + L::TILE;   // two stages
  bf16* vs = ks + 2 * L::TILE;  // two stages
  __shared__ float delta_s[kMmaTile];

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int tile = gridDim.z - 1 - blockIdx.z;  // the last rows, which see the most keys, first
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_rep = hq / hkv;
  const int rows = sq * n_rep;  // packed (query, head) rows
  const int p0 = tile * kMmaTile;

  // the key range any row of this tile can see
  const int i_first = p0 / n_rep;
  const int i_last = (min(p0 + kMmaTile, rows) - 1) / n_rep;
  const int k_end = causal ? min(sk, q_offset + i_last + 1) : sk;
  const int k_begin = window > 0 ? max(0, q_offset + i_first - window + 1) : 0;
  const int n_tiles = k_begin < k_end ? (k_end - k_begin + kMmaTile - 1) / kMmaTile : 0;

  const long long kv_row = static_cast<long long>(hkv) * D;  // elements between keys
  const bf16* kb = k + static_cast<long long>(b) * sk * kv_row + g * D;
  const bf16* vb = v + static_cast<long long>(b) * sk * kv_row + g * D;
  // packed row p: query p / n_rep, head g n_rep + p % n_rep
  auto row_off = [&](int p) {
    return ((static_cast<long long>(b) * sq + p / n_rep) * hq + g * n_rep + p % n_rep) * D;
  };

  for (int i = tid; i < kMmaTile * CH; i += kMmaThreads) {
    const int r = i / CH;
    const int c = i % CH;
    const bool ok = p0 + r < rows;
    const long long off = ok ? row_off(p0 + r) + c * 8 : 0;
    cp_async16(qs + r * LD + c * 8, q + off, ok);
    cp_async16(dos + r * LD + c * 8, dout + off, ok);
  }
  // iteration it < n_tiles is pass 1 over key tile it (K only), it >=
  // n_tiles pass 2 over key tile it - n_tiles (K and V); stage it % 2
  auto load_kv = [&](int it) {
    const bool pass2 = it >= n_tiles;
    const int t0 = k_begin + (pass2 ? it - n_tiles : it) * kMmaTile;
    bf16* kd = ks + (it & 1) * L::TILE;
    bf16* vd = vs + (it & 1) * L::TILE;
    for (int i = tid; i < kMmaTile * CH; i += kMmaThreads) {
      const int j = i / CH;
      const int c = i % CH;
      const bool ok = t0 + j < k_end;
      const long long off = ok ? (t0 + j) * kv_row + c * 8 : 0;
      cp_async16(kd + j * LD + c * 8, kb + off, ok);
      if (pass2) cp_async16(vd + j * LD + c * 8, vb + off, ok);
    }
  };
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();

  {  // delta = dO . O of each packed row: two threads a row, 16-byte loads
    const int r = tid >> 1;
    const int part = tid & 1;
    float acc = 0.f;
    if (p0 + r < rows) {
      const long long off = row_off(p0 + r);
      for (int c = part; c < CH; c += 2) {
        const uint4 ov = *reinterpret_cast<const uint4*>(out + off + c * 8);
        const uint4 gv = *reinterpret_cast<const uint4*>(dout + off + c * 8);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(o2[e]);
          const float2 d = __bfloat1622float2(g2[e]);
          acc += a.x * d.x + a.y * d.y;
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (part == 0) delta_s[r] = acc;
  }
  __syncthreads();

  // this thread's accumulator rows 16 warp + lane/4 (+ 8) and the keys
  // [lo_k, hi_k) each sees (none for a padded row)
  int lo_k[2], hi_k[2];
  bool live[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + 16 * warp + (lane >> 2) + 8 * h;
    const int qpos = q_offset + p / n_rep;
    live[h] = p < rows;
    hi_k[h] = !live[h] ? 0 : causal ? min(k_end, qpos + 1) : k_end;
    lo_k[h] = !live[h] ? 0 : window > 0 ? max(k_begin, qpos - window + 1) : k_begin;
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // base-2 running max and sum
  float lse2[2] = {INFINITY, INFINITY}, dl[2] = {0.f, 0.f};
  // the logsumexp from the four lanes of each row (a fixed butterfly: each
  // pair adds the same two terms), written with delta to stats
  auto finish_lse = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[h], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[h], o);
        const float mn = fmaxf(m[h], mo);
        l[h] = l[h] * ex2(m[h] - mn) + lo * ex2(mo - mn);
        m[h] = mn;
      }
      lse2[h] = l[h] > 0.f ? m[h] + log2f(l[h]) : INFINITY;
      const int r = 16 * warp + (lane >> 2) + 8 * h;
      dl[h] = delta_s[r];
      if ((lane & 3) == 0 && live[h]) {
        const int p = p0 + r;
        const long long at =
            (static_cast<long long>(b) * hq + g * n_rep + p % n_rep) * sq + p / n_rep;
        lse_g[at] = lse2[h] * kLn2;
        delta_g[at] = dl[h];
      }
    }
  };

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int it = 0; it < 2 * n_tiles; ++it) {
    if (it + 1 < 2 * n_tiles) load_kv(it + 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO and this iteration's tile have landed
    __syncthreads();
    const bool pass2 = it >= n_tiles;
    if (it == n_tiles) finish_lse();
    const int t0 = k_begin + (pass2 ? it - n_tiles : it) * kMmaTile;
    const bf16* kt = ks + (it & 1) * L::TILE;
    const bf16* vt = vs + (it & 1) * L::TILE;
    // masks only where the tile straddles a row's limits; no work where it
    // lies outside all of the warp's rows
    bool inside = true, outside = true;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      inside = inside && lo_k[h] <= t0 && t0 + kMmaTile <= hi_k[h];
      outside = outside && (hi_k[h] <= t0 || lo_k[h] >= t0 + kMmaTile || hi_k[h] <= lo_k[h]);
    }
    const bool full = __all_sync(0xffffffffu, inside);
    if (!__all_sync(0xffffffffu, outside)) {
#pragma unroll
      for (int c0 = 0; c0 < kMmaTile; c0 += SUB) {
        float s[SUB / 8][4];
        product_abt<D, SUB>(s, qs, 16 * warp, kt, c0, lane);
        if (!pass2) {
          float mx[2] = {kNegInf, kNegInf};
#pragma unroll
          for (int j = 0; j < SUB / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int h = e >> 1;
              const int kpos = t0 + c0 + 8 * j + 2 * (lane & 3) + (e & 1);
              float slope;
              float lg = logit2(s[j][e], scale, cap, slope);
              if (!full && !(kpos >= lo_k[h] && kpos < hi_k[h])) lg = -INFINITY;
              s[j][e] = lg;
              mx[h] = fmaxf(mx[h], lg);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float mn = fmaxf(m[h], mx[h]);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < SUB / 8; ++j) {
              sum += ex2(s[j][2 * h] - mn) + ex2(s[j][2 * h + 1] - mn);
            }
            l[h] = l[h] * ex2(m[h] - mn) + sum;
            m[h] = mn;
          }
        } else {
          float dp[SUB / 8][4];
          product_abt<D, SUB>(dp, dos, 16 * warp, vt, c0, lane);
#pragma unroll
          for (int j = 0; j < SUB / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int h = e >> 1;
              const int kpos = t0 + c0 + 8 * j + 2 * (lane & 3) + (e & 1);
              float slope;
              const float lg = logit2(s[j][e], scale, cap, slope);
              const bool vis = full || (kpos >= lo_k[h] && kpos < hi_k[h]);
              const float p = vis ? ex2(lg - lse2[h]) : 0.f;
              s[j][e] = p * (dp[j][e] - dl[h]) * slope;
            }
          }
          uint32_t da[SUB / 16][4];
          to_a<SUB>(da, s);
          product_pb<D, SUB>(acc, da, kt, c0, lane);  // dQ += dS K
        }
      }
    }
    __syncthreads();  // the stage is consumed before a later load refills it
  }
  if (n_tiles == 0) finish_lse();

  cp_async_wait<0>();
  __syncthreads();  // every copy into Q has landed (there may have been no key tile)
  stage_rows<D>(qs, 16 * warp, acc, lane);
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH;
    const int c = i % CH;
    const int p = p0 + 16 * warp + r;
    if (p < rows) {
      *reinterpret_cast<uint4*>(dq + row_off(p) + c * 8) =
          *reinterpret_cast<const uint4*>(qs + (16 * warp + r) * LD + c * 8);
    }
  }
}

// a barrier over the 128 threads of warp group 0 or 1 (named barriers 1, 2)
__device__ __forceinline__ void group_sync(int grp) {
  if (grp == 0) {
    asm volatile("bar.sync 1, %0;\n" ::"n"(kMmaThreads) : "memory");
  } else {
    asm volatile("bar.sync 2, %0;\n" ::"n"(kMmaThreads) : "memory");
  }
}

template <int D>
__global__ void __launch_bounds__(kDkvGroups * kMmaThreads, 1)
dkv_mma_kernel(const bf16* __restrict__ dout, const bf16* __restrict__ q,
               const bf16* __restrict__ k, const bf16* __restrict__ v, bf16* __restrict__ dk,
               bf16* __restrict__ dv, const float* __restrict__ lse_g,
               const float* __restrict__ delta_g, int sq, int sk, int hq, int hkv, int causal,
               int window, float cap, int q_offset, float scale) {
  using L = MmaTiles<D>;
  constexpr int LD = L::LD;
  constexpr int CH = D / 8;
  constexpr int SUB = dkv_sub<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + L::TILE;
  bf16* rings = vs + L::TILE;  // per group: Q (two stages), dO (two stages)
  // per group: (2 stages, lse / delta, 64)
  float* stats = reinterpret_cast<float*>(rings + kDkvGroups * 4 * L::TILE);

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * kMmaTile;  // key tile 0, which sees the most queries, first
  const int tid = threadIdx.x;
  const int grp = tid >> 7;            // warp group: takes iterations grp, grp + kDkvGroups, ...
  const int gt = tid & (kMmaThreads - 1);
  const int warp = gt >> 5;            // the group's warp: keys 16 warp ..
  const int lane = tid & 31;
  const int n_rep = hq / hkv;
  bf16* qs = rings + grp * 4 * L::TILE;
  bf16* dos = qs + 2 * L::TILE;
  float* lse_s = stats + grp * 4 * kMmaTile;
  float* delta_s = lse_s + 2 * kMmaTile;

  // the query range that can see any key of this tile
  const int k_last = min(k0 + kMmaTile, sk) - 1;
  const int i_begin = causal ? max(0, k0 - q_offset) : 0;
  const int i_end = window > 0 ? min(sq, k_last + window - q_offset) : sq;
  const int n_q = i_begin < i_end ? (i_end - i_begin + kMmaTile - 1) / kMmaTile : 0;
  const int n_it = n_rep * n_q;  // heads of the group, then query tiles

  const long long kv_off = (static_cast<long long>(b) * sk * hkv + g) * D;
  for (int i = tid; i < kMmaTile * CH; i += kDkvGroups * kMmaThreads) {
    const int j = i / CH;
    const int c = i % CH;
    const bool ok = k0 + j < sk;
    const long long off = ok ? kv_off + static_cast<long long>(k0 + j) * hkv * D + c * 8 : 0;
    cp_async16(ks + j * LD + c * 8, k + off, ok);
    cp_async16(vs + j * LD + c * 8, v + off, ok);
  }
  cp_async_commit();
  // the group's iteration it into its stage (it / kDkvGroups) % 2
  auto load_q = [&](int it) {
    const int stage = (it / kDkvGroups) & 1;
    const int h = g * n_rep + it / n_q;
    const int i0 = i_begin + (it % n_q) * kMmaTile;
    bf16* qd = qs + stage * L::TILE;
    bf16* dd = dos + stage * L::TILE;
    for (int i = gt; i < kMmaTile * CH; i += kMmaThreads) {
      const int r = i / CH;
      const int c = i % CH;
      const bool ok = i0 + r < sq;
      const long long off =
          ok ? ((static_cast<long long>(b) * sq + i0 + r) * hq + h) * D + c * 8 : 0;
      cp_async16(qd + r * LD + c * 8, q + off, ok);
      cp_async16(dd + r * LD + c * 8, dout + off, ok);
    }
    if (gt < kMmaTile) {
      const bool ok = i0 + gt < sq;
      const long long at = ok ? (static_cast<long long>(b) * hq + h) * sq + i0 + gt : 0;
      cp_async4(lse_s + stage * kMmaTile + gt, lse_g + at, ok);
      cp_async4(delta_s + stage * kMmaTile + gt, delta_g + at, ok);
    }
  };
  if (grp < n_it) load_q(grp);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // K and V have landed, whichever thread copied them

  // this thread's accumulator rows: keys k0 + 16 warp + lane/4 (+ 8), and
  // the queries [lo_q, hi_q) that see each (none for a key past Sk)
  int lo_q[2], hi_q[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kpos = k0 + 16 * warp + (lane >> 2) + 8 * h;
    const bool live = kpos < sk;
    lo_q[h] = !live ? 0 : causal ? max(0, kpos - q_offset) : 0;
    hi_q[h] = !live ? 0 : window > 0 ? min(sq, kpos + window - q_offset) : sq;
  }

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
    dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
  }

  for (int it = grp; it < n_it; it += kDkvGroups) {
    if (it + kDkvGroups < n_it) load_q(it + kDkvGroups);
    cp_async_commit();
    cp_async_wait<1>();  // this iteration's tile has landed
    group_sync(grp);
    const int stage = (it / kDkvGroups) & 1;
    const int i0 = i_begin + (it % n_q) * kMmaTile;
    const bf16* qt = qs + stage * L::TILE;
    const bf16* dt = dos + stage * L::TILE;
    const float* ls = lse_s + stage * kMmaTile;
    const float* dls = delta_s + stage * kMmaTile;
    bool inside = true, outside = true;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      inside = inside && lo_q[h] <= i0 && i0 + kMmaTile <= hi_q[h];
      outside = outside && (hi_q[h] <= i0 || lo_q[h] >= i0 + kMmaTile || hi_q[h] <= lo_q[h]);
    }
    const bool full = __all_sync(0xffffffffu, inside);
    if (!__all_sync(0xffffffffu, outside)) {
#pragma unroll
      for (int c0 = 0; c0 < kMmaTile; c0 += SUB) {
        float s[SUB / 8][4], dp[SUB / 8][4];
        product_abt<D, SUB>(s, ks, 16 * warp, qt, c0, lane);   // S^T = K Q^T
        product_abt<D, SUB>(dp, vs, 16 * warp, dt, c0, lane);  // dP^T = V dO^T
#pragma unroll
        for (int j = 0; j < SUB / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const int col = c0 + 8 * j + 2 * (lane & 3) + (e & 1);
            const int qi = i0 + col;
            float slope;
            const float lg = logit2(s[j][e], scale, cap, slope);
            const bool vis = full || (qi >= lo_q[h] && qi < hi_q[h]);
            const float p = vis ? ex2(lg - ls[col] * kLog2e) : 0.f;
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - dls[col]) * slope;
          }
        }
        uint32_t pa[SUB / 16][4], da[SUB / 16][4];
        to_a<SUB>(pa, s);
        to_a<SUB>(da, dp);
        product_pb<D, SUB>(dva, pa, dt, c0, lane);  // dV += P^T dO
        product_pb<D, SUB>(dka, da, qt, c0, lane);  // dK += dS^T Q
      }
    }
    group_sync(grp);  // the stage is consumed before a later load refills it
  }

  // group 1's sums through the rings (thread for thread), added after group
  // 0's: dK = (even iterations) + (odd iterations), in that order
  cp_async_wait<0>();
  __syncthreads();  // both groups are done with their rings
  float* other = reinterpret_cast<float*>(rings);
  if (grp == 1) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        other[((2 * j) * 4 + e) * kMmaThreads + gt] = dka[j][e];
        other[((2 * j + 1) * 4 + e) * kMmaThreads + gt] = dva[j][e];
      }
    }
  }
  __syncthreads();
  if (grp == 1) return;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[j][e] += other[((2 * j) * 4 + e) * kMmaThreads + gt];
      dva[j][e] += other[((2 * j + 1) * 4 + e) * kMmaThreads + gt];
    }
  }
  stage_rows<D>(ks, 16 * warp, dka, lane);
  stage_rows<D>(vs, 16 * warp, dva, lane);
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH;
    const int c = i % CH;
    const int kpos = k0 + 16 * warp + r;
    if (kpos < sk) {
      const long long off = kv_off + static_cast<long long>(kpos) * hkv * D + c * 8;
      *reinterpret_cast<uint4*>(dk + off) =
          *reinterpret_cast<const uint4*>(ks + (16 * warp + r) * LD + c * 8);
      *reinterpret_cast<uint4*>(dv + off) =
          *reinterpret_cast<const uint4*>(vs + (16 * warp + r) * LD + c * 8);
    }
  }
}

template <int D>
cudaError_t launch_mma(const void* dout, const void* q, const void* k, const void* v,
                       const void* out, void* dq, void* dk, void* dv, void* stats, int b, int sq,
                       int sk, int hq, int hkv, int causal, int window, float cap, int q_offset,
                       cudaStream_t st) {
  using L = MmaTiles<D>;
  static bool attr_set = false;  // raise the dynamic shared-memory caps once
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(dq_mma_kernel<D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           L::DQ_BYTES);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(dkv_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::DKV_BYTES);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const long long rows = static_cast<long long>(sq) * (hq / hkv);
  const long long tiles_dq = (rows + kMmaTile - 1) / kMmaTile;
  const long long tiles_dkv = (static_cast<long long>(sk) + kMmaTile - 1) / kMmaTile;
  if (tiles_dq > 65535 || tiles_dkv > 65535) return cudaErrorInvalidValue;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  float* lse = static_cast<float*>(stats);
  float* delta = lse + static_cast<long long>(b) * hq * sq;
  const dim3 grid_dq(hkv, b, static_cast<unsigned>(tiles_dq));
  dq_mma_kernel<D><<<grid_dq, kMmaThreads, L::DQ_BYTES, st>>>(
      static_cast<const bf16*>(dout), static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(out), static_cast<bf16*>(dq), lse,
      delta, sq, sk, hq, hkv, causal, window, cap, q_offset, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_dkv(hkv, b, static_cast<unsigned>(tiles_dkv));
  dkv_mma_kernel<D><<<grid_dkv, kDkvGroups * kMmaThreads, L::DKV_BYTES, st>>>(
      static_cast<const bf16*>(dout), static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(dk), static_cast<bf16*>(dv), lse, delta,
      sq, sk, hq, hkv, causal, window, cap, q_offset, scale);
  return cudaGetLastError();
}

// the head dim's instantiation of the dtype's route
#define REPRO_FLASH_BWD_ARGS                                                                 \
  dout, q, k, v, out, dq, dk, dv, stats, b, sq, sk, hq, hkv, causal, window, cap, q_offset, st
cudaError_t launch_route(int d, int dtype, const void* dout, const void* q, const void* k,
                         const void* v, const void* out, void* dq, void* dk, void* dv,
                         void* stats, int b, int sq, int sk, int hq, int hkv, int causal,
                         int window, float cap, int q_offset, cudaStream_t st) {
  if (dtype == 1) {
    switch (d) {
      case 32: return launch_mma<32>(REPRO_FLASH_BWD_ARGS);
      case 64: return launch_mma<64>(REPRO_FLASH_BWD_ARGS);
      case 96: return launch_mma<96>(REPRO_FLASH_BWD_ARGS);
      case 128: return launch_mma<128>(REPRO_FLASH_BWD_ARGS);
      default: return cudaErrorInvalidValue;
    }
  }
  if (dtype == 0) {
    switch (d) {
      case 32: return launch<32, float>(REPRO_FLASH_BWD_ARGS);
      case 64: return launch<64, float>(REPRO_FLASH_BWD_ARGS);
      case 96: return launch<96, float>(REPRO_FLASH_BWD_ARGS);
      case 128: return launch<128, float>(REPRO_FLASH_BWD_ARGS);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}
#undef REPRO_FLASH_BWD_ARGS

}  // namespace

// causal: 0/1.  window <= 0: no window.  logit_cap <= 0: no soft-cap.
// dtype: 0 = float32 (the CUDA cores), 1 = bfloat16 (the tensor cores);
// dout, q, k, v, out, dq, dk, dv alike, 16-byte aligned.  stats: f32
// scratch of (2, b, hq, sq), each query row's logsumexp then its dO . O.
// d in {32, 64, 96, 128}.  Returns cudaGetLastError() after the launches.
extern "C" int repro_flash_attention_backward(const void* dout, const void* q, const void* k,
                                              const void* v, const void* out, void* dq,
                                              void* dk, void* dv, void* stats, int b, int sq,
                                              int sk, int hq, int hkv, int d, int causal,
                                              int window, float logit_cap, int q_offset,
                                              int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || hkv <= 0 || hq % hkv != 0 || hq > 65535 || b > 65535 ||
      q_offset < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_route(d, dtype, dout, q, k, v, out, dq, dk, dv, stats, b, sq,
                                       sk, hq, hkv, causal, window, logit_cap, q_offset,
                                       static_cast<cudaStream_t>(stream)));
}
