// Decode attention (one query per sequence against a static KV cache) for
// Hopper (sm_90a).
//
// Replaces src/repro/kernels/decode_attention/kernel.py:decode_attention_pallas
// (body _decode_kernel): q (B,Hq,D) against K/V (B,S,Hkv,D); positions
// >= kv_len[b] are masked, an optional window keeps positions >= kv_len-window;
// scale 1/sqrt(D); online softmax with m, l, acc in f32 and l floored at 1e-30;
// the n_rep = Hq/Hkv query heads of a GQA group share each K/V read.  Output
// (B,Hq,D) in q's dtype.
//
// Bound: bytes.  Every valid K/V row is read once and used for n_rep dot
// products: ~2 flops per byte, far below the card's balance point.  Design:
// one block of 4 warps per (kv head, batch row) serves all n_rep query rows
// of the group from each K/V row it reads, so K/V cross the memory bus once
// per group.  The warps split the valid key range [lo, kv_len) into 32-key
// chunks; only valid keys are read (no S % 512 rule, and the cache tail past
// kv_len costs nothing).  Within a chunk each lane owns D/32 interleaved
// dimensions (coalesced loads); a score is a lane-partial dot product reduced
// with shuffles and parked in the lane of its key, so the softmax rescale
// happens once per chunk, not once per key.  The warps' partial (m, l, acc)
// merge through shared memory at the end.  At B=1 this is only Hkv = 8 blocks
// on 132 SMs: splitting the keys across blocks (flash-decoding) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxRep = 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// DPL = D / 32: the dimensions each lane owns (lane + 32 * i).
template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const int* __restrict__ kv_len, T* __restrict__ out, int hq, int hkv, int s,
              int n_rep, int window, float scale) {
  constexpr int D = DPL * 32;
  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int len = min(kv_len[b], s);
  const int lo = window > 0 ? max(0, len - window) : 0;

  float qr[kMaxRep][DPL];
  float m[kMaxRep], l[kMaxRep], acc[kMaxRep][DPL];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      acc[r][i] = 0.f;
      qr[r][i] = r < n_rep
          ? to_f(q[(static_cast<long long>(b) * hq + g * n_rep + r) * D + lane + 32 * i])
          : 0.f;
    }
  }

  const long long pos_stride = static_cast<long long>(hkv) * D;
  const long long base = (static_cast<long long>(b) * s * hkv + g) * D;
  const T* kb = k + base;
  const T* vb = v + base;

  for (int c0 = lo + warp * 32; c0 < len; c0 += kWarps * 32) {
    const int nk = min(32, len - c0);
    float sc[kMaxRep];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) sc[r] = kNegInf;

    for (int j = 0; j < nk; ++j) {
      const T* kr = kb + (c0 + j) * pos_stride;
      float kf[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) kf[i] = to_f(kr[lane + 32 * i]);
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < n_rep) {
          float p = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) p += qr[r][i] * kf[i];
          p = warp_sum(p);
          if (lane == j) sc[r] = p * scale;
        }
      }
    }

    const bool valid = lane < nk;
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < n_rep) {
        const float m_new = fmaxf(m[r], warp_max(valid ? sc[r] : kNegInf));
        const float alpha = expf(m[r] - m_new);
        const float p = valid ? expf(sc[r] - m_new) : 0.f;
        l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
        m[r] = m_new;
        sc[r] = p;
      }
    }

    for (int j = 0; j < nk; ++j) {
      const T* vr = vb + (c0 + j) * pos_stride;
      float vf[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) vf[i] = to_f(vr[lane + 32 * i]);
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r < n_rep) {
          const float pj = __shfl_sync(0xffffffffu, sc[r], j);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] += pj * vf[i];
        }
      }
    }
  }

  // merge the warps' partial softmax states
  __shared__ float sm_m[kWarps][kMaxRep];
  __shared__ float sm_l[kWarps][kMaxRep];
  __shared__ float sm_acc[kWarps][kMaxRep][D];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r < n_rep) {
      if (lane == 0) {
        sm_m[warp][r] = m[r];
        sm_l[warp][r] = l[r];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) sm_acc[warp][r][lane + 32 * i] = acc[r][i];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < n_rep * D; idx += blockDim.x) {
    const int r = idx / D;
    const int dd = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(sm_m[w][r] - mx);
      lsum += sm_l[w][r] * a;
      o += sm_acc[w][r][dd] * a;
    }
    store(out + (static_cast<long long>(b) * hq + g * n_rep + r) * D + dd,
          o / fmaxf(lsum, 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_len, void* out,
                   int b, int hq, int hkv, int s, int d, int window, cudaStream_t stream) {
  const dim3 grid(hkv, b);
  const dim3 block(kWarps * 32);
  const float scale = 1.0f / sqrtf(static_cast<float>(d));
  const int n_rep = hq / hkv;
  auto qp = static_cast<const T*>(q);
  auto kp = static_cast<const T*>(k);
  auto vp = static_cast<const T*>(v);
  auto op = static_cast<T*>(out);
  switch (d) {
    case 32:
      decode_kernel<T, 1><<<grid, block, 0, stream>>>(qp, kp, vp, kv_len, op, hq, hkv, s, n_rep,
                                                       window, scale);
      break;
    case 64:
      decode_kernel<T, 2><<<grid, block, 0, stream>>>(qp, kp, vp, kv_len, op, hq, hkv, s, n_rep,
                                                       window, scale);
      break;
    case 128:
      decode_kernel<T, 4><<<grid, block, 0, stream>>>(qp, kp, vp, kv_len, op, hq, hkv, s, n_rep,
                                                       window, scale);
      break;
    case 256:
      decode_kernel<T, 8><<<grid, block, 0, stream>>>(qp, kp, vp, kv_len, op, hq, hkv, s, n_rep,
                                                       window, scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// window <= 0: no sliding window.  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* kv_len, void* out, int b, int hq, int hkv,
                                      int s, int d, int window, int dtype, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxRep) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_len);
  cudaError_t err = dtype == 1
      ? launch<__nv_bfloat16>(q, k, v, lens, out, b, hq, hkv, s, d, window, st)
      : launch<float>(q, k, v, lens, out, b, hq, hkv, s, d, window, st);
  return static_cast<int>(err);
}
