// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas
// (body _flash_fwd_kernel): q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) -> (B,Sq,Hq,D).
// Causal with q_offset (query i sits at key position q_offset + i), optional
// window (keep k > q - window), optional soft-cap cap*tanh(s/cap) applied
// before masking; GQA maps query head h to KV head h / n_rep without
// replicating K/V; online softmax in f32 with l floored at 1e-30.
//
// Bound: at the slice's prefill shapes (Sq = Sk = prompt length, D = 128) the
// work is ~Sq/2 flops per K/V byte under the causal mask, so a short prompt is
// bound by bytes and a long one by operations.  Design: one block of 4 warps
// per (16-query tile, batch * query head); each warp owns 4 query rows held in
// registers.  The block walks only the key range its rows can see (the causal
// and window limits of the tile), so fully masked key tiles are never loaded;
// each 32-key K/V tile is staged once in shared memory as f32 and read by all
// 16 rows.  Scores are lane-partial dot products over D/32 interleaved
// dimensions reduced with shuffles, parked in the lane of their key, so the
// softmax rescale runs once per tile.  Ragged Sq and Sk are masked in the
// kernel: there is no % 128 rule.  The products run on the CUDA cores, not
// the tensor cores: wgmma tiles are the later, fast version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kRows = 4;                 // query rows per warp
constexpr int kBlockQ = kWarps * kRows;  // query rows per block
constexpr int kTileK = 32;               // keys per shared-memory tile
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
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int sq, int sk, int hq, int hkv, int causal, int window,
             float cap, int q_offset, float scale) {
  constexpr int D = DPL * 32;
  extern __shared__ float smem[];
  float* ks = smem;                  // (kTileK, D)
  float* vs = smem + kTileK * D;     // (kTileK, D)

  const int bh = blockIdx.y;
  const int b = bh / hq;
  const int h = bh % hq;
  const int g = h / (hq / hkv);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kBlockQ;
  const int row0 = q0 + warp * kRows;

  float qr[kRows][DPL];
  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    const bool live = row0 + r < sq;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      acc[r][i] = 0.f;
      qr[r][i] = live
          ? to_f(q[((static_cast<long long>(b) * sq + row0 + r) * hq + h) * D + lane + 32 * i])
          : 0.f;
    }
  }

  // the key range any row of this tile can see
  const int q_first = q_offset + q0;
  const int q_last = q_offset + min(q0 + kBlockQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;

  for (int t0 = k_begin; t0 < k_end; t0 += kTileK) {
    const int nk = min(kTileK, k_end - t0);
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < nk * D; idx += blockDim.x) {
      const int j = idx / D;
      const int dd = idx % D;
      const long long off = ((static_cast<long long>(b) * sk + t0 + j) * hkv + g) * D + dd;
      ks[j * D + dd] = to_f(k[off]);
      vs[j * D + dd] = to_f(v[off]);
    }
    __syncthreads();

    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = kNegInf;
    for (int j = 0; j < nk; ++j) {
      float kf[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) kf[i] = ks[j * D + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float p = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) p += qr[r][i] * kf[i];
        p = warp_sum(p);
        if (lane == j) sc[r] = p;
      }
    }

    const int kpos = t0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q_offset + row0 + r;
      bool ok = lane < nk && row0 + r < sq;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      float s = sc[r] * scale;
      if (cap > 0.f) s = cap * tanhf(s / cap);
      const float m_new = fmaxf(m[r], warp_max(ok ? s : kNegInf));
      const float alpha = expf(m[r] - m_new);
      const float p = ok ? expf(s - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
      m[r] = m_new;
      sc[r] = p;
    }

    for (int j = 0; j < nk; ++j) {
      float vf[DPL];
#pragma unroll
      for (int i = 0; i < DPL; ++i) vf[i] = vs[j * D + lane + 32 * i];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, sc[r], j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] += pj * vf[i];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (row0 + r < sq) {
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      T* o = out + ((static_cast<long long>(b) * sq + row0 + r) * hq + h) * D;
#pragma unroll
      for (int i = 0; i < DPL; ++i) store(o + lane + 32 * i, acc[r][i] * inv);
    }
  }
}

template <typename T, int DPL>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, int b, int sq,
                     int sk, int hq, int hkv, int causal, int window, float cap, int q_offset,
                     cudaStream_t stream) {
  const size_t smem = 2 * kTileK * DPL * 32 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, b * hq);
  const float scale = 1.0f / sqrtf(static_cast<float>(DPL * 32));
  flash_kernel<T, DPL><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), sq, sk, hq, hkv, causal, window, cap, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int sq,
                   int sk, int hq, int hkv, int d, int causal, int window, float cap,
                   int q_offset, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_d<T, 1>(q, k, v, out, b, sq, sk, hq, hkv, causal, window, cap, q_offset,
                            stream);
    case 64:
      return launch_d<T, 2>(q, k, v, out, b, sq, sk, hq, hkv, causal, window, cap, q_offset,
                            stream);
    case 128:
      return launch_d<T, 4>(q, k, v, out, b, sq, sk, hq, hkv, causal, window, cap, q_offset,
                            stream);
    case 256:
      return launch_d<T, 8>(q, k, v, out, b, sq, sk, hq, hkv, causal, window, cap, q_offset,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// causal: 0/1.  window <= 0: no window.  logit_cap <= 0: no soft-cap.
// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int b, int sq, int sk, int hq, int hkv, int d, int causal,
                                     int window, float logit_cap, int q_offset, int dtype,
                                     void* stream) {
  if (b <= 0 || sq <= 0 || hkv <= 0 || hq % hkv != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? launch<__nv_bfloat16>(q, k, v, out, b, sq, sk, hq, hkv, d, causal, window, logit_cap,
                              q_offset, st)
      : launch<float>(q, k, v, out, b, sq, sk, hq, hkv, d, causal, window, logit_cap, q_offset,
                      st);
  return static_cast<int>(err);
}
