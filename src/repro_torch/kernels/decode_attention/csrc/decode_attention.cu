// Decode attention (one query per sequence against a static KV cache) for
// Hopper (sm_90a), split across the key range ("flash-decoding").
//
// Replaces src/repro/kernels/decode_attention/kernel.py:decode_attention_pallas
// (body _decode_kernel): q (B,Hq,D) against K/V (B,S,Hkv,D); positions
// >= kv_len[b] are masked, an optional window keeps positions >= kv_len-window;
// scale 1/sqrt(D); softmax with m, l, acc in f32 and l floored at 1e-30; the
// n_rep = Hq/Hkv query heads of a GQA group share each K/V read.  Output
// (B,Hq,D) in q's dtype.
//
// Bound: bytes.  Every valid K/V row is read once and used for n_rep dot
// products: ~2 flops per byte, far below the card's balance point.  What
// holds a batch-1 decode back is latency, not bandwidth, so the design keeps
// the chain of dependent memory trips short and spreads long caches over
// the SMs:
// * The grid is (Hkv, B, n_split): split z owns keys [z*L, (z+1)*L) of the
//   cache, with n_split = ceil(S / L) fixed by the cache length S (kv_len is
//   a device tensor; the grid never depends on it).  A split that lies wholly
//   outside [lo, min(kv_len, S)) has l = 0.
// * A block streams its split through a two-stage shared-memory ring of
//   chunks of KC keys (64 at D = 128 in bf16), copied with 16-byte cp.async:
//   chunk c+1 is in flight while chunk c is computed, and a split of at
//   most KC valid keys (every served decode step) starts all of its copies
//   before any arithmetic, so the memory latency is paid once.  L is
//   therefore not bounded by shared memory, and at L = SPLIT_LEN the served
//   caches (S = 512 and 128) are one split: one launch, no merge.
// * Scores run in parallel over keys: a group of G lanes (16 bytes each)
//   covers one K row, and all n_rep query rows of the GQA group are scored
//   from that read; the group reduces with log2(G) shuffles.
// * The chunk's online softmax runs in f32 and base 2 (ex2.approx, the scale
//   times log2 e folded into the scores); every warp takes the row maxima and
//   sums itself, so the chunk needs two barriers.  P.V runs with each thread
//   owning one 16-byte slice of D for a subset of the keys, summed over the
//   key subsets by shuffles and shared memory in a fixed order at the end of
//   the split.
// * With one split the block writes the output.  Otherwise each split writes
//   its unnormalised (acc, m, l) to f32 scratch (B, Hq, n_split, D+2), and a
//   second kernel, launched by the same entry point, merges them in split
//   order, sum acc 2^(m - M) / sum l 2^(m - M): 8 warps per (query row, 32
//   columns of D), each summing every 8th split.  No atomics, so the result
//   does not depend on the order in which blocks run, and two runs agree bit
//   for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRep = 8;
constexpr float kNegInf = -1e30f;

// A 16-byte chunk of a row: 8 bf16 or 4 f32 values.
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// 2^x in one MUFU instruction (relative error ~2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

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

// Keys per shared-memory chunk: 64, or fewer where a row exceeds 256 bytes,
// so the two-stage K and V ring stays within 64 KB.
template <typename T, int D>
__host__ __device__ constexpr int chunk_keys() {
  return 16384 / (D * static_cast<int>(sizeof(T))) < 64
             ? 16384 / (D * static_cast<int>(sizeof(T)))
             : 64;
}

// Shared memory of a split, in bytes: the K and V ring (2 stages x KC rows x
// D in T each; the warps' partial P.V, kWarps x NREP x D f32, reuses it after
// the last chunk), the chunk's scores (NREP x KC f32) and the split's (m, l)
// of each query row.
template <typename T, int D, int NREP>
__host__ __device__ constexpr int smem_bytes() {
  return 4 * chunk_keys<T, D>() * D * static_cast<int>(sizeof(T)) + NREP * chunk_keys<T, D>() * 4 +
         2 * NREP * 4;
}

template <typename T, int D, int NREP>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int* __restrict__ kv_len, T* __restrict__ out, float* __restrict__ part,
             int hq, int hkv, int s, int n_rep, int window, int split_len, float scale) {
  using C = Chunk<T>;
  constexpr int VPL = C::N;                // values per 16-byte chunk
  constexpr int CH = D / VPL;              // 16-byte chunks per row
  constexpr int G = CH < 32 ? CH : 32;     // lanes per key
  constexpr int CPL = CH / G;              // 16-byte chunks per lane
  constexpr int SLOTS = kThreads / G;      // keys in flight per pass
  constexpr int KC = chunk_keys<T, D>();   // keys per shared-memory chunk
  static_assert(4 * KC * D * sizeof(T) >= kWarps * NREP * D * 4, "P.V partials reuse the ring");

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int z = blockIdx.z;
  const int n_split = gridDim.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gl = tid % G;      // lane within the key group
  const int slot = tid / G;    // key slot

  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);                  // [2][KC][D]
  T* vs = ks + 2 * KC * D;                             // [2][KC][D]
  float* sc = reinterpret_cast<float*>(vs + 2 * KC * D);   // [NREP][KC]
  float* ml = sc + NREP * KC;                          // [NREP][2]: the split's m, l

  const long long pos_stride = static_cast<long long>(hkv) * D;
  auto copy_rows = [&](const T* src, T* dst, int rows) {
    for (int i = tid; i < rows * CH; i += kThreads) {
      const int j = i / CH;
      const int cc = i % CH;
      cp_async16(dst + j * D + cc * VPL, src + j * pos_stride + cc * VPL);
    }
  };
  // Without a window the first split starts at key 0 whatever kv_len is:
  // its first chunk's copies go out before kv_len arrives (rows past kv_len,
  // still inside the cache, are copied and never read), so the step pays
  // one memory trip, not two.
  const bool early = z == 0 && window <= 0;
  const long long head = static_cast<long long>(b) * s * pos_stride + static_cast<long long>(g) * D;
  if (early) {
    copy_rows(k + head, ks, min(KC, s));
    copy_rows(v + head, vs, min(KC, s));
  }

  const int len = min(kv_len[b], s);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int k0 = max(lo, z * split_len);
  const int n = min(len, (z + 1) * split_len) - k0;   // keys of this split
  const long long row0 = static_cast<long long>(b) * hq + static_cast<long long>(g) * n_rep;

  if (n <= 0) {   // nothing to attend in this split: l = 0
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (n_split == 1) {
      for (int i = tid; i < n_rep * D; i += kThreads) store(out + row0 * D + i, 0.f);
    } else {
      for (int r = tid; r < n_rep; r += kThreads) {
        float* p = part + ((row0 + r) * n_split + z) * (D + 2);
        p[D] = kNegInf;
        p[D + 1] = 0.f;
      }
    }
    return;
  }

  const T* kb = k + head + k0 * pos_stride;
  const T* vb = v + head + k0 * pos_stride;
  auto load_chunk = [&](int c, int stage) {
    const int j0 = c * KC;
    const int nc = min(KC, n - j0);
    copy_rows(kb + j0 * pos_stride, ks + stage * KC * D, nc);
    copy_rows(vb + j0 * pos_stride, vs + stage * KC * D, nc);
  };

  // the first chunk's copies in flight before any arithmetic
  if (!early) load_chunk(0, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // the lane's slices of the group's query rows, while the copies fly
  float qr[NREP][CPL][VPL];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) {
      if (r < n_rep) {
        const uint4 u = *reinterpret_cast<const uint4*>(q + (row0 + r) * D + (gl + cc * G) * VPL);
        C::unpack(u, qr[r][cc]);
      } else {
#pragma unroll
        for (int e = 0; e < VPL; ++e) qr[r][cc][e] = 0.f;
      }
    }
  }
  float acc[NREP][CPL][VPL];
#pragma unroll
  for (int r = 0; r < NREP; ++r)
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
      for (int e = 0; e < VPL; ++e) acc[r][cc][e] = 0.f;
  // the running max and sum of each query row, in base-2 units (the scores
  // carry the scale times log2 e); every thread holds the same values
  const float scale2 = scale * 1.4426950408889634f;
  float m_run[NREP], l_run[NREP];
#pragma unroll
  for (int r = 0; r < NREP; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
  }

  const int n_chunks = (n + KC - 1) / KC;
  for (int c = 0; c < n_chunks; ++c) {
    const int stage = c & 1;
    if (c + 1 < n_chunks) load_chunk(c + 1, stage ^ 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");   // chunk c has landed
    __syncthreads();
    const int nc = min(KC, n - c * KC);
    const T* kc = ks + stage * KC * D;
    const T* vc = vs + stage * KC * D;

    // scores: one key per group of G lanes, every query row from one read
#pragma unroll 2
    for (int j0 = 0; j0 < nc; j0 += SLOTS) {   // uniform trip count: the shuffles need it
      const int j = j0 + slot;
      const bool live = j < nc;
      float dot[NREP];
#pragma unroll
      for (int r = 0; r < NREP; ++r) dot[r] = 0.f;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        float kf[VPL];
        const uint4 u = live ? *reinterpret_cast<const uint4*>(kc + j * D + (gl + cc * G) * VPL)
                             : make_uint4(0u, 0u, 0u, 0u);
        C::unpack(u, kf);
#pragma unroll
        for (int r = 0; r < NREP; ++r)
#pragma unroll
          for (int e = 0; e < VPL; ++e) dot[r] += qr[r][cc][e] * kf[e];
      }
#pragma unroll
      for (int r = 0; r < NREP; ++r) {
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1) dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], o);
        if (live && gl == 0 && r < n_rep) sc[r * KC + j] = dot[r] * scale2;
      }
    }
    __syncthreads();

    // the chunk's online softmax: every warp takes each row's max and sum
    // itself (the same values in every warp), so P.V follows without a
    // barrier; then the running P.V sums are rescaled
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      if (r < n_rep) {
        const float* row = sc + r * KC;
        float mx = kNegInf;
        for (int j = lane; j < nc; j += 32) mx = fmaxf(mx, row[j]);
        mx = warp_max(mx);
        const float m_new = fmaxf(m_run[r], mx);
        float sum = 0.f;
        for (int j = lane; j < nc; j += 32) sum += ex2(row[j] - m_new);
        sum = warp_sum(sum);
        const float a = ex2(m_run[r] - m_new);
        l_run[r] = l_run[r] * a + sum;
        m_run[r] = m_new;
#pragma unroll
        for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
          for (int e = 0; e < VPL; ++e) acc[r][cc][e] *= a;
      }
    }

    // P.V: the thread's 16-byte slices of D over its keys
#pragma unroll 2
    for (int j = slot; j < nc; j += SLOTS) {
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        float vf[VPL];
        C::unpack(*reinterpret_cast<const uint4*>(vc + j * D + (gl + cc * G) * VPL), vf);
#pragma unroll
        for (int r = 0; r < NREP; ++r) {
          if (r < n_rep) {
            const float p = ex2(sc[r * KC + j] - m_run[r]);
#pragma unroll
            for (int e = 0; e < VPL; ++e) acc[r][cc][e] += p * vf[e];
          }
        }
      }
    }
    __syncthreads();   // this stage and the scores may be overwritten
  }

  // sum over the warp's key slots (lanes gl, gl+G, ...), then over the warps
  float* red = reinterpret_cast<float*>(smem);   // [kWarps][NREP][D], over the ring
#pragma unroll
  for (int r = 0; r < NREP; ++r)
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
      for (int e = 0; e < VPL; ++e)
#pragma unroll
        for (int o = G; o < 32; o <<= 1)
          acc[r][cc][e] += __shfl_xor_sync(0xffffffffu, acc[r][cc][e], o);
  if (lane < G) {
#pragma unroll
    for (int r = 0; r < NREP; ++r)
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc)
#pragma unroll
        for (int e = 0; e < VPL; ++e)
          if (r < n_rep) red[(warp * NREP + r) * D + (gl + cc * G) * VPL + e] = acc[r][cc][e];
  }
  if (tid == 0) {
#pragma unroll
    for (int r = 0; r < NREP; ++r) {
      ml[2 * r] = m_run[r];
      ml[2 * r + 1] = l_run[r];
    }
  }
  __syncthreads();

  for (int i = tid; i < n_rep * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += red[(w * NREP + r) * D + d];
    if (n_split == 1) {
      store(out + (row0 + r) * D + d, o / fmaxf(ml[2 * r + 1], 1e-30f));
    } else {
      float* p = part + ((row0 + r) * n_split + z) * (D + 2);
      p[d] = o;
      if (d == 0) {
        p[D] = ml[2 * r];
        p[D + 1] = ml[2 * r + 1];
      }
    }
  }
}

// Merge of many splits: block (query row, 32 columns of D) of 8 warps; warp w
// sums splits w, w+8, ..., lane = column; the warps' sums add in warp order.
constexpr int kMergeWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kMergeWarps * 32)
merge_kernel(const float* __restrict__ part, T* __restrict__ out, int d, int n_split) {
  __shared__ float red_m[kMergeWarps];
  __shared__ float red_l[kMergeWarps];
  __shared__ float red_o[kMergeWarps][32];
  const long long row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.y * 32 + lane;
  const float* p = part + row * n_split * (d + 2);

  float mx = kNegInf;
  for (int z = threadIdx.x; z < n_split; z += kMergeWarps * 32) {
    const float* pz = p + static_cast<long long>(z) * (d + 2);
    if (pz[d + 1] > 0.f) mx = fmaxf(mx, pz[d]);
  }
  mx = warp_max(mx);
  if (lane == 0) red_m[warp] = mx;
  __syncthreads();
  mx = red_m[0];
#pragma unroll
  for (int w = 1; w < kMergeWarps; ++w) mx = fmaxf(mx, red_m[w]);

  float l = 0.f, o = 0.f;
#pragma unroll 4
  for (int z = warp; z < n_split; z += kMergeWarps) {
    const float* pz = p + static_cast<long long>(z) * (d + 2);
    const float lz = pz[d + 1];
    if (lz > 0.f) {
      const float a = ex2(pz[d] - mx);
      l += lz * a;
      if (col < d) o += pz[col] * a;
    }
  }
  red_o[warp][lane] = o;
  if (lane == 0) red_l[warp] = l;
  __syncthreads();
  if (warp == 0 && col < d) {
    float ot = 0.f, lt = 0.f;
#pragma unroll
    for (int w = 0; w < kMergeWarps; ++w) {
      ot += red_o[w][lane];
      lt += red_l[w];
    }
    store(out + row * d + col, ot / fmaxf(lt, 1e-30f));
  }
}

template <typename T, int D, int NREP>
cudaError_t launch_split(const T* q, const T* k, const T* v, const int* kv_len, T* out,
                         float* part, int b, int hq, int hkv, int s, int window, int split_len,
                         int n_split, cudaStream_t stream) {
  constexpr int smem = smem_bytes<T, D, NREP>();
  static bool attr_set = false;   // raise the dynamic shared-memory cap once
  if (smem > 48 * 1024 && !attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_kernel<T, D, NREP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid(hkv, b, n_split);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  split_kernel<T, D, NREP><<<grid, kThreads, smem, stream>>>(
      q, k, v, kv_len, out, part, hq, hkv, s, hq / hkv, window, split_len, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(const T* q, const T* k, const T* v, const int* kv_len, T* out, float* part,
                     int b, int hq, int hkv, int s, int window, int split_len, int n_split,
                     cudaStream_t stream) {
  const int n_rep = hq / hkv;
  if (n_rep == 1)
    return launch_split<T, D, 1>(q, k, v, kv_len, out, part, b, hq, hkv, s, window, split_len,
                                 n_split, stream);
  if (n_rep == 2)
    return launch_split<T, D, 2>(q, k, v, kv_len, out, part, b, hq, hkv, s, window, split_len,
                                 n_split, stream);
  if (n_rep <= 4)
    return launch_split<T, D, 4>(q, k, v, kv_len, out, part, b, hq, hkv, s, window, split_len,
                                 n_split, stream);
  return launch_split<T, D, 8>(q, k, v, kv_len, out, part, b, hq, hkv, s, window, split_len,
                               n_split, stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* kv_len, void* out,
                   float* part, int b, int hq, int hkv, int s, int d, int window, int split_len,
                   int n_split, cudaStream_t stream) {
  auto qp = static_cast<const T*>(q);
  auto kp = static_cast<const T*>(k);
  auto vp = static_cast<const T*>(v);
  auto op = static_cast<T*>(out);
  cudaError_t err;
  switch (d) {
    case 32:
      err = launch_d<T, 32>(qp, kp, vp, kv_len, op, part, b, hq, hkv, s, window, split_len,
                            n_split, stream);
      break;
    case 64:
      err = launch_d<T, 64>(qp, kp, vp, kv_len, op, part, b, hq, hkv, s, window, split_len,
                            n_split, stream);
      break;
    case 128:
      err = launch_d<T, 128>(qp, kp, vp, kv_len, op, part, b, hq, hkv, s, window, split_len,
                             n_split, stream);
      break;
    case 256:
      err = launch_d<T, 256>(qp, kp, vp, kv_len, op, part, b, hq, hkv, s, window, split_len,
                             n_split, stream);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || n_split == 1) return err;
  merge_kernel<T><<<dim3(b * hq, (d + 31) / 32), kMergeWarps * 32, 0, stream>>>(part, op, d,
                                                                              n_split);
  return cudaGetLastError();
}

}  // namespace

// window <= 0: no sliding window.  dtype: 0 = float32, 1 = bfloat16.
// n_split = ceil(s / split_len); part: f32 scratch of (b, hq, n_split, d + 2)
// when n_split > 1, else unused (may be null).  q, k, v and out are 16-byte
// aligned.  Returns cudaGetLastError() after the launches.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* kv_len, void* out, void* part, int b, int hq,
                                      int hkv, int s, int d, int window, int split_len,
                                      int dtype, void* stream) {
  if (b <= 0 || s <= 0 || hkv <= 0 || hq % hkv != 0 || hq / hkv > kMaxRep || split_len <= 0 ||
      b > 65535)
    return cudaErrorInvalidValue;
  const int n_split = (s + split_len - 1) / split_len;
  if (n_split > 65535 || (n_split > 1 && part == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_len);
  float* pp = static_cast<float*>(part);
  cudaError_t err = dtype == 1
      ? launch<__nv_bfloat16>(q, k, v, lens, out, pp, b, hq, hkv, s, d, window, split_len,
                              n_split, st)
      : launch<float>(q, k, v, lens, out, pp, b, hq, hkv, s, d, window, split_len, n_split, st);
  return static_cast<int>(err);
}
