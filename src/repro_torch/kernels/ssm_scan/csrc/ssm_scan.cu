// Chunked gated linear recurrence (the SSD scan of Mamba2 and mLSTM), for
// Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssm_scan/kernel.py:gated_scan_pallas (body
// _ssd_kernel; ssm_scan_pallas is its Mamba2 wrapper).  Per (batch, head):
//     h_t = exp(ld_t) * h_{t-1} + gi_t * B_t x_t^T        (state N x P, f32)
//     y_t = C_t . h_t + D * x_t
// x (B,S,H,P) and y in the working type (f32 or bf16); ld, gi (B,S,H), D (H,),
// h0 and the final state h (B,H,N,P) in f32; B/C (B,S,G,N) with head h
// reading group h / (H/G).  Per chunk of Q steps, with cs the inclusive
// cumulative sum of ld inside the chunk:
//     y_i = sum_{j<=i} (C_i.B_j) exp(cs_i - cs_j) gi_j x_j
//           + exp(cs_i) C_i.h_prev + D x_i
//     h   = exp(cs_{Q-1}) h_prev + sum_j B_j exp(cs_{Q-1} - cs_j) gi_j x_j^T
//
// Bound: at zamba2-1.2b's shapes (H 64, P 64, G 1, N 64, bf16) the work is
// about 2 (Q N + Q P + 2 N P) flops per (step, head, column), i.e. ~40 per
// input byte at Q = 64: below the card's ~295 flops per byte, so the bound
// is bytes.  At the short prompts and buckets the served path gives it
// (S = 16 .. 64) the largest single transfer is the f32 final state
// (H N P 4 = 1 MB per batch row), more than x and y together.
//
// Design.  The TPU kernel carries h in VMEM along a sequential chunk grid
// axis; blocks on the GPU run in parallel with nothing carried between them.
// Here one block of 8 warps serves one (batch, head, 32-column tile of P)
// and loops over the chunks itself, keeping its N x 32 slice of the state in
// shared memory the whole time: the state never goes to device memory
// between chunks, and is written once at the end.  Columns of h evolve
// independently given B, C, ld and gi, so P tiles across blocks (a ragged P
// is masked), which also doubles the blocks at P = 64 (128 blocks at batch 1
// on 132 SMs).  Per chunk the block stages x (Q x 32), B (Q x N, rows padded
// by one float against bank conflicts), C (Q x N), the cumulative sum of ld
// (one warp scan) and the decay factors in shared memory, all as f32.  The
// decay-masked scores are formed one row at a time: the warp that owns row
// i computes C_i.B_j for its lanes' j <= i only (so exp(cs_i - cs_j) is only
// taken where it is <= 1 and cannot overflow), parks them in a per-warp row
// of shared memory, and then each lane sums its own column of y.  A ragged
// last chunk is masked in the kernel (its missing steps are identity steps:
// ld 0, gi 0), so S needs no padding.  The products run on the CUDA cores:
// wgmma tiles and a chunk-parallel split (chunk states, state passing,
// outputs) are the later, fast version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileP = 32;      // state columns per block (one per lane)
constexpr int kMaxChunk = 128;  // Q
constexpr int kMaxState = 128;  // N

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// floats of dynamic shared memory for a chunk of q steps and state size n
__host__ __device__ constexpr int smem_floats(int q, int n) {
  return n * kTileP        // hs: state slice (N, 32)
       + q * kTileP        // xs: x chunk (Q, 32)
       + q * (n + 1)       // bs: B chunk (Q, N+1)
       + q * n             // cm: C chunk (Q, N)
       + 4 * q             // cs, ecs, gis, wend
       + kWarps * q;       // sw: one score row per warp
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ ld, const float* __restrict__ gi,
           const T* __restrict__ bmat, const T* __restrict__ cmat, const float* __restrict__ dvec,
           const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ hout, int s,
           int nh, int p, int ng, int n, int q) {
  extern __shared__ float smem[];
  float* hs = smem;
  float* xs = hs + n * kTileP;
  float* bs = xs + q * kTileP;
  float* cm = bs + q * (n + 1);
  float* cs = cm + q * n;
  float* ecs = cs + q;
  float* gis = ecs + q;
  float* wend = gis + q;
  float* sw = wend + q;

  const int p0 = blockIdx.x * kTileP;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int grp = head / (nh / ng);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = p0 + lane;              // the y column this lane owns
  const bool col_ok = col < p;
  const float dh = dvec != nullptr ? dvec[head] : 0.f;

  // state slice: h0 or zeros
  for (int idx = tid; idx < n * kTileP; idx += kThreads) {
    const int nn = idx / kTileP;
    const int pp = p0 + idx % kTileP;
    hs[idx] = (h0 != nullptr && pp < p)
        ? h0[((static_cast<long long>(b) * nh + head) * n + nn) * p + pp]
        : 0.f;
  }

  for (int t0 = 0; t0 < s; t0 += q) {
    const int valid = min(q, s - t0);
    __syncthreads();  // the previous chunk is consumed (and hs initialised)

    // ---- stage the chunk; steps past the end are identity steps
    for (int idx = tid; idx < q * kTileP; idx += kThreads) {
      const int j = idx / kTileP;
      const int pp = p0 + idx % kTileP;
      xs[idx] = (j < valid && pp < p)
          ? to_f(x[((static_cast<long long>(b) * s + t0 + j) * nh + head) * p + pp])
          : 0.f;
    }
    for (int idx = tid; idx < q * n; idx += kThreads) {
      const int j = idx / n;
      const int nn = idx % n;
      float bv = 0.f, cv = 0.f;
      if (j < valid) {
        const long long off = ((static_cast<long long>(b) * s + t0 + j) * ng + grp) * n + nn;
        bv = to_f(bmat[off]);
        cv = to_f(cmat[off]);
      }
      bs[j * (n + 1) + nn] = bv;
      cm[idx] = cv;
    }
    if (warp == 0) {
      // inclusive cumulative sum of ld over the chunk: each lane sums a run of
      // consecutive steps, then the lanes' totals are scanned with shuffles
      constexpr int kPer = kMaxChunk / 32;
      float run[kPer];
      float tot = 0.f;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int j = lane * kPer + e;
        float v = 0.f;
        if (j < valid) {
          const long long off = (static_cast<long long>(b) * s + t0 + j) * nh + head;
          v = ld[off];
          gis[j] = gi[off];
        } else if (j < q) {
          gis[j] = 0.f;
        }
        tot += v;
        run[e] = tot;
      }
      float incl = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      const float before = incl - tot;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int j = lane * kPer + e;
        if (j < q) cs[j] = before + run[e];
      }
    }
    __syncthreads();
    const float cs_end = cs[q - 1];
    for (int j = tid; j < q; j += kThreads) {
      ecs[j] = expf(cs[j]);
      wend[j] = expf(cs_end - cs[j]) * gis[j];
    }
    __syncthreads();

    // ---- outputs, one row per warp at a time
    float* row = sw + warp * q;
    for (int i = warp; i < valid; i += kWarps) {
      const float* ci = cm + i * n;
      const float csi = cs[i];
      for (int j0 = 0; j0 <= i; j0 += 32) {
        const int j = j0 + lane;
        if (j <= i) {
          const float* bj = bs + j * (n + 1);
          float dot = 0.f;
          for (int nn = 0; nn < n; ++nn) dot += ci[nn] * bj[nn];
          row[j] = dot * expf(csi - cs[j]) * gis[j];
        }
      }
      __syncwarp();
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc += row[j] * xs[j * kTileP + lane];
      float off = 0.f;
      for (int nn = 0; nn < n; ++nn) off += ci[nn] * hs[nn * kTileP + lane];
      acc += ecs[i] * off + dh * xs[i * kTileP + lane];
      if (col_ok) store(y + ((static_cast<long long>(b) * s + t0 + i) * nh + head) * p + col, acc);
      __syncwarp();  // the row buffer is free for the warp's next row
    }
    __syncthreads();  // every row has read the chunk's entering state

    // ---- state update
    const float dec_end = expf(cs_end);
    for (int idx = tid; idx < n * kTileP; idx += kThreads) {
      const int nn = idx / kTileP;
      const int pp = idx % kTileP;
      float a = 0.f;
      for (int j = 0; j < valid; ++j) a += bs[j * (n + 1) + nn] * wend[j] * xs[j * kTileP + pp];
      hs[idx] = dec_end * hs[idx] + a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < n * kTileP; idx += kThreads) {
    const int pp = p0 + idx % kTileP;
    if (pp < p) hout[((static_cast<long long>(b) * nh + head) * n + idx / kTileP) * p + pp] = hs[idx];
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* ld, const float* gi, const void* bmat,
                   const void* cmat, const float* dvec, const float* h0, void* y, float* hout,
                   int b, int s, int nh, int p, int ng, int n, int q, cudaStream_t stream) {
  static bool attr_set = false;  // raise the dynamic shared-memory cap once
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_floats(kMaxChunk, kMaxState) * sizeof(float)));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const size_t smem = static_cast<size_t>(smem_floats(q, n)) * sizeof(float);
  const dim3 grid((p + kTileP - 1) / kTileP, nh, b);
  ssd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), ld, gi, static_cast<const T*>(bmat), static_cast<const T*>(cmat),
      dvec, h0, static_cast<T*>(y), hout, s, nh, p, ng, n, q);
  return cudaGetLastError();
}

}  // namespace

// d and h0 may be null (no skip term; a zero initial state).  chunk: the
// chunk length Q (1..128; the caller passes min(chunk, S)).  n: 1..128.
// dtype of x, B, C and y: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_ssm_scan(const void* x, const void* ld, const void* gi, const void* bmat,
                              const void* cmat, const void* d, const void* h0, void* y,
                              void* hout, int b, int s, int nh, int p, int ng, int n, int chunk,
                              int dtype, void* stream) {
  if (b <= 0 || s <= 0 || nh <= 0 || p <= 0 || ng <= 0 || nh % ng != 0 || n <= 0 ||
      n > kMaxState || chunk <= 0 || chunk > kMaxChunk) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ldf = static_cast<const float*>(ld);
  const float* gif = static_cast<const float*>(gi);
  const float* df = static_cast<const float*>(d);
  const float* h0f = static_cast<const float*>(h0);
  float* ho = static_cast<float*>(hout);
  cudaError_t err = dtype == 1
      ? launch<__nv_bfloat16>(x, ldf, gif, bmat, cmat, df, h0f, y, ho, b, s, nh, p, ng, n, chunk,
                              st)
      : launch<float>(x, ldf, gif, bmat, cmat, df, h0f, y, ho, b, s, nh, p, ng, n, chunk, st);
  return static_cast<int>(err);
}
