// Chunked gated linear recurrence (the SSD scan of Mamba2 and mLSTM),
// backward, for Hopper (sm_90a).
//
// Replaces the gradient that JAX's AD derives through
// src/repro/kernels/ssm_scan/kernel.py:gated_scan_pallas (the reference has
// no backward kernel: its training differentiates the chunked body,
// ref.py:gated_scan_ref).  Written from that chunked form.  Per (batch,
// head) and chunk of Q steps, with cs the inclusive cumulative sum of ld
// inside the chunk, e_i = exp(cs_i), w_j = exp(cs_last - cs_j) gi_j, L_ij =
// exp(cs_i - cs_j) gi_j for j <= i (else 0), H the state entering the chunk
// and dH the gradient of the state leaving it:
//   forward   S = (C B^T) o L,  y = S x + diag(e) C H + D x,
//             H' = exp(cs_last) H + B^T diag(w) x
//   backward  dS = dy x^T,  G = dS o L (the gradient of C B^T)
//             dx = S^T dy + diag(w) B dH + D dy
//             dB = G^T C + diag(w) x dH^T       (summed over a group's heads)
//             dC = G B   + diag(e) dy H^T       (summed over a group's heads)
//             dH_in = exp(cs_last) dH + C^T diag(e) dy  (the reverse scan)
//             dgi_j = sum_i dS_ij (C B^T)_ij exp(cs_i - cs_j) + exp(cs_last - cs_j) u_j
//             dcs_k = sum_j (dS o S)_kj - sum_i (dS o S)_ik + C_k . (e_k H dy_k)
//                     - w_k u_k + [k last] (sum_j w_j u_j + exp(cs_last) <H, dH>)
//             dld   = the reverse cumulative sum of dcs inside the chunk, taken
//                     as sum_{i >= t > j} (dS o S)_ij + sum_{k >= t} C_k . (e_k H dy_k)
//                     + sum_{j < t} w_j u_j + exp(cs_last) <H, dH>, with no
//                     whole-chunk sums that cancel
//   with u_j = B_j . (dH x_j); dD = sum x o dy; dh0 = dH_in of chunk 0.
// x, dy, B, C and their gradients are in the working type (f32 or bf16),
// everything else in f32; every product accumulates in f32.
//
// Eight launches (nine on the wide route), each over blocks that own their
// outputs, so no sum crosses blocks except through a workspace added in a
// fixed order: no atomics, and two launches give the same bits.
//   0 cumsum        each chunk's cumulative log-decay, one thread per
//                   (batch, chunk, head) in step order, read by the rest.
//   1 state_pass    the states entering each chunk (forward from h0) and the
//                   state gradients leaving each chunk (backward from
//                   dh_final) into an f32 workspace (B, NC, H, N, P) each,
//                   one block per (32 columns of P, rows of N, direction x
//                   head x batch), the chunks in order inside the block; the
//                   backward direction writes dh0.
//   2 scores        per (chunk, head, batch): C B^T over N and dy x^T over P
//                   in slabs of 16, then S and G into the workspace and the
//                   per-step sums of dS o S and of the dgi term (on the wide
//                   route the sums over N and P first split over blocks:
//                   scores_part).
//   3 dx            per (32 columns of P, chunk, head x batch): S^T dy and
//                   B dH over slabs, and the block's part of dD.
//   4 dbc           per (32 columns of N, chunk, head x batch): x dH^T and
//                   dy H^T over slabs of P (each block's part of u, of
//                   C . (e H dy) and of <H, dH>), then G^T C and G B; the
//                   head's dB and dC into an f32 workspace.
//   5 finish        per (chunk, head, batch): the parts over N tiles added in
//                   order, dgi, dcs and its reverse cumulative sum, dld.
//   6 reduce_bc     dB and dC: each group's heads added in order.
//   7 reduce_d      dD: the blocks' parts added in order (only with D).
//
// Routes (ops.py:scan_backward_plan): narrow (N <= 128, Mamba2) keeps a
// block's whole N x 32 state tile in registers in the state pass, one block
// per column tile, rows rounded to 64 or 128; wide (N up to 1024, the
// mLSTM's 1024 x 1025 state) cannot (the f32 slice alone is 128 KB), so
// the state pass splits N into tiles of 64 rows across blocks, and the dbc
// kernel's per-tile parts (up to 32) are added by the finish kernel.  Both
// stream B, C, x, dy and the states through shared memory in slabs of 32;
// nothing whole-chunk-by-whole-state is ever resident.  The products run on
// the CUDA cores in both dtypes (a simple kernel; tensor cores are queued):
// the state pass, dx and dbc as register tiles of 4 or 8 rows by 2 columns
// a thread, the scores as 8 x 8.
// A ragged last chunk is masked (its missing steps count nothing), which
// equals the plain version's padding with identity steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdio.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kMaxChunk = 128;     // Q
constexpr int kNarrowState = 128;  // N of the narrow route
constexpr int kMaxState = 1024;    // N of the wide route
constexpr int kThreads = 256;
// blocks per SM the tiled kernels' registers must leave room for: three (80
// registers a thread) measured faster than one (up to 128) at both training
// shapes, the loads' latency hidden by more warps
constexpr int kMinBlocks = 3;
constexpr int kTile = 32;          // columns of P (state pass, dx) or N (dbc) per block
constexpr int kWideRows = 64;      // state rows per block on the wide route
constexpr int kSlab = 16;          // columns per staged slab of the scores' sums
enum Route { kNarrow = 0, kWide = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16(v); }

struct Dims {
  int b, s, nh, p, ng, n, q, nc, rep, pt, nt;  // pt, nt: column tiles of P and N
  int ks;                                      // ranges the scores' sums split into
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// offsets (floats) of the workspace's parts; ops.py:scan_backward_plan
// computes the same total
struct Workspace {
  long long hs, dhs, sg, stepw, part, hdh, dbh, dch, ddp, ssp, cs, total;
};

__host__ __device__ inline Workspace workspace(const Dims& d) {
  Workspace w;
  const long long bch = static_cast<long long>(d.b) * d.nc * d.nh;
  const long long state = bch * d.n * d.p;
  w.hs = 0;
  w.dhs = w.hs + state;
  w.sg = w.dhs + state;
  w.stepw = w.sg + bch * 2 * d.q * d.q;
  w.part = w.stepw + bch * 2 * d.q;
  w.hdh = w.part + bch * d.nt * 2 * d.q;
  w.dbh = w.hdh + bch * d.nt;
  const long long heads = static_cast<long long>(d.b) * d.s * d.nh * d.n;
  w.dch = w.dbh + heads;
  w.ddp = w.dch + heads;
  w.ssp = w.ddp + bch * d.pt;
  w.cs = w.ssp + (d.ks > 1 ? bch * d.ks * 2 * kMaxChunk * kMaxChunk : 0);
  w.total = w.cs + bch * d.q;
  return w;
}

// index of (batch b, step t, head h) in a (B, S, H) array
__device__ __forceinline__ long long row(const Dims& d, int b, int t, int h) {
  return (static_cast<long long>(b) * d.s + t) * d.nh + h;
}
// index of (batch b, step t, group g, column 0) in a (B, S, G, N) array
__device__ __forceinline__ long long grow(const Dims& d, int b, int t, int g) {
  return ((static_cast<long long>(b) * d.s + t) * d.ng + g) * d.n;
}
// (batch, chunk, head) slot of the per-chunk workspaces
__device__ __forceinline__ long long bch(const Dims& d, int b, int c, int h) {
  return (static_cast<long long>(b) * d.nc + c) * d.nh + h;
}

// 0. Each chunk's inclusive cumulative log-decay, once for every kernel:
// a warp per (batch, chunk, head) loads the chunk's log-decays, and its
// first lane sums them in step order, the order of the plain version's
// cumsum along the step axis (a sequential scan per column on the card and
// on the CPU).  At zamba2's decays the sums reach -256, where another order
// moves exp(cs_i - cs_j) by more than the f32 tolerance.
constexpr int kCumsumWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
cumsum_kernel(const float* __restrict__ ld, float* __restrict__ csw, Dims d) {
  __shared__ float s_v[kCumsumWarps][kMaxChunk];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long e = static_cast<long long>(blockIdx.x) * kCumsumWarps + w;
  if (e >= static_cast<long long>(d.b) * d.nc * d.nh) return;   // whole warps only
  const int h = static_cast<int>(e % d.nh);
  const int c = static_cast<int>((e / d.nh) % d.nc), b = static_cast<int>(e / d.nh / d.nc);
  const int t0 = c * d.q, len = min(d.q, d.s - t0);
  float* v = s_v[w];
  for (int i = lane; i < len; i += 32) v[i] = ld[row(d, b, t0 + i, h)];
  __syncwarp();
  if (lane == 0) {
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < len; ++i) {
      acc += v[i];
      v[i] = acc;
    }
  }
  __syncwarp();
  float* out = csw + e * d.q;   // e is the (batch, chunk, head) slot
  for (int i = lane; i < len; i += 32) out[i] = v[i];
}

// The chunk's cumulative log-decay (cumsum_kernel's) into cs[0, len) and
// its input scales into gis.  Ends with a barrier.
__device__ __forceinline__ void chunk_load(const Dims& d, const float* __restrict__ csw,
                                           const float* __restrict__ gi, int b, int c, int h,
                                           int len, float* cs, float* gis) {
  const float* src = csw + bch(d, b, c, h) * d.q;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    cs[i] = src[i];
    gis[i] = gi[row(d, b, c * d.q + i, h)];
  }
  __syncthreads();
}

// Register tiles: a block's output tile is (16 R) rows x 32 columns; thread
// (warp w, lane l) owns the R rows from (2w + l / 16) R and the columns
// 2 (l % 16) and 2 (l % 16) + 1, so each k step of a product reads R rows
// of the left operand (float4s that the warp's two row groups share) and
// two columns of the right one (a float2), for 2 R multiply-adds.
constexpr int kK = 32;   // depth of a staged slab of a product's sum

struct TileThread {
  int r0, c0;   // first row and first column of the thread's tile
};

template <int R>
__device__ __forceinline__ TileThread tile_thread() {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  return TileThread{(2 * w + (lane >> 4)) * R, 2 * (lane & 15)};
}

// acc[r][c] += sum over k < kK of a[k * lda + r0 + r] * x[k * ldx + c0 + c]
template <int R>
__device__ __forceinline__ void tile_fma(const float* __restrict__ a, int lda,
                                         const float* __restrict__ x, int ldx, TileThread t,
                                         float (&acc)[R][2]) {
#pragma unroll 8
  for (int k = 0; k < kK; ++k) {
    float av[R];
#pragma unroll
    for (int v = 0; v < R; v += 4) {
      const float4 q = *reinterpret_cast<const float4*>(a + k * lda + t.r0 + v);
      av[v] = q.x;
      av[v + 1] = q.y;
      av[v + 2] = q.z;
      av[v + 3] = q.w;
    }
    const float2 xv = *reinterpret_cast<const float2*>(x + k * ldx + t.c0);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[r][0] += av[r] * xv.x;
      acc[r][1] += av[r] * xv.y;
    }
  }
}

// 1. States forward (dir 0: h_in of each chunk, from h0) and state gradients
// backward (dir 1: dH of each chunk, from dh_final; then dh0).  A block owns
// rows [n0, n0 + 16 R) x 32 columns of the state as register tiles and walks
// the chunks in order.  Per chunk it writes the state it enters with, then
// adds A^T X over the chunk's steps in slabs of 32: dir 0 A = diag(w) B,
// X = x; dir 1 A = diag(e) C, X = dy.  (Forming every chunk's term at once
// and scanning over chunks in a second kernel measured slower at both
// training shapes: the scan's extra pass over the workspace costs more than
// the walk's serial chunks.)
template <typename T, int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
state_pass_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ csw, const float* __restrict__ gi, const T* __restrict__ bmat,
                  const T* __restrict__ cmat, const float* __restrict__ h0,
                  const float* __restrict__ dh_final, float* __restrict__ hs,
                  float* __restrict__ dhs, float* __restrict__ dh0, Dims d) {
  constexpr int kRows = 16 * R;
  __shared__ float s_cs[kMaxChunk], s_gi[kMaxChunk], s_coef[kMaxChunk];
  __shared__ __align__(16) float s_a[kK * kRows];
  __shared__ __align__(16) float s_x[kK * kTile];
  const int bh = blockIdx.z % (d.b * d.nh);
  const int dir = blockIdx.z / (d.b * d.nh);
  const int b = bh / d.nh, h = bh % d.nh, g = h / d.rep;
  const int p0 = blockIdx.x * kTile, n0 = blockIdx.y * kRows;
  const TileThread t = tile_thread<R>();
  const T* amat = dir == 0 ? bmat : cmat;
  const T* xmat = dir == 0 ? x : dy;
  const float* init = dir == 0 ? h0 : dh_final;
  float st[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = n0 + t.r0 + r, p = p0 + t.c0 + c;
      st[r][c] = (init != nullptr && n < d.n && p < d.p)
                     ? init[((static_cast<long long>(b) * d.nh + h) * d.n + n) * d.p + p]
                     : 0.f;
    }
  for (int step = 0; step < d.nc; ++step) {
    const int c = dir == 0 ? step : d.nc - 1 - step;
    const int t0 = c * d.q, len = min(d.q, d.s - t0);
    float* out = (dir == 0 ? hs : dhs) + bch(d, b, c, h) * d.n * d.p;
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int n = n0 + t.r0 + r, p = p0 + t.c0 + cc;
        if (n < d.n && p < d.p) out[static_cast<long long>(n) * d.p + p] = st[r][cc];
      }
    __syncthreads();   // the previous chunk is done with the shared arrays
    chunk_load(d, csw, gi, b, c, h, len, s_cs, s_gi);
    const float last = s_cs[len - 1];
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      s_coef[i] = dir == 0 ? expf(last - s_cs[i]) * s_gi[i] : expf(s_cs[i]);
    }
    float acc[R][2] = {};
    for (int j0 = 0; j0 < len; j0 += kK) {
      __syncthreads();
#pragma unroll 4
      for (int e = threadIdx.x; e < kK * kRows; e += kThreads) {
        const int jj = e / kRows, r = e % kRows;
        const int j = j0 + jj, n = n0 + r;
        s_a[e] = (j < len && n < d.n) ? to_f(amat[grow(d, b, t0 + j, g) + n]) * s_coef[j] : 0.f;
      }
#pragma unroll 4
      for (int e = threadIdx.x; e < kK * kTile; e += kThreads) {
        const int jj = e / kTile, cc = e % kTile;
        const int j = j0 + jj, pp = p0 + cc;
        s_x[e] = (j < len && pp < d.p) ? to_f(xmat[row(d, b, t0 + j, h) * d.p + pp]) : 0.f;
      }
      __syncthreads();
      tile_fma<R>(s_a, kRows, s_x, kTile, t, acc);
    }
    const float decay = expf(last);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) st[r][cc] = decay * st[r][cc] + acc[r][cc];
  }
  if (dir == 1 && dh0 != nullptr) {
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int n = n0 + t.r0 + r, p = p0 + t.c0 + cc;
        if (n < d.n && p < d.p) {
          dh0[((static_cast<long long>(b) * d.nh + h) * d.n + n) * d.p + p] = st[r][cc];
        }
      }
  }
}

// 2. Per (chunk, head, batch): C B^T and dS = dy x^T, each a 128 x 128
// product on a 16 x 16 thread grid (thread (ty, tx) owns rows ty + 16a,
// columns tx + 16b), their operands staged in slabs of 16 columns; then S
// and G into the workspace, and per step t the sum of dS o S over the pairs
// that straddle it (i >= t > j: dld's intra-chunk term, in a form without
// the whole chunk's cancelling row and column sums) and the column sum of
// dS o C B^T o exp(cs_i - cs_j) (dgi's).  On the wide route a chunk's sums
// over N and P are split into ``ks`` ranges over as many blocks
// (scores_part_kernel: the mLSTM has only B x H x NC = 16 chunk-heads), and
// scores_kernel adds their partial matrices in range order before the rest.
__host__ __device__ constexpr int scores_smem_floats() {
  return 2 * kMaxChunk + 2 * kMaxChunk * (kSlab + 1) + kMaxChunk * (kMaxChunk + 1);
}

__device__ __forceinline__ long long group_row(const Dims& d, int b, int t, int g) {
  return (static_cast<long long>(b) * d.s + t) * d.ng + g;
}

// acc += the chunk's U V^T over columns [lo, hi): C B^T over N (kGroup: the
// rows of B and C are group hg's) or dy x^T over P (head hg's), staged in
// slabs of 16
template <bool kGroup, typename T>
__device__ __forceinline__ void chunk_gram(const T* __restrict__ u, const T* __restrict__ v,
                                           int lo, int hi, int b, int t0, int hg, int len,
                                           float* s_u, float* s_v, const Dims& d,
                                           float (&acc)[8][8]) {
  const int ld = kGroup ? d.n : d.p;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int n0 = lo; n0 < hi; n0 += kSlab) {
    __syncthreads();
    #pragma unroll 4
    for (int e = threadIdx.x; e < kMaxChunk * kSlab; e += kThreads) {
      const int i = e / kSlab, k = e % kSlab, n = n0 + k;
      const bool in = i < len && n < hi;
      const long long base = (kGroup ? group_row(d, b, t0 + i, hg) : row(d, b, t0 + i, hg)) * ld
                             + n;
      s_u[i * (kSlab + 1) + k] = in ? to_f(u[base]) : 0.f;
      s_v[i * (kSlab + 1) + k] = in ? to_f(v[base]) : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int k = 0; k < kSlab; ++k) {
      float uv[8], vv[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        uv[a] = s_u[(ty + 16 * a) * (kSlab + 1) + k];
        vv[a] = s_v[(tx + 16 * a) * (kSlab + 1) + k];
      }
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[a][e] += uv[a] * vv[e];
    }
  }
}

// the split of a sum over `total` columns into ks ranges of whole slabs
__host__ __device__ inline int split_width(int total, int ks) {
  return cdiv(cdiv(total, kSlab), ks) * kSlab;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scores_part_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                   const T* __restrict__ bmat, const T* __restrict__ cmat,
                   float* __restrict__ ws, Workspace w, Dims d) {
  __shared__ float s_u[kMaxChunk * (kSlab + 1)], s_v[kMaxChunk * (kSlab + 1)];
  const int c = blockIdx.x / d.ks, k = blockIdx.x % d.ks, h = blockIdx.y, b = blockIdx.z;
  const int g = h / d.rep, t0 = c * d.q, len = min(d.q, d.s - t0);
  const int wn = split_width(d.n, d.ks), wp = split_width(d.p, d.ks);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float* out = ws + w.ssp + (bch(d, b, c, h) * d.ks + k) * 2 * kMaxChunk * kMaxChunk;
  float acc[8][8];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[a][e] = 0.f;
    if (m == 0) {
      chunk_gram<true>(cmat, bmat, k * wn, min(d.n, (k + 1) * wn), b, t0, g, len, s_u, s_v, d,
                       acc);
    } else {
      chunk_gram<false>(dy, x, k * wp, min(d.p, (k + 1) * wp), b, t0, h, len, s_u, s_v, d, acc);
    }
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        out[m * kMaxChunk * kMaxChunk + (ty + 16 * a) * kMaxChunk + tx + 16 * e] = acc[a][e];
      }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scores_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ gi,
              const T* __restrict__ bmat,
              const T* __restrict__ cmat, float* __restrict__ ws, Workspace w, Dims d) {
  extern __shared__ float smem[];
  float* s_cs = smem;
  float* s_gi = s_cs + kMaxChunk;
  float* s_u = s_gi + kMaxChunk;             // (128, 17): C or dy slab
  float* s_v = s_u + kMaxChunk * (kSlab + 1); // (128, 17): B or x slab
  float* s_m = s_v + kMaxChunk * (kSlab + 1); // (128, 129)
  constexpr int kLd = kMaxChunk + 1;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, g = h / d.rep;
  const int t0 = c * d.q, len = min(d.q, d.s - t0);
  chunk_load(d, ws + w.cs, gi, b, c, h, len, s_cs, s_gi);
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[8][8];
  const float* part = ws + w.ssp + bch(d, b, c, h) * d.ks * 2 * kMaxChunk * kMaxChunk;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[a][e] = 0.f;
    if (d.ks > 1) {   // the split's partial sums, added in range order
      for (int k = 0; k < d.ks; ++k) {
        const float* pk = part + (k * 2 + m) * kMaxChunk * kMaxChunk;
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[a][e] += pk[(ty + 16 * a) * kMaxChunk + tx + 16 * e];
      }
    } else if (m == 0) {
      chunk_gram<true>(cmat, bmat, 0, d.n, b, t0, g, len, s_u, s_v, d, acc);
    } else {
      chunk_gram<false>(dy, x, 0, d.p, b, t0, h, len, s_u, s_v, d, acc);
    }
    if (m == 0) {   // park C B^T
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int e = 0; e < 8; ++e) s_m[(ty + 16 * a) * kLd + tx + 16 * e] = acc[a][e];
    }
  }
  // S, G out; dS o S kept in acc; the dgi term parked in s_m (each thread
  // reads and writes only its own entries here)
  float* sg = ws + w.sg + bch(d, b, c, h) * 2 * d.q * d.q;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = ty + 16 * a;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = tx + 16 * e;
      const float cb = s_m[i * kLd + j], ds = acc[a][e];
      float sv = 0.f, gv = 0.f, mv = 0.f, dg = 0.f;
      if (i < len && j <= i) {
        const float k = expf(s_cs[i] - s_cs[j]);
        const float l = k * s_gi[j];
        sv = cb * l;
        gv = ds * l;
        mv = ds * sv;
        dg = ds * cb * k;
      }
      if (i < d.q && j < d.q) {
        sg[i * d.q + j] = sv;
        sg[d.q * d.q + i * d.q + j] = gv;
      }
      acc[a][e] = mv;
      s_m[i * kLd + j] = dg;
    }
  }
  __syncthreads();
  float dgi_col = 0.f;
  if (threadIdx.x < kMaxChunk) {
    for (int i = 0; i < kMaxChunk; ++i) dgi_col += s_m[i * kLd + threadIdx.x];
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int e = 0; e < 8; ++e) s_m[(ty + 16 * a) * kLd + tx + 16 * e] = acc[a][e];
  __syncthreads();
  // column suffix sums in place: s_m[i][j] = sum over i' >= i of (dS o S)_i'j
  if (threadIdx.x < kMaxChunk) {
    float suffix = 0.f;
    for (int i = kMaxChunk - 1; i >= 0; --i) {
      suffix += s_m[i * kLd + threadIdx.x];
      s_m[i * kLd + threadIdx.x] = suffix;
    }
  }
  __syncthreads();
  // the pairs straddling step t (i >= t > j): row t of the suffixes over j < t
  if (threadIdx.x < len) {
    float r = 0.f;
    for (int j = 0; j < static_cast<int>(threadIdx.x); ++j) r += s_m[threadIdx.x * kLd + j];
    float* sw = ws + w.stepw + bch(d, b, c, h) * 2 * d.q;
    sw[threadIdx.x] = r;
    sw[d.q + threadIdx.x] = dgi_col;
  }
}

// 3. dx = S^T dy + diag(w) B dH + D dy for 32 columns of P of one chunk and
// head, as 8 x 2 register tiles over the chunk's 128 rows: S slabs as they
// lie in the workspace (rows i, columns j), B slabs transposed into (n, j).
// The block's sum of x o dy goes to its slot of dD's parts.
constexpr int kLdRows = kMaxChunk + 4;   // a staged slab's row of 128 chunk rows

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dx_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ gi,
          const T* __restrict__ bmat, const float* __restrict__ dvec,
          float* __restrict__ ws, T* __restrict__ dx, Workspace w, Dims d) {
  __shared__ float s_cs[kMaxChunk], s_gi[kMaxChunk];
  __shared__ __align__(16) float s_a[kK * kLdRows];
  __shared__ __align__(16) float s_x[kK * kTile];
  __shared__ float s_red[kThreads];
  const int pt = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / d.nh, h = blockIdx.z % d.nh, g = h / d.rep;
  const int t0 = c * d.q, len = min(d.q, d.s - t0);
  const int p0 = pt * kTile;
  const TileThread t = tile_thread<8>();
  chunk_load(d, ws + w.cs, gi, b, c, h, len, s_cs, s_gi);
  const float last = s_cs[len - 1];
  const float* sg = ws + w.sg + bch(d, b, c, h) * 2 * d.q * d.q;
  const float* dh = ws + w.dhs + bch(d, b, c, h) * d.n * d.p;
  float acc[8][2] = {}, acc2[8][2] = {};
  for (int i0 = 0; i0 < len; i0 += kK) {
    __syncthreads();
    #pragma unroll 4
    for (int e = threadIdx.x; e < kK * kMaxChunk; e += kThreads) {
      const int ii = e / kMaxChunk, j = e % kMaxChunk, i = i0 + ii;
      s_a[ii * kLdRows + j] = (i < len && j < len) ? sg[i * d.q + j] : 0.f;
    }
    #pragma unroll 4
    for (int e = threadIdx.x; e < kK * kTile; e += kThreads) {
      const int ii = e / kTile, cc = e % kTile, i = i0 + ii, pp = p0 + cc;
      s_x[e] = (i < len && pp < d.p) ? to_f(dy[row(d, b, t0 + i, h) * d.p + pp]) : 0.f;
    }
    __syncthreads();
    tile_fma<8>(s_a, kLdRows, s_x, kTile, t, acc);
  }
  for (int n0 = 0; n0 < d.n; n0 += kK) {
    __syncthreads();
    #pragma unroll 4
    for (int e = threadIdx.x; e < kMaxChunk * kK; e += kThreads) {
      const int j = e / kK, k = e % kK, n = n0 + k;
      s_a[k * kLdRows + j] = (j < len && n < d.n) ? to_f(bmat[grow(d, b, t0 + j, g) + n]) : 0.f;
    }
    #pragma unroll 4
    for (int e = threadIdx.x; e < kK * kTile; e += kThreads) {
      const int k = e / kTile, cc = e % kTile, n = n0 + k, pp = p0 + cc;
      s_x[e] = (n < d.n && pp < d.p) ? dh[static_cast<long long>(n) * d.p + pp] : 0.f;
    }
    __syncthreads();
    tile_fma<8>(s_a, kLdRows, s_x, kTile, t, acc2);
  }
  const float dd = dvec != nullptr ? dvec[h] : 0.f;
  float xdy = 0.f;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = t.r0 + r;
    if (j >= len) continue;
    const float wj = expf(last - s_cs[j]) * s_gi[j];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int p = p0 + t.c0 + cc;
      if (p < d.p) {
        const long long at = row(d, b, t0 + j, h) * d.p + p;
        const float dyv = to_f(dy[at]);
        store(dx + at, acc[r][cc] + wj * acc2[r][cc] + dd * dyv);
        xdy += to_f(x[at]) * dyv;
      }
    }
  }
  s_red[threadIdx.x] = xdy;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int i = 0; i < kThreads; ++i) tot += s_red[i];
    ws[w.ddp + bch(d, b, c, h) * d.pt + pt] = tot;
  }
}

// The sum of v over the 16 lanes of a half warp (a xor butterfly: every lane
// gets the same bits).
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 4. One head's dB = G^T C + diag(w) x dH^T and dC = G B + diag(e) dy H^T
// for 32 columns of N of one chunk, as 8 x 2 register tiles over the chunk's
// 128 rows.  While x dH^T and dy H^T stream over P, the block also adds its
// part of <H, dH>; the rows' parts of u (B . x dH^T) and of C . (e dy H^T)
// are half-warp sums (a half warp owns whole rows of the tile).
constexpr int kLdCols = kTile + 2;   // a staged slab's row of 32 columns (even, for float2)

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dbc_kernel(const T* __restrict__ x, const T* __restrict__ dy, const float* __restrict__ gi,
           const T* __restrict__ bmat, const T* __restrict__ cmat,
           float* __restrict__ ws, Workspace w, Dims d) {
  __shared__ float s_cs[kMaxChunk], s_gi[kMaxChunk];
  __shared__ __align__(16) float s_a[kK * kLdRows];    // x^T; then G or G^T slabs
  __shared__ __align__(16) float s_a2[kK * kLdRows];   // dy^T
  __shared__ __align__(16) float s_x[kK * kLdCols];    // dH^T; then C or B slabs
  __shared__ __align__(16) float s_x2[kK * kLdCols];   // H^T
  __shared__ float s_red[kThreads];
  const int nt = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / d.nh, h = blockIdx.z % d.nh, g = h / d.rep;
  const int t0 = c * d.q, len = min(d.q, d.s - t0);
  const int n0 = nt * kTile;
  const TileThread t = tile_thread<8>();
  chunk_load(d, ws + w.cs, gi, b, c, h, len, s_cs, s_gi);
  const float last = s_cs[len - 1];
  const float* hin = ws + w.hs + bch(d, b, c, h) * d.n * d.p;
  const float* dh = ws + w.dhs + bch(d, b, c, h) * d.n * d.p;
  float av[8][2] = {}, aw[8][2] = {};
  float hdh = 0.f;
  for (int p0 = 0; p0 < d.p; p0 += kK) {
    __syncthreads();
    #pragma unroll 4
    for (int e = threadIdx.x; e < kMaxChunk * kK; e += kThreads) {
      const int j = e / kK, k = e % kK, pp = p0 + k;
      const bool in = j < len && pp < d.p;
      const long long at = row(d, b, t0 + j, h) * d.p + pp;
      s_a[k * kLdRows + j] = in ? to_f(x[at]) : 0.f;
      s_a2[k * kLdRows + j] = in ? to_f(dy[at]) : 0.f;
    }
    #pragma unroll 4
    for (int e = threadIdx.x; e < kTile * kK; e += kThreads) {
      const int nn = e / kK, k = e % kK, nr = n0 + nn, pp = p0 + k;
      float ho = 0.f, hi = 0.f;
      if (nr < d.n && pp < d.p) {
        const long long at = static_cast<long long>(nr) * d.p + pp;
        ho = dh[at];
        hi = hin[at];
      }
      s_x[k * kLdCols + nn] = ho;
      s_x2[k * kLdCols + nn] = hi;
      hdh += ho * hi;
    }
    __syncthreads();
    tile_fma<8>(s_a, kLdRows, s_x, kLdCols, t, av);
    tile_fma<8>(s_a2, kLdRows, s_x2, kLdCols, t, aw);
  }
  // parts of u and of the y_off term, and the weighted starts of dB and dC
  float* part = ws + w.part + (bch(d, b, c, h) * d.nt + nt) * 2 * d.q;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = t.r0 + r;
    float u = 0.f, yo = 0.f, wj = 0.f, e = 0.f;
    if (j < len) {
      e = expf(s_cs[j]);
      wj = expf(last - s_cs[j]) * s_gi[j];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int n = n0 + t.c0 + cc;
        if (n < d.n) {
          u += to_f(bmat[grow(d, b, t0 + j, g) + n]) * av[r][cc];
          yo += to_f(cmat[grow(d, b, t0 + j, g) + n]) * e * aw[r][cc];
        }
      }
    }
    u = half_warp_sum(u);
    yo = half_warp_sum(yo);
    if (t.c0 == 0 && j < d.q) {
      part[j] = u;
      part[d.q + j] = yo;
    }
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      av[r][cc] *= wj;
      aw[r][cc] *= e;
    }
  }
  // dB_j += sum_i G_ij C_i: G rows as they lie (i, j), C slabs (i, n)
  const float* gm = ws + w.sg + bch(d, b, c, h) * 2 * d.q * d.q + d.q * d.q;
  for (int i0 = 0; i0 < len; i0 += kK) {
    __syncthreads();
    #pragma unroll 4
    for (int e = threadIdx.x; e < kK * kMaxChunk; e += kThreads) {
      const int ii = e / kMaxChunk, j = e % kMaxChunk, i = i0 + ii;
      s_a[ii * kLdRows + j] = (i < len && j < len) ? gm[i * d.q + j] : 0.f;
    }
    #pragma unroll 4
    for (int e = threadIdx.x; e < kK * kTile; e += kThreads) {
      const int ii = e / kTile, nn = e % kTile, i = i0 + ii, nr = n0 + nn;
      s_x[ii * kLdCols + nn] = (i < len && nr < d.n) ? to_f(cmat[grow(d, b, t0 + i, g) + nr])
                                                     : 0.f;
    }
    __syncthreads();
    tile_fma<8>(s_a, kLdRows, s_x, kLdCols, t, av);
  }
  // dC_i += sum_j G_ij B_j: G transposed into (j, i), B slabs (j, n)
  for (int j0 = 0; j0 < len; j0 += kK) {
    __syncthreads();
    #pragma unroll 4
    for (int e = threadIdx.x; e < kMaxChunk * kK; e += kThreads) {
      const int i = e / kK, jj = e % kK, j = j0 + jj;
      s_a[jj * kLdRows + i] = (i < len && j < len) ? gm[i * d.q + j] : 0.f;
    }
    #pragma unroll 4
    for (int e = threadIdx.x; e < kK * kTile; e += kThreads) {
      const int jj = e / kTile, nn = e % kTile, j = j0 + jj, nr = n0 + nn;
      s_x[jj * kLdCols + nn] = (j < len && nr < d.n) ? to_f(bmat[grow(d, b, t0 + j, g) + nr])
                                                     : 0.f;
    }
    __syncthreads();
    tile_fma<8>(s_a, kLdRows, s_x, kLdCols, t, aw);
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int j = t.r0 + r;
    if (j >= len) continue;
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int n = n0 + t.c0 + cc;
      if (n < d.n) {
        const long long at = row(d, b, t0 + j, h) * d.n + n;
        ws[w.dbh + at] = av[r][cc];
        ws[w.dch + at] = aw[r][cc];
      }
    }
  }
  s_red[threadIdx.x] = hdh;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int i = 0; i < kThreads; ++i) tot += s_red[i];
    ws[w.hdh + bch(d, b, c, h) * d.nt + nt] = tot;
  }
}

// 5. Per (chunk, head, batch), thread j = step: the parts over N tiles added
// in order; dgi; dld_t, the reverse cumulative sum of dcs taken term by term
// so that nothing cancels: the straddling pairs' sum (scores kernel), the
// y_off terms from t on, the chunk-state terms w_j u_j before t, and the
// chunk decay's exp(cs_last) <H, dH> (one thread, step order).
__global__ void __launch_bounds__(kMaxChunk)
finish_kernel(const float* __restrict__ gi, const float* __restrict__ ws, float* __restrict__ dld, float* __restrict__ dgi,
              Workspace w, Dims d) {
  __shared__ float s_cs[kMaxChunk], s_gi[kMaxChunk], s_t[kMaxChunk], s_y[kMaxChunk];
  __shared__ float s_decay_term;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int t0 = c * d.q, len = min(d.q, d.s - t0);
  chunk_load(d, ws + w.cs, gi, b, c, h, len, s_cs, s_gi);
  const float last = s_cs[len - 1];
  const long long slot = bch(d, b, c, h);
  const int j = threadIdx.x;
  float dg = 0.f;
  if (j < len) {
    float u = 0.f, yo = 0.f;
    for (int t = 0; t < d.nt; ++t) {
      const float* part = ws + w.part + (slot * d.nt + t) * 2 * d.q;
      u += part[j];
      yo += part[d.q + j];
    }
    const float el = expf(last - s_cs[j]);
    dg = ws[w.stepw + slot * 2 * d.q + d.q + j] + el * u;
    s_t[j] = el * s_gi[j] * u;
    s_y[j] = yo;
  }
  __syncthreads();
  if (j == 0) {
    float hdh = 0.f;
    for (int t = 0; t < d.nt; ++t) hdh += ws[w.hdh + slot * d.nt + t];
    s_decay_term = expf(last) * hdh;
    float before = 0.f;
    for (int i = 0; i < len; ++i) {   // s_t -> sum over steps before i
      const float t = s_t[i];
      s_t[i] = before;
      before += t;
    }
    float from = 0.f;
    for (int i = len - 1; i >= 0; --i) {   // s_y -> sum over steps from i on
      from += s_y[i];
      s_y[i] = from;
    }
  }
  __syncthreads();
  if (j < len) {
    const long long at = row(d, b, t0 + j, h);
    dld[at] = ws[w.stepw + slot * 2 * d.q + j] + s_y[j] + s_t[j] + s_decay_term;
    dgi[at] = dg;
  }
}

// 6. dB and dC: each group's heads added in head order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
reduce_bc_kernel(const float* __restrict__ ws, T* __restrict__ db, T* __restrict__ dc, Workspace w,
                 Dims d) {
  const long long total = static_cast<long long>(d.b) * d.s * d.ng * d.n;
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    const int n = static_cast<int>(e % d.n);
    const long long bsg = e / d.n;
    const int g = static_cast<int>(bsg % d.ng);
    const long long bs = bsg / d.ng;
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < d.rep; ++r) {
      const long long at = (bs * d.nh + g * d.rep + r) * d.n + n;
      sb += ws[w.dbh + at];
      sc += ws[w.dch + at];
    }
    store(db + e, sb);
    store(dc + e, sc);
  }
}

// 7. dD: per head, the dx blocks' parts added in (batch, chunk, tile) order.
__global__ void __launch_bounds__(kThreads)
reduce_d_kernel(const float* __restrict__ ws, float* __restrict__ dd, Workspace w, Dims d) {
  for (int h = threadIdx.x; h < d.nh; h += kThreads) {
    float t = 0.f;
    for (int b = 0; b < d.b; ++b)
      for (int c = 0; c < d.nc; ++c)
        for (int k = 0; k < d.pt; ++k) t += ws[w.ddp + bch(d, b, c, h) * d.pt + k];
    dd[h] = t;
  }
}

// ranges the wide route splits a chunk's score sums into: enough blocks for
// two on every SM, at most 16
inline int scores_splits(int route, int chunk_heads) {
  if (route != kWide) return 1;
  const int ks = cdiv(264, chunk_heads);
  return ks < 1 ? 1 : (ks > 16 ? 16 : ks);
}

// the error of the launch just made, reported with the kernel's name
inline cudaError_t launched(const char* kernel) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    fprintf(stderr, "ssm_scan_backward: %s failed to launch: %s\n", kernel,
            cudaGetErrorString(err));
  }
  return err;
}

template <typename T>
cudaError_t launch(const void* dy, const float* dh_final, const void* x, const float* ld,
                   const float* gi, const void* bmat, const void* cmat, const float* dvec,
                   const float* h0, void* dx, float* dld, float* dgi, void* db, void* dc,
                   float* dd, float* dh0, float* ws, const Dims& d, int route, cudaStream_t st) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(scores_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           scores_smem_floats() * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const Workspace w = workspace(d);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const T* bt = static_cast<const T*>(bmat);
  const T* ct = static_cast<const T*>(cmat);
  cudaError_t err;
  const long long slots = static_cast<long long>(d.b) * d.nc * d.nh;
  cumsum_kernel<<<static_cast<unsigned>((slots + kCumsumWarps - 1) / kCumsumWarps), kThreads, 0,
                  st>>>(ld, ws + w.cs, d);
  if ((err = launched("cumsum")) != cudaSuccess) return err;
  if (route == kNarrow && d.n > kWideRows) {   // one block holds all 65-128 rows
    const dim3 grid(d.pt, 1, 2 * d.b * d.nh);
    state_pass_kernel<T, 8><<<grid, kThreads, 0, st>>>(xt, dyt, ws + w.cs, gi, bt, ct, h0,
                                                       dh_final, ws + w.hs, ws + w.dhs, dh0, d);
  } else {   // narrow up to 64 rows: one tile; wide: tiles of 64 rows across blocks
    const dim3 grid(d.pt, cdiv(d.n, kWideRows), 2 * d.b * d.nh);
    state_pass_kernel<T, kWideRows / 16><<<grid, kThreads, 0, st>>>(
        xt, dyt, ws + w.cs, gi, bt, ct, h0, dh_final, ws + w.hs, ws + w.dhs, dh0, d);
  }
  if ((err = launched("state_pass")) != cudaSuccess) return err;
  if (d.ks > 1) {
    scores_part_kernel<T><<<dim3(d.nc * d.ks, d.nh, d.b), kThreads, 0, st>>>(xt, dyt, bt, ct, ws,
                                                                              w, d);
    if ((err = launched("scores_part")) != cudaSuccess) return err;
  }
  scores_kernel<T><<<dim3(d.nc, d.nh, d.b), kThreads,
                     scores_smem_floats() * sizeof(float), st>>>(xt, dyt, gi, bt, ct, ws, w,
                                                                 d);
  if ((err = launched("scores")) != cudaSuccess) return err;
  dx_kernel<T><<<dim3(d.pt, d.nc, d.nh * d.b), kThreads, 0, st>>>(
      xt, dyt, gi, bt, dvec, ws, static_cast<T*>(dx), w, d);
  if ((err = launched("dx")) != cudaSuccess) return err;
  dbc_kernel<T><<<dim3(d.nt, d.nc, d.nh * d.b), kThreads, 0, st>>>(xt, dyt, gi, bt, ct, ws,
                                                                   w, d);
  if ((err = launched("dbc")) != cudaSuccess) return err;
  finish_kernel<<<dim3(d.nc, d.nh, d.b), kMaxChunk, 0, st>>>(gi, ws, dld, dgi, w, d);
  if ((err = launched("finish")) != cudaSuccess) return err;
  const long long total = static_cast<long long>(d.b) * d.s * d.ng * d.n;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  reduce_bc_kernel<T><<<blocks, kThreads, 0, st>>>(ws, static_cast<T*>(db), static_cast<T*>(dc),
                                                   w, d);
  if ((err = launched("reduce_bc")) != cudaSuccess) return err;
  if (dd != nullptr) {
    reduce_d_kernel<<<1, kThreads, 0, st>>>(ws, dd, w, d);
    if ((err = launched("reduce_d")) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// a refused call: the reason on stderr, cudaErrorInvalidValue returned
inline int refuse(const char* what) {
  fprintf(stderr, "ssm_scan_backward: the launch plan does not fit the call: %s\n", what);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dy, dh_final (or null), x, ld, gi, B, C, D (or null), h0 (or null); dx,
// dld, dgi, dB, dC, dD (null without D), dh0 (null without h0); the f32
// workspace of ws_floats floats; the shapes; dtype (0 f32, 1 bf16), route
// (0 narrow, 1 wide) and the scores kernel's shared memory in bytes, as
// ops.py:scan_backward_plan states them.  Returns a cudaError_t.
extern "C" int repro_ssm_scan_backward(const void* dy, const void* dh_final, const void* x,
                                       const void* ld, const void* gi, const void* bmat,
                                       const void* cmat, const void* dvec, const void* h0,
                                       void* dx, void* dld, void* dgi, void* db, void* dc,
                                       void* dd, void* dh0, void* ws, long long ws_floats, int b,
                                       int s, int nh, int p, int ng, int n, int chunk, int dtype,
                                       int route, int smem, void* stream) {
  if (b <= 0 || s <= 0 || nh <= 0 || p <= 0 || ng <= 0 || nh % ng != 0 || n <= 0 ||
      n > kMaxState || chunk <= 0 || chunk > kMaxChunk || b > 65535 || nh > 65535 ||
      (dtype != 0 && dtype != 1)) {
    return refuse("shapes, chunk or dtype");
  }
  if (route != (n > kNarrowState ? kWide : kNarrow)) return refuse("route");
  if (smem != scores_smem_floats() * static_cast<int>(sizeof(float))) {
    return refuse("shared memory");
  }
  if ((dvec == nullptr) != (dd == nullptr) || (h0 == nullptr) != (dh0 == nullptr)) {
    return refuse("optional operands");
  }
  Dims d;
  d.b = b;
  d.s = s;
  d.nh = nh;
  d.p = p;
  d.ng = ng;
  d.n = n;
  d.q = chunk;
  d.nc = cdiv(s, chunk);
  d.rep = nh / ng;
  d.pt = cdiv(p, kTile);
  d.nt = cdiv(n, kTile);
  d.ks = scores_splits(route, d.b * d.nc * d.nh);
  if (d.nc > 65535 || static_cast<long long>(d.nh) * d.b * 2 > 65535 || d.pt > 65535) {
    return refuse("grid");
  }
  if (ws_floats != workspace(d).total) return refuse("workspace");
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ldf = static_cast<const float*>(ld);
  const float* gif = static_cast<const float*>(gi);
  const float* dhf = static_cast<const float*>(dh_final);
  const float* dv = static_cast<const float*>(dvec);
  const float* h0f = static_cast<const float*>(h0);
  float* wsf = static_cast<float*>(ws);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(dy, dhf, x, ldf, gif, bmat, cmat, dv, h0f, dx, static_cast<float*>(dld),
                        static_cast<float*>(dgi), db, dc, static_cast<float*>(dd),
                        static_cast<float*>(dh0), wsf, d, route, st);
  } else {
    err = launch<bf16>(dy, dhf, x, ldf, gif, bmat, cmat, dv, h0f, dx, static_cast<float*>(dld),
                       static_cast<float*>(dgi), db, dc, static_cast<float*>(dd),
                       static_cast<float*>(dh0), wsf, d, route, st);
  }
  return static_cast<int>(err);
}
