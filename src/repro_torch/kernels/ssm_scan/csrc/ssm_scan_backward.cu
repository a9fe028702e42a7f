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
// Launches over blocks that own their outputs, so no sum crosses blocks
// except through a workspace added in a fixed order: no atomics, and two
// launches give the same bits.  The dtype picks the kernels
// (ops.py:scan_backward_plan); cumsum, finish, reduce_bc and reduce_d are
// shared.
//   cumsum          each chunk's cumulative log-decay, one thread per
//                   (batch, chunk, head) in step order, read by the rest.
//   state pass      the states entering each chunk (forward from h0) and the
//                   state gradients leaving each chunk (backward from
//                   dh_final) into an f32 workspace (B, NC, H, N, P) each,
//                   one block per (column tile of P, row tile of N,
//                   direction x head x batch), the chunks in order inside
//                   the block; the backward direction writes dh0.
//   scores          per (chunk, head, batch): C B^T over N and dy x^T over P,
//                   the per-step sums of dS o S and of the dgi term, and S
//                   and G into the workspace.  On the wide route the sums
//                   over N and P first split over blocks (scores_part), and
//                   scores adds them in range order.
//   dx              per (column tile of P, chunk, head x batch): S^T dy and
//                   B dH (f32: and the block's part of dD).
//   dbc             per (column tile of N, chunk, head x batch): x dH^T and
//                   dy H^T over P (each block's part of u, of C . (e H dy)
//                   and of <H, dH>), then G^T C and G B; the head's dB and dC
//                   into an f32 workspace.
//   finish          per (chunk, head, batch): the parts over N tiles added in
//                   order, dgi, dcs and its reverse cumulative sum, dld.
//   reduce_bc       dB and dC: each group's heads added in order.
//   reduce_d        dD: the parts added in order (only with D).
//
// Routes by N: narrow (N <= 128, Mamba2) and wide (N up to 1024, the mLSTM's
// 1024 x 1025 state).
//
// bf16, the tensor cores: pad_rows (where P % 8 != 0), cumsum,
// state_pass_mma, [wide: scores_part_mma, scores], dx_mma, dbc_mma, finish,
// reduce_bc, reduce_d.  Every product runs on mma.sync.m16n8k16 with bf16
// operands fed by ldmatrix from shared rows padded by 16 bytes and f32
// sums; x, dy, B, C and the f32 states are copied by 16-byte cp.async (x and
// dy through row-padded copies in the workspace where P % 8 != 0, the
// states' rows padded to 4 floats).  An operand that is f32 (S, G, diag(w)
// B, diag(e) C, H, dH) enters as two bf16 terms (hi + lo, mma_bf16.cuh) and
// its product runs twice, as in the forward; C B^T and dy x^T are products
// of bf16 inputs.  ref.py's gated_scan_backward_mma_ref is the plain mirror
// of these roundings.  Exponents are ex2.approx.ftz: the accurate expf's
// branch for results below f32's range, which zamba2's decays reach
// (exp(cs_i - cs_j) down to e^-256), made the elementwise passes the
// kernel's slowest.  Blocks of 8 warps; warp w owns the chunk rows
// [16 w, 16 w + 16) of every row-indexed product, and the causal zeros of S
// and G are skipped a whole 16 x 16 block at a time.
//   state_pass_mma  a block owns a 64 x 64 tile of the state in registers and
//                   adds (diag(w) B)^T x or (diag(e) C)^T dy per chunk; the
//                   next chunk's slabs are copied while this one's run.
//   scores_part_mma the wide route's C B^T and dy x^T over one range of N
//                   and of P.
//   dx_mma          per 64 columns of P: S as two bf16 terms, B dH over
//                   slabs of 64 of N, then S^T dy; 105 KB of shared memory,
//                   two blocks an SM.
//   dbc_mma         per 64 columns of N: G as two bf16 terms, x dH^T and
//                   dy H^T over slabs of 64 of P, then G^T C and G B.  On the
//                   narrow route the block of the first N tile also forms
//                   C B^T and takes the per-step sums (the scores' work: that
//                   route has no scores launch) and the chunk-head's part of
//                   dD.
// On the narrow route S and G never reach device memory: dx_mma forms C B^T
// itself (whole N, at most two slabs) and dbc_mma dy x^T (over P), each on
// the tensor cores.  Holding both in one block per chunk-head would keep
// dx and dB/dC in one launch, but S and G (two bf16 terms each, 139 KB)
// beside C, B and the states' slabs exceed a block's 227 KB at N = 128;
// recomputing lets the same dx and dbc kernels serve the wide route, which
// streams N and P in slabs and reads S and G from the workspace (its 16
// chunk-heads would spend 1024-wide sums per P or N tile recomputing them).
// Bound at zamba2-1.2b's training shape: bytes (x, dy, B, C read once, the
// gradients written once: 15.96 us at 3.35 TB/s), above the ~11 us its 10.8
// GFLOP of products take at the bf16 peak; the f32 states, the heads' dB and
// dC and the launches' serial phases (one block of 8 warps an SM in
// dbc_mma) keep it well above that (PERF.md).
//
// f32, the CUDA cores (TF32 would miss the f32 tolerance): cumsum,
// state_pass, [wide: scores_part], scores, dx, dbc, finish, reduce_bc,
// reduce_d.  On the narrow route a state-pass block keeps its whole N x 32
// state tile in registers (rows rounded to 64 or 128); on the wide route N
// splits into tiles of 64 rows across blocks, and the dbc kernel's
// per-tile parts (up to 32) are added by the finish kernel.  Both stream B,
// C, x, dy and the states through shared memory in slabs of 32, as register
// tiles of 4 or 8 rows by 2 columns a thread (the scores as 8 x 8).
// A ragged last chunk is masked (its missing steps count nothing), which
// equals the plain version's padding with identity steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdio.h>

#include "mma_bf16.cuh"

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
  int mma, narrow;   // the bf16 tensor-core kernels; N <= 128
  int xp;            // the row length of the x and dy the bf16 kernels read (P padded to 8)
  int dparts;        // dD's parts per (batch, chunk, head): f32 one per P tile, bf16 one
  int sp;            // the row length of the workspace's states (bf16 route: P padded to 4)
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// offsets (floats) of the workspace's parts, the large ones first;
// ops.py:scan_backward_plan computes the same total
struct Workspace {
  long long xpad, hs, dhs, dbh, dch, sg, ssp, stepw, part, hdh, ddp, cs, total;
};

__host__ __device__ inline Workspace workspace(const Dims& d) {
  Workspace w;
  const long long bch = static_cast<long long>(d.b) * d.nc * d.nh;
  const long long state = bch * d.n * d.sp;
  const long long heads = static_cast<long long>(d.b) * d.s * d.nh * d.n;
  w.xpad = 0;   // the bf16 kernels' padded x and dy (two bf16 arrays), where P % 8 != 0
  w.hs = w.xpad + (d.xp != d.p ? static_cast<long long>(d.b) * d.s * d.nh * d.xp : 0);
  w.dhs = w.hs + state;
  w.dbh = w.dhs + state;
  w.dch = w.dbh + heads;
  w.sg = w.dch + heads;
  // S and G: the f32 kernels' and the wide route's (the bf16 narrow route
  // never writes them)
  w.ssp = w.sg + (d.mma && d.narrow ? 0 : bch * 2 * d.q * d.q);
  w.stepw = w.ssp + (d.ks > 1 ? bch * d.ks * 2 * kMaxChunk * kMaxChunk : 0);
  w.part = w.stepw + bch * 2 * d.q;
  w.hdh = w.part + bch * d.nt * 2 * d.q;
  w.ddp = w.hdh + bch * d.nt;
  w.cs = w.ddp + bch * d.dparts;
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
template <int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
state_pass_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  const float* __restrict__ csw, const float* __restrict__ gi, const float* __restrict__ bmat,
                  const float* __restrict__ cmat, const float* __restrict__ h0,
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
  const float* amat = dir == 0 ? bmat : cmat;
  const float* xmat = dir == 0 ? x : dy;
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
        s_a[e] = (j < len && n < d.n) ? amat[grow(d, b, t0 + j, g) + n] * s_coef[j] : 0.f;
      }
#pragma unroll 4
      for (int e = threadIdx.x; e < kK * kTile; e += kThreads) {
        const int jj = e / kTile, cc = e % kTile;
        const int j = j0 + jj, pp = p0 + cc;
        s_x[e] = (j < len && pp < d.p) ? xmat[row(d, b, t0 + j, h) * d.p + pp] : 0.f;
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

__global__ void __launch_bounds__(kThreads)
scores_part_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                   const float* __restrict__ bmat, const float* __restrict__ cmat,
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

__global__ void __launch_bounds__(kThreads, kMinBlocks)
dx_kernel(const float* __restrict__ x, const float* __restrict__ dy, const float* __restrict__ gi,
          const float* __restrict__ bmat, const float* __restrict__ dvec,
          float* __restrict__ ws, float* __restrict__ dx, Workspace w, Dims d) {
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
      s_x[e] = (i < len && pp < d.p) ? dy[row(d, b, t0 + i, h) * d.p + pp] : 0.f;
    }
    __syncthreads();
    tile_fma<8>(s_a, kLdRows, s_x, kTile, t, acc);
  }
  for (int n0 = 0; n0 < d.n; n0 += kK) {
    __syncthreads();
    #pragma unroll 4
    for (int e = threadIdx.x; e < kMaxChunk * kK; e += kThreads) {
      const int j = e / kK, k = e % kK, n = n0 + k;
      s_a[k * kLdRows + j] = (j < len && n < d.n) ? bmat[grow(d, b, t0 + j, g) + n] : 0.f;
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
        const float dyv = dy[at];
        dx[at] = acc[r][cc] + wj * acc2[r][cc] + dd * dyv;
        xdy += x[at] * dyv;
      }
    }
  }
  s_red[threadIdx.x] = xdy;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int i = 0; i < kThreads; ++i) tot += s_red[i];
    ws[w.ddp + bch(d, b, c, h) * d.dparts + pt] = tot;
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

__global__ void __launch_bounds__(kThreads, kMinBlocks)
dbc_kernel(const float* __restrict__ x, const float* __restrict__ dy, const float* __restrict__ gi,
           const float* __restrict__ bmat, const float* __restrict__ cmat,
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
      s_a[k * kLdRows + j] = in ? x[at] : 0.f;
      s_a2[k * kLdRows + j] = in ? dy[at] : 0.f;
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
          u += bmat[grow(d, b, t0 + j, g) + n] * av[r][cc];
          yo += cmat[grow(d, b, t0 + j, g) + n] * e * aw[r][cc];
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
      s_x[ii * kLdCols + nn] = (i < len && nr < d.n) ? cmat[grow(d, b, t0 + i, g) + nr]
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
      s_x[jj * kLdCols + nn] = (j < len && nr < d.n) ? bmat[grow(d, b, t0 + j, g) + nr]
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

// 7. dD: per head, the parts (of the f32 dx blocks, or of the bf16 dB/dC
// kernel's first N tile) added in (batch, chunk, tile) order, sixteen loads
// in flight at a time.
__global__ void __launch_bounds__(kThreads)
reduce_d_kernel(const float* __restrict__ ws, float* __restrict__ dd, Workspace w, Dims d) {
  constexpr int kBatch = 16;
  const int per_batch = d.nc * d.dparts;   // parts of one batch row
  for (int h = threadIdx.x; h < d.nh; h += kThreads) {
    float t = 0.f;
    const int total = d.b * per_batch;
    for (int k0 = 0; k0 < total; k0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 + u, b = k / per_batch, c = k % per_batch / d.dparts;
        v[u] = k < total ? ws[w.ddp + bch(d, b, c, h) * d.dparts + k % d.dparts] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) t += v[u];
    }
    dd[h] = t;
  }
}

// ------------------------------------------------------------------------
// bf16: the tensor cores
// ------------------------------------------------------------------------
constexpr int kMT = 64;                  // columns of a staged slab; a tile of P or N
constexpr int kLdt = kMT + 8;            // bf16 per shared row of a slab
constexpr int kLdq = kMaxChunk + 8;      // bf16 per shared row of S or G
constexpr int kMmaWarps = kThreads / 32;

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// dynamic shared memory (bytes) of the mma kernels; ops.py:scan_backward_plan
// states the same
constexpr int kSlabBytes = kMaxChunk * kLdt * 2;      // a (128, 64 + 8) bf16 slab
constexpr int kStateSlabBytes = kMT * kLdt * 2;       // a (64, 64 + 8) bf16 state slab
constexpr int kLdf = kMT + 4;                         // floats per shared row of an f32 state slice
constexpr int kStateF32Bytes = kMT * kLdf * 4;        // a (64, 64 + 4) f32 state slice
constexpr int kTermsBytes = 2 * kMaxChunk * kLdq * 2; // S or G as two bf16 terms
constexpr int kSumsBytes = 2 * kMmaWarps * kMaxChunk * 4;   // the warps' step-sum columns
constexpr int kChunkBytes = 2 * kMaxChunk * 4 + 2 * kMmaWarps * 4;   // cs, gi, the warps' sums
constexpr int kStateMmaBytes = 2 * (2 * kSlabBytes + 2 * kMaxChunk * 4);   // two stages
constexpr int kScoresPartBytes = 2 * kSlabBytes;
constexpr int kDxMmaBytes = kTermsBytes + 2 * kSlabBytes + kChunkBytes;
static_assert(kStateF32Bytes <= kTermsBytes && 2 * kStateSlabBytes <= kSlabBytes,
              "dx_mma's f32 dH fits in S's space, its terms in a slab");
constexpr int kDbcMmaBytes = kTermsBytes + 4 * kSlabBytes + 4 * kStateSlabBytes
                             + 2 * kStateF32Bytes + kSumsBytes + kChunkBytes;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// Rows [0, qp) x columns [0, 64) of a bf16 matrix whose row r starts at
// src + r * stride into shared rows of kLdt; rows from `valid` on and
// columns from `cols` on are zeros.  16-byte cp.async where `vec` (cols a
// multiple of 8 and every row 16-byte aligned; the caller waits), else one
// element a thread, eight loads in flight before their stores.
__device__ __noinline__ void stage_rows(bf16* dst, const bf16* __restrict__ src,
                                           long long stride, int qp, int valid, int cols,
                                           bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < qp * (kMT / 8); e += kThreads) {
      const int r = e / (kMT / 8), c = e % (kMT / 8) * 8;
      bf16* to = dst + r * kLdt + c;
      if (r < valid && c < cols) cp_async16(to, src + r * stride + c);
      else *reinterpret_cast<uint4*>(to) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const bf16 zero = __float2bfloat16(0.f);
  const int total = qp * kMT;
  for (int e0 = threadIdx.x; e0 < total; e0 += 8 * kThreads) {
    bf16 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kThreads, r = e / kMT, c = e % kMT;
      v[u] = (e < total && r < valid && c < cols) ? src[r * stride + c] : zero;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kThreads;
      if (e < total) dst[e / kMT * kLdt + e % kMT] = v[u];
    }
  }
}

// whether rows of `ld` floats from p can be read or written as float2
// pairs at even columns
__device__ __forceinline__ bool pairs_ok(const float* p, int ld) {
  return (ld & 1) == 0 && (reinterpret_cast<uintptr_t>(p) & 7) == 0;
}

// the f32 pair (src[at], src[at + 1]) of a row, zeros past `live` of them
// (at even where `pairs`)
__device__ __forceinline__ float2 load_pair(const float* __restrict__ src, long long at, int live,
                                            bool pairs) {
  if (live >= 2 && pairs) return *reinterpret_cast<const float2*>(src + at);
  return make_float2(live >= 1 ? src[at] : 0.f, live >= 2 ? src[at + 1] : 0.f);
}

// (a, b) into dst[at], dst[at + 1], the second only where `live` is 2
__device__ __forceinline__ void store_pair(float* __restrict__ dst, long long at, float a, float b,
                                           int live, bool pairs) {
  if (live >= 2 && pairs) {
    *reinterpret_cast<float2*>(dst + at) = make_float2(a, b);
  } else {
    if (live >= 1) dst[at] = a;
    if (live >= 2) dst[at + 1] = b;
  }
}

// Rows [0, 64) x columns [0, 64) of an f32 state slice (rows of `ld` floats
// from src) into shared rows of kLdf, zeros from `rows` and `cols` on:
// 16-byte cp.async where the rows allow it (the caller waits), else one
// element a thread, sixteen loads in flight before their stores.
__device__ __noinline__ void stage_f32(float* dst, const float* __restrict__ src, int ld, int rows,
                                       int cols) {
  if ((ld & 3) == 0 && (cols & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    for (int e = threadIdx.x; e < kMT * (kMT / 4); e += kThreads) {
      const int r = e / (kMT / 4), c = e % (kMT / 4) * 4;
      float* to = dst + r * kLdf + c;
      if (r < rows && c < cols) cp_async16(to, src + static_cast<long long>(r) * ld + c);
      else *reinterpret_cast<float4*>(to) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }
  constexpr int kPer = kMT * kMT / kThreads;
  float v[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + u * kThreads, r = e / kMT, c = e % kMT;
    v[u] = (r < rows && c < cols) ? src[static_cast<long long>(r) * ld + c] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + u * kThreads;
    dst[e / kMT * kLdf + e % kMT] = v[u];
  }
}

// A staged f32 state slice (dh, rows of kLdf) as two bf16 terms into shared
// rows of kLdt; with `hin` (H's slice, staged alike) also its terms, and
// the thread's part of <H, dH> over the slice is returned.
__device__ __forceinline__ float split_states(bf16* dhh, bf16* dhl, const float* dh, bf16* hh,
                                              bf16* hl, const float* hin) {
  float dot = 0.f;
  for (int e = threadIdx.x; e < kMT * (kMT / 2); e += kThreads) {
    const int r = e / (kMT / 2), c = e % (kMT / 2) * 2;
    const float2 dv = *reinterpret_cast<const float2*>(dh + r * kLdf + c);
    uint32_t hi, lo;
    split2(dv.x, dv.y, hi, lo);
    *reinterpret_cast<uint32_t*>(dhh + r * kLdt + c) = hi;
    *reinterpret_cast<uint32_t*>(dhl + r * kLdt + c) = lo;
    if (hin != nullptr) {
      const float2 hv = *reinterpret_cast<const float2*>(hin + r * kLdf + c);
      split2(hv.x, hv.y, hi, lo);
      *reinterpret_cast<uint32_t*>(hh + r * kLdt + c) = hi;
      *reinterpret_cast<uint32_t*>(hl + r * kLdt + c) = lo;
      dot += hv.x * dv.x + hv.y * dv.y;
    }
  }
  return dot;
}

// Rows [0, 64) x columns [0, 64) of an f32 state slice (rows of `ld` floats
// from dh) as two bf16 terms into shared rows of kLdt, straight from device
// memory (each thread's loads issued before its stores), rows from `rows`
// and columns from `cols` on zeros; with `hin` (the same slice of the state
// entering the chunk) also its two terms, and the thread's part of
// <H, dH> over the slice is returned.
__device__ __noinline__ float stage_states(bf16* dhh, bf16* dhl, const float* __restrict__ dh,
                                           bf16* hh, bf16* hl, const float* __restrict__ hin,
                                           int ld, int rows, int cols) {
  constexpr int kPairs = kMT * (kMT / 2) / kThreads;
  const bool dpairs = pairs_ok(dh, ld), hpairs = hin != nullptr && pairs_ok(hin, ld);
  float2 dv[kPairs], hv[kPairs];
#pragma unroll
  for (int u = 0; u < kPairs; ++u) {
    const int e = threadIdx.x + u * kThreads, r = e / (kMT / 2), c = e % (kMT / 2) * 2;
    const long long at = static_cast<long long>(r) * ld + c;
    const int live = r < rows ? min(2, cols - c) : 0;
    dv[u] = load_pair(dh, at, live, dpairs);
    hv[u] = hin != nullptr ? load_pair(hin, at, live, hpairs) : make_float2(0.f, 0.f);
  }
  float dot = 0.f;
#pragma unroll
  for (int u = 0; u < kPairs; ++u) {
    const int e = threadIdx.x + u * kThreads, r = e / (kMT / 2), c = e % (kMT / 2) * 2;
    uint32_t hi, lo;
    split2(dv[u].x, dv[u].y, hi, lo);
    *reinterpret_cast<uint32_t*>(dhh + r * kLdt + c) = hi;
    *reinterpret_cast<uint32_t*>(dhl + r * kLdt + c) = lo;
    if (hin != nullptr) {
      split2(hv[u].x, hv[u].y, hi, lo);
      *reinterpret_cast<uint32_t*>(hh + r * kLdt + c) = hi;
      *reinterpret_cast<uint32_t*>(hl + r * kLdt + c) = lo;
      dot += hv[u].x * dv[u].x + hv[u].y * dv[u].y;
    }
  }
  return dot;
}

// The chunk's cumulative log-decay (cumsum_kernel's) and input scales by
// 4-byte cp.async into cs and gis, zeros from len to the chunk's end (the
// caller waits)
__device__ __forceinline__ void chunk_issue(const Dims& d, const float* __restrict__ csw,
                                            const float* __restrict__ gi, int b, int c, int h,
                                            int len, float* cs, float* gis) {
  const float* src = csw + bch(d, b, c, h) * d.q;
  for (int i = threadIdx.x; i < kMaxChunk; i += kThreads) {
    if (i < len) {
      cp_async4(cs + i, src + i);
      cp_async4(gis + i, gi + row(d, b, c * d.q + i, h));
    } else {
      cs[i] = gis[i] = 0.f;
    }
  }
}

// S or G of a chunk-head from the workspace (rows of q floats) as two bf16
// terms into shared rows of kLdq: rows and columns [0, qp), zeros from len
// on; eight pairs in flight before their stores
__device__ __noinline__ void stage_terms(bf16* hi, bf16* lo, const float* __restrict__ src,
                                            int q, int qp, int len) {
  const int half = qp / 2, total = qp * half;
  const bool pairs = pairs_ok(src, q);
  for (int e0 = threadIdx.x; e0 < total; e0 += 8 * kThreads) {
    float2 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kThreads, r = e / half, c = e % half * 2;
      v[u] = load_pair(src, static_cast<long long>(r) * q + c,
                       e < total && r < len ? min(2, len - c) : 0, pairs);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int e = e0 + u * kThreads, r = e / half, c = e % half * 2;
      if (e < total) {
        uint32_t h, l;
        split2(v[u].x, v[u].y, h, l);
        *reinterpret_cast<uint32_t*>(hi + r * kLdq + c) = h;
        *reinterpret_cast<uint32_t*>(lo + r * kLdq + c) = l;
      }
    }
  }
}

// The warp's 16 rows (from i0) of U V^T over columns [lo, hi) of U and V
// (bf16 rows of `stride` elements from u and v, one per chunk step), for
// the column blocks kt < nkt (16 columns each: the blocks on or below the
// warp's diagonal), added to acc; U and V staged in slabs of 64 through
// s_u and s_v, or already there (`staged`: one slab, its copies issued by
// the caller).  Every thread calls it: it starts with a barrier and ends
// with the slabs in use.
__device__ __forceinline__ void gram_mma(float (&acc)[8][2][4], const bf16* __restrict__ u,
                                         const bf16* __restrict__ v, long long stride, int lo,
                                         int hi, int qp, int len, bf16* s_u, bf16* s_v, int nkt,
                                         int i0, int lane, bool vec, bool staged) {
  #pragma unroll 1
  for (int c0 = lo; c0 < hi; c0 += kMT) {
    const int cols = min(kMT, hi - c0);
    __syncthreads();   // the previous slab (or the caller's use of s_u, s_v) is done
    if (!staged) {
      stage_rows(s_u, u + c0, stride, qp, len, cols, vec);
      stage_rows(s_v, v + c0, stride, qp, len, cols, vec);
    }
    cp_async_wait_all();
    __syncthreads();
    if (nkt == 0) continue;
    for (int k0 = 0; k0 < cols; k0 += 16) {
      uint32_t ua[4];
      ldsm_x4(ua, s_u + (i0 + (lane & 15)) * kLdt + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int kt = 0; kt < 8; ++kt) {
        if (kt < nkt) {
          uint32_t bf[4];
          ldsm_x4(bf, s_v + (kt * 16 + (lane & 7) + (lane >> 4) * 8) * kLdt + k0 +
                          ((lane >> 3) & 1) * 8);
          mma_bf16(acc[kt][0], ua, bf[0], bf[1]);
          mma_bf16(acc[kt][1], ua, bf[2], bf[3]);
        }
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[8][2][4]) {
#pragma unroll
  for (int kt = 0; kt < 8; ++kt)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[kt][u][e] = 0.f;
}

// the warp's accumulators (rows i0 + g8 and + 8, columns 16 kt + 8 u + 2 t4
// and + 1: all 128 columns) into rows of `ld` floats
__device__ __forceinline__ void park(const float (&acc)[8][2][4], float* dst, int ld, int i0,
                                     int lane) {
  const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kt = 0; kt < 8; ++kt)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dst[(i0 + g8 + (e >> 1) * 8) * ld + kt * 16 + u * 8 + 2 * t4 + (e & 1)] = acc[kt][u][e];
      }
}

// The warp's rows of C B^T or dS (accumulators: rows i0 + g8 and + 8, columns
// 16 kt + 8 u + 2 t4 and + 1) times the decay
// mask L_ij = exp(cs_i - cs_j) gi_j (j <= i < len, else 0): S or G, as two
// bf16 terms into shared rows of kLdq
__device__ __forceinline__ void masked_terms(const float (&acc)[8][2][4], bf16* hi, bf16* lo,
                                             const float* cs, const float* gis, int i0, int len,
                                             int lane) {
  const int g8 = lane >> 2, t4 = lane & 3, diag = i0 / 16;   // blocks kt > diag are zeros
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = i0 + g8 + 8 * hf;
    const float csi = i < len ? cs[i] : 0.f;
#pragma unroll
    for (int kt = 0; kt < 8; ++kt)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = kt * 16 + u * 8 + 2 * t4;
        uint32_t h = 0u, l = 0u;
        if (kt <= diag) {
          const float v0 = (i < len && j <= i)
                               ? acc[kt][u][2 * hf] * (exp_ftz(csi - cs[j]) * gis[j]) : 0.f;
          const float v1 = (i < len && j + 1 <= i)
                               ? acc[kt][u][2 * hf + 1] * (exp_ftz(csi - cs[j + 1]) * gis[j + 1])
                               : 0.f;
          split2(v0, v1, h, l);
        }
        *reinterpret_cast<uint32_t*>(hi + i * kLdq + j) = h;
        *reinterpret_cast<uint32_t*>(lo + i * kLdq + j) = l;
      }
  }
}

// G's terms and the per-step sums of a chunk-head, from its dS and C B^T
// (the warp's accumulators: rows i0 + g8 and + 8, columns 16 kt + 8 u + 2 t4
// and + 1).  With L_ij = exp(cs_i - cs_j) gi_j (j <= i < len, else 0),
// G = dS o L goes to shared memory as two bf16 terms (as masked_terms
// writes it), and with m = dS o S (S = C B^T o L):
//   straddle_t = sum over i >= t > j of m_ij = sum over rows i >= t of the
//                row's exclusive prefix P_i(t) = sum over j < t of m_ij,
//   dgi_t      = sum over i of dS_it C B^T_it exp(cs_i - cs_t).
// A row's 128 columns lie in the four lanes of a quad, two to a lane in each
// n8 tile; P_i runs over the tiles in order, inside a tile over the quad's
// lanes in order (shuffles from each lane, added in lane order, so all four
// lanes hold the same bits).  The column sums go over the thread's two rows,
// the warp's eight row groups (a xor butterfly over lane bits 2-4) and the
// warps in order.  Tiles right of the warp's diagonal block hold zeros and
// are skipped.  Writes (straddle, dgi) to sw[t] and sw[q + t].
__device__ __forceinline__ void sums_and_terms(const float (&ds)[8][2][4],
                                               const float (&cb)[8][2][4], bf16* ghi, bf16* glo,
                                               float* s_st, float* s_dg, const float* s_cs,
                                               const float* s_gi, float* __restrict__ sw, int q,
                                               int i0, int len, int warp, int lane) {
  const int g8 = lane >> 2, t4 = lane & 3, quad = lane & ~3;
  float base[2] = {0.f, 0.f};   // each row's sum over the tiles before this one
#pragma unroll
  for (int kt = 0; kt < 8; ++kt)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = kt * 16 + u * 8 + 2 * t4;   // this lane's first column
      if (kt > warp) {   // right of the warp's diagonal block: G = m = 0, and t > i
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int i = i0 + g8 + 8 * hf;
          *reinterpret_cast<uint32_t*>(ghi + i * kLdq + j) = 0u;
          *reinterpret_cast<uint32_t*>(glo + i * kLdq + j) = 0u;
        }
        if (g8 == 0) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s_st[warp * kMaxChunk + j + e] = 0.f;
            s_dg[warp * kMaxChunk + j + e] = 0.f;
          }
        }
        continue;
      }
      float st[2] = {0.f, 0.f}, dg[2] = {0.f, 0.f};   // this lane's two columns
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = i0 + g8 + 8 * hf;
        float m[2], gv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          m[e] = gv[e] = 0.f;
          if (i < len && j + e <= i) {
            const float kd = exp_ftz(s_cs[i] - s_cs[j + e]);
            const float l = kd * s_gi[j + e], d = ds[kt][u][2 * hf + e], c = cb[kt][u][2 * hf + e];
            gv[e] = d * l;
            m[e] = d * (c * l);
            dg[e] += d * c * kd;
          }
        }
        uint32_t h, lo;
        split2(gv[0], gv[1], h, lo);
        *reinterpret_cast<uint32_t*>(ghi + i * kLdq + j) = h;
        *reinterpret_cast<uint32_t*>(glo + i * kLdq + j) = lo;
        const float pair = m[0] + m[1];
        float lanes[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) lanes[k] = __shfl_sync(0xffffffffu, pair, quad | k);
        float before = base[hf];   // P_i at this lane's first column
#pragma unroll
        for (int k = 0; k < 3; ++k) before += k < t4 ? lanes[k] : 0.f;
        if (i >= j) st[0] += before;
        if (i >= j + 1) st[1] += before + m[0];
        base[hf] += ((lanes[0] + lanes[1]) + lanes[2]) + lanes[3];
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float a = st[e], b = dg[e];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          a += __shfl_xor_sync(0xffffffffu, a, o);
          b += __shfl_xor_sync(0xffffffffu, b, o);
        }
        if (g8 == 0) {
          s_st[warp * kMaxChunk + j + e] = a;
          s_dg[warp * kMaxChunk + j + e] = b;
        }
      }
    }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) < len) {
    float a = 0.f, b = 0.f;
    for (int w = 0; w < kMmaWarps; ++w) {
      a += s_st[w * kMaxChunk + threadIdx.x];
      b += s_dg[w * kMaxChunk + threadIdx.x];
    }
    sw[threadIdx.x] = a;
    sw[q + threadIdx.x] = b;
  }
}

// the block's sums of each thread's a and b into *oa and *ob (b's only
// where ob is not null): each warp's by a xor butterfly (every lane gets the
// same bits), then the warps' in order
__device__ __forceinline__ void block_sums(float a, float b, float* s_red, float* __restrict__ oa,
                                           float* __restrict__ ob) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  if ((threadIdx.x & 31) == 0) {
    s_red[threadIdx.x >> 5] = a;
    s_red[kMmaWarps + (threadIdx.x >> 5)] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float ta = 0.f, tb = 0.f;
    for (int i = 0; i < kMmaWarps; ++i) {
      ta += s_red[i];
      tb += s_red[kMmaWarps + i];
    }
    *oa = ta;
    if (ob != nullptr) *ob = tb;
  }
}

// 0 (bf16, P not a multiple of 8). x and dy with rows padded to a multiple
// of 8 (zeros past P) into the workspace, so every kernel stages their slabs
// by 16-byte cp.async: the mLSTM's P = 1025 rows are 2050 bytes apart
__global__ void __launch_bounds__(kThreads)
pad_rows_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy, bf16* __restrict__ xp,
                bf16* __restrict__ dyp, Dims d) {
  const long long total = static_cast<long long>(d.b) * d.s * d.nh * d.xp;
  const bf16 zero = __float2bfloat16(0.f);
  for (long long e = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    const long long r = e / d.xp;
    const int c = static_cast<int>(e % d.xp);
    xp[e] = c < d.p ? x[r * d.p + c] : zero;
    dyp[e] = c < d.p ? dy[r * d.p + c] : zero;
  }
}

// 1 (bf16). States forward (dir 0) and state gradients backward (dir 1), a
// 64 x 64 tile of the state per block in registers: warp w owns rows
// 16 (w % 4) and 32 columns from 32 (w / 4), as four m16n8 accumulators.
// Per chunk it writes the state it enters with, then adds A^T X over the
// chunk's steps: A = diag(w) B or diag(e) C (staged bf16, scaled and split
// into two terms as its fragment is built), X = x or dy.  The next chunk's
// slabs, log-decays and input scales are staged (two stages) while this
// chunk's products run.
__device__ __forceinline__ void state_stage(bf16* s_a, bf16* s_x, float* s_cs, float* s_coef,
                                            const bf16* amat, const bf16* xmat,
                                            const float* __restrict__ csw,
                                            const float* __restrict__ gi, const Dims& d, int b,
                                            int c, int h, int g, int n0, int p0, int vec) {
  const int t0 = c * d.q, len = min(d.q, d.s - t0), qp = round16(len);
  stage_rows(s_a, amat + grow(d, b, t0, g) + n0, static_cast<long long>(d.ng) * d.n, qp, len,
             min(kMT, d.n - n0), vec & 2);
  stage_rows(s_x, xmat + row(d, b, t0, h) * d.xp + p0, static_cast<long long>(d.nh) * d.xp, qp,
             len, min(kMT, d.p - p0), vec & 1);
  chunk_issue(d, csw, gi, b, c, h, len, s_cs, s_coef);
}

__global__ void __launch_bounds__(kThreads, 2)
state_pass_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                      const float* __restrict__ csw, const float* __restrict__ gi,
                      const bf16* __restrict__ bmat, const bf16* __restrict__ cmat,
                      const float* __restrict__ h0, const float* __restrict__ dh_final,
                      float* __restrict__ hs, float* __restrict__ dhs, float* __restrict__ dh0,
                      Dims d, int vec) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const int bh = blockIdx.z % (d.b * d.nh);
  const int dir = blockIdx.z / (d.b * d.nh);
  const int b = bh / d.nh, h = bh % d.nh, g = h / d.rep;
  const int p0 = blockIdx.x * kMT, n0 = blockIdx.y * kMT;
  const int lane = threadIdx.x & 31, warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int g8 = lane >> 2, t4 = lane & 3;
  const int m0 = 16 * (warp & 3), c0 = 32 * (warp >> 2);
  const bf16* amat = dir == 0 ? bmat : cmat;
  const bf16* xmat = dir == 0 ? x : dy;
  const float* init = dir == 0 ? h0 : dh_final;
  const long long hbase = (static_cast<long long>(b) * d.nh + h) * d.n * d.p;
  // stage k: its A and X slabs, then its log-decays and coefficients
  constexpr int kStage = 2 * kSlabBytes + 2 * kMaxChunk * 4;
  auto slab_a = [&](int k) { return reinterpret_cast<bf16*>(smem_mma + k * kStage); };
  auto slab_x = [&](int k) { return reinterpret_cast<bf16*>(smem_mma + k * kStage + kSlabBytes); };
  auto cs_of = [&](int k) {
    return reinterpret_cast<float*>(smem_mma + k * kStage + 2 * kSlabBytes);
  };
  float st[4][4];
  const bool pairs = (d.sp & 1) == 0;
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + m0 + g8 + (e >> 1) * 8, p = p0 + c0 + 8 * t + 2 * t4 + (e & 1);
      st[t][e] = (init != nullptr && n < d.n && p < d.p)
                     ? init[hbase + static_cast<long long>(n) * d.p + p] : 0.f;
    }
  {
    const int c = dir == 0 ? 0 : d.nc - 1;
    state_stage(slab_a(0), slab_x(0), cs_of(0), cs_of(0) + kMaxChunk, amat, xmat, csw, gi, d, b,
                c, h, g, n0, p0, vec);
  }
  #pragma unroll 1
  for (int step = 0; step < d.nc; ++step) {
    const int k = step & 1;
    const int c = dir == 0 ? step : d.nc - 1 - step;
    const int len = min(d.q, d.s - c * d.q), qp = round16(len);
    float* out = (dir == 0 ? hs : dhs) + bch(d, b, c, h) * d.n * d.sp;
    const bool opairs = pairs && ((reinterpret_cast<uintptr_t>(out) & 7) == 0);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = n0 + m0 + g8 + hf * 8, p = p0 + c0 + 8 * t + 2 * t4;
        if (n < d.n) {
          store_pair(out, static_cast<long long>(n) * d.sp + p, st[t][2 * hf], st[t][2 * hf + 1],
                     min(2, d.p - p), opairs);
        }
      }
    cp_async_wait_all();
    __syncthreads();   // stage k is in; the other stage's readers are done
    if (step + 1 < d.nc) {
      const int cn = dir == 0 ? step + 1 : d.nc - 2 - step;
      state_stage(slab_a(k ^ 1), slab_x(k ^ 1), cs_of(k ^ 1), cs_of(k ^ 1) + kMaxChunk, amat,
                  xmat, csw, gi, d, b, cn, h, g, n0, p0, vec);
    }
    const float* s_cs = cs_of(k);
    float* s_coef = cs_of(k) + kMaxChunk;
    const float last = s_cs[len - 1];
    for (int i = threadIdx.x; i < qp; i += kThreads) {
      if (i < len) s_coef[i] = dir == 0 ? exp_ftz(last - s_cs[i]) * s_coef[i] : exp_ftz(s_cs[i]);
    }
    __syncthreads();
    const bf16* s_a = slab_a(k);
    const bf16* s_x = slab_x(k);
    float acc[4][4] = {};
    for (int k0 = 0; k0 < qp; k0 += 16) {
      // a0/a1 hold steps k0 + 2 t4 (+1), a2/a3 steps k0 + 8 + 2 t4 (+1)
      uint32_t a[4];
      ldsm_x4_t(a, s_a + (k0 + (lane & 7) + (lane >> 4) * 8) * kLdt + m0 + ((lane >> 3) & 1) * 8);
      const int j = k0 + 2 * t4;
      const float w0 = s_coef[j], w1 = s_coef[j + 1], w2 = s_coef[j + 8], w3 = s_coef[j + 9];
      uint32_t ah[4], al[4];
      float2 v = unpack_bf16(a[0]);
      split2(v.x * w0, v.y * w1, ah[0], al[0]);
      v = unpack_bf16(a[1]);
      split2(v.x * w0, v.y * w1, ah[1], al[1]);
      v = unpack_bf16(a[2]);
      split2(v.x * w2, v.y * w3, ah[2], al[2]);
      v = unpack_bf16(a[3]);
      split2(v.x * w2, v.y * w3, ah[3], al[3]);
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        uint32_t xf[4];
        ldsm_x4_t(xf, s_x + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdt + c0 + pr * 16 +
                          (lane >> 4) * 8);
        mma_split(acc[2 * pr], ah, al, xf[0], xf[1]);
        mma_split(acc[2 * pr + 1], ah, al, xf[2], xf[3]);
      }
    }
    const float decay = exp_ftz(last);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[t][e] = decay * st[t][e] + acc[t][e];
  }
  if (dir == 1 && dh0 != nullptr) {
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + m0 + g8 + (e >> 1) * 8, p = p0 + c0 + 8 * t + 2 * t4 + (e & 1);
        if (n < d.n && p < d.p) dh0[hbase + static_cast<long long>(n) * d.p + p] = st[t][e];
      }
  }
}

// 2 (bf16, the wide route). A chunk's C B^T over one range of N and dS =
// dy x^T over one range of P on the tensor cores, the warp's 16 rows by the
// column blocks on or below its diagonal, into the workspace for
// scores_kernel to add in range order (the narrow route's per-step sums are
// dbc_mma's).
__global__ void __launch_bounds__(kThreads)
scores_part_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                       const bf16* __restrict__ bmat, const bf16* __restrict__ cmat,
                       float* __restrict__ ws, Workspace w, Dims d, int vec) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* s_u = reinterpret_cast<bf16*>(smem_mma);   // C or dy slab
  bf16* s_v = s_u + kMaxChunk * kLdt;                // B or x slab
  const int k = blockIdx.x % d.ks, c = blockIdx.x / d.ks;
  const int h = blockIdx.y, b = blockIdx.z, g = h / d.rep;
  const int t0 = c * d.q, len = min(d.q, d.s - t0), qp = round16(len);
  const int lane = threadIdx.x & 31, warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int i0 = 16 * warp, nkt = i0 < qp ? warp + 1 : 0;
  const int wn = split_width(d.n, d.ks), wp = split_width(d.p, d.ks);
  float* part = ws + w.ssp + (bch(d, b, c, h) * d.ks + k) * 2 * kMaxChunk * kMaxChunk;
  float acc[8][2][4];
  zero(acc);
  gram_mma(acc, cmat + grow(d, b, t0, g), bmat + grow(d, b, t0, g),
           static_cast<long long>(d.ng) * d.n, min(d.n, k * wn), min(d.n, (k + 1) * wn), qp, len,
           s_u, s_v, nkt, i0, lane, vec & 2, false);
  park(acc, part, kMaxChunk, i0, lane);   // all 128 columns: zeros above the diagonal blocks
  zero(acc);
  gram_mma(acc, dy + row(d, b, t0, h) * d.xp, x + row(d, b, t0, h) * d.xp,
           static_cast<long long>(d.nh) * d.xp, min(d.p, k * wp), min(d.p, (k + 1) * wp), qp,
           len, s_u, s_v, nkt, i0, lane, vec & 1, false);
  park(acc, part + kMaxChunk * kMaxChunk, kMaxChunk, i0, lane);
}

// 3 (bf16). dx = S^T dy + diag(w) B dH + D dy for 64 columns of P of one
// chunk and head: S as two bf16 terms (narrow: from C B^T, formed here on
// the tensor cores; wide: from the workspace), B dH over slabs of 64 of N
// (dH split into two bf16 terms), then S^T dy (S^T's fragments by
// ldmatrix.trans, from the warp's own diagonal block on).  Shared memory
// holds S's space and two slabs, so that two blocks share an SM and one's
// copies overlap the other's products: dH's terms go to the C slab once
// C B^T is formed, and dy to the B slab once B dH is.  On the narrow route
// with N <= 64, C, B and dH (in f32, in S's space before S) are copied at
// once, before anything else; elsewhere dH is split straight from device
// memory, slab by slab, and the wide route's S is copied after B dH.
__global__ void __launch_bounds__(kThreads, 2)
dx_mma_kernel(const bf16* __restrict__ dy, const float* __restrict__ gi,
              const bf16* __restrict__ bmat, const bf16* __restrict__ cmat,
              const float* __restrict__ dvec, float* __restrict__ ws, bf16* __restrict__ dx,
              Workspace w, Dims d, int vec) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* s_sh = reinterpret_cast<bf16*>(smem_mma);      // S, two terms
  bf16* s_sl = s_sh + kMaxChunk * kLdq;
  float* s_df = reinterpret_cast<float*>(smem_mma);    // dH slab in f32, before S
  bf16* s_a = s_sl + kMaxChunk * kLdq;                  // C slab; then dH's two terms
  bf16* s_b = s_a + kMaxChunk * kLdt;                   // B slab; then dy
  bf16* s_hh = s_a;
  bf16* s_hl = s_hh + kMT * kLdt;
  float* s_cs = reinterpret_cast<float*>(s_b + kMaxChunk * kLdt);
  float* s_gi = s_cs + kMaxChunk;
  const int pt = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / d.nh, h = blockIdx.z % d.nh, g = h / d.rep;
  const int t0 = c * d.q, len = min(d.q, d.s - t0), qp = round16(len);
  const int p0 = pt * kMT, pw = min(kMT, d.p - p0);
  const int lane = threadIdx.x & 31, warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int g8 = lane >> 2, t4 = lane & 3, i0 = 16 * warp;
  const bool active = i0 < qp;
  const long long gstride = static_cast<long long>(d.ng) * d.n;
  const bf16* bg = bmat + grow(d, b, t0, g);
  const bf16* cg = cmat + grow(d, b, t0, g);
  const float* dh = ws + w.dhs + bch(d, b, c, h) * d.n * d.sp + p0;
  const bool staged = d.narrow && d.n <= kMT;   // C, B and dH: one slab each
  if (staged) {
    stage_rows(s_a, cg, gstride, qp, len, d.n, vec & 2);
    stage_rows(s_b, bg, gstride, qp, len, d.n, vec & 2);
    stage_f32(s_df, dh, d.sp, d.n, pw);
  }
  chunk_issue(d, ws + w.cs, gi, b, c, h, len, s_cs, s_gi);
  cp_async_wait_all();
  __syncthreads();
  const float last = s_cs[len - 1];
  if (d.narrow) {
    float acc[8][2][4];
    zero(acc);
    gram_mma(acc, cg, bg, gstride, 0, d.n, qp, len, s_a, s_b, active ? warp + 1 : 0, i0, lane,
             vec & 2, staged);
    if (staged) {
      __syncthreads();   // C is read: dH's terms take its slab
      split_states(s_hh, s_hl, s_df, nullptr, nullptr, nullptr);
      __syncthreads();   // the f32 dH is read: S takes its space
    }
    masked_terms(acc, s_sh, s_sl, s_cs, s_gi, i0, len, lane);
  }
  float ax[8][4] = {};   // the warp's rows j x 64 columns of P
  #pragma unroll 1
  for (int n0 = 0; n0 < d.n; n0 += kMT) {
    const int nw = min(kMT, d.n - n0);
    __syncthreads();   // the C slab (or the previous B and dH slabs) is read
    if (!staged) {
      stage_rows(s_b, bg + n0, gstride, qp, len, nw, vec & 2);
      stage_states(s_hh, s_hl, dh + static_cast<long long>(n0) * d.sp, nullptr, nullptr, nullptr,
                   d.sp, nw, pw);
      cp_async_wait_all();
    }
    __syncthreads();
    if (!active) continue;
    for (int k0 = 0; k0 < nw; k0 += 16) {
      uint32_t a[4];
      ldsm_x4(a, s_b + (i0 + (lane & 15)) * kLdt + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int pr = 0; pr < kMT / 16; ++pr) {
        const int at = (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdt + pr * 16 + (lane >> 4) * 8;
        uint32_t fh[4], fl[4];
        ldsm_x4_t(fh, s_hh + at);
        ldsm_x4_t(fl, s_hl + at);
        mma_bf16(ax[2 * pr], a, fh[0], fh[1]);
        mma_bf16(ax[2 * pr], a, fl[0], fl[1]);
        mma_bf16(ax[2 * pr + 1], a, fh[2], fh[3]);
        mma_bf16(ax[2 * pr + 1], a, fl[2], fl[3]);
      }
    }
  }
  __syncthreads();   // B is read: dy takes its slab
  stage_rows(s_b, dy + row(d, b, t0, h) * d.xp + p0, static_cast<long long>(d.nh) * d.xp, qp, len,
             pw, vec & 1);
  if (!d.narrow) stage_terms(s_sh, s_sl, ws + w.sg + bch(d, b, c, h) * 2 * d.q * d.q, d.q, qp, len);
  float wr[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int j = i0 + g8 + 8 * hf;
    wr[hf] = j < len ? exp_ftz(last - s_cs[j]) * s_gi[j] : 0.f;
  }
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) ax[t][e] *= wr[e >> 1];
  cp_async_wait_all();
  __syncthreads();   // dy and S are in
  const bf16* s_y = s_b;
  if (active) {
    for (int k0 = i0; k0 < qp; k0 += 16) {   // S_ij = 0 for i < j
      const int at = (k0 + (lane & 7) + (lane >> 4) * 8) * kLdq + i0 + ((lane >> 3) & 1) * 8;
      uint32_t ah[4], al[4];
      ldsm_x4_t(ah, s_sh + at);
      ldsm_x4_t(al, s_sl + at);
#pragma unroll
      for (int pr = 0; pr < kMT / 16; ++pr) {
        uint32_t yf[4];
        ldsm_x4_t(yf, s_y + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdt + pr * 16 +
                          (lane >> 4) * 8);
        mma_split(ax[2 * pr], ah, al, yf[0], yf[1]);
        mma_split(ax[2 * pr + 1], ah, al, yf[2], yf[3]);
      }
    }
  }
  const float dd = dvec != nullptr ? dvec[h] : 0.f;
  const bool pairs = (d.p & 1) == 0 && (reinterpret_cast<uintptr_t>(dx) & 3) == 0;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = i0 + g8 + 8 * hf, cc = 8 * t + 2 * t4;
      if (j >= len || cc >= pw) continue;
      const float2 dyv = make_float2(__bfloat162float(s_y[j * kLdt + cc]),
                                     __bfloat162float(s_y[j * kLdt + cc + 1]));
      const float a = ax[t][2 * hf] + dd * dyv.x, bv = ax[t][2 * hf + 1] + dd * dyv.y;
      const long long at = row(d, b, t0 + j, h) * d.p + p0 + cc;
      if (cc + 1 < pw && pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dx + at) = __floats2bfloat162_rn(a, bv);
      } else {
        dx[at] = __float2bfloat16(a);
        if (cc + 1 < pw) dx[at + 1] = __float2bfloat16(bv);
      }
    }
}

// 4 (bf16). One head's dB = G^T C + diag(w) x dH^T and dC = G B + diag(e)
// dy H^T for 64 columns of N of one chunk: G as two bf16 terms in shared
// memory (narrow: from dS = dy x^T, formed here on the tensor cores; wide:
// from the workspace), x dH^T and dy H^T over slabs of 64 of P (H and dH
// split into two terms as they are staged, the block's part of <H, dH>
// taken from their f32 values), the rows' parts of u = B . x dH^T and of
// C . (e dy H^T) (the four lanes of a row by a xor butterfly), then
// G^T C and G B; the head's dB and dC go to the f32 workspace.  On the
// narrow route the block of the first N tile also forms C B^T (kept in
// registers beside dS) and takes the chunk's per-step sums as it writes G's
// terms (sums_and_terms): the scores' work, with no launch of its own.  The
// block's C and B tiles (C B^T's slabs where N <= 64) and, where P <= 64 on
// the narrow route, x, dy and the states are copied before anything else.
// The block of the first N tile also sums x o dy over the slabs for dD's
// part of the chunk-head.
__global__ void __launch_bounds__(kThreads)
dbc_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
               const float* __restrict__ gi, const bf16* __restrict__ bmat,
               const bf16* __restrict__ cmat, float* __restrict__ ws, Workspace w, Dims d,
               int vec) {
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* s_gh = reinterpret_cast<bf16*>(smem_mma);      // G, two terms
  bf16* s_gl = s_gh + kMaxChunk * kLdq;
  bf16* s_u = s_gl + kMaxChunk * kLdq;                  // x slab
  bf16* s_v = s_u + kMaxChunk * kLdt;                   // dy slab
  bf16* s_ct = s_v + kMaxChunk * kLdt;                  // C tile
  bf16* s_bt = s_ct + kMaxChunk * kLdt;                 // B tile
  bf16* s_dhh = s_bt + kMaxChunk * kLdt;                // dH slab, two terms
  bf16* s_dhl = s_dhh + kMT * kLdt;
  bf16* s_hh = s_dhl + kMT * kLdt;                      // H slab, two terms
  bf16* s_hl = s_hh + kMT * kLdt;
  float* s_dhf = reinterpret_cast<float*>(s_hl + kMT * kLdt);   // dH and H slabs, f32
  float* s_hf = s_dhf + kMT * kLdf;
  float* s_st = s_hf + kMT * kLdf;                      // the warps' step-sum columns
  float* s_dg = s_st + kMmaWarps * kMaxChunk;
  float* s_cs = s_dg + kMmaWarps * kMaxChunk;
  float* s_gi = s_cs + kMaxChunk;
  float* s_red = s_gi + kMaxChunk;
  const int nt = blockIdx.x, c = blockIdx.y;
  const int b = blockIdx.z / d.nh, h = blockIdx.z % d.nh, g = h / d.rep;
  const int t0 = c * d.q, len = min(d.q, d.s - t0), qp = round16(len);
  const int n0 = nt * kMT, nw = min(kMT, d.n - n0);
  const int lane = threadIdx.x & 31, warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int g8 = lane >> 2, t4 = lane & 3, i0 = 16 * warp;
  const bool active = i0 < qp;
  const long long xstride = static_cast<long long>(d.nh) * d.xp;
  const long long gstride = static_cast<long long>(d.ng) * d.n;
  const bf16* xg = x + row(d, b, t0, h) * d.xp;
  const bf16* dyg = dy + row(d, b, t0, h) * d.xp;
  const bf16* cg = cmat + grow(d, b, t0, g);
  const bf16* bg = bmat + grow(d, b, t0, g);
  const long long sbase = bch(d, b, c, h) * d.n * d.sp + static_cast<long long>(n0) * d.sp;
  const bool staged = d.narrow && d.p <= kMT;   // one slab of x, dy and the states
  stage_rows(s_ct, cg + n0, gstride, qp, len, nw, vec & 2);
  stage_rows(s_bt, bg + n0, gstride, qp, len, nw, vec & 2);
  float hdh = 0.f;
  if (staged) {
    stage_rows(s_u, xg, xstride, qp, len, d.p, vec & 1);
    stage_rows(s_v, dyg, xstride, qp, len, d.p, vec & 1);
    stage_f32(s_dhf, ws + w.dhs + sbase, d.sp, nw, d.p);
    stage_f32(s_hf, ws + w.hs + sbase, d.sp, nw, d.p);
  }
  chunk_issue(d, ws + w.cs, gi, b, c, h, len, s_cs, s_gi);
  cp_async_wait_all();
  __syncthreads();
  const float last = s_cs[len - 1];
  if (staged) hdh = split_states(s_dhh, s_dhl, s_dhf, s_hh, s_hl, s_hf);
  if (d.narrow) {
    float acc[8][2][4], cb[8][2][4];
    const bool sums = nt == 0;
    if (sums) {   // C B^T: over the tiles where N <= 64, else in slabs through G's space
      zero(cb);
      const bool one = d.n <= kMT;
      bf16* su = one ? s_ct : s_gh;
      gram_mma(cb, cg, bg, gstride, 0, d.n, qp, len, su, one ? s_bt : su + kMaxChunk * kLdt,
               active ? warp + 1 : 0, i0, lane, vec & 2, one);
    }
    // dy x^T; its slabs land as the P loop stages them (x in s_u)
    zero(acc);
    gram_mma(acc, dyg, xg, xstride, 0, d.p, qp, len, s_v, s_u, active ? warp + 1 : 0, i0, lane,
             vec & 1, staged);
    if (sums) {
      sums_and_terms(acc, cb, s_gh, s_gl, s_st, s_dg, s_cs, s_gi,
                     ws + w.stepw + bch(d, b, c, h) * 2 * d.q, d.q, i0, len, warp, lane);
    } else {
      masked_terms(acc, s_gh, s_gl, s_cs, s_gi, i0, len, lane);
    }
  } else {
    stage_terms(s_gh, s_gl, ws + w.sg + bch(d, b, c, h) * 2 * d.q * d.q + d.q * d.q, d.q, qp,
                len);
  }
  float av[8][4] = {}, aw[8][4] = {};   // the warp's rows j x 64 columns of N
  float xdy = 0.f;
  #pragma unroll 1
  for (int p0 = 0; p0 < d.p; p0 += kMT) {
    const int pw = min(kMT, d.p - p0);
    __syncthreads();
    if (!staged) {
      stage_rows(s_u, xg + p0, xstride, qp, len, pw, vec & 1);
      stage_rows(s_v, dyg + p0, xstride, qp, len, pw, vec & 1);
      hdh += stage_states(s_dhh, s_dhl, ws + w.dhs + sbase + p0, s_hh, s_hl,
                          ws + w.hs + sbase + p0, d.sp, nw, pw);
      cp_async_wait_all();
    }
    __syncthreads();
    if (nt == 0) {
      for (int e = threadIdx.x; e < qp * kMT; e += kThreads) {
        const int r = e / kMT, cc = e % kMT;
        xdy += __bfloat162float(s_u[r * kLdt + cc]) * __bfloat162float(s_v[r * kLdt + cc]);
      }
    }
    if (!active) continue;
    for (int k0 = 0; k0 < pw; k0 += 16) {
      uint32_t xa[4], ya[4];
      ldsm_x4(xa, s_u + (i0 + (lane & 15)) * kLdt + k0 + (lane >> 4) * 8);
      ldsm_x4(ya, s_v + (i0 + (lane & 15)) * kLdt + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < kMT / 16; ++np) {
        // dH and H rows are N, their columns P: the B operand as it lies
        const int at = (np * 16 + (lane & 7) + (lane >> 4) * 8) * kLdt + k0 + ((lane >> 3) & 1) * 8;
        uint32_t f[4];
        ldsm_x4(f, s_dhh + at);
        mma_bf16(av[2 * np], xa, f[0], f[1]);
        mma_bf16(av[2 * np + 1], xa, f[2], f[3]);
        ldsm_x4(f, s_dhl + at);
        mma_bf16(av[2 * np], xa, f[0], f[1]);
        mma_bf16(av[2 * np + 1], xa, f[2], f[3]);
        ldsm_x4(f, s_hh + at);
        mma_bf16(aw[2 * np], ya, f[0], f[1]);
        mma_bf16(aw[2 * np + 1], ya, f[2], f[3]);
        ldsm_x4(f, s_hl + at);
        mma_bf16(aw[2 * np], ya, f[0], f[1]);
        mma_bf16(aw[2 * np + 1], ya, f[2], f[3]);
      }
    }
  }
  // parts of u and of the y_off term over this tile of N, and the weighted
  // starts of dB and dC
  float* part = ws + w.part + (bch(d, b, c, h) * d.nt + nt) * 2 * d.q;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int j = i0 + g8 + 8 * hf;
    float u = 0.f, yo = 0.f;
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cc = 8 * t + 2 * t4 + e;
        u += __bfloat162float(s_bt[j * kLdt + cc]) * av[t][2 * hf + e];
        yo += __bfloat162float(s_ct[j * kLdt + cc]) * aw[t][2 * hf + e];
      }
    u += __shfl_xor_sync(0xffffffffu, u, 1);
    u += __shfl_xor_sync(0xffffffffu, u, 2);
    yo += __shfl_xor_sync(0xffffffffu, yo, 1);
    yo += __shfl_xor_sync(0xffffffffu, yo, 2);
    const float ej = j < len ? exp_ftz(s_cs[j]) : 0.f;
    const float wj = j < len ? exp_ftz(last - s_cs[j]) * s_gi[j] : 0.f;
    if (t4 == 0 && j < d.q) {
      part[j] = u;
      part[d.q + j] = ej * yo;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        av[t][2 * hf + e] *= wj;
        aw[t][2 * hf + e] *= ej;
      }
  }
  if (active) {
    // dB_j += sum_i G_ij C_i over i >= j: G^T's fragments by ldmatrix.trans
    for (int k0 = i0; k0 < qp; k0 += 16) {
      const int at = (k0 + (lane & 7) + (lane >> 4) * 8) * kLdq + i0 + ((lane >> 3) & 1) * 8;
      uint32_t gh[4], gl[4];
      ldsm_x4_t(gh, s_gh + at);
      ldsm_x4_t(gl, s_gl + at);
#pragma unroll
      for (int np = 0; np < kMT / 16; ++np) {
        uint32_t f[4];
        ldsm_x4_t(f, s_ct + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdt + np * 16 +
                         (lane >> 4) * 8);
        mma_split(av[2 * np], gh, gl, f[0], f[1]);
        mma_split(av[2 * np + 1], gh, gl, f[2], f[3]);
      }
    }
    // dC_i += sum_j G_ij B_j over j <= i
    for (int k0 = 0; k0 <= i0; k0 += 16) {
      const int at = (i0 + (lane & 15)) * kLdq + k0 + (lane >> 4) * 8;
      uint32_t gh[4], gl[4];
      ldsm_x4(gh, s_gh + at);
      ldsm_x4(gl, s_gl + at);
#pragma unroll
      for (int np = 0; np < kMT / 16; ++np) {
        uint32_t f[4];
        ldsm_x4_t(f, s_bt + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdt + np * 16 +
                         (lane >> 4) * 8);
        mma_split(aw[2 * np], gh, gl, f[0], f[1]);
        mma_split(aw[2 * np + 1], gh, gl, f[2], f[3]);
      }
    }
  }
  const bool pairs = pairs_ok(ws + w.dbh, d.n) && pairs_ok(ws + w.dch, d.n);
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = i0 + g8 + 8 * hf, nn = n0 + 8 * t + 2 * t4;
      if (j < len && nn < d.n) {
        const long long at = row(d, b, t0 + j, h) * d.n + nn;
        const int live = min(2, d.n - nn);
        store_pair(ws + w.dbh, at, av[t][2 * hf], av[t][2 * hf + 1], live, pairs);
        store_pair(ws + w.dch, at, aw[t][2 * hf], aw[t][2 * hf + 1], live, pairs);
      }
    }
  block_sums(hdh, xdy, s_red, ws + w.hdh + bch(d, b, c, h) * d.nt + nt,
             nt == 0 ? ws + w.ddp + bch(d, b, c, h) : nullptr);
}

// ranges the wide route splits a chunk's score sums into: on the CUDA cores
// enough blocks for two on every SM, at most 16; on the tensor cores about
// 64 blocks (each range is then several slabs of 64), at least two
inline int scores_splits(int route, int mma, int chunk_heads) {
  if (route != kWide) return 1;
  const int ks = cdiv(mma ? 64 : 264, chunk_heads);
  return ks < (mma ? 2 : 1) ? (mma ? 2 : 1) : (ks > 16 ? 16 : ks);
}

// the largest dynamic shared memory a launch takes (the entry point's
// `smem`): the f32 scores kernel's (which also adds the wide route's split
// sums), or on the bf16 route dbc_mma's
inline int max_dynamic_bytes(const Dims& d) {
  return d.mma ? kDbcMmaBytes : scores_smem_floats() * static_cast<int>(sizeof(float));
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

// launches 5-7, the same for both dtypes
template <typename T>
cudaError_t launch_tail(const float* gi, void* db, void* dc, float* dld, float* dgi, float* dd,
                        float* ws, const Workspace& w, const Dims& d, cudaStream_t st) {
  cudaError_t err;
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

// f32: launches 0-4 on the CUDA cores
cudaError_t launch_f32(const float* dyt, const float* dh_final, const float* xt, const float* ld,
                       const float* gi, const float* bt, const float* ct, const float* dvec,
                       const float* h0, float* dx, float* dld, float* dgi, void* db, void* dc,
                       float* dd, float* dh0, float* ws, const Dims& d, cudaStream_t st) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(scores_kernel<float>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           scores_smem_floats() * static_cast<int>(sizeof(float)));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const Workspace w = workspace(d);
  cudaError_t err;
  const long long slots = static_cast<long long>(d.b) * d.nc * d.nh;
  cumsum_kernel<<<static_cast<unsigned>((slots + kCumsumWarps - 1) / kCumsumWarps), kThreads, 0,
                  st>>>(ld, ws + w.cs, d);
  if ((err = launched("cumsum")) != cudaSuccess) return err;
  if (d.narrow && d.n > kWideRows) {   // one block holds all 65-128 rows
    const dim3 grid(d.pt, 1, 2 * d.b * d.nh);
    state_pass_kernel<8><<<grid, kThreads, 0, st>>>(xt, dyt, ws + w.cs, gi, bt, ct, h0, dh_final,
                                                    ws + w.hs, ws + w.dhs, dh0, d);
  } else {   // narrow up to 64 rows: one tile; wide: tiles of 64 rows across blocks
    const dim3 grid(d.pt, cdiv(d.n, kWideRows), 2 * d.b * d.nh);
    state_pass_kernel<kWideRows / 16><<<grid, kThreads, 0, st>>>(
        xt, dyt, ws + w.cs, gi, bt, ct, h0, dh_final, ws + w.hs, ws + w.dhs, dh0, d);
  }
  if ((err = launched("state_pass")) != cudaSuccess) return err;
  if (d.ks > 1) {
    scores_part_kernel<<<dim3(d.nc * d.ks, d.nh, d.b), kThreads, 0, st>>>(xt, dyt, bt, ct, ws,
                                                                           w, d);
    if ((err = launched("scores_part")) != cudaSuccess) return err;
  }
  scores_kernel<float><<<dim3(d.nc, d.nh, d.b), kThreads,
                         scores_smem_floats() * sizeof(float), st>>>(xt, dyt, gi, bt, ct, ws, w,
                                                                      d);
  if ((err = launched("scores")) != cudaSuccess) return err;
  dx_kernel<<<dim3(d.pt, d.nc, d.nh * d.b), kThreads, 0, st>>>(xt, dyt, gi, bt, dvec, ws, dx, w,
                                                               d);
  if ((err = launched("dx")) != cudaSuccess) return err;
  dbc_kernel<<<dim3(d.nt, d.nc, d.nh * d.b), kThreads, 0, st>>>(xt, dyt, gi, bt, ct, ws, w, d);
  if ((err = launched("dbc")) != cudaSuccess) return err;
  return launch_tail<float>(gi, db, dc, dld, dgi, dd, ws, w, d, st);
}

// bf16: launches 1-4 on the tensor cores (the narrow route's scores in
// dbc_mma), after x and dy are padded where P % 8 != 0
cudaError_t launch_mma(const bf16* dyt, const float* dh_final, const bf16* xt, const float* ld,
                       const float* gi, const bf16* bt, const bf16* ct, const float* dvec,
                       const float* h0, bf16* dx, float* dld, float* dgi, void* db, void* dc,
                       float* dd, float* dh0, float* ws, const Dims& d, int vec,
                       cudaStream_t st) {
  static bool attr_set = false;
  if (!attr_set) {
    const struct {
      const void* fn;
      int bytes;
    } big[] = {
        {reinterpret_cast<const void*>(scores_kernel<bf16>),
         scores_smem_floats() * static_cast<int>(sizeof(float))},
        {reinterpret_cast<const void*>(state_pass_mma_kernel), kStateMmaBytes},
        {reinterpret_cast<const void*>(dx_mma_kernel), kDxMmaBytes},
        {reinterpret_cast<const void*>(dbc_mma_kernel), kDbcMmaBytes},
    };
    for (const auto& k : big) {
      const cudaError_t err = cudaFuncSetAttribute(
          k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k.bytes);
      if (err != cudaSuccess) return err;
    }
    attr_set = true;
  }
  const Workspace w = workspace(d);
  cudaError_t err;
  if (d.xp != d.p) {
    bf16* xpad = reinterpret_cast<bf16*>(ws + w.xpad);
    bf16* dypad = xpad + static_cast<long long>(d.b) * d.s * d.nh * d.xp;
    const long long total = static_cast<long long>(d.b) * d.s * d.nh * d.xp;
    const long long want = (total + kThreads - 1) / kThreads;
    pad_rows_kernel<<<static_cast<int>(want < 4096 ? want : 4096), kThreads, 0, st>>>(
        xt, dyt, xpad, dypad, d);
    if ((err = launched("pad_rows")) != cudaSuccess) return err;
    xt = xpad;
    dyt = dypad;
    vec |= 1;
  }
  const long long slots = static_cast<long long>(d.b) * d.nc * d.nh;
  cumsum_kernel<<<static_cast<unsigned>((slots + kCumsumWarps - 1) / kCumsumWarps), kThreads, 0,
                  st>>>(ld, ws + w.cs, d);
  if ((err = launched("cumsum")) != cudaSuccess) return err;
  state_pass_mma_kernel<<<dim3(cdiv(d.p, kMT), cdiv(d.n, kMT), 2 * d.b * d.nh), kThreads,
                          kStateMmaBytes, st>>>(xt, dyt, ws + w.cs, gi, bt, ct, h0, dh_final,
                                                ws + w.hs, ws + w.dhs, dh0, d, vec);
  if ((err = launched("state_pass_mma")) != cudaSuccess) return err;
  if (!d.narrow) {
    scores_part_mma_kernel<<<dim3(d.nc * d.ks, d.nh, d.b), kThreads, kScoresPartBytes, st>>>(
        xt, dyt, bt, ct, ws, w, d, vec);
    if ((err = launched("scores_part_mma")) != cudaSuccess) return err;
    scores_kernel<bf16><<<dim3(d.nc, d.nh, d.b), kThreads,
                          scores_smem_floats() * sizeof(float), st>>>(xt, dyt, gi, bt, ct, ws, w,
                                                                      d);
    if ((err = launched("scores")) != cudaSuccess) return err;
  }
  dx_mma_kernel<<<dim3(d.pt, d.nc, d.nh * d.b), kThreads, kDxMmaBytes, st>>>(
      dyt, gi, bt, ct, dvec, ws, dx, w, d, vec);
  if ((err = launched("dx_mma")) != cudaSuccess) return err;
  dbc_mma_kernel<<<dim3(d.nt, d.nc, d.nh * d.b), kThreads, kDbcMmaBytes, st>>>(
      xt, dyt, gi, bt, ct, ws, w, d, vec);
  if ((err = launched("dbc_mma")) != cudaSuccess) return err;
  return launch_tail<bf16>(gi, db, dc, dld, dgi, dd, ws, w, d, st);
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
// (0 narrow, 1 wide), the largest dynamic shared memory of a launch in
// bytes and the bf16 kernels' 16-byte loads (bit 0 x and dy, bit 1 B and C), as
// ops.py:scan_backward_plan and vector_flags state them.  Returns a
// cudaError_t.
extern "C" int repro_ssm_scan_backward(const void* dy, const void* dh_final, const void* x,
                                       const void* ld, const void* gi, const void* bmat,
                                       const void* cmat, const void* dvec, const void* h0,
                                       void* dx, void* dld, void* dgi, void* db, void* dc,
                                       void* dd, void* dh0, void* ws, long long ws_floats, int b,
                                       int s, int nh, int p, int ng, int n, int chunk, int dtype,
                                       int route, int smem, int vec, void* stream) {
  if (b <= 0 || s <= 0 || nh <= 0 || p <= 0 || ng <= 0 || nh % ng != 0 || n <= 0 ||
      n > kMaxState || chunk <= 0 || chunk > kMaxChunk || b > 65535 || nh > 65535 ||
      (dtype != 0 && dtype != 1)) {
    return refuse("shapes, chunk or dtype");
  }
  if (route != (n > kNarrowState ? kWide : kNarrow)) return refuse("route");
  if ((dvec == nullptr) != (dd == nullptr) || (h0 == nullptr) != (dh0 == nullptr)) {
    return refuse("optional operands");
  }
  if (vec < 0 || vec > 3 || (dtype == 0 && vec != 0)) return refuse("vector flags");
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
  d.mma = dtype == 1;
  d.narrow = route == kNarrow;
  d.xp = d.mma ? (p + 7) / 8 * 8 : p;
  const int tile = d.mma ? kMT : kTile;
  d.pt = cdiv(p, tile);
  d.nt = cdiv(n, tile);
  d.dparts = d.mma ? 1 : d.pt;
  d.sp = d.mma ? (p + 3) / 4 * 4 : p;
  d.ks = scores_splits(route, d.mma, d.b * d.nc * d.nh);
  if (smem != max_dynamic_bytes(d)) return refuse("shared memory");
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
  float* dldf = static_cast<float*>(dld);
  float* dgif = static_cast<float*>(dgi);
  float* ddf = static_cast<float*>(dd);
  float* dh0f = static_cast<float*>(dh0);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_f32(static_cast<const float*>(dy), dhf, static_cast<const float*>(x), ldf, gif,
                     static_cast<const float*>(bmat), static_cast<const float*>(cmat), dv, h0f,
                     static_cast<float*>(dx), dldf, dgif, db, dc, ddf, dh0f, wsf, d, st);
  } else {
    err = launch_mma(static_cast<const bf16*>(dy), dhf, static_cast<const bf16*>(x), ldf, gif,
                     static_cast<const bf16*>(bmat), static_cast<const bf16*>(cmat), dv, h0f,
                     static_cast<bf16*>(dx), dldf, dgif, db, dc, ddf, dh0f, wsf, d, vec, st);
  }
  return static_cast<int>(err);
}
