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
// (H N P 4 = 1 MB per batch row), more than x and y together; both bounds
// (0.4-0.6 us) lie below one launch's floor of about 1.1 us (an empty launch
// of this grid from a CUDA graph, tools/scan_variants.py).
//
// The TPU kernel carries h in VMEM along a sequential chunk grid axis;
// blocks on the GPU run in parallel with nothing carried between them, so
// each block loops over the chunks itself with its slice of the state in
// shared memory, written once at the end.  A ragged last chunk is masked in
// the kernel (its missing steps are identity steps: ld 0, gi 0), so S needs
// no padding.  Columns of h evolve independently given B, C, ld and gi, so
// P tiles across blocks (a ragged P is masked).  The dtype picks the route
// (ops.py:scan_plan):
//
// f32, the CUDA cores (ssd_kernel): one block of 8 warps per (batch, head,
// 32 columns of P).  Per chunk it stages x (Q x 32), B (Q x N, rows padded by
// one float against bank conflicts), C, the cumulative sum of ld and the
// decay factors in shared memory as f32.  The decay-masked scores are formed
// one row at a time: the warp that owns row i computes C_i.B_j for its
// lanes' j <= i only (so exp(cs_i - cs_j) is only taken where it is <= 1 and
// cannot overflow), parks them in a per-warp row of shared memory, and then
// each lane sums its own column of y.  It holds the f32 tolerance (2e-4),
// which no bf16 product can.
//
// bf16, the tensor cores (ssd_mma_kernel): one block per (batch, head, 32
// columns of P); 4 warps for Q <= 64 and 8 for Q <= 128, warp w owning the
// 16 rows [16w, 16w + 16) of the chunk.  At P = 64 the two blocks of a head
// each form the scores C.B^T: that was measured faster than one block per
// head, and 16 columns slower again (tools/scan_variants.py, PERF.md): with
// one block of 4 warps per SM every latency is exposed, and half the
// columns halve the two longest chains.
// Per chunk x (Q x 32), B and C (Q x N) are copied as bf16 into shared
// memory rows padded by 16 bytes (so ldmatrix's eight row addresses fall in
// distinct banks) with 16-byte cp.async where P and N are multiples of 8
// and the pointers 16-byte aligned (else scalar loads); ld and gi arrive as
// f32 through the same one-warp shuffle scan, their loads issued before the
// copies.  All three products run on mma.sync.m16n8k16 (bf16 in, f32
// accumulate), fed by ldmatrix:
//   S = C.B^T    per k16 step of N the warp's C strip as A, B rows as the
//                col-major B operand, for all column blocks on or below the
//                strip's diagonal at once (blocks wholly above it are
//                skipped; the blocks' chains overlap); exp(cs_i - cs_j) gi_j
//                is applied on the accumulator fragments with j > i zeroed
//                before the exponent, so no exponent is positive;
//   Y = S.X      S's accumulators are the A operand (the m16n8 accumulator
//                layout of two column tiles is the m16n8k16 A layout once
//                packed to bf16), X through ldmatrix.trans; Y starts as
//                exp(cs_i) C.h_prev, formed in the same k16 steps as S from
//                the f32 state (skipped while h is zero: the first chunk
//                without h0), and D x_i is added after; y goes back through
//                shared memory as 16-byte stores;
//   h update     h <- exp(cs_end) h + (B o w)^T X with w_j = exp(cs_end -
//                cs_j) gi_j: B through ldmatrix.trans as the A operand,
//                scaled by w in registers once per k16 step and used for all
//                of the warp's column pairs; each warp owns 16-row tiles of
//                the N x 32 state, which stays f32 in shared memory for the
//                whole loop.  While h is zero no barrier separates this from
//                the y rows, so warps with fewer rows start on it early.
// Exponents are ex2.approx.ftz (denormal results flushed): the accurate
// expf's branch for denormal results costs more than a microsecond a
// launch (tools/scan_variants.py).
//
// A state wider than 128 rows (mLSTM: N = 1024 key rows, P = 1025 value
// columns with the normalizer, xlstm-1.3b) takes the wide routes.  A block
// owns 32 columns of P and keeps its N-row slice of the f32 state in
// shared memory for the whole sequence, but B and C no longer fit beside
// it, so each chunk streams them through shared memory in slabs along N.
// Per slab the rows accumulate the causal scores C.B^T and C.h_prev over
// the slab's columns in registers (bf16) or shared memory (f32); after a
// barrier the slab's rows of the state are updated from the B slab still
// resident, so B and C are read once per chunk.  After the last slab the
// scores are decayed and multiplied into X as on the narrow routes.  Each
// block sums over N in a fixed order with no atomics and no split of N
// across blocks: two runs give the same bits.
//   bf16 (ssd_mma_wide_kernel): the same mma.sync products and two-term
//     splits as ssd_mma_kernel (gated_scan_mma_ref mirrors both routes).
//     At xlstm-1.3b's stateless bucket (S = 64, B = 1) the bytes are the
//     16.8 MB f32 final state, written once (a bound of ~5.6 us).  The
//     first design (4 warps and 32 columns a block: 33 x 4 = 132 blocks,
//     one an SM; each slab of 64 loaded and then waited on; the state
//     stored after the loop) took 58.85 us, its latencies exposed.  Now 8
//     warps own a block of 32 columns (one block an SM, one wave of 132);
//     slabs pass through a two-stage ring of cp.async groups, so the next
//     slab loads while this one's products run, one barrier a slab; slabs
//     are 128 columns up to a chunk of 64 (8 barriers for N = 1024, and 8
//     update units of 2 column pairs each, one a warp) and 64 beyond (a
//     chunk of 128 fills the 227 KB); where the chunk has at most half as
//     many 16-row strips as warps, a second warp takes each strip's odd
//     k16 steps of the scores, its sums added to the first's after the
//     slabs; and the last chunk's update stores each slab's rows of the
//     final state as it forms them, so the state's write is spread over
//     the slab loop.  16-column tiles (two blocks an SM) measured slower:
//     each recomputes the chunk's scores and reads all of B and C
//     (tools/wide_scan_variants.py, PERF.md).
//   f32 (ssd_wide_kernel): slabs of 16 columns on the CUDA cores, the
//     scores in a Q x Q shared array; served paths never take it (it runs in
//     the f32 reference checks).
// Precision: S, B o w and h are f32 intermediates that enter bf16 products.
// Rounded once to bf16 they miss the 2e-2 tolerance (max |d| / tol 1.65 at
// zamba2's head shape; tests/test_torch_ssm_scan.py), so each is carried as
// two bf16 terms, t = hi + lo (hi = bf16(t), lo = bf16(t - hi)), and its
// product runs twice: 16 significant bits, one more mma per product.
// ref.py:gated_scan_mma_ref is the plain mirror of these roundings.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kMaxChunk = 128;      // Q
constexpr int kMaxState = 128;      // N of the narrow routes
constexpr int kMaxWideState = 1024; // N of the wide routes

constexpr int kPer = kMaxChunk / 32;  // steps per lane of the chunk's scan

// One warp's loads of a chunk's log-decays and input scales: lane l holds
// steps l * kPer .. l * kPer + kPer - 1; step j reads ld[off0 + j * stride];
// steps from `valid` on are identity steps (ld 0, gi 0).
__device__ __forceinline__ void chunk_load(const float* __restrict__ ld,
                                           const float* __restrict__ gi, long long off0,
                                           int stride, int valid, int lane, float (&ldv)[kPer],
                                           float (&giv)[kPer]) {
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int j = lane * kPer + e;
    ldv[e] = giv[e] = 0.f;
    if (j < valid) {
      const long long off = off0 + static_cast<long long>(j) * stride;
      ldv[e] = ld[off];
      giv[e] = gi[off];
    }
  }
}

// The inclusive cumulative sum of the loaded log-decays into cs[0, rows),
// and the input scales into gis[0, rows): each lane sums its run of steps,
// then the lanes' totals are scanned with shuffles.
__device__ __forceinline__ void chunk_scan(const float (&ldv)[kPer], const float (&giv)[kPer],
                                           int rows, float* cs, float* gis, int lane) {
  float run[kPer];
  float tot = 0.f;
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    tot += ldv[e];
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
    if (j < rows) {
      cs[j] = before + run[e];
      gis[j] = giv[e];
    }
  }
}

// ------------------------------------------------------------------------
// f32: the CUDA cores
// ------------------------------------------------------------------------
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileP = 32;      // state columns per block (one per lane)

// floats of dynamic shared memory for a chunk of q steps and state size n
__host__ __device__ constexpr int smem_floats(int q, int n) {
  return n * kTileP        // hs: state slice (N, 32)
       + q * kTileP        // xs: x chunk (Q, 32)
       + q * (n + 1)       // bs: B chunk (Q, N+1)
       + q * n             // cm: C chunk (Q, N)
       + 4 * q             // cs, ecs, gis, wend
       + kWarps * q;       // sw: one score row per warp
}

__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ ld,
           const float* __restrict__ gi, const float* __restrict__ bmat,
           const float* __restrict__ cmat, const float* __restrict__ dvec,
           const float* __restrict__ h0, float* __restrict__ y, float* __restrict__ hout, int s,
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
          ? x[((static_cast<long long>(b) * s + t0 + j) * nh + head) * p + pp]
          : 0.f;
    }
    for (int idx = tid; idx < q * n; idx += kThreads) {
      const int j = idx / n;
      const int nn = idx % n;
      float bv = 0.f, cv = 0.f;
      if (j < valid) {
        const long long off = ((static_cast<long long>(b) * s + t0 + j) * ng + grp) * n + nn;
        bv = bmat[off];
        cv = cmat[off];
      }
      bs[j * (n + 1) + nn] = bv;
      cm[idx] = cv;
    }
    if (warp == 0) {
      float ldv[kPer], giv[kPer];
      chunk_load(ld, gi, (static_cast<long long>(b) * s + t0) * nh + head, nh, valid, lane, ldv,
                 giv);
      chunk_scan(ldv, giv, q, cs, gis, lane);
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
      if (col_ok) y[((static_cast<long long>(b) * s + t0 + i) * nh + head) * p + col] = acc;
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

// ------------------------------------------------------------------------
// bf16: the tensor cores
// ------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kMmaTileP = 32;           // state columns per block
constexpr int kLdx = kMmaTileP + 8;     // bf16 per shared row of x and y
constexpr int kLdh = kMmaTileP + 4;     // floats per shared row of the state

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

// The mma route's dynamic shared memory for a chunk of q steps and state
// size n, as byte offsets (ops.py:scan_plan computes the same total).
struct MmaSmem {
  int qp, np, ldn;                  // padded chunk rows and state rows; bf16 per B/C row
  int xs, ys, bs, cm, hs, cs, gis;  // offsets
  int bytes;
};

__host__ __device__ inline MmaSmem mma_smem(int q, int n) {
  MmaSmem m{};
  m.qp = round16(q);
  m.np = round16(n);
  m.ldn = m.np + 8;
  int o = 0;
  m.xs = o; o += m.qp * kLdx * 2;   // x chunk (Qp, 32) bf16
  m.ys = o; o += m.qp * kLdx * 2;   // y chunk (Qp, 32) bf16, stored 16 bytes at a time
  m.bs = o; o += m.qp * m.ldn * 2;  // B chunk (Qp, Np) bf16
  m.cm = o; o += m.qp * m.ldn * 2;  // C chunk (Qp, Np) bf16
  m.hs = o; o += m.np * kLdh * 4;   // state (Np, 32) f32
  m.cs = o; o += m.qp * 4;          // cumulative log-decay
  m.gis = o; o += m.qp * 4;         // input scales
  m.bytes = o;
  return m;
}

// The pieces both mma kernels are built from.  Each block owns 32 columns
// of P (pw of them live, in npair 16-column pairs) of one (head, batch row);
// nt is the block's thread count.

// the state: h0 or zeros (rows past N and columns past P stay zero)
__device__ __forceinline__ void mma_init_state(float* hs, const float* __restrict__ h0,
                                               long long hbase, int n, int np, int p, int pw,
                                               int tid, int nt) {
  if (h0 != nullptr) {
    for (int idx = tid; idx < np * kMmaTileP; idx += nt) {
      const int nn = idx / kMmaTileP;
      const int c = idx % kMmaTileP;
      hs[nn * kLdh + c] =
          (nn < n && c < pw) ? h0[hbase + static_cast<long long>(nn) * p + c] : 0.f;
    }
  } else {
    for (int idx = tid; idx < np * (kMmaTileP / 4); idx += nt) {
      *reinterpret_cast<float4*>(hs + idx / (kMmaTileP / 4) * kLdh + idx % (kMmaTileP / 4) * 4) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// x (Qp x 32) as bf16, 16 bytes at a time where `vec`; rows past the chunk
// and columns past P are zeros
__device__ __forceinline__ void mma_stage_x(bf16* xs, const bf16* __restrict__ xg,
                                            long long xstep, int qp, int valid, int pw, bool vec,
                                            int tid, int nt) {
  if (vec) {
    for (int idx = tid; idx < qp * (kMmaTileP / 8); idx += nt) {
      const int j = idx / (kMmaTileP / 8);
      const int c = idx % (kMmaTileP / 8) * 8;
      bf16* dst = xs + j * kLdx + c;
      if (j < valid && c < pw) cp_async16(dst, xg + j * xstep + c);
      else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    // plain loads, eight a thread in flight before their stores
    const bf16 zero = __float2bfloat16(0.f);
    const int total = qp * kMmaTileP;
    for (int base = tid; base < total; base += 8 * nt) {
      bf16 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int idx = base + u * nt;
        const int j = idx / kMmaTileP;
        const int c = idx % kMmaTileP;
        v[u] = (idx < total && j < valid && c < pw) ? xg[j * xstep + c] : zero;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int idx = base + u * nt;
        if (idx < total) xs[idx / kMmaTileP * kLdx + idx % kMmaTileP] = v[u];
      }
    }
  }
}

// Columns [0, kw) of B and C (rows of `ld` bf16 in shared memory) into the
// warp's 16 rows from i0: S = C.B^T on the column blocks on or below the
// strip's diagonal, and C.h from the state's rows `hr` (read straight into
// B fragments: rows 2 t4, 2 t4 + 1, + 8, + 9 of the step, column g8;
// split) while h is not zero.  One k16 step at a time (from step kfirst in
// strides of kstride: two warps may share a strip's steps): the strip of C
// as the A fragment, all blocks' products issued together so their
// accumulation chains overlap.
template <int kWarpsT>
__device__ __forceinline__ void mma_scores(float (&acc)[kMmaTileP / 8][4],
                                           float (&sc)[kWarpsT][2][4], const bf16* cm,
                                           const bf16* bs, int ld, int kw, const float* hr,
                                           bool has_h, int nkt, int npair, int i0, int lane,
                                           int kfirst = 0, int kstride = 1) {
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  for (int k0 = 16 * kfirst; k0 < kw; k0 += 16 * kstride) {
    uint32_t ca[4];
    ldsm_x4(ca, cm + (i0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8);
    if (has_h) {
      const float* hk = hr + (k0 + 2 * t4) * kLdh + g8;
#pragma unroll
      for (int t = 0; t < kMmaTileP / 8; ++t) {
        if (t < 2 * npair) {
          const float* h = hk + t * 8;
          uint32_t b0h, b0l, b1h, b1l;
          split2(h[0], h[kLdh], b0h, b0l);
          split2(h[8 * kLdh], h[9 * kLdh], b1h, b1l);
          mma_bf16(acc[t], ca, b0h, b1h);
          mma_bf16(acc[t], ca, b0l, b1l);
        }
      }
    }
#pragma unroll
    for (int kt = 0; kt < kWarpsT; ++kt) {
      if (kt < nkt) {
        uint32_t bf[4];
        ldsm_x4(bf, bs + (kt * 16 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(sc[kt][0], ca, bf[0], bf[1]);
        mma_bf16(sc[kt][1], ca, bf[2], bf[3]);
      }
    }
  }
}

// The warp's y rows ra and rb = ra + 8 from its accumulators: C.h scaled by
// exp(cs_i); the scores' decay and input scale (j > i zeroed before the
// exponent), split into two bf16 terms, then Y += S.X; + D x_i, to shared
// memory as bf16
template <int kWarpsT>
__device__ __forceinline__ void mma_y_rows(float (&acc)[kMmaTileP / 8][4],
                                           float (&sc)[kWarpsT][2][4], const float* cs,
                                           const float* gis, const bf16* xs, bf16* ys, int ra,
                                           int nkt, int npair, bool has_h, float dh, int lane) {
  const int t4 = lane & 3;
  const int rb = ra + 8;
  const float csa = cs[ra], csb = cs[rb];
  if (has_h) {
    const float ea = exp_ftz(csa), eb = exp_ftz(csb);
#pragma unroll
    for (int t = 0; t < kMmaTileP / 8; ++t) {
      acc[t][0] *= ea;
      acc[t][1] *= ea;
      acc[t][2] *= eb;
      acc[t][3] *= eb;
    }
  }
#pragma unroll
  for (int kt = 0; kt < kWarpsT; ++kt) {
    if (kt < nkt) {
      const int j0 = kt * 16;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? ra : rb;
          const int j = j0 + u * 8 + 2 * t4 + (e & 1);
          const float csi = e < 2 ? csa : csb;
          sc[kt][u][e] = j <= i ? sc[kt][u][e] * exp_ftz(csi - cs[j]) * gis[j] : 0.f;
        }
      }
      uint32_t ah[4], al[4];
      split2(sc[kt][0][0], sc[kt][0][1], ah[0], al[0]);
      split2(sc[kt][0][2], sc[kt][0][3], ah[1], al[1]);
      split2(sc[kt][1][0], sc[kt][1][1], ah[2], al[2]);
      split2(sc[kt][1][2], sc[kt][1][3], ah[3], al[3]);
#pragma unroll
      for (int pr = 0; pr < kMmaTileP / 16; ++pr) {
        if (pr < npair) {
          uint32_t xf[4];
          ldsm_x4_t(xf, xs + (j0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdx + pr * 16 +
                            (lane >> 4) * 8);
          mma_split(acc[2 * pr], ah, al, xf[0], xf[1]);
          mma_split(acc[2 * pr + 1], ah, al, xf[2], xf[3]);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < kMmaTileP / 8; ++t) {
    if (t < 2 * npair) {
      const int c = t * 8 + 2 * t4;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = hf ? rb : ra;
        const float2 xv =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + r * kLdx + c));
        *reinterpret_cast<__nv_bfloat162*>(ys + r * kLdx + c) = __floats2bfloat162_rn(
            acc[t][2 * hf] + dh * xv.x, acc[t][2 * hf + 1] + dh * xv.y);
      }
    }
  }
}

// The state's rows hr[0, 16 mtiles), from B's columns [0, 16 mtiles) (rows
// of `ld` bf16): h <- exp(cs_end) h + (B o w)^T X with w_j = exp(cs_end -
// cs_j) gi_j.  A unit is one 16-row tile of the state (m0) and every
// `groups`-th 16-column pair of it; per k16 step the warp builds B^T's A
// fragment, scaled by w and split, once and uses it for all its column
// pairs.  `zero`: the entering state is zero and is not read.  With `hg`
// (the wide route's last chunk) the new rows are the final state: they go
// straight to device memory (hg[row * hstride + c] for rows < hrows and
// columns < pw, scalar stores: P may be odd) and not back to hr.
template <int kWarpsT>
__device__ __forceinline__ void mma_update_state(float* hr, const bf16* bs, int ld, int mtiles,
                                                 int valid, const float* cs, const float* gis,
                                                 int qp, const bf16* xs, int npair, int warp,
                                                 int lane, bool zero = false,
                                                 float* __restrict__ hg = nullptr,
                                                 long long hstride = 0, int hrows = 0,
                                                 int pw = 0) {
  const int g8 = lane >> 2;
  const int t4 = lane & 3;
  const float cs_end = cs[qp - 1];   // identity steps past the end keep it
  const float dec_end = exp_ftz(cs_end);
  const int groups = max(1, kWarpsT / mtiles);
  for (int u = warp; u < mtiles * groups; u += kWarpsT) {
    const int m0 = u % mtiles * 16;
    const int pr0 = u / mtiles;
    float ha[kMmaTileP / 16][2][4];
#pragma unroll
    for (int k = 0; k < kMmaTileP / 16; ++k) {
#pragma unroll
      for (int v8 = 0; v8 < 2; ++v8) ha[k][v8][0] = ha[k][v8][1] = ha[k][v8][2] = ha[k][v8][3] = 0.f;
    }
    for (int k0 = 0; k0 < valid; k0 += 16) {
      // a0/a1 hold steps k0 + 2 t4 (+1), a2/a3 steps k0 + 8 + 2 t4 (+1)
      uint32_t a[4];
      ldsm_x4_t(a, bs + (k0 + (lane & 7) + (lane >> 4) * 8) * ld + m0 + ((lane >> 3) & 1) * 8);
      const int j = k0 + 2 * t4;
      const float w0 = exp_ftz(cs_end - cs[j]) * gis[j];
      const float w1 = exp_ftz(cs_end - cs[j + 1]) * gis[j + 1];
      const float w2 = exp_ftz(cs_end - cs[j + 8]) * gis[j + 8];
      const float w3 = exp_ftz(cs_end - cs[j + 9]) * gis[j + 9];
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
      for (int k = 0; k < kMmaTileP / 16; ++k) {
        const int pr = pr0 + k * groups;
        if (k * groups < kMmaTileP / 16 && pr < npair) {
          uint32_t xf[4];
          ldsm_x4_t(xf, xs + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdx + pr * 16 +
                            (lane >> 4) * 8);
          mma_split(ha[k][0], ah, al, xf[0], xf[1]);
          mma_split(ha[k][1], ah, al, xf[2], xf[3]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMmaTileP / 16; ++k) {
      const int pr = pr0 + k * groups;
      if (k * groups < kMmaTileP / 16 && pr < npair) {
#pragma unroll
        for (int v8 = 0; v8 < 2; ++v8) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int row = m0 + g8 + hf * 8;
            const int c = pr * 16 + v8 * 8 + 2 * t4;
            float2* hp = reinterpret_cast<float2*>(hr + row * kLdh + c);
            const float2 old = zero ? make_float2(0.f, 0.f) : *hp;
            const float2 h = make_float2(dec_end * old.x + ha[k][v8][2 * hf],
                                         dec_end * old.y + ha[k][v8][2 * hf + 1]);
            if (hg == nullptr) {
              *hp = h;
            } else if (row < hrows) {
              float* o = hg + row * hstride + c;
              if (c < pw) o[0] = h.x;
              if (c + 1 < pw) o[1] = h.y;
            }
          }
        }
      }
    }
  }
}

// the chunk's staged y rows to device memory
__device__ __forceinline__ void mma_store_y(bf16* __restrict__ yg, const bf16* ys, long long xstep,
                                            int qp, int valid, int pw, bool vec, int tid,
                                            int nt) {
  if (vec) {
    for (int idx = tid; idx < qp * (kMmaTileP / 8); idx += nt) {
      const int j = idx / (kMmaTileP / 8);
      const int c = idx % (kMmaTileP / 8) * 8;
      if (j < valid && c < pw) {
        *reinterpret_cast<uint4*>(yg + j * xstep + c) =
            *reinterpret_cast<const uint4*>(ys + j * kLdx + c);
      }
    }
  } else {
    for (int idx = tid; idx < qp * kMmaTileP; idx += nt) {
      const int j = idx / kMmaTileP;
      const int c = idx % kMmaTileP;
      if (j < valid && c < pw) yg[j * xstep + c] = ys[j * kLdx + c];
    }
  }
}

// the final state to device memory
__device__ __forceinline__ void mma_store_state(float* __restrict__ hout, const float* hs,
                                                long long hbase, int n, int p, int pw, bool vec,
                                                int tid, int nt) {
  if (vec) {
    for (int idx = tid; idx < n * (kMmaTileP / 4); idx += nt) {
      const int nn = idx / (kMmaTileP / 4);
      const int c = idx % (kMmaTileP / 4) * 4;
      if (c < pw) {
        *reinterpret_cast<float4*>(hout + hbase + static_cast<long long>(nn) * p + c) =
            *reinterpret_cast<const float4*>(hs + nn * kLdh + c);
      }
    }
  } else {
    for (int idx = tid; idx < n * kMmaTileP; idx += nt) {
      const int nn = idx / kMmaTileP;
      const int c = idx % kMmaTileP;
      if (c < pw) hout[hbase + static_cast<long long>(nn) * p + c] = hs[nn * kLdh + c];
    }
  }
}

template <int kWarpsT>
__global__ void __launch_bounds__(kWarpsT * 32)
ssd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ ld,
               const float* __restrict__ gi, const bf16* __restrict__ bmat,
               const bf16* __restrict__ cmat, const float* __restrict__ dvec,
               const float* __restrict__ h0, bf16* __restrict__ y, float* __restrict__ hout,
               int s, int nh, int p, int ng, int n, int q, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MmaSmem m = mma_smem(q, n);
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + m.xs);
  bf16* ys = reinterpret_cast<bf16*>(smem_raw + m.ys);
  bf16* bs = reinterpret_cast<bf16*>(smem_raw + m.bs);
  bf16* cm = reinterpret_cast<bf16*>(smem_raw + m.cm);
  float* hs = reinterpret_cast<float*>(smem_raw + m.hs);
  float* cs = reinterpret_cast<float*>(smem_raw + m.cs);
  float* gis = reinterpret_cast<float*>(smem_raw + m.gis);
  const int qp = m.qp, np = m.np, ldn = m.ldn;

  const int p0 = blockIdx.x * kMmaTileP;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int grp = head / (nh / ng);
  const int tid = threadIdx.x;
  constexpr int nthreads = kWarpsT * 32;
  const int lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);  // uniform in the warp
  const int pw = min(kMmaTileP, p - p0);   // live state columns of this block
  const int npair = (pw + 15) / 16;        // 16-column pairs of n8 tiles that hold them
  const float dh = dvec != nullptr ? dvec[head] : 0.f;
  const long long xstep = static_cast<long long>(nh) * p;   // elements between steps of x, y
  const long long bstep = static_cast<long long>(ng) * n;
  const long long hbase = (static_cast<long long>(b) * nh + head) * n * p + p0;
  const bf16 zero = __float2bfloat16(0.f);

  mma_init_state(hs, h0, hbase, n, np, p, pw, tid, nthreads);
  bool has_h = h0 != nullptr;

  for (int t0 = 0; t0 < s; t0 += q) {
    const int valid = min(q, s - t0);
    const long long row0 = static_cast<long long>(b) * s + t0;
    const bf16* bg = bmat + (row0 * ng + grp) * n;
    const bf16* cg = cmat + (row0 * ng + grp) * n;
    __syncthreads();  // the previous chunk is consumed: y stored, hs updated (or initialised)
    float ldv[kPer], giv[kPer];
    if (warp == 0) chunk_load(ld, gi, row0 * nh + head, nh, valid, lane, ldv, giv);

    // ---- stage x (Qp x 32), B and C (Qp x Np) as bf16; rows past the end of
    // the chunk and columns past P or N are zeros
    mma_stage_x(xs, x + (row0 * nh + head) * p + p0, xstep, qp, valid, pw, vec, tid, nthreads);
    if (vec) {
      const int nv = np / 8;
      for (int idx = tid; idx < qp * nv; idx += nthreads) {
        const int j = idx / nv;
        const int c = idx % nv * 8;
        bf16* db = bs + j * ldn + c;
        bf16* dc = cm + j * ldn + c;
        if (j < valid && c < n) {
          cp_async16(db, bg + j * bstep + c);
          cp_async16(dc, cg + j * bstep + c);
        } else {
          *reinterpret_cast<uint4*>(db) = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(dc) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    } else {
      for (int idx = tid; idx < qp * np; idx += nthreads) {
        const int j = idx / np;
        const int c = idx % np;
        const bool ok = j < valid && c < n;
        bs[j * ldn + c] = ok ? bg[j * bstep + c] : zero;
        cm[j * ldn + c] = ok ? cg[j * bstep + c] : zero;
      }
    }
    if (warp == 0) chunk_scan(ldv, giv, qp, cs, gis, lane);
    cp_async_wait_all();
    __syncthreads();

    // ---- y: warp w owns rows [16w, 16w + 16) of the chunk
    const int i0 = warp * 16;
    if (i0 < valid) {
      const int nkt = min(warp + 1, (valid + 15) / 16);
      float acc[kMmaTileP / 8][4];
#pragma unroll
      for (int t = 0; t < kMmaTileP / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
      float sc[kWarpsT][2][4];
#pragma unroll
      for (int kt = 0; kt < kWarpsT; ++kt) {
#pragma unroll
        for (int u = 0; u < 2; ++u) sc[kt][u][0] = sc[kt][u][1] = sc[kt][u][2] = sc[kt][u][3] = 0.f;
      }
      mma_scores<kWarpsT>(acc, sc, cm, bs, ldn, np, hs, has_h, nkt, npair, i0, lane);
      mma_y_rows<kWarpsT>(acc, sc, cs, gis, xs, ys, i0 + (lane >> 2), nkt, npair, has_h, dh,
                          lane);
    }
    // C.h has read the entering state before the update overwrites it; while
    // h is zero no warp reads it, and warps done with their rows go on
    if (has_h) __syncthreads();

    // ---- state update
    mma_update_state<kWarpsT>(hs, bs, ldn, np / 16, valid, cs, gis, qp, xs, npair, warp, lane);
    __syncthreads();  // y is staged

    mma_store_y(y + (row0 * nh + head) * p + p0, ys, xstep, qp, valid, pw, vec, tid, nthreads);
    has_h = true;
  }
  __syncthreads();
  mma_store_state(hout, hs, hbase, n, p, pw, vec, tid, nthreads);
}

// ------------------------------------------------------------------------
// bf16, the tensor cores, a wide state (128 < N <= 1024)
// ------------------------------------------------------------------------
constexpr int kWideStages = 2;        // slabs of B and C in flight: the ring's depth
constexpr int kWideWarps = 8;         // warps a block
constexpr int kWideSmemMax = 232448;  // a block's shared memory on the H100

// The wide mma route's dynamic shared memory for a chunk of q steps, state
// size n and slabs of `slab` columns of B and C, as byte offsets
// (ops.py:scan_plan computes the same total).
struct WideSmem {
  int qp, np, ldk;
  int xs, ring, hs, cs, gis;
  int stage;  // bytes of one stage of the ring: a B slab, then a C slab
  int bytes;
};

__host__ __device__ inline WideSmem wide_smem(int q, int n, int slab) {
  WideSmem m{};
  m.qp = round16(q);
  m.np = round16(n);
  m.ldk = slab + 8;
  m.stage = 2 * m.qp * m.ldk * 2;
  int o = 0;
  m.xs = o; o += m.qp * kLdx * 2;          // x chunk (Qp, 32) bf16
  m.ring = o; o += kWideStages * m.stage;  // the slabs of B and C (Qp, slab) bf16 each;
                                           // y (Qp, 32) bf16 at its end after them
  m.hs = o; o += m.np * kLdh * 4;          // state (Np, 32) f32
  m.cs = o; o += m.qp * 4;                 // cumulative log-decay
  m.gis = o; o += m.qp * 4;                // input scales
  m.bytes = o;
  return m;
}

// Columns [n0, n0 + kw) of B and C into one stage of the ring (rows of ldk
// bf16): 16-byte cp.async where `vec`, else plain loads; rows past the
// chunk and columns past N are zeros.  Commits one group of copies.
__device__ __forceinline__ void wide_stage_slab(bf16* bs, bf16* cm, int ldk,
                                                const bf16* __restrict__ bg,
                                                const bf16* __restrict__ cg, long long bstep,
                                                int n0, int kw, int n, int qp, int valid,
                                                bool vec, int tid, int nt) {
  if (vec) {
    const int nv = kw / 8;
    for (int idx = tid; idx < qp * nv; idx += nt) {
      const int j = idx / nv;
      const int c = idx % nv * 8;
      bf16* db = bs + j * ldk + c;
      bf16* dc = cm + j * ldk + c;
      if (j < valid && n0 + c < n) {
        cp_async16(db, bg + j * bstep + n0 + c);
        cp_async16(dc, cg + j * bstep + n0 + c);
      } else {
        *reinterpret_cast<uint4*>(db) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(dc) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  } else {
    const bf16 zero = __float2bfloat16(0.f);
    for (int idx = tid; idx < qp * kw; idx += nt) {
      const int j = idx / kw;
      const int c = idx % kw;
      const bool ok = j < valid && n0 + c < n;
      bs[j * ldk + c] = ok ? bg[j * bstep + n0 + c] : zero;
      cm[j * ldk + c] = ok ? cg[j * bstep + n0 + c] : zero;
    }
  }
  cp_async_commit();  // one group a slab (empty where the loads were plain)
}

// ssd_mma_kernel with B and C streamed through shared memory in slabs of
// kSlabW columns, kWideWarps warps a block.  The slabs pass through a ring
// of kWideStages stages: while the warps form one slab's products the next
// slab's cp.async copies are in flight, and one barrier a slab both makes
// the slab visible and frees the stage the next copy overwrites.  Per slab
// the warps' scores and C.h accumulate in registers, then (after a barrier
// where h is read) the slab's rows of the state are updated from the B slab
// still resident; in the last chunk those rows are the final state and are
// stored to device memory there, so the state's write is spread over the
// slab loop instead of following it.  vec: bit 0 = x and y move 16 bytes at
// a time (P a multiple of 8, x and y 16-byte aligned), bit 1 = B and C do
// (N a multiple of 8, both aligned).
template <int kSlabW>
__global__ void __launch_bounds__(kWideWarps * 32)
ssd_mma_wide_kernel(const bf16* __restrict__ x, const float* __restrict__ ld,
                    const float* __restrict__ gi, const bf16* __restrict__ bmat,
                    const bf16* __restrict__ cmat, const float* __restrict__ dvec,
                    const float* __restrict__ h0, bf16* __restrict__ y,
                    float* __restrict__ hout, int s, int nh, int p, int ng, int n, int q,
                    int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kWarpsT = kWideWarps;
  const WideSmem m = wide_smem(q, n, kSlabW);
  bf16* xs = reinterpret_cast<bf16*>(smem_raw + m.xs);
  float* hs = reinterpret_cast<float*>(smem_raw + m.hs);
  float* cs = reinterpret_cast<float*>(smem_raw + m.cs);
  float* gis = reinterpret_cast<float*>(smem_raw + m.gis);
  const int qp = m.qp, np = m.np, ldk = m.ldk;
  const bool vec_x = (vec & 1) != 0;
  const bool vec_bc = (vec & 2) != 0;

  const int p0 = blockIdx.x * kMmaTileP;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int grp = head / (nh / ng);
  const int tid = threadIdx.x;
  constexpr int nthreads = kWarpsT * 32;
  const int lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);  // uniform in the warp
  const int pw = min(kMmaTileP, p - p0);
  const int npair = (pw + 15) / 16;
  const float dh = dvec != nullptr ? dvec[head] : 0.f;
  const long long xstep = static_cast<long long>(nh) * p;
  const long long bstep = static_cast<long long>(ng) * n;
  const long long hbase = (static_cast<long long>(b) * nh + head) * n * p + p0;
  const int nslab = (np + kSlabW - 1) / kSlabW;
  // after a chunk's slabs the ring holds y at its end and, below it, the
  // odd k16 steps' sums of the scores where two warps share a strip
  const int ring_bytes = kWideStages * m.stage;
  const int y_bytes = qp * kLdx * 2;
  bf16* ys = reinterpret_cast<bf16*>(smem_raw + m.ring + ring_bytes - y_bytes);
  float* part = reinterpret_cast<float*>(smem_raw + m.ring);
  // the chunk's 16-row strips; where they are at most half the warps (and
  // the sums fit), warps strips .. 2 strips - 1 take each slab's odd k16
  // steps of the scores for the same rows as warps 0 .. strips - 1
  constexpr int kPart = kWarpsT / 2 * 8 + kMmaTileP / 2;  // floats a thread: scores, then C.h
  const int strips = qp / 16;
  const bool split = kWarpsT >= 2 * strips && strips * kPart * 32 * 4 + y_bytes <= ring_bytes;
  const int strip = split && warp >= strips ? warp - strips : warp;
  const int half = split && warp >= strips ? 1 : 0;

  mma_init_state(hs, h0, hbase, n, np, p, pw, tid, nthreads);
  bool has_h = h0 != nullptr;

  for (int t0 = 0; t0 < s; t0 += q) {
    const int valid = min(q, s - t0);
    const bool last = t0 + q >= s;
    const long long row0 = static_cast<long long>(b) * s + t0;
    const bf16* bg = bmat + (row0 * ng + grp) * n;
    const bf16* cg = cmat + (row0 * ng + grp) * n;
    __syncthreads();  // the previous chunk is consumed: y stored, hs updated (or initialised)
    float ldv[kPer], giv[kPer];
    if (warp == 0) chunk_load(ld, gi, row0 * nh + head, nh, valid, lane, ldv, giv);
    // x's copies join the first slab's group
    mma_stage_x(xs, x + (row0 * nh + head) * p + p0, xstep, qp, valid, pw, vec_x, tid,
                nthreads);
#pragma unroll
    for (int k = 0; k < kWideStages - 1; ++k) {
      bf16* st = reinterpret_cast<bf16*>(smem_raw + m.ring + k * m.stage);
      if (k < nslab) {
        wide_stage_slab(st, st + qp * ldk, ldk, bg, cg, bstep, k * kSlabW,
                        min(kSlabW, np - k * kSlabW), n, qp, valid, vec_bc, tid, nthreads);
      } else {
        cp_async_commit();
      }
    }
    if (warp == 0) chunk_scan(ldv, giv, qp, cs, gis, lane);

    // warp w owns rows [16 strip, 16 strip + 16) of the chunk (warps past
    // the strips, and past twice the strips where they split, own none)
    const int i0 = strip * 16;
    const bool rows_live = i0 < valid;
    const int nkt = min(strip + 1, (valid + 15) / 16);
    float acc[kMmaTileP / 8][4];
#pragma unroll
    for (int t = 0; t < kMmaTileP / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
    float sc[kWarpsT][2][4];
#pragma unroll
    for (int kt = 0; kt < kWarpsT; ++kt) {
#pragma unroll
      for (int u = 0; u < 2; ++u) sc[kt][u][0] = sc[kt][u][1] = sc[kt][u][2] = sc[kt][u][3] = 0.f;
    }

    for (int k = 0; k < nslab; ++k) {
      const int n0 = k * kSlabW;
      const int kw = min(kSlabW, np - n0);  // a multiple of 16
      // this thread's copies of slab k have landed (later slabs may still be
      // in flight); the barrier makes every thread's visible, and every warp
      // is done with slab k - 1, whose stage the next copy takes
      cp_async_wait_group<kWideStages - 2>();
      __syncthreads();
      const int kn = k + kWideStages - 1;
      if (kn < nslab) {
        bf16* st = reinterpret_cast<bf16*>(smem_raw + m.ring + (kn % kWideStages) * m.stage);
        wide_stage_slab(st, st + qp * ldk, ldk, bg, cg, bstep, kn * kSlabW,
                        min(kSlabW, np - kn * kSlabW), n, qp, valid, vec_bc, tid, nthreads);
      } else {
        cp_async_commit();  // an empty group: one group a slab either way
      }
      const bf16* bs =
          reinterpret_cast<const bf16*>(smem_raw + m.ring + (k % kWideStages) * m.stage);
      const bf16* cm = bs + qp * ldk;

      if (rows_live) {
        mma_scores<kWarpsT>(acc, sc, cm, bs, ldk, kw, hs + n0 * kLdh, has_h, nkt, npair, i0,
                            lane, half, split ? 2 : 1);
      }
      // C.h has read the slab's rows of the entering state before their update
      if (has_h) __syncthreads();
      mma_update_state<kWarpsT>(hs + n0 * kLdh, bs, ldk, kw / 16, valid, cs, gis, qp, xs,
                                npair, warp, lane, !has_h,
                                last ? hout + hbase + static_cast<long long>(n0) * p : nullptr,
                                p, n - n0, pw);
    }

    __syncthreads();  // every slab is consumed: the ring is free
    if (split) {
      // the odd steps' sums through shared memory, added to the even
      // steps' in that order
      float* mine = part + strip * kPart * 32 + lane;
      if (half == 1 && rows_live) {
#pragma unroll
        for (int kt = 0; kt < kWarpsT / 2; ++kt) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (kt < nkt) mine[(kt * 8 + e) * 32] = sc[kt][e >> 2][e & 3];
          }
        }
#pragma unroll
        for (int e = 0; e < kMmaTileP / 2; ++e) {
          mine[(kWarpsT / 2 * 8 + e) * 32] = acc[e >> 2][e & 3];
        }
      }
      __syncthreads();
      if (half == 0 && rows_live) {
#pragma unroll
        for (int kt = 0; kt < kWarpsT / 2; ++kt) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (kt < nkt) sc[kt][e >> 2][e & 3] += mine[(kt * 8 + e) * 32];
          }
        }
#pragma unroll
        for (int e = 0; e < kMmaTileP / 2; ++e) {
          acc[e >> 2][e & 3] += mine[(kWarpsT / 2 * 8 + e) * 32];
        }
      }
    }
    if (rows_live && half == 0) {
      mma_y_rows<kWarpsT>(acc, sc, cs, gis, xs, ys, i0 + (lane >> 2), nkt, npair, has_h, dh,
                          lane);
    }
    __syncthreads();  // y is staged
    mma_store_y(y + (row0 * nh + head) * p + p0, ys, xstep, qp, valid, pw, vec_x, tid,
                nthreads);
    has_h = true;
  }
  // the last chunk's updates have stored the final state
}

// ------------------------------------------------------------------------
// f32, the CUDA cores, a wide state (128 < N <= 1024)
// ------------------------------------------------------------------------
constexpr int kSlabF = 16;   // columns of B and C per slab

// floats of dynamic shared memory for a chunk of q steps and state size n
__host__ __device__ constexpr int wide_smem_floats(int q, int n) {
  return n * kTileP            // hs: state slice (N, 32)
       + q * q                 // sm: the chunk's scores (Q, Q)
       + q * kTileP            // xs: x chunk (Q, 32)
       + q * (kSlabF + 1)      // bsl: B slab (Q, 16 + 1)
       + q * kSlabF            // csl: C slab (Q, 16)
       + 4 * q;                // cs, ecs, gis, wend
}

__global__ void __launch_bounds__(kThreads)
ssd_wide_kernel(const float* __restrict__ x, const float* __restrict__ ld,
                const float* __restrict__ gi, const float* __restrict__ bmat,
                const float* __restrict__ cmat, const float* __restrict__ dvec,
                const float* __restrict__ h0, float* __restrict__ y, float* __restrict__ hout,
                int s, int nh, int p, int ng, int n, int q) {
  extern __shared__ float smem[];
  float* hs = smem;
  float* sm = hs + n * kTileP;
  float* xs = sm + q * q;
  float* bsl = xs + q * kTileP;
  float* csl = bsl + q * (kSlabF + 1);
  float* cs = csl + q * kSlabF;
  float* ecs = cs + q;
  float* gis = ecs + q;
  float* wend = gis + q;
  constexpr int kRowsPerThread = kMaxChunk / kWarps;

  const int p0 = blockIdx.x * kTileP;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int grp = head / (nh / ng);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col = p0 + lane;
  const bool col_ok = col < p;
  const float dh = dvec != nullptr ? dvec[head] : 0.f;
  const long long hbase = (static_cast<long long>(b) * nh + head) * n * p;

  for (int idx = tid; idx < n * kTileP; idx += kThreads) {
    const int pp = p0 + idx % kTileP;
    hs[idx] = (h0 != nullptr && pp < p) ? h0[hbase + static_cast<long long>(idx / kTileP) * p + pp]
                                        : 0.f;
  }
  bool has_h = h0 != nullptr;

  for (int t0 = 0; t0 < s; t0 += q) {
    const int valid = min(q, s - t0);
    __syncthreads();  // the previous chunk is consumed (and hs initialised)
    for (int idx = tid; idx < q * kTileP; idx += kThreads) {
      const int j = idx / kTileP;
      const int pp = p0 + idx % kTileP;
      xs[idx] = (j < valid && pp < p)
          ? x[((static_cast<long long>(b) * s + t0 + j) * nh + head) * p + pp]
          : 0.f;
    }
    for (int idx = tid; idx < q * q; idx += kThreads) sm[idx] = 0.f;
    if (warp == 0) {
      float ldv[kPer], giv[kPer];
      chunk_load(ld, gi, (static_cast<long long>(b) * s + t0) * nh + head, nh, valid, lane, ldv,
                 giv);
      chunk_scan(ldv, giv, q, cs, gis, lane);
    }
    __syncthreads();
    const float cs_end = cs[q - 1];
    const float dec_end = expf(cs_end);
    for (int j = tid; j < q; j += kThreads) {
      ecs[j] = expf(cs[j]);
      wend[j] = expf(cs_end - cs[j]) * gis[j];
    }
    float acc[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.f;

    for (int n0 = 0; n0 < n; n0 += kSlabF) {
      const int kw = min(kSlabF, n - n0);
      __syncthreads();  // the previous slab is consumed (and ecs, wend written)
      for (int idx = tid; idx < q * kSlabF; idx += kThreads) {
        const int j = idx / kSlabF;
        const int k = idx % kSlabF;
        float bv = 0.f, cv = 0.f;
        if (j < valid && k < kw) {
          const long long off =
              ((static_cast<long long>(b) * s + t0 + j) * ng + grp) * n + n0 + k;
          bv = bmat[off];
          cv = cmat[off];
        }
        bsl[j * (kSlabF + 1) + k] = bv;
        csl[idx] = cv;
      }
      __syncthreads();
      // the causal scores over the slab's columns, S[i][j] for j <= i
      for (int idx = tid; idx < valid * valid; idx += kThreads) {
        const int i = idx / valid;
        const int j = idx % valid;
        if (j <= i) {
          float dot = 0.f;
#pragma unroll
          for (int k = 0; k < kSlabF; ++k) dot += csl[i * kSlabF + k] * bsl[j * (kSlabF + 1) + k];
          sm[i * q + j] += dot;
        }
      }
      // C.h_prev over the slab: lane = the column, rows warp + 8 r
      if (has_h) {
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const int i = warp + r * kWarps;
          if (i < valid) {
            float a = 0.f;
            for (int k = 0; k < kw; ++k) a += csl[i * kSlabF + k] * hs[(n0 + k) * kTileP + lane];
            acc[r] += a;
          }
        }
        __syncthreads();  // every row has read the slab's rows of the entering state
      }
      // the slab's rows of the state
      for (int idx = tid; idx < kw * kTileP; idx += kThreads) {
        const int k = idx / kTileP;
        const int c = idx % kTileP;
        float a = 0.f;
        for (int j = 0; j < valid; ++j) a += bsl[j * (kSlabF + 1) + k] * wend[j] * xs[j * kTileP + c];
        float* hp = hs + (n0 + k) * kTileP + c;
        *hp = dec_end * *hp + a;
      }
    }
    __syncthreads();  // every slab's scores are summed
    for (int idx = tid; idx < valid * valid; idx += kThreads) {
      const int i = idx / valid;
      const int j = idx % valid;
      if (j <= i) sm[i * q + j] *= expf(cs[i] - cs[j]) * gis[j];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int i = warp + r * kWarps;
      if (i < valid) {
        float a = 0.f;
        for (int j = 0; j <= i; ++j) a += sm[i * q + j] * xs[j * kTileP + lane];
        a += ecs[i] * acc[r] + dh * xs[i * kTileP + lane];
        if (col_ok) y[((static_cast<long long>(b) * s + t0 + i) * nh + head) * p + col] = a;
      }
    }
    has_h = true;
  }
  __syncthreads();
  for (int idx = tid; idx < n * kTileP; idx += kThreads) {
    const int pp = p0 + idx % kTileP;
    if (pp < p) hout[hbase + static_cast<long long>(idx / kTileP) * p + pp] = hs[idx];
  }
}

// ------------------------------------------------------------------------
enum Route { kCudaCores = 0, kMma = 1, kMmaWide = 2, kCudaCoresWide = 3 };

using WideKernel = void (*)(const bf16*, const float*, const float*, const bf16*, const bf16*,
                            const float*, const float*, bf16*, float*, int, int, int, int, int,
                            int, int);

// The wide mma kernel of a plan's slab: 128 columns up to a chunk of 64,
// 64 beyond (ops.py:MMA_WIDE_SLABS); nullptr for any other width.
#define REPRO_WIDE_SLABS(X) X(128) X(64)

WideKernel wide_kernel(int slab) {
#define REPRO_WIDE(K) \
  if (slab == K) return ssd_mma_wide_kernel<K>;
  REPRO_WIDE_SLABS(REPRO_WIDE)
#undef REPRO_WIDE
  return nullptr;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

cudaError_t launch_cuda_cores(const float* x, const float* ld, const float* gi, const float* bmat,
                              const float* cmat, const float* dvec, const float* h0, float* y,
                              float* hout, int b, int s, int nh, int p, int ng, int n, int q,
                              int smem, cudaStream_t stream) {
  static bool attr_set = false;  // raise the dynamic shared-memory cap once
  if (!attr_set) {
    cudaError_t err =
        allow_smem(ssd_kernel, static_cast<int>(smem_floats(kMaxChunk, kMaxState) * sizeof(float)));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((p + kTileP - 1) / kTileP, nh, b);
  ssd_kernel<<<grid, kThreads, smem, stream>>>(x, ld, gi, bmat, cmat, dvec, h0, y, hout, s, nh, p,
                                               ng, n, q);
  return cudaGetLastError();
}

}  // namespace

// d and h0 may be null (no skip term; a zero initial state).  chunk: the
// chunk length Q (1..128; the caller passes min(chunk, S)).  n: 1..1024.
// dtype of x, B, C and y: 0 = float32, 1 = bfloat16.  route (0 the CUDA
// cores: f32, N <= 128; 1 the tensor cores: bf16, N <= 128; 2 the tensor
// cores, wide: bf16, 128 < N <= 1024; 3 the CUDA cores, wide: f32,
// 128 < N <= 1024), warps, slab (route 2's columns of B and C a slab; the
// other routes ignore it) and smem (dynamic shared memory in bytes) come
// from ops.py:scan_plan.  vec, on route 1: P and N are multiples of 8 and
// x, B, C and y 16-byte aligned, so x, B, C and y move 16 bytes at a time; on
// route 2 a bit mask: bit 0 for x, y and the state's rows (P a multiple of
// 8, x and y aligned), bit 1 for B and C (N a multiple of 8, both aligned).
// A plan that does not match the shapes returns cudaErrorInvalidValue and
// launches nothing.  Returns cudaGetLastError() after the launch.
extern "C" int repro_ssm_scan(const void* x, const void* ld, const void* gi, const void* bmat,
                              const void* cmat, const void* d, const void* h0, void* y,
                              void* hout, int b, int s, int nh, int p, int ng, int n, int chunk,
                              int dtype, int route, int warps, int slab, int smem,
                              int vec, void* stream) {
  if (b <= 0 || s <= 0 || nh <= 0 || p <= 0 || ng <= 0 || nh % ng != 0 || n <= 0 ||
      n > kMaxWideState || chunk <= 0 || chunk > kMaxChunk || b > 65535 || nh > 65535) {
    return cudaErrorInvalidValue;
  }
  const bool wide = route == kMmaWide || route == kCudaCoresWide;
  if (wide != (n > kMaxState)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ldf = static_cast<const float*>(ld);
  const float* gif = static_cast<const float*>(gi);
  const float* df = static_cast<const float*>(d);
  const float* h0f = static_cast<const float*>(h0);
  float* ho = static_cast<float*>(hout);
  if (route == kMma) {
    if (dtype != 1 || (warps != 4 && warps != 8) || warps * 16 < round16(chunk) ||
        smem != mma_smem(chunk, n).bytes || (vec && (p % 8 != 0 || n % 8 != 0))) {
      return cudaErrorInvalidValue;
    }
    static bool attr_set = false;
    if (!attr_set) {
      cudaError_t err = allow_smem(ssd_mma_kernel<4>, mma_smem(kMaxChunk, kMaxState).bytes);
      if (err == cudaSuccess) {
        err = allow_smem(ssd_mma_kernel<8>, mma_smem(kMaxChunk, kMaxState).bytes);
      }
      if (err != cudaSuccess) return static_cast<int>(err);
      attr_set = true;
    }
    const dim3 grid((p + kMmaTileP - 1) / kMmaTileP, nh, b);
    auto kernel = warps == 4 ? ssd_mma_kernel<4> : ssd_mma_kernel<8>;
    kernel<<<grid, warps * 32, smem, st>>>(
        static_cast<const bf16*>(x), ldf, gif, static_cast<const bf16*>(bmat),
        static_cast<const bf16*>(cmat), df, h0f, static_cast<bf16*>(y), ho, s, nh, p, ng, n, chunk,
        vec);
    return static_cast<int>(cudaGetLastError());
  }
  if (route == kMmaWide) {
    const auto kernel = wide_kernel(slab);
    if (dtype != 1 || kernel == nullptr || warps != kWideWarps || warps * 16 < round16(chunk) ||
        smem != wide_smem(chunk, n, slab).bytes || smem > kWideSmemMax ||
        (vec & ~3) != 0 || ((vec & 1) && p % 8 != 0) || ((vec & 2) && n % 8 != 0)) {
      return cudaErrorInvalidValue;
    }
    static bool attr_set = false;  // raise every wide kernel's shared-memory cap once
    if (!attr_set) {
      cudaError_t err = cudaSuccess;
#define REPRO_WIDE(K) \
  if (err == cudaSuccess) err = allow_smem(ssd_mma_wide_kernel<K>, kWideSmemMax);
      REPRO_WIDE_SLABS(REPRO_WIDE)
#undef REPRO_WIDE
      if (err != cudaSuccess) return static_cast<int>(err);
      attr_set = true;
    }
    const dim3 grid((p + kMmaTileP - 1) / kMmaTileP, nh, b);
    kernel<<<grid, warps * 32, smem, st>>>(
        static_cast<const bf16*>(x), ldf, gif, static_cast<const bf16*>(bmat),
        static_cast<const bf16*>(cmat), df, h0f, static_cast<bf16*>(y), ho, s, nh, p, ng, n, chunk,
        vec);
    return static_cast<int>(cudaGetLastError());
  }
  if (route == kCudaCoresWide) {
    if (dtype != 0 || warps != kWarps ||
        smem != static_cast<int>(wide_smem_floats(chunk, n) * sizeof(float))) {
      return cudaErrorInvalidValue;
    }
    static bool attr_set = false;
    if (!attr_set) {
      cudaError_t err = allow_smem(
          ssd_wide_kernel,
          static_cast<int>(wide_smem_floats(kMaxChunk, kMaxWideState) * sizeof(float)));
      if (err != cudaSuccess) return static_cast<int>(err);
      attr_set = true;
    }
    const dim3 grid((p + kTileP - 1) / kTileP, nh, b);
    ssd_wide_kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(x), ldf, gif, static_cast<const float*>(bmat),
        static_cast<const float*>(cmat), df, h0f, static_cast<float*>(y), ho, s, nh, p, ng, n,
        chunk);
    return static_cast<int>(cudaGetLastError());
  }
  if (route != kCudaCores || dtype != 0 || warps != kWarps ||
      smem != static_cast<int>(smem_floats(chunk, n) * sizeof(float))) {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(launch_cuda_cores(
      static_cast<const float*>(x), ldf, gif, static_cast<const float*>(bmat),
      static_cast<const float*>(cmat), df, h0f, static_cast<float*>(y), ho, b, s, nh, p, ng, n,
      chunk, smem, st));
}
