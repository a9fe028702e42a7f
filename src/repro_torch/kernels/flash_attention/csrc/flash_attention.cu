// Flash attention, forward, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention/kernel.py:flash_attention_pallas
// (body _flash_fwd_kernel): q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) -> (B,Sq,Hq,D).
// Causal with q_offset (query i sits at key position q_offset + i), optional
// window (keep k > q - window), optional soft-cap cap*tanh(s/cap) applied
// before masking; GQA maps query head h to KV head h / n_rep without
// replicating K/V; online softmax in f32 with l floored at 1e-30.
//
// Bound: at the served prefill shapes (Sq = Sk = prompt length, D = 64 or
// 128) the work is ~Sq/2 flops per K/V byte under the causal mask, so a short
// prompt is bound by bytes and a long one by operations.
//
// Two routes, picked by dtype in repro_flash_attention below:
//
// * bf16: the tensor cores through wgmma (wgmma_kernel).  One warpgroup (128
//   threads) per 64-row Q tile of one (KV head, batch row).  A tile's rows
//   are packed (query, head within the GQA group) pairs, row p = query
//   p / n_rep, head g * n_rep + p % n_rep, so every K/V tile is read once for
//   the whole group and the M = 64 rows of a wgmma are filled even by a short
//   prompt (qwen3's 32 tokens x 2 heads, zamba2's 64 tokens x 1).  Causal,
//   window and q_offset masks use each packed row's own query position.  K/V
//   tiles of 64 keys stream through a two-stage ring of 16-byte cp.async
//   copies: tile t+1 is in flight while tile t is multiplied.  S = Q K^T is
//   m64n64k16 wgmma over D, bf16 in and f32 accumulate, both operands K-major
//   in shared memory; the online softmax runs on the accumulator registers
//   in base 2 (ex2.approx, the scale times log2 e folded into one multiply;
//   each row's visible keys [lo, hi) computed once per block);
//   P is rounded to bf16 and written to shared memory as the A operand of a
//   second wgmma, O += P V, with V's tile as the transposed (MN-major) B
//   operand.  Every operand tile is stored in wgmma's 128-byte swizzle: rows
//   of 64 bf16 (128 bytes) in 1024-byte atoms of 8 rows, the 16-byte chunk c
//   of row r at chunk c ^ (r % 8).  D = 32 pads its rows to 64 and D = 96
//   (MLA's nope 64 + rope 32) to 128: two atoms, the second half-filled.
//   Only the first D columns are multiplied into S (D / 16 k-steps); P V
//   runs over whole atoms (n = 64 each), V's padded columns are zeroed once
//   at the start, and the padded columns of O are never stored.  D = 256
//   keeps four 64-column atoms of Q, K and V and 128 f32 accumulators of O a
//   thread.
//
// * f32: the CUDA cores (core_kernel).  wgmma computes an f32 product only in
//   TF32, which cannot meet the f32 tolerance of 2e-4, so f32 keeps the
//   simple kernel: one block of 4 warps per (16-query tile, batch * query
//   head), each warp 4 query rows in registers, 32-key K/V tiles staged in
//   shared memory, scores by lane-partial dot products and shuffles.  f32
//   runs in the reduced-model checks only; no served bf16 path reaches it.
//
// Both routes walk only the key range a tile's rows can see (the causal and
// window limits), mask ragged Sq and Sk in the kernel (no % 128 rule), and
// give 0 for a row that sees no key.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------- bf16, wgmma

constexpr int kTileRows = 64;    // packed Q rows per block (the wgmma M)
constexpr int kTileKeys = 64;    // keys per K/V tile
constexpr int kAtom = 64 * 128;  // bytes of one 64-row x 128-byte swizzled atom

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of element (row, col), col < 64, in a 128-byte-swizzled atom
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ (row & 7)) << 4) | ((col & 7) << 1));
}

// 16-byte copy, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset, stride byte offset 1024 (8 rows of 128 bytes)
// and layout 1 (128-byte swizzle), address fields in units of 16 bytes.  A
// K-major operand ignores the leading offset (16 bytes by convention); for
// the MN-major V operand both offsets are the 1024-byte step between groups
// of 8 keys, whichever of the two the unit reads for it.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lead_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lead_bytes >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// 2^x in one MUFU instruction (relative error ~2^-22, far inside bf16's)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// pin accumulator registers: no read or write of them moves across this point
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D(64x64, f32) += A(64x16, bf16) * B(16x64, bf16), A and B from shared
// memory; TRANS_B = 1 reads B MN-major.  accumulate = 0 ignores D's input.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t a, uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

// Shared memory of the wgmma route, in 1024-byte-aligned atoms: Q (NB
// atoms), K and V (two stages of NB atoms each), P (one atom); NB = the
// 64-column atoms of a row.
template <int D>
struct WgmmaSmem {
  static constexpr int NB = (D + 63) / 64;
  static constexpr int Q = 0;
  static constexpr int K = Q + NB * kAtom;
  static constexpr int V = K + 2 * NB * kAtom;
  static constexpr int P = V + 2 * NB * kAtom;
  static constexpr int BYTES = P + kAtom + 1024;   // + room to align the base
};

template <int D>
__global__ void __launch_bounds__(128, 1)
wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int sq,
             int sk, int hq, int hkv, int causal, int window, float cap, int q_offset,
             float scale) {
  using L = WgmmaSmem<D>;
  constexpr int NB = L::NB;
  constexpr int CH = D / 8;          // 16-byte chunks of a row
  constexpr int KSTEPS = D / 16;     // k16 steps of Q K^T

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int tile = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_rep = hq / hkv;
  const int rows = sq * n_rep;       // packed (query, head) rows
  const int p0 = tile * kTileRows;

  // the key range any row of this tile can see
  const int i_first = p0 / n_rep;
  const int i_last = (min(p0 + kTileRows, rows) - 1) / n_rep;
  const int k_end = causal ? min(sk, q_offset + i_last + 1) : sk;
  const int k_begin = window > 0 ? max(0, q_offset + i_first - window + 1) : 0;
  const int n_tiles = k_begin < k_end ? (k_end - k_begin + kTileKeys - 1) / kTileKeys : 0;

  const long long kv_row = static_cast<long long>(hkv) * D;   // elements between keys
  const __nv_bfloat16* kb = k + static_cast<long long>(b) * sk * kv_row + g * D;
  const __nv_bfloat16* vb = v + static_cast<long long>(b) * sk * kv_row + g * D;

  // Q tile: packed row r -> query (p0 + r) / n_rep, head g*n_rep + (p0 + r) % n_rep
  for (int i = tid; i < kTileRows * CH; i += 128) {
    const int r = i / CH;
    const int c = i % CH;
    const int p = p0 + r;
    const bool ok = p < rows;
    const __nv_bfloat16* src =
        ok ? q + ((static_cast<long long>(b) * sq + p / n_rep) * hq + g * n_rep + p % n_rep) * D +
                 c * 8
           : q;
    cp_async16(base + L::Q + (c >> 3) * kAtom + swz(r, (c & 7) * 8), src, ok);
  }

  auto load_kv = [&](int t, int stage) {
    const int t0 = k_begin + t * kTileKeys;
    for (int i = tid; i < kTileKeys * CH; i += 128) {
      const int j = i / CH;
      const int c = i % CH;
      const bool ok = t0 + j < k_end;
      const long long off = ok ? (t0 + j) * kv_row + c * 8 : 0;
      const uint32_t at = (stage * NB + (c >> 3)) * kAtom + swz(j, (c & 7) * 8);
      cp_async16(base + L::K + at, kb + off, ok);
      cp_async16(base + L::V + at, vb + off, ok);
    }
  };

  // this thread's accumulator rows, r0 = 16*warp + lane/4 and r0 + 8, and
  // the keys [lo_k, hi_k) each may see (none for a padded row)
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
  // scores in base-2 units: exp(x) = 2^(x log2 e), the scale folded in
  constexpr float kLog2e = 1.4426950408889634f;
  const float scale2 = scale * kLog2e;

  float o_acc[NB][32];
  float s_acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s_acc[i] = 0.f;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) o_acc[nb][i] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  if constexpr (D % 64 != 0) {
    // the padded columns [D, 64 NB) of both V stages: the copies never
    // write them, and P V reads them (their output columns are not stored)
    constexpr int PADC = (64 * NB - D) / 8;   // 16-byte chunks of padding a row
    for (int i = tid; i < 2 * kTileKeys * PADC; i += 128) {
      const int stage = i / (kTileKeys * PADC);
      const int j = i / PADC % kTileKeys;
      const int c = D / 8 + i % PADC;
      *reinterpret_cast<uint4*>(smem + L::V + (stage * NB + (c >> 3)) * kAtom +
                                swz(j, (c & 7) * 8)) = make_uint4(0u, 0u, 0u, 0u);
    }
  }

  if (n_tiles > 0) load_kv(0, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) load_kv(t + 1, stage ^ 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");   // Q and tile t have landed
    fence_async_smem();
    __syncthreads();

    // S = Q K^T over D
    const uint32_t k_tile = base + L::K + stage * NB * kAtom;
    fence_regs(s_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t off = (kk >> 2) * kAtom + (kk & 3) * 32;
      wgmma_m64n64k16<0>(s_acc, desc(base + L::Q + off, 16), desc(k_tile + off, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s_acc);

    // online softmax on the accumulators: s_acc[i] is row r0 + 8*((i>>1)&1),
    // key column 8*(i>>2) + 2*(lane&3) + (i&1)
    const int t0 = k_begin + t * kTileKeys;
    uint32_t ok_bits = 0;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      const int kpos = t0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const float s = cap > 0.f ? cap * tanhf(s_acc[i] * scale / cap) * kLog2e
                                : s_acc[i] * scale2;
      s_acc[i] = s;
      if (kpos >= lo_k[h] && kpos < hi_k[h]) {
        ok_bits |= 1u << i;
        mx[h] = fmaxf(mx[h], s);
      }
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = ex2(m[h] - m_new);
      m[h] = m_new;
    }
    unsigned char* p_tile = smem + L::P;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int h = (i >> 1) & 1;
      const float e0 = (ok_bits >> i) & 1u ? ex2(s_acc[i] - m[h]) : 0.f;
      const float e1 = (ok_bits >> (i + 1)) & 1u ? ex2(s_acc[i + 1] - m[h]) : 0.f;
      const __nv_bfloat162 pb = __floats2bfloat162_rn(e0, e1);
      const float2 pf = __bfloat1622float2(pb);   // sum what the product uses
      rsum[h] += pf.x + pf.y;
      const int row = 16 * warp + (lane >> 2) + 8 * h;
      const int col = 8 * (i >> 2) + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(p_tile + swz(row, col)) = pb;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 1);
      rsum[h] += __shfl_xor_sync(0xffffffffu, rsum[h], 2);
      l[h] = l[h] * alpha[h] + rsum[h];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 32; ++i) o_acc[nb][i] *= alpha[(i >> 1) & 1];
    fence_async_smem();
    __syncthreads();   // P is whole

    // O += P V: A = P (64 x 64 keys), B = V's tile read MN-major
    const uint32_t v_tile = base + L::V + stage * NB * kAtom;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(o_acc[nb]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileKeys / 16; ++kk) {
      const uint64_t a = desc(base + L::P + kk * 32, 16);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        wgmma_m64n64k16<1>(o_acc[nb], a, desc(v_tile + nb * kAtom + kk * 2048, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(o_acc[nb]);
    __syncthreads();   // this stage and P may be overwritten
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
    const int p = p0 + 16 * warp + (lane >> 2) + 8 * h;
    const float inv = 1.f / fmaxf(l[h], 1e-30f);
    __nv_bfloat16* o =
        out + ((static_cast<long long>(b) * sq + p / n_rep) * hq + g * n_rep + p % n_rep) * D;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int i = 2 * h; i < 32; i += 4) {   // registers i, i+1 of row h
        const int d = nb * 64 + 8 * (i >> 2) + 2 * (lane & 3);
        if (d < D)
          *reinterpret_cast<__nv_bfloat162*>(o + d) =
              __floats2bfloat162_rn(o_acc[nb][i] * inv, o_acc[nb][i + 1] * inv);
      }
    }
  }
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int b, int sq,
                         int sk, int hq, int hkv, int causal, int window, float cap,
                         int q_offset, cudaStream_t stream) {
  constexpr int smem = WgmmaSmem<D>::BYTES;
  static bool attr_set = false;   // raise the dynamic shared-memory cap once
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int n_rep = hq / hkv;
  const dim3 grid((sq * n_rep + kTileRows - 1) / kTileRows, hkv, b);
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  wgmma_kernel<D><<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), sq, sk, hq, hkv,
      causal, window, cap, q_offset, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------- f32, CUDA cores

constexpr int kWarps = 4;
constexpr int kRows = 4;                 // query rows per warp
constexpr int kBlockQ = kWarps * kRows;  // query rows per block
constexpr int kTileK = 32;               // keys per shared-memory tile

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
template <int DPL>
__global__ void __launch_bounds__(kWarps * 32)
core_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ out, int sq, int sk, int hq,
            int hkv, int causal, int window, float cap, int q_offset, float scale) {
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
      qr[r][i] =
          live ? q[((static_cast<long long>(b) * sq + row0 + r) * hq + h) * D + lane + 32 * i]
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
      ks[j * D + dd] = k[off];
      vs[j * D + dd] = v[off];
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
      float* o = out + ((static_cast<long long>(b) * sq + row0 + r) * hq + h) * D;
#pragma unroll
      for (int i = 0; i < DPL; ++i) o[lane + 32 * i] = acc[r][i] * inv;
    }
  }
}

template <int DPL>
cudaError_t launch_core(const void* q, const void* k, const void* v, void* out, int b, int sq,
                        int sk, int hq, int hkv, int causal, int window, float cap,
                        int q_offset, cudaStream_t stream) {
  const size_t smem = 2 * kTileK * DPL * 32 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        core_kernel<DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, b * hq);
  const float scale = 1.0f / sqrtf(static_cast<float>(DPL * 32));
  core_kernel<DPL><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), sq, sk, hq, hkv, causal, window, cap, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// causal: 0/1.  window <= 0: no window.  logit_cap <= 0: no soft-cap.
// dtype: 0 = float32 (CUDA-core route), 1 = bfloat16 (wgmma route; q, k, v
// and out 16-byte aligned).  Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int b, int sq, int sk, int hq, int hkv, int d, int causal,
                                     int window, float logit_cap, int q_offset, int dtype,
                                     void* stream) {
  if (b <= 0 || sq <= 0 || hkv <= 0 || hq % hkv != 0 || b > 65535 || hkv > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    switch (d) {
      case 32:
        err = launch_wgmma<32>(q, k, v, out, b, sq, sk, hq, hkv, causal, window, logit_cap,
                               q_offset, st);
        break;
      case 64:
        err = launch_wgmma<64>(q, k, v, out, b, sq, sk, hq, hkv, causal, window, logit_cap,
                               q_offset, st);
        break;
      case 96:
        err = launch_wgmma<96>(q, k, v, out, b, sq, sk, hq, hkv, causal, window, logit_cap,
                               q_offset, st);
        break;
      case 128:
        err = launch_wgmma<128>(q, k, v, out, b, sq, sk, hq, hkv, causal, window, logit_cap,
                                q_offset, st);
        break;
      case 256:
        err = launch_wgmma<256>(q, k, v, out, b, sq, sk, hq, hkv, causal, window, logit_cap,
                                q_offset, st);
        break;
      default:
        err = cudaErrorInvalidValue;
    }
  } else if (dtype == 0) {
    switch (d) {
      case 32:
        err = launch_core<1>(q, k, v, out, b, sq, sk, hq, hkv, causal, window, logit_cap,
                             q_offset, st);
        break;
      case 64:
        err = launch_core<2>(q, k, v, out, b, sq, sk, hq, hkv, causal, window, logit_cap,
                             q_offset, st);
        break;
      case 96:
        err = launch_core<3>(q, k, v, out, b, sq, sk, hq, hkv, causal, window, logit_cap,
                             q_offset, st);
        break;
      case 128:
        err = launch_core<4>(q, k, v, out, b, sq, sk, hq, hkv, causal, window, logit_cap,
                             q_offset, st);
        break;
      case 256:
        err = launch_core<8>(q, k, v, out, b, sq, sk, hq, hkv, causal, window, logit_cap,
                             q_offset, st);
        break;
      default:
        err = cudaErrorInvalidValue;
    }
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
