// Exact softmax attention and its gradient, bf16 in / bf16 out: a forward
// kernel (which also writes each row's log-sum-exp when the caller asks)
// and the backward's dK/dV and dQ kernels.
//
// The forward replaces the TPU kernels
// diffcodec_tpu/ops/attention.py::fused_attention (kernel body
// _make_kernel, pallas_call at :119) and
// diffcodec_tpu/models/layers.py::_flash_self_attention (:195, the stock
// Pallas TPU flash kernel).  Both compute softmax(q k^T * scale) v per
// (batch * head) with fp32 logits; keys past Lk are masked.  The backward
// replaces that flash kernel's backward in the installed jax,
// jax/experimental/pallas/ops/tpu/flash_attention.py
// _flash_attention_bwd_dkv (:941, kernel :796) and _flash_attention_bwd_dq
// (:1287, kernel :1146), which training reaches.
//
// What bounds them on an H100: the bf16 matrix products against the
// 989 TFLOP/s dense bf16 tensor-core rate: 4 * BH * Lq * Lk * D FLOP for
// the forward, 8 for dK/dV (P recomputed, dV, dP, dK) and 6 for dQ (P, dP,
// dQ).  At the decode's heaviest shape (BH = 112, L = 4096, D = 40) the
// forward is 301 GFLOP, 0.30 ms at peak, while q, k, v and o together are
// 147 MB (0.044 ms at 3.35 TB/s): the operations bound it, and so the
// backward at training's [64, 4096, 4096, 40].  At the 77-token
// cross-attention the bytes do.
//
// Forward design (FlashAttention-2's structure, kept simple):
//   * a block of 4 warps takes 64 queries of one (batch*head); each warp
//     owns 16 query rows, whose Q fragments stay in registers;
//   * keys stream through shared memory in chunks of 64 with an fp32
//     online softmax in base 2 (scale folded in), so L = 4096 never writes
//     a logits row to device memory; K and V chunks are copied with
//     cp.async into two stages, so the copy of chunk j + 1 overlaps the
//     products of chunk j;
//   * both products are mma.sync m16n8k16 (bf16 operands, fp32
//     accumulators); the logits, the probabilities (re-packed in registers
//     as the A operand of P.V) and the output accumulator live in
//     registers; V stays row-major and ldmatrix.trans forms its B operand;
//   * D is a template parameter, instantiated for 16, 32, 40, 80 and 160
//     only (any D % 8 == 0 up to 160 would compile): the accumulator is
//     D/8 fragments of 16 x 8, so D = 40 needs no padding in P.V and only
//     40 -> 48 in q.k (zeros in shared memory), not the TPU's 128 lanes;
//     at D = 160 each thread holds 80 fp32 accumulators (228 registers, a
//     12-byte spill);
//   * keys past Lk (the 77-token text context) get -inf logits, so ragged
//     key counts need no padding in device memory.
// Backward design (FlashAttention-2's, split in two kernels so that every
// output is written by one block, without atomics, in a fixed order):
//   * dK/dV: a block of 4 warps owns 64 keys (16 a warp) and streams the
//     queries, dO, lse and Di = rowsum(dO * O) in chunks through two
//     cp.async stages, computing in the transposed form (keys as rows) so
//     that P^T and dS^T, re-packed in registers, are the A operands of
//     dV += P^T dO and dK += dS^T Q;
//   * dQ: a block owns 64 queries and streams K and V, as the forward;
//   * both keep two fp32 accumulators' worth of D columns in registers; at
//     D = 160 the chunk is 32 rows instead of 64 to fit (252 registers for
//     dK/dV, no spill);
//   * P is recomputed from the saved natural-log lse, so the backward reads
//     no [L, L] matrix; padded keys get P = 0 in dQ and are never written
//     in dK/dV; padded queries get lse = +inf, so P = 0.
// Inputs are [BH, L, D] contiguous and 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block
constexpr int kBlockK = 64;           // keys per chunk
constexpr int kMaxDevices = 64;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16-byte global -> shared copy that bypasses registers; zero-fills the
// destination when `valid` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the B operand (16 keys x 8 columns) of P.V from a row-major V tile: two
// 8x8 matrices loaded transposed
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(a));
}

// d[16x8] += a[16x16] . b[16x8], bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [row0, row0 + rows) of a [L, d] bf16 matrix -> shared tile with row
// stride ld, zero past L and in columns [d, dp)
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int rows, int L, int d, int dp,
                                          int ld) {
  const int vec = dp / 8;
  for (int i = threadIdx.x; i < rows * vec; i += kThreads) {
    const int r = i / vec;
    const int c = (i - r * vec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L && c < d) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * d + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// rows [row0, row0 + rows) of a [L, d] bf16 matrix -> shared tile with
// row stride ld, asynchronously; zero past L and in columns [d, dp)
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int row0, int rows, int L,
                                                int d, int dp, int ld) {
  const int vec = dp / 8;
  for (int i = threadIdx.x; i < rows * vec; i += kThreads) {
    const int r = i / vec;
    const int c = (i - r * vec) * 8;
    const bool valid = row0 + r < L && c < d;
    cp_async16(dst + r * ld + c, valid ? src + (size_t)(row0 + r) * d + c
                                       : src, valid);
  }
}

template <int D8>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, int Lq, int Lk,
                     float scale_log2) {
  constexpr int D = 8 * D8;
  constexpr int KD = (D + 15) / 16;  // k-steps of 16 over the padded D
  constexpr int DP = 16 * KD;
  constexpr int LD = DP + 8;         // bf16 row stride of the Q and K tiles
  extern __shared__ __align__(128) unsigned char smem[];
  // Q tile, then two stages of (K chunk, V chunk), all row-major
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* skv = sq + kBlockQ * LD;
  constexpr int kStage = 2 * kBlockK * LD;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const __nv_bfloat16* qb = q + (size_t)bh * Lq * D;
  const __nv_bfloat16* kb = k + (size_t)bh * Lk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Lk * D;

  load_rows(sq, qb, q0, kBlockQ, Lq, D, DP, LD);
  __syncthreads();
  uint32_t qa[KD][4];
  {
    const __nv_bfloat16* base = sq + (warp * 16 + g) * LD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      qa[kk][0] = ld32(base + kk * 16);
      qa[kk][1] = ld32(base + 8 * LD + kk * 16);
      qa[kk][2] = ld32(base + kk * 16 + 8);
      qa[kk][3] = ld32(base + 8 * LD + kk * 16 + 8);
    }
  }

  float acc[D8][4];
#pragma unroll
  for (int n = 0; n < D8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  }
  float m_lo = -INFINITY, m_hi = -INFINITY;  // rows g and g + 8
  float l_lo = 0.f, l_hi = 0.f;              // this thread's partial sums

  // keys stream in chunks of kBlockK through two stages: the copy of
  // chunk j + 1 overlaps the products of chunk j
  const int n_chunks = (Lk + kBlockK - 1) / kBlockK;
  load_rows_async(skv, kb, 0, kBlockK, Lk, D, DP, LD);
  load_rows_async(skv + kBlockK * LD, vb, 0, kBlockK, Lk, D, DP, LD);
  cp_async_commit();
  for (int j = 0; j < n_chunks; ++j) {
    const int k0 = j * kBlockK;
    if (j + 1 < n_chunks) {
      __nv_bfloat16* nxt = skv + ((j + 1) & 1) * kStage;
      load_rows_async(nxt, kb, k0 + kBlockK, kBlockK, Lk, D, DP, LD);
      load_rows_async(nxt + kBlockK * LD, vb, k0 + kBlockK, kBlockK, Lk, D,
                      DP, LD);
    }
    cp_async_commit();
    cp_async_wait<1>();  // chunk j has landed
    __syncthreads();
    const __nv_bfloat16* sk = skv + (j & 1) * kStage;
    const __nv_bfloat16* sv = sk + kBlockK * LD;

    // S[16 x 64] of this warp's rows: 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = sk + (nt * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        mma_16816(s[nt], qa[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
      }
    }

    // online softmax, base 2, keys past Lk masked
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = k0 + nt * 8 + 2 * t + j < Lk;
        s[nt][j] = ok ? s[nt][j] * scale_log2 : -INFINITY;
        s[nt][2 + j] = ok ? s[nt][2 + j] * scale_log2 : -INFINITY;
        mx_lo = fmaxf(mx_lo, s[nt][j]);
        mx_hi = fmaxf(mx_hi, s[nt][2 + j]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float c_lo = exp2f(m_lo - mn_lo), c_hi = exp2f(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= c_lo;
    l_hi *= c_hi;
#pragma unroll
    for (int n = 0; n < D8; ++n) {
      acc[n][0] *= c_lo;
      acc[n][1] *= c_lo;
      acc[n][2] *= c_hi;
      acc[n][3] *= c_hi;
    }
    uint32_t pa[4][4];  // P as the A operand of 4 k-steps of 16 keys
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = exp2f(s[nt][0] - mn_lo), p1 = exp2f(s[nt][1] - mn_lo);
      const float p2 = exp2f(s[nt][2] - mn_hi), p3 = exp2f(s[nt][3] - mn_hi);
      l_lo += p0 + p1;
      l_hi += p2 + p3;
      pa[nt / 2][(nt & 1) * 2 + 0] = pack_bf16(p0, p1);
      pa[nt / 2][(nt & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O[16 x D] += P[16 x 64] . V[64 x D]
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const __nv_bfloat16* vr = sv + (kk * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int n = 0; n < D8; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, vr + n * 8);
        mma_16816(acc[n], pa[kk], b0, b1);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  const int row_lo = q0 + warp * 16 + g;
  const int row_hi = row_lo + 8;
  if (lse != nullptr && t == 0) {
    // natural-log log-sum-exp of the scaled logits, for the backward
    float* lb = lse + (size_t)bh * Lq;
    if (row_lo < Lq) lb[row_lo] = (m_lo + log2f(l_lo)) * kLn2;
    if (row_hi < Lq) lb[row_hi] = (m_hi + log2f(l_hi)) * kLn2;
  }
  __nv_bfloat16* ob = o + (size_t)bh * Lq * D;
#pragma unroll
  for (int n = 0; n < D8; ++n) {
    const int c = n * 8 + 2 * t;
    if (row_lo < Lq) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_lo * D + c) =
          pack_bf16(acc[n][0] * inv_lo, acc[n][1] * inv_lo);
    }
    if (row_hi < Lq) {
      *reinterpret_cast<uint32_t*>(ob + (size_t)row_hi * D + c) =
          pack_bf16(acc[n][2] * inv_hi, acc[n][3] * inv_hi);
    }
  }
}


// the A operand (16 rows x 16 columns at column c0) of a row-major shared
// tile, `base` pointing at row g, column 2t of the warp's 16 rows
__device__ __forceinline__ void a_frag(uint32_t (&a)[4],
                                       const __nv_bfloat16* base, int ld,
                                       int c0) {
  a[0] = ld32(base + c0);
  a[1] = ld32(base + 8 * ld + c0);
  a[2] = ld32(base + c0 + 8);
  a[3] = ld32(base + 8 * ld + c0 + 8);
}

// the A operand of k-step kk (16 columns) from fp32 accumulator tiles of
// 8 columns, rounded to bf16
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                       const float (&x)[N][4], int kk) {
  a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
}

// rows of the backward's chunk: 64 for D <= 80, 32 at D = 160, where the
// two fp32 accumulators of D columns already take 160 registers a thread
template <int D8>
struct BwdChunk {
  static constexpr int kRows = D8 > 10 ? 32 : 64;
};

// dK and dV of kBlockK keys of one (batch * head), each warp 16 keys.
// Queries stream through two shared-memory stages in chunks of BQ; per
// chunk, in the transposed form (keys are the rows):
//   P^T  = exp2(K Q^T * scale_log2 - lse_2[q])   (P recomputed, fp32)
//   dV  += P^T dO                                  (P^T rounded to bf16)
//   dS^T = P^T * (V dO^T - Di[q])
//   dK  += dS^T Q                                  (dS^T rounded to bf16)
// and dK is scaled once at the end.  Queries past Lq get lse = +inf (so
// P = 0) and Di = 0; keys past Lk are computed on zero rows and never
// written.
template <int D8>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int Lq, int Lk,
                         float scale_log2, float scale) {
  constexpr int D = 8 * D8;
  constexpr int KD = (D + 15) / 16;
  constexpr int DP = 16 * KD;
  constexpr int LD = DP + 8;
  constexpr int BQ = BwdChunk<D8>::kRows;
  constexpr int NQ = BQ / 8;   // accumulator tiles of 8 queries
  constexpr int KQ = BQ / 16;  // k-steps of 16 queries
  constexpr int kStage = 2 * BQ * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  // K and V of the block, then two stages of (Q chunk, dO chunk), then two
  // stages of (lse_2, Di) of the chunk's queries
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sv = sk + kBlockK * LD;
  __nv_bfloat16* sqd = sv + kBlockK * LD;
  float* sld = reinterpret_cast<float*>(sqd + 2 * kStage);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBlockK;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const __nv_bfloat16* qb = q + (size_t)bh * Lq * D;
  const __nv_bfloat16* dob = dout + (size_t)bh * Lq * D;
  const float* lb = lse + (size_t)bh * Lq;
  const float* db = delta + (size_t)bh * Lq;

  load_rows_async(sk, k + (size_t)bh * Lk * D, k0, kBlockK, Lk, D, DP, LD);
  load_rows_async(sv, v + (size_t)bh * Lk * D, k0, kBlockK, Lk, D, DP, LD);
  auto load_chunk = [&](int j) {
    __nv_bfloat16* st = sqd + (j & 1) * kStage;
    load_rows_async(st, qb, j * BQ, BQ, Lq, D, DP, LD);
    load_rows_async(st + BQ * LD, dob, j * BQ, BQ, Lq, D, DP, LD);
    float* f = sld + (j & 1) * 2 * BQ;
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const int r = j * BQ + i;
      f[i] = r < Lq ? lb[r] * kLog2e : INFINITY;
      f[BQ + i] = r < Lq ? db[r] : 0.f;
    }
  };
  load_chunk(0);
  cp_async_commit();

  float dk_acc[D8][4], dv_acc[D8][4];
  zero(dk_acc);
  zero(dv_acc);
  const __nv_bfloat16* kw = sk + (warp * 16 + g) * LD + 2 * t;
  const __nv_bfloat16* vw = sv + (warp * 16 + g) * LD + 2 * t;

  const int n_chunks = (Lq + BQ - 1) / BQ;
  for (int j = 0; j < n_chunks; ++j) {
    // stage (j + 1) & 1 was last read in iteration j - 1, before its
    // closing barrier
    if (j + 1 < n_chunks) load_chunk(j + 1);
    cp_async_commit();
    cp_async_wait<1>();  // chunk j (and K, V) landed
    __syncthreads();
    const __nv_bfloat16* sq = sqd + (j & 1) * kStage;
    const __nv_bfloat16* sdo = sq + BQ * LD;
    const float* sl = sld + (j & 1) * 2 * BQ;
    const float* sdi = sl + BQ;

    // P^T [16 keys x BQ queries]
    float p[NQ][4];
    zero(p);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      a_frag(a, kw, LD, kk * 16);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        const __nv_bfloat16* qr = sq + (nt * 8 + g) * LD + 2 * t + kk * 16;
        mma_16816(p[nt], a, ld32(qr), ld32(qr + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float l2 = sl[nt * 8 + 2 * t + jj];
        p[nt][jj] = exp2f(p[nt][jj] * scale_log2 - l2);
        p[nt][2 + jj] = exp2f(p[nt][2 + jj] * scale_log2 - l2);
      }
    }
    // dV [16 x D] += P^T dO
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
      uint32_t a[4];
      pack_a(a, p, kq);
      const __nv_bfloat16* dr = sdo + (kq * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int n = 0; n < D8; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, dr + n * 8);
        mma_16816(dv_acc[n], a, b0, b1);
      }
    }
    // dS^T = P^T * (V dO^T - Di)
    float ds[NQ][4];
    zero(ds);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      a_frag(a, vw, LD, kk * 16);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        const __nv_bfloat16* dr = sdo + (nt * 8 + g) * LD + 2 * t + kk * 16;
        mma_16816(ds[nt], a, ld32(dr), ld32(dr + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const float di = sdi[nt * 8 + 2 * t + jj];
        ds[nt][jj] = p[nt][jj] * (ds[nt][jj] - di);
        ds[nt][2 + jj] = p[nt][2 + jj] * (ds[nt][2 + jj] - di);
      }
    }
    // dK [16 x D] += dS^T Q
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
      uint32_t a[4];
      pack_a(a, ds, kq);
      const __nv_bfloat16* qr = sq + (kq * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int n = 0; n < D8; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, qr + n * 8);
        mma_16816(dk_acc[n], a, b0, b1);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  const int row_lo = k0 + warp * 16 + g;
  const int row_hi = row_lo + 8;
  __nv_bfloat16* dkb = dk + (size_t)bh * Lk * D;
  __nv_bfloat16* dvb = dv + (size_t)bh * Lk * D;
#pragma unroll
  for (int n = 0; n < D8; ++n) {
    const int c = n * 8 + 2 * t;
    if (row_lo < Lk) {
      const size_t o = (size_t)row_lo * D + c;
      *reinterpret_cast<uint32_t*>(dkb + o) =
          pack_bf16(dk_acc[n][0] * scale, dk_acc[n][1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + o) =
          pack_bf16(dv_acc[n][0], dv_acc[n][1]);
    }
    if (row_hi < Lk) {
      const size_t o = (size_t)row_hi * D + c;
      *reinterpret_cast<uint32_t*>(dkb + o) =
          pack_bf16(dk_acc[n][2] * scale, dk_acc[n][3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + o) =
          pack_bf16(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

// dQ of kBlockQ queries of one (batch * head), each warp 16 queries.  Keys
// stream through two stages in chunks of BK; per chunk
//   P   = exp2(Q K^T * scale_log2 - lse_2)   (keys past Lk: P = 0)
//   dS  = P * (dO V^T - Di)
//   dQ += dS K                                 (dS rounded to bf16)
// and dQ is scaled once at the end.  A separate kernel from dK/dV, so each
// output is written by one block, without atomics, in a fixed order.
template <int D8>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int Lq, int Lk,
                        float scale_log2, float scale) {
  constexpr int D = 8 * D8;
  constexpr int KD = (D + 15) / 16;
  constexpr int DP = 16 * KD;
  constexpr int LD = DP + 8;
  constexpr int BK = BwdChunk<D8>::kRows;
  constexpr int NK = BK / 8;
  constexpr int KK = BK / 16;
  constexpr int kStage = 2 * BK * LD;
  extern __shared__ __align__(128) unsigned char smem[];
  // Q and dO of the block, then two stages of (K chunk, V chunk)
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdo = sq + kBlockQ * LD;
  __nv_bfloat16* skv = sdo + kBlockQ * LD;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const __nv_bfloat16* kb = k + (size_t)bh * Lk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Lk * D;

  load_rows_async(sq, q + (size_t)bh * Lq * D, q0, kBlockQ, Lq, D, DP, LD);
  load_rows_async(sdo, dout + (size_t)bh * Lq * D, q0, kBlockQ, Lq, D, DP,
                  LD);
  auto load_chunk = [&](int j) {
    __nv_bfloat16* st = skv + (j & 1) * kStage;
    load_rows_async(st, kb, j * BK, BK, Lk, D, DP, LD);
    load_rows_async(st + BK * LD, vb, j * BK, BK, Lk, D, DP, LD);
  };
  load_chunk(0);
  cp_async_commit();

  const int row_lo = q0 + warp * 16 + g;
  const int row_hi = row_lo + 8;
  const float* lb = lse + (size_t)bh * Lq;
  const float* db = delta + (size_t)bh * Lq;
  const float l2_lo = row_lo < Lq ? lb[row_lo] * kLog2e : INFINITY;
  const float l2_hi = row_hi < Lq ? lb[row_hi] * kLog2e : INFINITY;
  const float di_lo = row_lo < Lq ? db[row_lo] : 0.f;
  const float di_hi = row_hi < Lq ? db[row_hi] : 0.f;

  float acc[D8][4];
  zero(acc);
  const __nv_bfloat16* qw = sq + (warp * 16 + g) * LD + 2 * t;
  const __nv_bfloat16* dw = sdo + (warp * 16 + g) * LD + 2 * t;

  const int n_chunks = (Lk + BK - 1) / BK;
  for (int j = 0; j < n_chunks; ++j) {
    const int k0 = j * BK;
    if (j + 1 < n_chunks) load_chunk(j + 1);
    cp_async_commit();
    cp_async_wait<1>();  // chunk j (and Q, dO) landed
    __syncthreads();
    const __nv_bfloat16* sk = skv + (j & 1) * kStage;
    const __nv_bfloat16* sv = sk + BK * LD;

    float p[NK][4];
    zero(p);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      a_frag(a, qw, LD, kk * 16);
#pragma unroll
      for (int nt = 0; nt < NK; ++nt) {
        const __nv_bfloat16* kr = sk + (nt * 8 + g) * LD + 2 * t + kk * 16;
        mma_16816(p[nt], a, ld32(kr), ld32(kr + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const bool ok = k0 + nt * 8 + 2 * t + jj < Lk;
        p[nt][jj] = ok ? exp2f(p[nt][jj] * scale_log2 - l2_lo) : 0.f;
        p[nt][2 + jj] = ok ? exp2f(p[nt][2 + jj] * scale_log2 - l2_hi) : 0.f;
      }
    }
    float ds[NK][4];
    zero(ds);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a[4];
      a_frag(a, dw, LD, kk * 16);
#pragma unroll
      for (int nt = 0; nt < NK; ++nt) {
        const __nv_bfloat16* vr = sv + (nt * 8 + g) * LD + 2 * t + kk * 16;
        mma_16816(ds[nt], a, ld32(vr), ld32(vr + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        ds[nt][jj] = p[nt][jj] * (ds[nt][jj] - di_lo);
        ds[nt][2 + jj] = p[nt][2 + jj] * (ds[nt][2 + jj] - di_hi);
      }
    }
    // dQ [16 x D] += dS K
#pragma unroll
    for (int kc = 0; kc < KK; ++kc) {
      uint32_t a[4];
      pack_a(a, ds, kc);
      const __nv_bfloat16* kr = sk + (kc * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int n = 0; n < D8; ++n) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, kr + n * 8);
        mma_16816(acc[n], a, b0, b1);
      }
    }
    __syncthreads();  // every warp is done with this stage
  }

  __nv_bfloat16* dqb = dq + (size_t)bh * Lq * D;
#pragma unroll
  for (int n = 0; n < D8; ++n) {
    const int c = n * 8 + 2 * t;
    if (row_lo < Lq) {
      *reinterpret_cast<uint32_t*>(dqb + (size_t)row_lo * D + c) =
          pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    }
    if (row_hi < Lq) {
      *reinterpret_cast<uint32_t*>(dqb + (size_t)row_hi * D + c) =
          pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
    }
  }
}

// the shared-memory limit is a per-device attribute of the function: set
// it once for each device, not on every launch
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem,
               std::atomic<bool> (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!done[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    done[dev].store(true, std::memory_order_release);
  }
  return 0;
}

template <int D8>
constexpr int row_stride() {
  return 16 * ((8 * D8 + 15) / 16) + 8;
}

template <int D8>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int lq, int lk, float scale,
               cudaStream_t stream) {
  constexpr size_t smem =
      sizeof(__nv_bfloat16) * (kBlockQ + 4 * kBlockK) * row_stride<D8>();
  static std::atomic<bool> done[kMaxDevices];
  const int err = allow_smem(attention_fwd_kernel<D8>, smem, done);
  if (err) return err;
  const dim3 grid((lq + kBlockQ - 1) / kBlockQ, bh);
  attention_fwd_kernel<D8><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), lq, lk, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D8>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int bh, int lq, int lk, float scale, cudaStream_t stream) {
  constexpr int BQ = BwdChunk<D8>::kRows;
  constexpr size_t smem =
      sizeof(__nv_bfloat16) * (2 * kBlockK + 4 * BQ) * row_stride<D8>() +
      sizeof(float) * 4 * BQ;
  static std::atomic<bool> done[kMaxDevices];
  const int err = allow_smem(attention_bwd_dkv_kernel<D8>, smem, done);
  if (err) return err;
  const dim3 grid((lk + kBlockK - 1) / kBlockK, bh);
  attention_bwd_dkv_kernel<D8><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), lq,
      lk, scale * kLog2e, scale);
  return (int)cudaGetLastError();
}

template <int D8>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int bh, int lq,
              int lk, float scale, cudaStream_t stream) {
  constexpr int BK = BwdChunk<D8>::kRows;
  constexpr size_t smem =
      sizeof(__nv_bfloat16) * (2 * kBlockQ + 4 * BK) * row_stride<D8>();
  static std::atomic<bool> done[kMaxDevices];
  const int err = allow_smem(attention_bwd_dq_kernel<D8>, smem, done);
  if (err) return err;
  const dim3 grid((lq + kBlockQ - 1) / kBlockQ, bh);
  attention_bwd_dq_kernel<D8><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), lq, lk, scale * kLog2e, scale);
  return (int)cudaGetLastError();
}

// f(std::integral_constant<int, D / 8>) for the head widths the kernels
// are built for: the UNet's (40, 80, 160) and the tiny configs' (16, 32)
template <typename F>
int dispatch_head_dim(int d, int bh, F&& f) {
  if (bh < 1 || bh > 65535) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 16:
      return f(std::integral_constant<int, 2>{});
    case 32:
      return f(std::integral_constant<int, 4>{});
    case 40:
      return f(std::integral_constant<int, 5>{});
    case 80:
      return f(std::integral_constant<int, 10>{});
    case 160:
      return f(std::integral_constant<int, 20>{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// All tensors contiguous, bf16 ones 16-byte aligned; q, o, dout, dq
// [BH, Lq, D], k, v, dk, dv [BH, Lk, D] bf16; lse and delta [BH, Lq] fp32;
// D in {16, 32, 40, 80, 160}.  Each launches on `stream` of the current
// device and returns cudaGetLastError() (0 on success).

// o = softmax(q k^T * scale) v; with lse non-null also the natural-log
// log-sum-exp of each row of scaled logits.
extern "C" int dc_attention_fwd(const void* q, const void* k, const void* v,
                                void* o, void* lse, int bh, int lq, int lk,
                                int d, float scale, void* stream) {
  return dispatch_head_dim(d, bh, [&](auto d8) {
    return launch_fwd<decltype(d8)::value>(q, k, v, o, lse, bh, lq, lk,
                                           scale, (cudaStream_t)stream);
  });
}

// dk, dv of the forward above, given its lse and delta = rowsum(dout * o)
extern "C" int dc_attention_bwd_dkv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int bh, int lq,
                                    int lk, int d, float scale,
                                    void* stream) {
  return dispatch_head_dim(d, bh, [&](auto d8) {
    return launch_dkv<decltype(d8)::value>(q, k, v, dout, lse, delta, dk, dv,
                                           bh, lq, lk, scale,
                                           (cudaStream_t)stream);
  });
}

// dq of the forward above, given its lse and delta = rowsum(dout * o)
extern "C" int dc_attention_bwd_dq(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, int bh, int lq, int lk, int d,
                                   float scale, void* stream) {
  return dispatch_head_dim(d, bh, [&](auto d8) {
    return launch_dq<decltype(d8)::value>(q, k, v, dout, lse, delta, dq, bh,
                                          lq, lk, scale,
                                          (cudaStream_t)stream);
  });
}
