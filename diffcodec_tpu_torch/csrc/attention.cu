// Exact softmax attention and its gradient, bf16 in / bf16 out: a forward
// kernel (which also writes each row's log-sum-exp when the caller asks)
// and one backward kernel that computes dQ, dK and dV.
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
// the forward and 10 for the backward (S, dP, dV, dK, dQ).  At the decode's
// heaviest shape (BH = 112, L = 4096, D = 40) the forward is 301 GFLOP,
// 0.30 ms at peak, while q, k, v and o together are 147 MB (0.044 ms at
// 3.35 TB/s): the operations bound it, and so the backward at training's
// [64, 4096, 4096, 40] (0.434 ms).  At the 77-token cross-attention the
// bytes do.  The backward also takes one exponential per element of P:
// 1.07e9 at that shape, >= 0.26 ms on the SFUs (16 a clock per SM), which
// the products can hide only if P is computed once.
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
// Backward design (FlashAttention-3's structure: TMA, mbarriers, wgmma,
// warp specialisation; P and dP computed once per tile): see
// attention_bwd_kernel below.
// Inputs are [BH, L, D] contiguous and 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "hopper.cuh"  // mbarriers, TMA, bulk reductions, wgmma

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block
constexpr int kBlockK = 64;           // keys per chunk
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

// ---------------------------------------------------------------------------
// The backward: one Hopper kernel for dQ, dK and dV.
//
// A block owns 128 keys of one (batch * head) and walks every query of it
// in tiles of BQ (64; 32 at D = 160).  Warpgroup 0 loads: one thread keeps
// TMA copies in flight (K and V of the block once; then Q and dO of each
// tile into a ring of STAGES stages on mbarriers), while its warp's lanes
// put the tile's lse (in base 2) and Di = rowsum(dO * O) beside them.
// Warpgroups 1 and 2 compute, each for 64 of the keys, with the keys as
// rows (the transposed form), so that P^T and dS^T are the A operands of
// the dV and dK products straight from registers:
//   S^T  = K Q^T                     wgmma, both operands from shared memory
//   dP^T = V dO^T                    wgmma, both from shared memory
//   P^T  = exp2(S^T * scale_log2 - lse_2)      fp32, once per element
//   dV  += P^T dO                    wgmma, A = P^T in registers (bf16)
//   dS^T = P^T * (dP^T - Di)                   fp32
//   dK  += dS^T Q                    wgmma, A = dS^T in registers (bf16)
// dS^T also goes to shared memory (bf16, the 128-byte swizzle), and once
// both warpgroups have stored their halves one of them (alternating by
// tile, so the two stay level) computes the tile's dQ over all 128 keys.
// The hand-over is one-way, on named barriers: the other warpgroup only
// arrives (and goes on to the next tile), and waits only before it
// overwrites a dS^T buffer that the dQ product of two tiles back may still
// read.  (One barrier a tile for both warpgroups timed the same; ptxas
// 12.9 crashed on that form of this kernel.)
//   dQ   = dS K                      wgmma, A = dS^T read transposed
//   (at D = 160: dQ^T = K^T dS^T, m64 tiles over D, as BQ = 32 < 64)
// scales it, writes it to shared memory in fp32 and adds it into the fp32
// dQ accumulator [BH, Lq, D] with one bulk reduction
// (cp.reduce.async.bulk .add.f32).  So dQ is summed over key blocks in an
// order that varies from run to run (its last bits do); dK and dV are
// written once, by the block that owns the keys, scaled at the end.
//
// Head widths: every tile row is stored as 64-column chunks of 128 bytes
// (TMA boxes of 64 columns with the 128-byte swizzle; zero fill past D),
// so D = 40 is one chunk with 24 zero columns and D = 160 three.  The
// products over D (S^T, dP^T) take ceil(D / 16) k-steps (40 -> 48); the
// products whose width is D (dV, dK, dQ) use N = D exactly (n40), reading
// Q, dO and K as MN-major operands through the descriptor's transpose bit.
// Registers: dK and dV take D fp32 a thread; at D = 160 that is 160, so
// the query tile there is 32 (S^T, dP^T m64n32) and dQ is computed as
// three m64n32 tiles of dQ^T.
//
// Tails: keys past Lk are zero rows (TMA's fill); their P^T is set to 0
// (so dQ gets nothing from them, whatever lse is) and their dK, dV are
// never written.  Queries past Lq are zero rows of Q and dO, and their
// lse and Di are stored as 0, not +inf: P^T = exp2(0 - 0) = 1 there, which
// is harmless only because dO = 0 and Di = 0 make their dV term and their
// dS^T exactly 0; the bulk reduction is clipped to the rows below Lq.
//
// Around it, in the same launch (FlashAttention-2/3's pre- and
// post-processing passes): attention_bwd_prep_kernel computes Di from dO
// and O and zeroes the fp32 dQ accumulator, attention_bwd_cast_kernel
// rounds the summed dQ to bf16.

constexpr int kBwdThreads = 384;  // warpgroup 0 loads, 1 and 2 compute
constexpr int kBwdKeys = 128;     // keys of a block: 64 a consumer warpgroup
constexpr int kRowBytes = 128;    // a 64-column chunk of a bf16 row

template <int D8>
struct BwdTile {
  static constexpr int D = 8 * D8;
  static constexpr int BQ = D > 80 ? 32 : 64;  // queries of a tile
  static constexpr int NC = (D + 63) / 64;     // 64-column chunks of a row
  static constexpr int KD = (D + 15) / 16;     // k-steps of 16 over D
  static constexpr bool SWAP_DQ = BQ < 64;     // dQ^T = K^T dS^T
  static constexpr int STAGES = NC == 1 ? 3 : 2;
  static constexpr int KV_CHUNK = kBwdKeys * kRowBytes;
  static constexpr int Q_CHUNK = BQ * kRowBytes;
  static constexpr int KV_BYTES = NC * KV_CHUNK;  // K (or V) of the block
  static constexpr int Q_BYTES = NC * Q_CHUNK;    // Q (or dO) of a tile
  static constexpr int DS_BYTES = kBwdKeys * kRowBytes;  // dS^T, 128 x 64
  static constexpr int DQ_BYTES = BQ * D * 4;     // a tile's dQ in fp32
  // byte offsets from the 1024-aligned base: K, V; STAGES x (Q, dO); two
  // dS^T buffers (by tile parity); two dQ buffers (one a consumer
  // warpgroup); STAGES x (lse_2, Di); the mbarriers
  static constexpr int OFF_K = 0;
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_Q = 2 * KV_BYTES;
  static constexpr int OFF_DS = OFF_Q + STAGES * 2 * Q_BYTES;
  static constexpr int OFF_DQ = OFF_DS + 2 * DS_BYTES;
  static constexpr int OFF_LD = OFF_DQ + 2 * DQ_BYTES;
  static constexpr int OFF_BAR = OFF_LD + STAGES * 2 * BQ * 4;
  static constexpr size_t SMEM = 1024 + OFF_BAR + 8 * (1 + 2 * STAGES);
  static_assert(SMEM <= 232448, "shared memory");
  static_assert(OFF_DS % 1024 == 0, "swizzled buffers are 1024-aligned");
};

struct BwdMaps {
  CUtensorMap q, k, v, dout;  // [BH, L, D], boxes of 64 columns
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the A fragments (k-steps of 16 columns) of an m64nN fp32 accumulator,
// rounded to bf16
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4],
                                       const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.f;
}

template <int D8>
__global__ void __launch_bounds__(kBwdThreads, 1)
attention_bwd_kernel(const __grid_constant__ BwdMaps maps,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int Lq, int Lk,
                     float scale_log2, float scale) {
  using T = BwdTile<D8>;
  constexpr int D = T::D, BQ = T::BQ, NC = T::NC, KD = T::KD;
  extern __shared__ unsigned char smem_raw[];
  // aligned by an offset from smem_raw, so that the compiler keeps the
  // accesses below in the shared space (LDS/STS, not generic LD/ST)
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(base + T::OFF_BAR);
  uint64_t* full = kv_full + 1;       // stage s holds tile s + k STAGES
  uint64_t* empty = full + T::STAGES; // stage s read by both warpgroups
  float* lds = reinterpret_cast<float*>(base + T::OFF_LD);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBwdKeys;
  const int n_tiles = (Lq + BQ - 1) / BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 32);   // the loading warp's lanes
      mbar_init(&empty[s], 8);   // the consumer warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp != 0) return;
    // the loader
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * T::KV_BYTES);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        tma_load_3d(base + T::OFF_K + c * T::KV_CHUNK, &maps.k, kv_full,
                    64 * c, k0, bh);
        tma_load_3d(base + T::OFF_V + c * T::KV_CHUNK, &maps.v, kv_full,
                    64 * c, k0, bh);
      }
    }
    const float* lb = lse + (size_t)bh * Lq;
    const float* db = delta + (size_t)bh * Lq;
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % T::STAGES;
      const int q0 = it * BQ;
      mbar_wait(&empty[s], ((it / T::STAGES) & 1) ^ 1);
      float* f = lds + s * 2 * BQ;
      for (int i = lane; i < BQ; i += 32) {
        const bool in = q0 + i < Lq;  // 0 past Lq: see the tails above
        f[i] = in ? lb[q0 + i] * kLog2e : 0.f;
        f[BQ + i] = in ? db[q0 + i] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(&full[s], 2 * T::Q_BYTES);
        unsigned char* st = base + T::OFF_Q + s * 2 * T::Q_BYTES;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load_3d(st + c * T::Q_CHUNK, &maps.q, &full[s], 64 * c, q0,
                      bh);
          tma_load_3d(st + T::Q_BYTES + c * T::Q_CHUNK, &maps.dout, &full[s],
                      64 * c, q0, bh);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  // consumer warpgroup (keys 64 wg ..).  Not broadcast with __shfl_sync
  // to mark it warp-uniform: ptxas 12.9 crashed on every instantiation
  const int wg = warp / 4 - 1;
  const int tw = threadIdx.x % 128;      // thread of the warpgroup
  const int w = tw / 32;                 // its warp: rows 16 w .. of an m64
  const int g = lane >> 2;               // accumulator row group
  const int qd = lane & 3;               // accumulator column pair
  const int row = 64 * wg + 16 * w + g;  // this thread's key rows: row, + 8
  const bool ok_lo = k0 + row < Lk, ok_hi = k0 + row + 8 < Lk;
  const bool tail = k0 + kBwdKeys > Lk;  // the block has keys past Lk
  // wgmma descriptors, built once; a product's k-step and a tile's stage
  // move them by constant byte offsets (desc_advance).  K-major (sbo 1024)
  // where the rows are the operand's M or N, MN-major (lbo = the stride
  // of 64-column chunks) where the rows are its K
  const unsigned sk = smem_addr(base + T::OFF_K);
  const uint64_t d_k_wg =  // this warpgroup's 64 keys of K, K-major
      desc_sw128(sk + 64 * wg * kRowBytes, 16, 1024);
  const uint64_t d_v_wg =
      desc_sw128(smem_addr(base + T::OFF_V) + 64 * wg * kRowBytes, 16, 1024);
  const uint64_t d_k_mn = desc_sw128(sk, T::KV_CHUNK, 1024);  // K as dQ's B
  const uint64_t d_q_k = desc_sw128(smem_addr(base + T::OFF_Q), 16, 1024);
  const uint64_t d_q_mn =
      desc_sw128(smem_addr(base + T::OFF_Q), T::Q_CHUNK, 1024);
  const uint64_t d_ds = desc_sw128(smem_addr(base + T::OFF_DS), 16, 1024);
  float* stage_dq = reinterpret_cast<float*>(base + T::OFF_DQ +
                                             wg * T::DQ_BYTES);

  float dv_acc[D / 2], dk_acc[D / 2];
  zero(dv_acc);
  zero(dk_acc);
  mbar_wait(kv_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % T::STAGES;
    const unsigned q_off = s * 2 * T::Q_BYTES, do_off = q_off + T::Q_BYTES;
    const float* sl = lds + s * 2 * BQ;  // lse_2 of the tile's queries
    const float* sdi = sl + BQ;          // Di
    mbar_wait(&full[s], (it / T::STAGES) & 1);

    // S^T and dP^T [64 keys x BQ queries], contracting over D (K-major);
    // the first k-step ignores the accumulators (scale-d 0)
    float st[BQ / 2], dpt[BQ / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const unsigned off = (kk / 4) * T::KV_CHUNK + (kk % 4) * 32;
      const unsigned qoff = (kk / 4) * T::Q_CHUNK + (kk % 4) * 32;
      wgmma_ss<BQ, 0, 0>(st, desc_advance(d_k_wg, off),
                         desc_advance(d_q_k, q_off + qoff), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const unsigned off = (kk / 4) * T::KV_CHUNK + (kk % 4) * 32;
      const unsigned qoff = (kk / 4) * T::Q_CHUNK + (kk % 4) * 32;
      wgmma_ss<BQ, 0, 0>(dpt, desc_advance(d_v_wg, off),
                         desc_advance(d_q_k, do_off + qoff), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(st);

    // P^T, fp32; a thread's columns are queries 8 j + 2 qd (+ 1)
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * j + 2 * qd);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l = e ? l2.y : l2.x;
        st[4 * j + e] = fast_exp2(fmaf(st[4 * j + e], scale_log2, -l));
        st[4 * j + 2 + e] =
            fast_exp2(fmaf(st[4 * j + 2 + e], scale_log2, -l));
      }
    }
    if (tail) {  // keys past Lk
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        st[4 * i] = ok_lo ? st[4 * i] : 0.f;
        st[4 * i + 1] = ok_lo ? st[4 * i + 1] : 0.f;
        st[4 * i + 2] = ok_hi ? st[4 * i + 2] : 0.f;
        st[4 * i + 3] = ok_hi ? st[4 * i + 3] : 0.f;
      }
    }
    uint32_t pa[BQ / 16][4];
    pack_a<BQ>(pa, st);
    // dV [64 keys x D] += P^T dO (dO MN-major: rows are queries)
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      wgmma_rs<D, 1>(dv_acc, pa[kq],
                     desc_advance(d_q_mn, do_off + kq * 2048), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // dP^T has landed; dV may still run
    fence_regs(dpt);

    // dS^T = P^T (dP^T - Di), fp32
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(sdi + 8 * j + 2 * qd);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float di = e ? d2.y : d2.x;
        dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - di);
        dpt[4 * j + 2 + e] = st[4 * j + 2 + e] * (dpt[4 * j + 2 + e] - di);
      }
    }
    uint32_t da[BQ / 16][4];
    pack_a<BQ>(da, dpt);
    // dK [64 keys x D] += dS^T Q (Q MN-major)
    wgmma_fence();
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      wgmma_rs<D, 1>(dk_acc, da[kq],
                     desc_advance(d_q_mn, q_off + kq * 2048), 1);
    }
    wgmma_commit();

    // this warpgroup's 64 rows of dS^T [128 keys x BQ queries] into the
    // tile parity's buffer, bf16, 16-byte chunk j of row r at j ^ (r % 8)
    // (the layout TMA's 128-byte swizzle gives; r % 8 == g for both rows).
    // Warpgroup b = it % 2 computes the tile's dQ; the other one first
    // waits until b's dQ product of tile it - 2 has read the buffer
    const int b = it & 1;
    unsigned char* ds = base + T::OFF_DS + b * T::DS_BYTES;
    if (wg != b && it >= 2) {
      named_barrier<256>(3 + b);
    }
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned char* p = ds + row * kRowBytes +
                           (((2 * kq + h) ^ g) << 4) + 4 * qd;
        *reinterpret_cast<uint32_t*>(p) = da[kq][2 * h];
        *reinterpret_cast<uint32_t*>(p + 8 * kRowBytes) = da[kq][2 * h + 1];
      }
    }
    fence_proxy_async();  // before wgmma reads them

    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
#pragma unroll
    for (int kq = 0; kq < BQ / 16; ++kq) {
      fence_regs(pa[kq]);
      fence_regs(da[kq]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // stage s read by this warp
    if (wg != b) {  // this half of dS^T is stored; on to the next tile
      named_barrier_arrive<256>(1 + b);
      continue;
    }
    named_barrier<256>(1 + b);  // the other half is stored

    // dQ of the tile over the block's 128 keys, by warpgroup b.  The bulk
    // reduction that last read stage_dq (two tiles ago) must be done
    // reading it before it is written again
    const uint64_t d_ds_b = desc_advance(d_ds, b * T::DS_BYTES);
    const int q0 = it * BQ;
    if constexpr (!T::SWAP_DQ) {
      // dQ [BQ queries x D] = dS K: A = dS^T read MN-major, B = K MN-major
      float acc[D / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdKeys / 16; ++kk) {
        wgmma_ss<D, 1, 1>(acc, desc_advance(d_ds_b, kk * 2048),
                          desc_advance(d_k_mn, kk * 2048), kk > 0);
      }
      wgmma_commit();
      if (tw == 0) bulk_wait_read<0>();
      wgmma_wait<0>();
      fence_regs(acc);
      if (it + 2 < n_tiles) named_barrier_arrive<256>(3 + b);
      named_barrier<128>(5 + wg);
      // rows (queries) 16 w + g (+ 8), columns 8 j + 2 qd (+ 1)
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        float* p = stage_dq + (16 * w + g) * D + 8 * j + 2 * qd;
        *reinterpret_cast<float2*>(p) =
            make_float2(acc[4 * j] * scale, acc[4 * j + 1] * scale);
        *reinterpret_cast<float2*>(p + 8 * D) =
            make_float2(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
      }
    } else {
      // dQ^T [D x BQ] = K^T dS^T, one m64 tile per 64-column chunk of K:
      // A = K read MN-major (rows are keys), B = dS^T MN-major
      float acc[NC][BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int mt = 0; mt < NC; ++mt) {
#pragma unroll
        for (int kk = 0; kk < kBwdKeys / 16; ++kk) {
          wgmma_ss<BQ, 1, 1>(
              acc[mt], desc_advance(d_k_mn, mt * T::KV_CHUNK + kk * 2048),
              desc_advance(d_ds_b, kk * 2048), kk > 0);
        }
      }
      wgmma_commit();
      if (tw == 0) bulk_wait_read<0>();
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < NC; ++mt) fence_regs(acc[mt]);
      if (it + 2 < n_tiles) named_barrier_arrive<256>(3 + b);
      named_barrier<128>(5 + wg);
      // rows (D) 64 mt + 16 w + g (+ 8), columns (queries) 8 j + 2 qd (+ 1)
#pragma unroll
      for (int mt = 0; mt < NC; ++mt) {
        const int d = 64 * mt + 16 * w + g;
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float* p = stage_dq + (8 * j + 2 * qd + e) * D + d;
            if (d < D) p[0] = acc[mt][4 * j + e] * scale;
            if (d + 8 < D) p[8] = acc[mt][4 * j + 2 + e] * scale;
          }
        }
      }
    }
    fence_proxy_async();  // before the bulk reduction reads them
    named_barrier<128>(5 + wg);
    if (tw == 0) {
      const int rows = Lq - q0 < BQ ? Lq - q0 : BQ;
      bulk_reduce_add_f32(dq + ((size_t)bh * Lq + q0) * D, stage_dq,
                          rows * D * 4);
    }
  }

  // dK (scaled once) and dV of this thread's two key rows
  __nv_bfloat16* dkb = dk + ((size_t)bh * Lk + k0 + row) * D;
  __nv_bfloat16* dvb = dv + ((size_t)bh * Lk + k0 + row) * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int c = 8 * j + 2 * qd;
    if (ok_lo) {
      *reinterpret_cast<uint32_t*>(dkb + c) =
          pack_bf16(dk_acc[4 * j] * scale, dk_acc[4 * j + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvb + c) =
          pack_bf16(dv_acc[4 * j], dv_acc[4 * j + 1]);
    }
    if (ok_hi) {
      *reinterpret_cast<uint32_t*>(dkb + 8 * D + c) =
          pack_bf16(dk_acc[4 * j + 2] * scale, dk_acc[4 * j + 3] * scale);
      *reinterpret_cast<uint32_t*>(dvb + 8 * D + c) =
          pack_bf16(dv_acc[4 * j + 2], dv_acc[4 * j + 3]);
    }
  }
  if (tw == 0) bulk_wait<0>();  // this thread's reductions have landed
}

// Di = rowsum(dO * O) in fp32 for each of the `rows` = BH * Lq rows, by
// eight threads a row: thread c of the eight takes the row's 16-byte
// chunks c, c + 8, .. (of D8) and shuffles add the eight partial sums, so
// that the loads coalesce and even a few thousand rows fill the card; and
// the fp32 dQ accumulator zeroed, float4 by float4 over the whole grid
template <int D8>
__global__ void __launch_bounds__(256)
attention_bwd_prep_kernel(const uint4* __restrict__ o,
                          const uint4* __restrict__ dout,
                          float* __restrict__ delta,
                          float4* __restrict__ dq_acc, int rows) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t r = t / 8;
  float s = 0.f;
  if (r < (size_t)rows) {
#pragma unroll
    for (int j = t % 8; j < D8; j += 8) {
      const uint4 a = o[r * D8 + j];
      const uint4 b = dout[r * D8 + j];
      const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(ha[e]);
        const float2 y = __bfloat1622float2(hb[e]);
        s = fmaf(x.x, y.x, fmaf(x.y, y.y, s));
      }
    }
  }
  // every lane takes part (the rows past the end add zeros)
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  if (r < (size_t)rows && t % 8 == 0) delta[r] = s;
  const size_t n4 = (size_t)rows * 2 * D8;  // D / 4 float4 a row
  for (size_t i = t; i < n4; i += (size_t)gridDim.x * blockDim.x) {
    dq_acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// dq = bf16(dq_acc), four elements a thread a step
__global__ void __launch_bounds__(256)
attention_bwd_cast_kernel(const float4* __restrict__ dq_acc,
                          uint2* __restrict__ dq, size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 x = dq_acc[i];
    dq[i] = make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
  }
}

template <int D8>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int lq, int lk, float scale,
               cudaStream_t stream) {
  constexpr int LD = 16 * ((8 * D8 + 15) / 16) + 8;  // the tiles' row stride
  constexpr size_t smem = sizeof(__nv_bfloat16) * (kBlockQ + 4 * kBlockK) * LD;
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t err = set_smem(attention_fwd_kernel<D8>, smem, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((lq + kBlockQ - 1) / kBlockQ, bh);
  attention_fwd_kernel<D8><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), lq, lk, scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int D8>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* delta, void* dq_acc,
               void* dq, void* dk, void* dv, int bh, int lq, int lk,
               float scale, cudaStream_t stream) {
  using T = BwdTile<D8>;
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  BwdMaps maps = {};
  // [BH, L, D] bf16, boxes of 64 columns (zero past D) by `rows` rows of
  // one (batch * head) (zero past L)
  auto encode = [&](CUtensorMap* map, const void* p, int L, int rows) {
    const cuuint64_t dims[3] = {(cuuint64_t)T::D, (cuuint64_t)L,
                                (cuuint64_t)bh};
    const cuuint64_t strides[2] = {2 * (cuuint64_t)T::D,
                                   2 * (cuuint64_t)L * T::D};
    const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
    return encode_bf16(enc, map, p, 3, dims, strides, box);
  };
  if (lq < 1 || !encode(&maps.q, q, lq, T::BQ) ||
      !encode(&maps.dout, dout, lq, T::BQ) ||
      !encode(&maps.k, k, lk, kBwdKeys) || !encode(&maps.v, v, lk, kBwdKeys)) {
    return (int)cudaErrorInvalidValue;
  }
  static std::atomic<bool> done[kMaxDevices];
  const cudaError_t err = set_smem(attention_bwd_kernel<D8>, T::SMEM, done);
  if (err != cudaSuccess) return (int)err;
  const int rows = bh * lq;
  attention_bwd_prep_kernel<D8><<<(rows + 31) / 32, 256, 0, stream>>>(
      static_cast<const uint4*>(o), static_cast<const uint4*>(dout),
      static_cast<float*>(delta), static_cast<float4*>(dq_acc), rows);
  cudaError_t launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;
  const dim3 grid((lk + kBwdKeys - 1) / kBwdKeys, bh);
  attention_bwd_kernel<D8><<<grid, kBwdThreads, T::SMEM, stream>>>(
      maps, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq_acc), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), lq, lk, scale * kLog2e, scale);
  launched = cudaGetLastError();
  if (launched != cudaSuccess) return (int)launched;
  const size_t n4 = (size_t)rows * 2 * D8;
  const size_t blocks = (n4 + 255) / 256;
  attention_bwd_cast_kernel<<<blocks < 65535 ? blocks : 65535, 256, 0,
                              stream>>>(static_cast<const float4*>(dq_acc),
                                        static_cast<uint2*>(dq), n4);
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

// All tensors contiguous, bf16 ones 16-byte aligned; q, o, dout, dq [BH,
// Lq, D], k, v, dk, dv [BH, Lk, D] bf16; lse and delta [BH, Lq] fp32;
// dq_acc [BH, Lq, D] fp32; D in {16, 32, 40, 80, 160}.  Each launches on
// `stream` of the current device and returns cudaGetLastError() (0 on
// success).

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

// the gradient (dq, dk, dv) of the forward above, given its o and lse, in
// three kernels: delta = rowsum(dout * o) and dq_acc zeroed (both the
// caller's scratch), the backward kernel (dQ summed over key blocks into
// dq_acc by bulk reductions; dk and dv written), then dq = bf16(dq_acc)
extern "C" int dc_attention_bwd(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, void* delta, void* dq_acc,
                                void* dq, void* dk, void* dv, int bh, int lq,
                                int lk, int d, float scale, void* stream) {
  if ((long long)bh * lq > 0x7fffffff) return (int)cudaErrorInvalidValue;
  return dispatch_head_dim(d, bh, [&](auto d8) {
    return launch_bwd<decltype(d8)::value>(q, k, v, o, dout, lse, delta,
                                           dq_acc, dq, dk, dv, bh, lq, lk,
                                           scale, (cudaStream_t)stream);
  });
}
