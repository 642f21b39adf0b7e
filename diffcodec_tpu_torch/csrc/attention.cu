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
// bytes do.  Both also take one exponential per element of P: 1.88e9 in
// the forward at the decode's shape, >= 0.5 ms on the SFUs (16 a clock
// per SM), more than the products' bound at D = 40: they can only hide
// under each other.
//
// Both kernels are FlashAttention-3's structure on the same tile layout:
// TMA copies on mbarriers from a loading warpgroup, two consumer
// warpgroups on wgmma (warp specialisation), every tile row stored as
// 64-column chunks of 128 bytes with the 128-byte swizzle (TMA boxes of 64
// columns, zero fill past D and L), so D = 40 is one chunk with 24 zero
// columns and D = 160 three; products over D take ceil(D / 16) k-steps (40
// -> 48), products whose width is D use N = D exactly (n40), reading the
// row-major operand as MN-major through the descriptor's transpose bit.
// See attention_fwd_kernel and attention_bwd_kernel below.
// Inputs are [BH, L, D] contiguous and 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "hopper.cuh"  // mbarriers, TMA, bulk reductions, wgmma

namespace {

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kRowBytes = 128;  // a 64-column chunk of a bf16 row

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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

// ---------------------------------------------------------------------------
// The forward: one Hopper kernel (FlashAttention-3's forward).
//
// Persistent: one block per SM (at most) walks items of BQ queries of one
// (batch * head), the query blocks of a head next to each other (so that
// the blocks in flight share its K and V in L2); each item walks all its
// keys in tiles of BK.  Warpgroup 0 loads, by TMA, and gives its registers
// to the consumers (setmaxnreg): one thread the Q of each item into QBUF
// buffers (on q_full and q_empty), another K and V of each key tile into a
// ring of STAGES stages (on full and empty) that runs on across items, so
// the next item's Q and first tiles land while this one is computed.
// CONS consumer warpgroups compute, each for 64 of the item's queries,
// with the queries as rows:
//   S   = Q K^T                wgmma, both operands from shared memory,
//                              K-major; m64 x BK (N = BK), ceil(D/16) steps
//   P   = exp2(S * scale_log2 - m)   online softmax, base 2, fp32: m the
//                              running row max, l the running row sum;
//                              ex2.approx; row max and sum over the quad
//                              that holds a row (shuffles)
//   O   = O * exp2(m_old - m) + P V  wgmma, A = P in registers (bf16),
//                              B = V MN-major (rows are keys), N = D
// The main loop overlaps two ways, each switchable (kFwdPingPong,
// kFwdIntraOverlap) so that a build can go without it:
//   * inside a warpgroup, tile j's S is issued before tile j-1's P V, and
//     the softmax of tile j runs while P V of tile j-1 is on the tensor
//     cores (wgmma.wait_group 1); O is rescaled only after that product has
//     been waited for;
//   * between the warpgroups (ping-pong), each issues its two products of
//     a tile at its own named barrier and then lets the next one in the
//     ring issue, so that the others' softmax runs under its products.
// The first tile of an item is peeled off the loop: ptxas serialised every
// wgmma of the kernel (C7514/C7520) while one P V was issued and waited
// for under `if (it > 0)`.
//
// What bounds it (H100, [112, 4096, 4096, 40]): the exponentials and the
// bf16 conversions of P share the SFU pipe (16 a clock per SM: >= 0.5 ms
// for the exponentials alone), the K and V stream into shared memory
// (0.43 ms alone with three consumers), then the products; see PERF.md.
// Hence three consumer warpgroups (192 queries an item) where D <= 64 (O is
// D / 2 fp32 a thread, so 160 registers suffice), which cuts the K and V
// streamed per query by a third, and K and V boxes of exactly D columns.
//
// Keys past Lk: only the tile that holds Lk masks them (-inf logits; TMA
// filled them with zeros).  Queries past Lq are zero rows of Q whose
// results are never written; where Lq leaves a consumer no query at all
// (Lq <= 64: the 8 x 8 latents), it leaves at once.
//
// Epilogue: each row scaled by 1/l and rounded to bf16 once, written from
// registers (a quad writes 16 contiguous bytes of a row a step; Q's buffer
// belongs to the next item by then); lse = (m + log2 l) * ln 2 per row
// where asked.  No atomics: a launch repeats bitwise.
//
// Shared memory (bytes; 1 KB of alignment slack and the mbarriers besides):
//   D <= 40: BQ 192, BK 128, 2 x Q 24576 + 4 stages x (K, V) 2 x 16384
//            = 180224
//   D = 80:  BQ 128, BK 128, Q 32768 + 3 stages x 2 x 32768 = 229376
//   D = 160: BQ 128, BK 64,  Q 49152 + 3 stages x 2 x 24576 = 196608
// (at D = 160 two stages of 128-key K and V, 96 KB each, and Q would not
// fit in 227 KB, and O's 80 fp32 a thread leave no room for a 128-wide S;
// at D = 80 and 160 a second Q buffer would cost a stage, which measured
// slower).  Registers: one block of 128 (1 + CONS) threads per SM; the
// loader keeps 24, a consumer thread up to REGS: S (BK / 2), P (BK / 4 as
// bf16 pairs), O (D / 2).

// consumer warpgroups of a block where D <= 64 (two where D > 64)
constexpr int kFwdNarrowConsumers = 3;
constexpr bool kFwdPingPong = true;      // the warpgroups take turns
constexpr bool kFwdIntraOverlap = true;  // S of tile j before P V of j - 1

template <int D8>
struct FwdTile {
  static constexpr int D = 8 * D8;
  // consumer warpgroups (64 queries each), threads (warpgroup 0 loads),
  // and the registers a consumer thread may use (setmaxnreg; the loader
  // keeps 24 of the SM's 65536)
  static constexpr int CONS = D <= 64 ? kFwdNarrowConsumers : 2;
  static constexpr int BQ = 64 * CONS;  // queries of an item
  static constexpr int THREADS = 128 * (1 + CONS);
  static constexpr int REGS = CONS == 3 ? 160 : 240;
  static constexpr int NC = (D + 63) / 64;  // 64-column chunks of a row
  static constexpr int KD = (D + 15) / 16;  // k-steps of 16 over D
  static constexpr int BK = D > 80 ? 64 : 128;  // keys of a tile
  static constexpr int STAGES = NC == 1 ? 4 : 3;
  // Q buffers: with two, an item's Q lands while the item before computes
  static constexpr int QBUF = NC == 1 ? 2 : 1;
  static constexpr int Q_CHUNK = BQ * kRowBytes;
  static constexpr int KV_CHUNK = BK * kRowBytes;
  static constexpr int Q_BYTES = NC * Q_CHUNK;
  static constexpr int KV_BYTES = NC * KV_CHUNK;  // K (or V) of a tile
  // columns of the last chunk: K and V come in boxes of exactly D columns
  // (64-column boxes and one of TAIL), so TMA writes no zero columns (a
  // box's cost follows its bytes in shared memory: with 64-column boxes
  // the 24 zero columns of D = 40 cost as much as the 40 of data)
  static constexpr int TAIL = D - 64 * (NC - 1);
  static constexpr int KV_TX = BK * D * 2;  // bytes of K (or V) a tile
  // byte offsets from the 1024-aligned base: Q; STAGES x (K, V); the
  // mbarriers
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_KV = QBUF * Q_BYTES;
  static constexpr int OFF_BAR = OFF_KV + STAGES * 2 * KV_BYTES;
  static constexpr size_t SMEM = 1024 + OFF_BAR + 8 * (2 * QBUF + 2 * STAGES);
  static_assert(SMEM <= 232448, "shared memory");
};

// S[64 x BK] = Q K^T over ceil(D / 16) k-steps, both operands K-major by
// descriptor (Q: this warpgroup's 64 rows; K: the tile's stage): issued
// and committed, not waited for
template <typename T>
__device__ __forceinline__ void issue_s(float (&s)[T::BK / 2], uint64_t d_q,
                                        uint64_t d_k) {
#pragma unroll
  for (int kk = 0; kk < T::KD; ++kk) {
    wgmma_ss<T::BK, 0, 0>(
        s, desc_advance(d_q, (kk / 4) * T::Q_CHUNK + (kk % 4) * 32),
        desc_advance(d_k, (kk / 4) * T::KV_CHUNK + (kk % 4) * 32), kk > 0);
  }
  wgmma_commit();
}

// The online softmax of a tile of S (the m64 x BK accumulator: this
// thread's rows 0 (lo) and 1 (hi), columns 8 j + 2 qd (+ 1)) in place:
// s becomes P = exp2(s * scale_log2 - m), m the running row max (scaled,
// base 2; scale_log2 > 0, so the max of the unscaled logits is taken), l
// the running sums of this thread's columns, and c the factors exp2(m_old
// - m) that rescale O and l (0 for the first tile, whose m_old is -inf).
// Keys from `valid` on are masked (-inf) in the tile that holds Lk only.
// Every tile holds a key below Lk, so the new maxima are finite
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&c)[2], float scale_log2,
                                             int valid, int qd) {
  if (valid < BK) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = 8 * j + 2 * qd + e < valid;
        s[4 * j + e] = ok ? s[4 * j + e] : -INFINITY;
        s[4 * j + 2 + e] = ok ? s[4 * j + 2 + e] : -INFINITY;
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], off));
    }
    const float mn = fmaxf(m[h], mx[h] * scale_log2);
    c[h] = fast_exp2(m[h] - mn);
    m[h] = mn;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        x = fast_exp2(fmaf(x, scale_log2, -m[h]));
        sum[h] += x;
      }
    }
  }
  l[0] = fmaf(l[0], c[0], sum[0]);
  l[1] = fmaf(l[1], c[1], sum[1]);
}

// O[64 x D] += P[64 x BK] V[BK x D], A = P in registers (bf16), B = V by
// `d_v`, MN-major (rows are keys): issued and committed, not waited for
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint64_t d_v) {
#pragma unroll
  for (int kv = 0; kv < BK / 16; ++kv) {
    wgmma_rs<D, 1>(o, pa[kv], desc_advance(d_v, kv * 2048), 1);
  }
  wgmma_commit();
}

struct FwdMaps {
  CUtensorMap q;                      // [BH, L, D], boxes of 64 columns
  CUtensorMap k, v, k_tail, v_tail;   // boxes of 64 and of TAIL columns
};

template <int D8>
__global__ void __launch_bounds__(FwdTile<D8>::THREADS, 1)
attention_fwd_kernel(const __grid_constant__ FwdMaps maps,
                     __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int Lq, int Lk,
                     int n_items, float scale_log2) {
  using T = FwdTile<D8>;
  constexpr int D = T::D, NC = T::NC, BK = T::BK;
  extern __shared__ unsigned char smem_raw[];
  // aligned by an offset from smem_raw, so that the compiler keeps the
  // accesses below in the shared space (LDS/STS, not generic LD/ST)
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + T::OFF_BAR);
  uint64_t* q_empty = q_full + T::QBUF;  // Q read by every S of its item
  uint64_t* full = q_empty + T::QBUF;    // stage s holds tile s + k STAGES
  uint64_t* empty = full + T::STAGES;  // stage s read by the consumers

  const int q_blocks = (Lq + T::BQ - 1) / T::BQ;
  const int n_tiles = (Lk + BK - 1) / BK;
  // warpgroups with queries (the ones past Lq leave at once)
  const int consumers = (Lq + 63) / 64 < T::CONS ? (Lq + 63) / 64 : T::CONS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int b = 0; b < T::QBUF; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], 4 * consumers);  // the consumer warps
    }
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * consumers);
    }
    mbar_init_fence();
  }
  if constexpr (T::KD * 16 > D) {
    // S reads K's columns D .. 16 KD - 1, which no copy writes: zero them
    // once (every column of the chunk past TAIL; the copies write the
    // others), so that they meet Q's zero columns as zeros, not as
    // whatever the memory held
    for (int i = threadIdx.x; i < T::STAGES * BK * 8; i += T::THREADS) {
      const int r = i / 8, c16 = i % 8;  // row of the stages' K tail chunks
      if (c16 * 8 >= T::TAIL) {
        const int st = r / BK, row = r % BK;
        *reinterpret_cast<uint4*>(
            base + T::OFF_KV + st * 2 * T::KV_BYTES + (NC - 1) * T::KV_CHUNK +
            row * kRowBytes + ((c16 ^ (row % 8)) << 4)) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
    fence_proxy_async();  // before wgmma reads them
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (lane != 0 || warp > 1) return;
    if (warp == 1) {
      // Q of each item of this block, once every S of the item before has
      // read the buffer
      for (int item = blockIdx.x, i = 0; item < n_items;
           item += gridDim.x, ++i) {
        const int b = i % T::QBUF;
        mbar_wait(&q_empty[b], ((i / T::QBUF) & 1) ^ 1);
        mbar_expect_tx(&q_full[b], T::Q_BYTES);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          tma_load_3d(base + T::OFF_Q + b * T::Q_BYTES + c * T::Q_CHUNK,
                      &maps.q, &q_full[b],
                      64 * c, (item % q_blocks) * T::BQ,
                      item / q_blocks);
        }
      }
      return;
    }
    // K and V of each key tile of each item into the ring, whose stages
    // and phases run on across items (so the next item's first tiles land
    // while this one is computed)
    int kv = 0;  // tiles loaded so far
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int bh = item / q_blocks;
      for (int it = 0; it < n_tiles; ++it, ++kv) {
        const int s = kv % T::STAGES;
        mbar_wait(&empty[s], ((kv / T::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * T::KV_TX);
        unsigned char* st = base + T::OFF_KV + s * 2 * T::KV_BYTES;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const CUtensorMap* mk = c + 1 < NC ? &maps.k : &maps.k_tail;
          const CUtensorMap* mv = c + 1 < NC ? &maps.v : &maps.v_tail;
          tma_load_3d(st + c * T::KV_CHUNK, mk, &full[s], 64 * c, it * BK,
                      bh);
          tma_load_3d(st + T::KV_BYTES + c * T::KV_CHUNK, mv, &full[s],
                      64 * c, it * BK, bh);
        }
      }
    }
    return;
  }

  // consumer warpgroup (queries q0 + 64 wg .. of each item).  Not
  // broadcast with __shfl_sync to mark it warp-uniform: ptxas 12.9 crashed
  // on that in the backward
  const int wg = warp / 4 - 1;
  if (wg >= consumers) return;
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(T::REGS)
               : "memory");
  const int tw = threadIdx.x % 128;  // thread of the warpgroup
  const int w = tw / 32;             // its warp: rows 16 w .. of an m64
  const int g = lane >> 2;           // accumulator row group
  const int qd = lane & 3;           // accumulator column pair
  // the ping-pong: warpgroup wg issues its products at named barrier
  // 1 + wg, then lets the next one in the ring issue
  const bool pingpong = kFwdPingPong && consumers > 1;
  const int next_turn = 1 + (wg + 1) % consumers;
  const bool last_wg = wg == consumers - 1;
  // wgmma descriptors, built once; a k-step and a stage move them by
  // constant byte offsets (desc_advance).  K-major (sbo 1024) where the
  // rows are the operand's M or N, MN-major (lbo = the stride of 64-column
  // chunks) where the rows are its K
  const uint64_t d_q =  // this warpgroup's 64 queries of Q
      desc_sw128(smem_addr(base + T::OFF_Q) + 64 * wg * kRowBytes, 16, 1024);
  const uint64_t d_k = desc_sw128(smem_addr(base + T::OFF_KV), 16, 1024);
  const uint64_t d_v = desc_sw128(smem_addr(base + T::OFF_KV + T::KV_BYTES),
                                  T::KV_CHUNK, 1024);
  // a buffer read by this warp (stage `it` of the ring, or Q)
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  auto stage_off = [&](int it) {
    return (unsigned)((it % T::STAGES) * 2 * T::KV_BYTES);
  };

  float o[D / 2];      // rows 16 w + g (+ 8), columns 8 j + 2 qd (+ 1)
  float s[BK / 2];     // S, then P, of the tile
  uint32_t pa[BK / 16][4];  // P as the A operand, bf16
  int kv = 0;               // tiles consumed so far
  // warpgroup 0 issues first: the last warpgroup primes its barrier once,
  // and so skips the arrival of its own last turn
  if (pingpong && last_wg) named_barrier_arrive<256>(1);
  for (int item = blockIdx.x, i = 0; item < n_items;
       item += gridDim.x, ++i) {
    const int q0 = (item % q_blocks) * T::BQ, bh = item / q_blocks;
    const bool last_item = item + (int)gridDim.x >= n_items;
    zero(o);
    float m[2] = {-INFINITY, -INFINITY};  // running row max, scaled base 2
    float l[2] = {0.f, 0.f};  // running row sums of this thread's columns
    float c[2];               // the tile's rescale factors of O and l

    // Tile 0 is peeled off the loop, so that in the loop every product is
    // issued and waited for unconditionally: ptxas serialises every wgmma
    // of the kernel where a wait it cannot match to its product (one under
    // a branch) leaves an accumulator possibly in flight
    const int qb = i % T::QBUF;  // Q's buffer
    mbar_wait(&q_full[qb], (i / T::QBUF) & 1);
    const uint64_t d_qi = desc_advance(d_q, qb * T::Q_BYTES);
    mbar_wait(&full[kv % T::STAGES], (kv / T::STAGES) & 1);
    if (pingpong) named_barrier<256>(1 + wg);  // this warpgroup's turn
    wgmma_fence();
    issue_s<T>(s, d_qi, desc_advance(d_k, stage_off(kv)));
    if (pingpong && (!last_wg || !last_item || n_tiles > 1)) {
      named_barrier_arrive<256>(next_turn);  // the next warpgroup's turn
    }
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile<BK>(s, m, l, c, scale_log2, Lk, qd);
    pack_a<BK>(pa, s);
    for (int it = 1; it < n_tiles; ++it) {
      mbar_wait(&full[(kv + it) % T::STAGES], ((kv + it) / T::STAGES) & 1);
      if (pingpong) named_barrier<256>(1 + wg);
      wgmma_fence();
      issue_s<T>(s, d_qi, desc_advance(d_k, stage_off(kv + it)));
      // O += P V of the tile before
      issue_pv<D, BK>(o, pa, desc_advance(d_v, stage_off(kv + it - 1)));
      if (pingpong && (!last_wg || !last_item || it + 1 < n_tiles)) {
        named_barrier_arrive<256>(next_turn);
      }
      if constexpr (kFwdIntraOverlap) {
        wgmma_wait<1>();  // S has landed; P V may still run
      } else {
        wgmma_wait<0>();
      }
      fence_regs(s);
      softmax_tile<BK>(s, m, l, c, scale_log2, Lk - it * BK, qd);
      wgmma_wait<0>();  // P V of the tile before has landed
      fence_regs(o);
#pragma unroll
      for (int f = 0; f < BK / 16; ++f) fence_regs(pa[f]);
      release(&empty[(kv + it - 1) % T::STAGES]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= c[0];
        o[4 * j + 1] *= c[0];
        o[4 * j + 2] *= c[1];
        o[4 * j + 3] *= c[1];
      }
      pack_a<BK>(pa, s);
    }
    release(&q_empty[qb]);  // every S of the item has read Q
    wgmma_fence();
    issue_pv<D, BK>(o, pa, desc_advance(d_v, stage_off(kv + n_tiles - 1)));
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int f = 0; f < BK / 16; ++f) fence_regs(pa[f]);
    kv += n_tiles;
    release(&empty[(kv - 1) % T::STAGES]);

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
      l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
    }
    const int row = q0 + 64 * wg + 16 * w + g;  // this thread's rows: + 8
    if (lse != nullptr && qd == 0) {
      // natural-log log-sum-exp of the scaled logits, for the backward
      float* lb = lse + (size_t)bh * Lq;
      if (row < Lq) lb[row] = (m[0] + log2f(l[0])) * kLn2;
      if (row + 8 < Lq) lb[row + 8] = (m[1] + log2f(l[1])) * kLn2;
    }
    // O from registers (Q's buffer is the next item's by now): a quad
    // writes 16 contiguous bytes of a row a step
    const float inv_lo = 1.f / l[0], inv_hi = 1.f / l[1];
    __nv_bfloat16* ob = out + ((size_t)bh * Lq + row) * D + 2 * qd;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (row < Lq) {
        *reinterpret_cast<uint32_t*>(ob + 8 * j) =
            pack_bf16(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
      }
      if (row + 8 < Lq) {
        *reinterpret_cast<uint32_t*>(ob + 8 * D + 8 * j) =
            pack_bf16(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi);
      }
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

// a map of a [BH, L, D] bf16 tensor: boxes of `cols` columns (zero past D)
// by `rows` rows of one (batch * head) (zero past L)
bool encode_bld(EncodeTiled enc, CUtensorMap* map, const void* p, int D,
                int L, int bh, int rows, int cols = 64) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {2 * (cuuint64_t)D, 2 * (cuuint64_t)L * D};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  return encode_bf16(enc, map, p, 3, dims, strides, box);
}

// the current device's SM count, looked up once for each device
cudaError_t sm_count(int* sms) {
  static std::atomic<int> count[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int n = count[dev].load(std::memory_order_acquire);
  if (n == 0) {
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    count[dev].store(n, std::memory_order_release);
  }
  *sms = n;
  return cudaSuccess;
}

template <int D8>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int lq, int lk, float scale,
               cudaStream_t stream) {
  using T = FwdTile<D8>;
  // the row max is taken of the unscaled logits
  if (lq < 1 || !(scale > 0.f)) return (int)cudaErrorInvalidValue;
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  FwdMaps maps = {};
  if (!encode_bld(enc, &maps.q, q, T::D, lq, bh, T::BQ) ||
      !encode_bld(enc, &maps.k, k, T::D, lk, bh, T::BK) ||
      !encode_bld(enc, &maps.v, v, T::D, lk, bh, T::BK) ||
      !encode_bld(enc, &maps.k_tail, k, T::D, lk, bh, T::BK, T::TAIL) ||
      !encode_bld(enc, &maps.v_tail, v, T::D, lk, bh, T::BK, T::TAIL)) {
    return (int)cudaErrorInvalidValue;
  }
  static std::atomic<bool> done[kMaxDevices];
  cudaError_t err = set_smem(attention_fwd_kernel<D8>, T::SMEM, done);
  if (err != cudaSuccess) return (int)err;
  // persistent: one block per SM (at most) walks the items (query block,
  // batch * head), query blocks of a head next to each other
  const long long items = (long long)((lq + T::BQ - 1) / T::BQ) * bh;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int grid = items < sms ? (int)items : sms;
  attention_fwd_kernel<D8><<<grid, T::THREADS, T::SMEM, stream>>>(
      maps, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), lq, lk,
      (int)items, scale * kLog2e);
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
  auto encode = [&](CUtensorMap* map, const void* p, int L, int rows) {
    return encode_bld(enc, map, p, T::D, L, bh, rows);
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
