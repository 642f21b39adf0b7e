// Exact softmax attention, forward only, bf16 in / bf16 out.
//
// Replaces the TPU kernels diffcodec_tpu/ops/attention.py::fused_attention
// (kernel body _make_kernel, pallas_call at :119) and
// diffcodec_tpu/models/layers.py::_flash_self_attention (:195, the stock
// Pallas TPU flash kernel).  Both compute softmax(q k^T * scale) v per
// (batch * head) with fp32 logits; keys past Lk are masked.
//
// What bounds it on an H100: 4 * BH * Lq * Lk * D FLOP of bf16 matrix
// products against the 989 TFLOP/s dense bf16 tensor-core rate.  At the
// decode's heaviest shape (BH = 112, L = 4096, D = 40) that is 301 GFLOP,
// 0.30 ms at peak, while q, k, v and o together are 147 MB (0.044 ms at
// 3.35 TB/s): the operations bound it.
//
// Design (FlashAttention-2's structure, kept simple):
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
// Inputs are [BH, L, D] contiguous and 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block
constexpr int kBlockK = 64;           // keys per chunk
constexpr int kMaxDevices = 64;

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

// rows [row0, row0 + kBlockK) of a [L, d] bf16 matrix -> shared tile with
// row stride ld, asynchronously; zero past L and in columns [d, dp)
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int row0, int L, int d,
                                                int dp, int ld) {
  const int vec = dp / 8;
  for (int i = threadIdx.x; i < kBlockK * vec; i += kThreads) {
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
                     __nv_bfloat16* __restrict__ o, int Lq, int Lk,
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
  load_rows_async(skv, kb, 0, Lk, D, DP, LD);
  load_rows_async(skv + kBlockK * LD, vb, 0, Lk, D, DP, LD);
  cp_async_commit();
  for (int j = 0; j < n_chunks; ++j) {
    const int k0 = j * kBlockK;
    if (j + 1 < n_chunks) {
      __nv_bfloat16* nxt = skv + ((j + 1) & 1) * kStage;
      load_rows_async(nxt, kb, k0 + kBlockK, Lk, D, DP, LD);
      load_rows_async(nxt + kBlockK * LD, vb, k0 + kBlockK, Lk, D, DP, LD);
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

template <int D8>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int lq, int lk, float scale_log2, cudaStream_t stream) {
  constexpr int D = 8 * D8;
  constexpr int LD = 16 * ((D + 15) / 16) + 8;
  constexpr size_t smem =
      sizeof(__nv_bfloat16) * (kBlockQ + 4 * kBlockK) * LD;
  // the shared-memory limit is a per-device attribute of the function: set
  // it once for each device, not on every launch
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(attention_fwd_kernel<D8>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev].store(true, std::memory_order_release);
  }
  const dim3 grid((lq + kBlockQ - 1) / kBlockQ, bh);
  attention_fwd_kernel<D8><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lq, lk, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q [BH, Lq, D], k and v [BH, Lk, D], o [BH, Lq, D]; all bf16, contiguous,
// 16-byte aligned, D in {16, 32, 40, 80, 160}.  Launches on `stream` of the
// current device and returns cudaGetLastError() (0 on success).
extern "C" int dc_attention_fwd(const void* q, const void* k, const void* v,
                                void* o, int bh, int lq, int lk, int d,
                                float scale, void* stream) {
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = (cudaStream_t)stream;
  // the UNet's head widths (40, 80, 160) and the tiny configs' (16, 32)
  switch (d) {
    case 16:
      return launch<2>(q, k, v, o, bh, lq, lk, scale_log2, s);
    case 32:
      return launch<4>(q, k, v, o, bh, lq, lk, scale_log2, s);
    case 40:
      return launch<5>(q, k, v, o, bh, lq, lk, scale_log2, s);
    case 80:
      return launch<10>(q, k, v, o, bh, lq, lk, scale_log2, s);
    case 160:
      return launch<20>(q, k, v, o, bh, lq, lk, scale_log2, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
