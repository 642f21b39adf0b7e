// 3x3 convolutions of the VAE, NHWC, bf16 in / bf16 out, fp32
// accumulation: one implicit-GEMM kernel with three entry points.
//
// Replaces the TPU kernels of diffcodec_tpu/ops/conv_pallas.py:
//   * gn_silu_conv3x3_pallas (:211, pallas_call :239): (x * scale + shift)
//     in fp32, rounded to bf16, SiLU, the SAME-pad ring zeroed, conv3x3 +
//     bias (+ residual) -> dc_conv3x3 with prologue 2;
//   * fused_silu_conv3x3_pallas (:96, pallas_call :108), and its earlier
//     copy scripts/conv_kernel_experiment.py:100: SiLU, conv3x3 + bias ->
//     dc_conv3x3 with prologue 1 (the affine compiled out);
//   * upsample_conv3x3_pallas (:531, pallas_call :544): conv3x3 of the
//     nearest-2x upsampled input, as four output phases of 2x2 collapsed
//     taps at the input resolution -> dc_upsample_conv3x3;
//   * downsample_conv3x3_pallas (:703, pallas_call :736): conv3x3 at
//     stride 2, padded bottom/right (the VAE encoder) or on all sides (the
//     UNet) -> dc_downsample_conv3x3, the stride template (8 x 16 output
//     pixels a block, a 17 x 33 input halo, 64 output channels).  The
//     stride halves the products per halo byte; the encoder's three
//     launches are bound by the operations at 256 and 128 px and by the
//     bytes at 512 px.
//
// What bounds it on an H100: 2 * taps * B * H * W * C * O FLOP of bf16
// products (taps = 9, or 16 collapsed for the upsample) against the
// 989 TFLOP/s dense bf16 rate.  At the decoder's heaviest launch,
// [7, 512, 512, 256 -> 128], that is 1.08 TFLOP (1.09 ms at peak) while
// the input and output are 0.7 GB (0.21 ms at 3.35 TB/s): the operations
// bound every launch of the decoder but the 128 -> 3 out-head, which the
// bytes bound.
//
// Design (mma.sync; no wgmma, no TMA yet):
//   * a block of 16 warps computes 256 output pixels (a 16 x 16 spatial
//     tile of one image, one output phase for the upsample) by BN output
//     channels: BN = 128, or 16 where O <= 16 (the 128 -> 3 out-head and
//     the tiny configs), so a narrow head does not pay for 128 columns;
//   * the input channels are walked in chunks of 16.  A chunk is the
//     (16 + 2) x (16 + 2) halo of the tile and the chunk's weights, [taps][BN]
//     rows of 16 channels (the wrapper lays the weights out chunk by chunk,
//     so a chunk's are one contiguous run), copied with cp.async into one
//     of three shared-memory stages: chunk j + 2 is in flight and chunk
//     j + 1 is activated while chunk j is multiplied, one barrier a chunk;
//   * activation happens once per halo element and chunk, in shared memory,
//     by the thread that copied it: fp32 affine, round to bf16, SiLU, round
//     to bf16 (the rounding order of conv_pallas.py:185-187,194); halo
//     positions outside the image were zero-filled by the copy and are left
//     0 (the pad-ring rule of :188-194: a padded zero must not become
//     silu(shift)); the 9 (or 4) taps then read the halo at shifted
//     offsets;
//   * fragments come from shared memory with ldmatrix.x4 at a row stride of
//     24 bf16 (48 bytes), which puts the 8 rows of a matrix in 8 different
//     bank groups; products are mma.sync m16n8k16 (bf16 operands, fp32
//     accumulators), each warp a 32 x 64 tile (16 x 16 where BN = 16);
//   * the epilogue adds the bias and, under a template flag, the residual
//     in fp32, rounds once to bf16 and stores with masks on the image edge
//     and on O; the upsample writes each phase straight into its place
//     (2y + di, 2x + dj) of [B, 2H, 2W, O], so no 2x tensor and no
//     interleave pass exist;
//   * offsets into activations are 64-bit ([7, 512, 512, 256] holds
//     4.7e8 elements).
// What it does not do yet, and what bounds it (PERF.md): every block
// re-reads its weight tile, ~4 GB from L2 at the heaviest launch, and the
// warps that multiply also start the copies and activate.
// Takes C % 8 == 0 (16-byte vectors of 8 channels), any O >= 1, any H, W.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 512;     // 16 warps
constexpr int kStages = 3;        // shared-memory stages of the chunk ring
constexpr int kWarps = kThreads / 32;
constexpr int kTW = 16;           // output columns of a block's tile
constexpr int kBK = 16;           // input channels per chunk
constexpr int kVec = kBK / 8;     // 16-byte vectors per chunk row
constexpr int kLD = kBK + 8;      // bf16 row stride in shared memory
constexpr int kMaxDevices = 64;

// A block's output tile (TH rows of kTW pixels) and the input halo it
// reads at stride S: 16 x 16 pixels and an 18 x 18 halo at stride 1; 8 x 16
// pixels and a 17 x 33 halo at stride 2, so that three stages still fit in
// shared memory
template <int S>
struct Tile {
  static constexpr int TH = S == 1 ? 16 : 8;
  static constexpr int BM = TH * kTW;               // output pixels
  static constexpr int HALO_W = S * (kTW - 1) + 3;
  static constexpr int HALO = (S * (TH - 1) + 3) * HALO_W;
};

enum Prologue { kNone = 0, kSilu = 1, kAffineSilu = 2 };

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy that bypasses registers; zero-fills the
// destination when `valid` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// 8 channels [c, c + 8) of one input pixel, in place -> the prologue's
// bf16 values; scale and shift are image b's rows, read only for
// kAffineSilu.  The affine is rounded as the plain version computes it (a
// product, then a sum: no fused multiply-add).  SiLU uses the fast
// exponential and division (a few ulp of fp32, below the bf16 rounding
// that follows).
template <int PRO>
__device__ __forceinline__ void prologue(uint4& raw,
                                         const float* __restrict__ scale,
                                         const float* __restrict__ shift,
                                         int c) {
  __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&raw);
  float sc[8], sh[8];
  if (PRO == kAffineSilu) {
    const float4* s4 = reinterpret_cast<const float4*>(scale + c);
    const float4* h4 = reinterpret_cast<const float4*>(shift + c);
    *reinterpret_cast<float4*>(sc) = __ldg(s4);
    *reinterpret_cast<float4*>(sc + 4) = __ldg(s4 + 1);
    *reinterpret_cast<float4*>(sh) = __ldg(h4);
    *reinterpret_cast<float4*>(sh + 4) = __ldg(h4 + 1);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float f = __bfloat162float(v[j]);
    if (PRO == kAffineSilu) {
      f = round_bf16(__fadd_rn(__fmul_rn(f, sc[j]), sh[j]));
    }
    v[j] = __float2bfloat16(__fdividef(f, 1.0f + __expf(-f)));
  }
}

template <int TAPS, int BN, int S>
struct Smem {
  static constexpr int kStage = (Tile<S>::HALO + TAPS * BN) * kLD;  // bf16
  static constexpr size_t kBytes =
      kStages * sizeof(__nv_bfloat16) * kStage;
};

// PRO: prologue; RES: add a residual [B, H, W, O] in the epilogue; UP: the
// upsample's 4 phases of 4 collapsed taps, else 9 taps; BN: output channels
// of a block; WARPS_M x WARPS_N = 16 warps over the BM x BN tile; S: the
// stride (2 only without UP).  Output pixel (oy, ox) of the base grid
// Hb x Wb (the output, or for UP the input resolution) reads input pixel
// (S * oy + dy - pad, S * ox + dx - pad) at tap (dy, dx).
template <int PRO, bool RES, bool UP, int BN, int WARPS_M, int S = 1>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ scale,
               const float* __restrict__ shift,
               const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ bias,
               const __nv_bfloat16* __restrict__ res,
               __nv_bfloat16* __restrict__ out, int H, int W, int C, int O,
               int Hb, int Wb, int pad, int tiles_w) {
  static_assert(S == 1 || (S == 2 && !UP && PRO == kNone), "stride");
  constexpr int TAPS = UP ? 4 : 9;
  constexpr int kTH = Tile<S>::TH;
  constexpr int kBM = Tile<S>::BM;
  constexpr int kHaloW = Tile<S>::HALO_W;
  constexpr int kHalo = Tile<S>::HALO;
  constexpr int WARPS_N = kWarps / WARPS_M;
  constexpr int WM = kBM / WARPS_M;  // rows (pixels) of a warp
  constexpr int WN = BN / WARPS_N;   // columns (channels) of a warp
  constexpr int MT = WM / 16;
  constexpr int NT = WN / 8;
  constexpr int kStage = Smem<TAPS, BN, S>::kStage;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile");
  extern __shared__ __align__(16) unsigned char smem[];
  // kStages stages of [halo kHalo][kLD] then [weights TAPS * BN][kLD]
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);

  const int ty0 = (blockIdx.x / tiles_w) * kTH;
  const int tx0 = (blockIdx.x % tiles_w) * kTW;
  const int iy0 = S * ty0 - pad;  // input pixel of the halo's corner
  const int ix0 = S * tx0 - pad;
  const int n0 = blockIdx.y * BN;
  const int phase = UP ? (blockIdx.z & 3) : 0;
  const int b = UP ? (blockIdx.z >> 2) : blockIdx.z;
  const int di = phase >> 1, dj = phase & 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = warp % WARPS_M;
  const int wn = warp / WARPS_M;

  const __nv_bfloat16* xb = x + (size_t)b * H * W * C;
  const int n_chunks = (C + kBK - 1) / kBK;
  // this phase's weights, [n_chunks][TAPS][O][kBK]: a chunk's tile is one
  // contiguous run, zero past C
  const __nv_bfloat16* wp = w + (size_t)phase * n_chunks * TAPS * O * kBK;
  const size_t bc = PRO == kAffineSilu ? (size_t)b * C : 0;
  const float* scb = scale + bc;  // null, and unread, below kAffineSilu
  const float* shb = shift + bc;

  // one chunk of channels [c0, c0 + kBK): the raw halo and the weights,
  // copied asynchronously into `stage`, as one cp.async group; 0 outside
  // the image, past C and past O
  auto copy_chunk = [&](int c0, __nv_bfloat16* stage) {
    for (int i = threadIdx.x; i < kHalo * kVec; i += kThreads) {
      const int p = i / kVec;
      const int v = i - p * kVec;
      const int y = iy0 + p / kHaloW;
      const int xx = ix0 + p % kHaloW;
      const int c = c0 + v * 8;
      const bool ok = y >= 0 && y < H && xx >= 0 && xx < W && c < C;
      cp_async16(stage + p * kLD + v * 8,
                 ok ? xb + ((size_t)y * W + xx) * C + c : xb, ok);
    }
    __nv_bfloat16* sw = stage + kHalo * kLD;
    const __nv_bfloat16* wc = wp + (size_t)(c0 / kBK) * TAPS * O * kBK;
    for (int i = threadIdx.x; i < TAPS * BN * kVec; i += kThreads) {
      const int r = i / kVec;  // tap * BN + n
      const int v = i - r * kVec;
      const int tap = r / BN;
      const int n = n0 + r - tap * BN;
      const bool ok = n < O;
      cp_async16(sw + r * kLD + v * 8,
                 ok ? wc + ((size_t)tap * O + n) * kBK + v * 8 : wp, ok);
    }
    cp_async_commit();
  };
  // the prologue on the halo vectors this thread copied (its own copies
  // are visible to it once waited for); padding stays 0: a padded zero
  // must not become silu(shift)
  auto activate = [&](int c0, __nv_bfloat16* stage) {
    if (PRO == kNone) return;
    for (int i = threadIdx.x; i < kHalo * kVec; i += kThreads) {
      const int p = i / kVec;
      const int v = i - p * kVec;
      const int y = iy0 + p / kHaloW;
      const int xx = ix0 + p % kHaloW;
      const int c = c0 + v * 8;
      if (y >= 0 && y < H && xx >= 0 && xx < W && c < C) {
        uint4* q = reinterpret_cast<uint4*>(stage + p * kLD + v * 8);
        uint4 val = *q;
        prologue<PRO>(val, scb, shb, c);
        *q = val;
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    }
  }

  // ldmatrix lane roles: A rows (pixels) lane % 16, k half lane / 16; B
  // rows (channels) lane % 8 + 8 * (lane / 16), k half (lane / 8) % 2
  const int a_row = lane & 15;
  const int a_k = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_k = ((lane >> 3) & 1) * 8;

  // chunk j lives in stage j % 3; an empty group keeps the count of
  // cp.async groups uniform, so wait<1> always means "chunk j + 1 landed"
  auto stage = [&](int j) { return stages + (j % kStages) * kStage; };
  copy_chunk(0, stage(0));
  if (n_chunks > 1) copy_chunk(kBK, stage(1));
  else cp_async_commit();
  cp_async_wait<1>();
  activate(0, stage(0));
  __syncthreads();
  for (int j = 0; j < n_chunks; ++j) {
    // stage (j + 2) % 3 was last read in iteration j - 1, before its
    // closing barrier
    if (j + 2 < n_chunks) copy_chunk((j + 2) * kBK, stage(j + 2));
    else cp_async_commit();
    cp_async_wait<1>();
    if (j + 1 < n_chunks) activate((j + 1) * kBK, stage(j + 1));
    const __nv_bfloat16* sx = stage(j);
    const __nv_bfloat16* sw = sx + kHalo * kLD;

#pragma unroll
    for (int tap = 0; tap < TAPS; ++tap) {
      // halo offset of the tap: rows and columns of the padded tile
      const int dy = UP ? (tap >> 1) + di : tap / 3;
      const int dx = UP ? (tap & 1) + dj : tap % 3;
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // an m-tile is one tile row of 16 pixels
        const int py = (wm * WM + mt * 16) / kTW;
        ldmatrix_x4(a[mt], sx + ((S * py + dy) * kHaloW + dx + S * a_row) *
                                    kLD + a_k);
      }
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bf[4];  // b0, b1 of n-tiles nt and nt + 1
        ldmatrix_x4(bf, sw + (tap * BN + wn * WN + nt * 8 + b_row) * kLD +
                            b_k);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_16816(acc[mt][nt], a[mt], bf[0], bf[1]);
          mma_16816(acc[mt][nt + 1], a[mt], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // chunk j + 1 activated for all; stage j free
  }

  // epilogue: + bias (+ residual) in fp32, one rounding to bf16
  const int g = lane >> 2;  // accumulator row group
  const int t = lane & 3;   // accumulator column pair
  const int Ho = UP ? 2 * Hb : Hb;
  const int Wo = UP ? 2 * Wb : Wb;
  const bool pairs = (O & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * WM + mt * 16 + g + 8 * half;
      const int y = ty0 + r / kTW;
      const int xx = tx0 + r % kTW;
      if (y >= Hb || xx >= Wb) continue;
      const int oy = UP ? 2 * y + di : y;
      const int ox = UP ? 2 * xx + dj : xx;
      const size_t o_off = (((size_t)b * Ho + oy) * Wo + ox) * O;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = n0 + wn * WN + nt * 8 + 2 * t;
        if (n >= O) continue;
        const bool two = n + 1 < O;
        float v0 = acc[mt][nt][2 * half] + bias[n];
        float v1 = two ? acc[mt][nt][2 * half + 1] + bias[n + 1] : 0.f;
        if (pairs) {  // n even, O even: n + 1 < O and 4-byte aligned
          if (RES) {
            const __nv_bfloat162 rv =
                *reinterpret_cast<const __nv_bfloat162*>(res + o_off + n);
            v0 += __low2float(rv);
            v1 += __high2float(rv);
          }
          *reinterpret_cast<__nv_bfloat162*>(out + o_off + n) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (RES) v0 += __bfloat162float(res[o_off + n]);
          out[o_off + n] = __float2bfloat16(v0);
          if (two) {
            if (RES) v1 += __bfloat162float(res[o_off + n + 1]);
            out[o_off + n + 1] = __float2bfloat16(v1);
          }
        }
      }
    }
  }
}

template <int PRO, bool RES, bool UP, int BN, int WARPS_M, int S = 1>
int launch(const void* x, const void* scale, const void* shift,
           const void* w, const void* bias, const void* res, void* out,
           int B, int H, int W, int C, int O, int Hb, int Wb, int pad,
           cudaStream_t stream) {
  constexpr size_t smem = Smem<UP ? 4 : 9, BN, S>::kBytes;
  constexpr int kTH = Tile<S>::TH;
  auto kernel = conv3x3_kernel<PRO, RES, UP, BN, WARPS_M, S>;
  // the shared-memory limit is a per-device attribute of the function: set
  // it once for each device, not on every launch
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev].store(true, std::memory_order_release);
  }
  const int tiles_w = (Wb + kTW - 1) / kTW;
  const int tiles_h = (Hb + kTH - 1) / kTH;
  const dim3 grid(tiles_w * tiles_h, (O + BN - 1) / BN, UP ? 4 * B : B);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out), H, W, C, O, Hb, Wb, pad, tiles_w);
  return (int)cudaGetLastError();
}

// BN = 16 (16 warps down the pixels) where O <= 16, else BN = 128 (8 x 2)
template <int PRO, bool RES, bool UP>
int launch_bn(const void* x, const void* scale, const void* shift,
              const void* w, const void* bias, const void* res, void* out,
              int B, int H, int W, int C, int O, cudaStream_t stream) {
  if (O <= 16) {
    return launch<PRO, RES, UP, 16, 16>(x, scale, shift, w, bias, res, out,
                                        B, H, W, C, O, H, W, 1, stream);
  }
  return launch<PRO, RES, UP, 128, 8>(x, scale, shift, w, bias, res, out, B,
                                      H, W, C, O, H, W, 1, stream);
}

bool bad_shape(int B, int H, int W, int C, int O) {
  return B < 1 || H < 1 || W < 1 || C < 8 || C % 8 != 0 || O < 1;
}

}  // namespace

// out [B, H, W, O] = conv3x3 SAME (prologue(x)) + bias (+ res).
// x [B, H, W, C] bf16; w [Cp / 16, 9, O, 16] bf16, C zero-padded to Cp
// (tap = 3 * row + column); bias [O] fp32; scale, shift [B, C] fp32 (read
// only for prologue 2); res [B, H, W, O] bf16 or null.  prologue 1: SiLU
// (no residual: no caller adds one); 2: affine, then SiLU.  x and w
// contiguous and 16-byte aligned, C % 8 == 0.  Launches on `stream` of the
// current device and returns cudaGetLastError().
extern "C" int dc_conv3x3(const void* x, const void* scale, const void* shift,
                          const void* w, const void* bias, const void* res,
                          void* out, int B, int H, int W, int C, int O,
                          int prologue, void* stream) {
  if (bad_shape(B, H, W, C, O)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (prologue == kSilu && !res) {
    return launch_bn<kSilu, false, false>(x, scale, shift, w, bias, res, out,
                                          B, H, W, C, O, s);
  }
  if (prologue == kAffineSilu) {
    if (res) {
      return launch_bn<kAffineSilu, true, false>(x, scale, shift, w, bias,
                                                 res, out, B, H, W, C, O, s);
    }
    return launch_bn<kAffineSilu, false, false>(x, scale, shift, w, bias,
                                                res, out, B, H, W, C, O, s);
  }
  return (int)cudaErrorInvalidValue;
}

// out [B, 2H, 2W, O] = conv3x3 SAME (nearest_up2(x)) + bias.
// x [B, H, W, C] bf16; w [4, Cp / 16, 4, O, 16] bf16: phase di * 2 + dj,
// collapsed tap a * 2 + b (conv_pallas.py::_collapse_upsample_kernel's
// taps), C zero-padded to Cp; bias [O] fp32.  Same requirements and
// return as dc_conv3x3.
extern "C" int dc_upsample_conv3x3(const void* x, const void* w,
                                   const void* bias, void* out, int B, int H,
                                   int W, int C, int O, void* stream) {
  if (bad_shape(B, H, W, C, O)) return (int)cudaErrorInvalidValue;
  return launch_bn<kNone, false, true>(x, nullptr, nullptr, w, bias, nullptr,
                                       out, B, H, W, C, O,
                                       (cudaStream_t)stream);
}

// out [B, Ho, Wo, O] = conv3x3 stride 2 (x padded by `pad` rows and
// columns at the top and left and by 1 at the bottom and right) + bias,
// Ho = (H + pad - 2) / 2 + 1 and Wo likewise: pad 0 is the VAE encoder's
// downsampler, pad 1 the UNet's (symmetric).  x [B, H, W, C] bf16; w, bias
// as for dc_conv3x3; same requirements and return.  A block computes 8 x 16
// output pixels by 64 output channels (shared memory holds three stages of
// the 17 x 33 input halo and 9 x 64 weight rows).
extern "C" int dc_downsample_conv3x3(const void* x, const void* w,
                                     const void* bias, void* out, int B,
                                     int H, int W, int C, int O, int pad,
                                     void* stream) {
  if (bad_shape(B, H, W, C, O) || (pad != 0 && pad != 1) || H + pad < 2 ||
      W + pad < 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int Ho = (H + pad - 2) / 2 + 1;
  const int Wo = (W + pad - 2) / 2 + 1;
  return launch<kNone, false, false, 64, 8, 2>(
      x, nullptr, nullptr, w, bias, nullptr, out, B, H, W, C, O, Ho, Wo, pad,
      (cudaStream_t)stream);
}
