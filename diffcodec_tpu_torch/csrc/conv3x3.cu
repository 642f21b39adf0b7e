// 3x3 convolutions of the VAE, NHWC, bf16 in / bf16 out, fp32
// accumulation: implicit GEMMs behind three entry points.
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
//     UNet) -> dc_downsample_conv3x3.
//
// What bounds each entry on an H100 (989 TFLOP/s dense bf16, 3.35 TB/s):
//   * dc_conv3x3: 2 * 9 * B * H * W * C * O FLOP.  At the decoder's
//     heaviest launch, [7, 512, 512, 256 -> 128], that is 1.08 TFLOP
//     (1.09 ms at peak) against 0.7 GB of input and output (0.21 ms): the
//     operations bound every launch but the 128 -> 3 out-head, which the
//     bytes bound.
//   * dc_downsample_conv3x3: a quarter of the products per input byte.
//     The encoder's [8, 512, 512, 128 -> 128] is bound by its 0.67 GB
//     (0.200 ms), its 256 and 128 px launches by the operations (0.156 ms).
//   * dc_upsample_conv3x3: 2 * 16 * B * H * W * C * O FLOP (16 collapsed
//     taps at the input resolution, 4/9 of the upsampled conv's), bound by
//     the operations: 0.97 ms at [7, 256, 256, 256 -> 256] and at
//     [7, 128, 128, 512 -> 512].
//
// Two main loops.  Every entry runs on the Hopper loop where O > 16;
// dc_conv3x3 and dc_upsample_conv3x3 take the mma.sync loop where O <= 16.
//
// The Hopper loop (conv3x3_hopper): dc_conv3x3 and dc_upsample_conv3x3
// where O > 16, and dc_downsample_conv3x3 at every O.  Three modes: stride
// 1, stride 2 and the upsample.  Persistent: one block of 512 threads
// per SM walks tiles i, i + #SMs, ...; its roles walk the same sequence of
// (tile, chunk of 64 input channels) steps, so the copies and the
// activation run ahead into the next tile while the consumers finish one.
//   * warp 0, one thread: the producer.  It keeps TMA copies in flight on
//     mbarriers: the input halo of a step (one 128-byte row a pixel,
//     128-byte swizzle) into a ring of 3 stages (2 at stride 2), and the
//     step's weights tap by tap (128 output channels x 64 input channels,
//     16 KB, 128-byte swizzle) into a ring of 6 stages (4 at stride 2).
//     The halo comes from a 4-D tensor map over [B, H, W, C] whose
//     out-of-bounds zero fill is the SAME pad ring and the zeros past C;
//     the weights from a 3-D map over the wrapper's layout
//     [Cp / 64][9][O][64] (the upsample's [4][Cp / 64][4][O][64]).  The
//     maps are encoded on the host (cuTensorMapEncodeTiled, fetched with
//     cudaGetDriverEntryPoint, so nothing links libcuda) and passed as
//     __grid_constant__ parameters.
//   * warps 1-7, for prologues 1 and 2: the activation.  Each landed halo
//     stage is turned into the prologue's bf16 values in place (fp32 affine
//     as a product then a sum, rounded to bf16; SiLU; rounded to bf16: the
//     rounding order of conv_pallas.py:185-187,194), only at in-image
//     positions below C (the pad-ring rule of conv_pallas.py:188-194: a
//     padded zero must not become silu(shift)), then released to the
//     consumers on its own mbarrier.  Seven warps, not three: with three
//     the activation, not the products, set the pace.
//   * warps 8-15, two consumer warpgroups: each takes half of a tile's
//     output pixels (128 of a 16 x 16 tile at stride 1; 64 of an 8 x 16
//     tile at stride 2) by 128 output channels, and issues
//     wgmma.mma_async m64n128k16 with A from registers (ldmatrix.x4 from
//     the swizzled halo at the tap's shifted window: the m16n8k16 A
//     fragment, one warp's 16 rows one tile row of 16 pixels) and B from a
//     shared-memory descriptor (128-byte swizzle, K-major).  Taps are split
//     into two groups of two k-steps; two register buffers of A let one
//     group's ldmatrix run while the group before it multiplies
//     (wgmma.wait_group 1).  A weight stage, and a chunk's halo stage, go
//     back to the producer only once wgmma has read what came from them.
//     setmaxnreg moves registers from the producer/activation side (56) to
//     the consumers (200).
//   * stride 2 reads four parity planes of the halo (even/odd rows x
//     even/odd columns), each from its own tensor map over the input seen
//     at twice its strides: tap (dy, dx) reads plane (dy & 1, dx & 1) at
//     offset (dy >> 1, dx >> 1), so its rows are unit-stride and the
//     consumer code is the stride-1 code.  BN = 128 fetches each input byte
//     once at O = 128.
//   * the upsample computes the nearest-2x upsampled conv at the input
//     resolution: output phase (di, dj) of input position (y, x) is a 2 x 2
//     conv with collapsed taps (a, b) of input pixel (y - 1 + di + a,
//     x - 1 + dj + b).  A tile is one phase of a 16 x 16 tile of input
//     positions, so its halo is the stride-1 halo and its taps read the
//     stride-1 windows shifted by (di, dj); a step takes 4 taps, not 9.
//     The phase sits next to the output-channel tile in the tile walk, so
//     the four phases of a halo run side by side on the SMs and read it
//     from L2.  The epilogue writes tile pixel (r, c) to output pixel
//     (2 (ty0 + r) + di, 2 (tx0 + c) + dj), still 8 channels a store.
//   * the epilogue adds the bias and, under a template flag, the residual
//     (its rows prefetched into L2 during the tile's last chunk) in fp32
//     and rounds once to bf16; where O % 8 == 0 a quad of lanes trades
//     accumulators so each lane writes 8 channels with one 16-byte store
//     (else 2- and 1-element stores), masked on the image edge and O.
// What bounds it now (PERF.md): shared-memory bandwidth.  wgmma reads B
// from shared memory once for every m64 (1 byte per 64 FLOP) and ldmatrix
// reads A once for 128 columns (1 byte per 128 FLOP): at the tensor cores'
// peak, 96 of the SM's 128 bytes a clock, before the TMA writes and the
// activation's read and write.  O = 128 layers cannot take n256, which
// would halve A's share.  The upsample reaches 70-76% of its bound on an
// H100 at 700 W: with its products off it takes half the time, with its
// copies or its stores off 5-7% less (PERF.md).
//
// The mma.sync loop (conv3x3_kernel), kept for dc_conv3x3 and
// dc_upsample_conv3x3 where O <= 16 (the 128 -> 3 out-head, bound by
// bytes): a 128-column wgmma tile would be 8x wider than the output.
// A block of 16 warps computes 256 output pixels (a 16 x 16 tile, one
// output phase for the upsample) by BN = 16 channels; input channels are
// walked in chunks of 16 (read from the weight layout's chunks of 64),
// copied with cp.async into a three-stage ring and activated once in
// shared memory by the thread that copied them; fragments come by
// ldmatrix at a 48-byte row stride (conflict-free) into mma.sync m16n8k16.
//
// Both take C % 8 == 0 (16-byte vectors of 8 channels), any O >= 1, any
// H, W (stride 2: H, W >= 2); offsets into activations are 64-bit
// ([7, 512, 512, 256] holds 4.7e8 elements).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"  // mbarriers, TMA, wgmma, tensor maps

namespace {

enum Prologue { kNone = 0, kSilu = 1, kAffineSilu = 2 };

// four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// the affine of channels [c, c + 8) from image b's rows of scale and
// shift, read only for kAffineSilu
template <int PRO>
__device__ __forceinline__ void affine_of(float (&sc)[8], float (&sh)[8],
                                          const float* __restrict__ scale,
                                          const float* __restrict__ shift,
                                          int c) {
  if (PRO == kAffineSilu) {
    const float4* s4 = reinterpret_cast<const float4*>(scale + c);
    const float4* h4 = reinterpret_cast<const float4*>(shift + c);
    *reinterpret_cast<float4*>(sc) = __ldg(s4);
    *reinterpret_cast<float4*>(sc + 4) = __ldg(s4 + 1);
    *reinterpret_cast<float4*>(sh) = __ldg(h4);
    *reinterpret_cast<float4*>(sh + 4) = __ldg(h4 + 1);
  }
}

// 8 channels of one input pixel, in place -> the prologue's bf16 values,
// with sc, sh their affine.  The affine is rounded as the plain version
// computes it (a product, then a sum: no fused multiply-add).  SiLU uses the
// fast exponential and division (a few ulp of fp32, below the bf16 rounding
// that follows).
template <int PRO>
__device__ __forceinline__ void prologue(uint4& raw, const float (&sc)[8],
                                         const float (&sh)[8]) {
  __nv_bfloat16* v = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float f = __bfloat162float(v[j]);
    if (PRO == kAffineSilu) {
      f = round_bf16(__fadd_rn(__fmul_rn(f, sc[j]), sh[j]));
    }
    v[j] = __float2bfloat16(__fdividef(f, 1.0f + __expf(-f)));
  }
}

// ---------------------------------------------------------------------------
// The Hopper loop: TMA, mbarriers, wgmma, warp specialisation.

constexpr int kHThreads = 512;    // 2 producer/activation WGs, 2 consumer
constexpr int kActThreads = 224;  // warps 1-7
constexpr int kConsumerWarp0 = 8;
constexpr int kConsumerWarps = 8;
constexpr int kCK = 64;           // input channels of a chunk: 128 bytes
constexpr int kBN = 128;          // output channels of a tile
constexpr int kWBytes = kBN * kCK * 2;  // one tap's weight stage

constexpr int round1024(int b) { return (b + 1023) / 1024 * 1024; }

// The Hopper loop's three modes: S = 1, 2 the conv's stride; S = 0 the
// nearest-2x upsample (its tiles, halo and taps at the input resolution).
// An output tile (TH x TW pixels; for the upsample TH x TW input positions
// of one output phase) and its halo: one (TH + 2) x (TW + 2) box at
// stride 1 and for the upsample; four (TH + 1) x (TW + 1) parity planes at
// stride 2.  MT: m64 tiles of each consumer warpgroup; TAPS: weight stages
// of a chunk (9 taps, or the upsample's 4 collapsed ones).  STAGED: the
// epilogue writes the tile into a shared-memory stage of STAGE_BYTES and
// warpgroup 1 stores it while the consumers go on with the next tile: the
// upsample, whose epilogue writes four output bytes for each input byte
// (its stores took 27% of the kernel before, PERF.md).  HS, WS: halo and
// weight stages, as many as shared memory holds (a third halo stage at
// stride 1 beat two more weight stages)
template <int S>
struct HTile {
  static constexpr int TH = S == 2 ? 8 : 16;
  static constexpr int TW = 16;
  static constexpr int MT = TH * TW / 128;
  static constexpr int PH = S == 2 ? TH + 1 : TH + 2;
  static constexpr int PW = S == 2 ? TW + 1 : TW + 2;
  static constexpr int PLANES = S == 2 ? 4 : 1;
  static constexpr int TAPS = S == 0 ? 4 : 9;
  static constexpr int BOX_BYTES = PH * PW * kCK * 2;  // one TMA box
  static constexpr int PLANE_BYTES = round1024(BOX_BYTES);
  static constexpr int HALO_BYTES = PLANES * PLANE_BYTES;
  static constexpr bool STAGED = S == 0;
  static constexpr int STAGE_BYTES = STAGED ? TH * TW * kBN * 2 : 0;
  static constexpr int HS = S == 2 || STAGED ? 2 : 3;  // halo stages
  static constexpr int WS = S == 2 || STAGED ? 4 : 6;  // weight stages
  static constexpr int N_BARS = 3 * HS + 2 * WS + (STAGED ? 2 : 0);
  // + 1024 to align the buffers (the 128-byte swizzle repeats every 1024)
  static constexpr size_t SMEM = 1024 + HS * HALO_BYTES + WS * kWBytes +
                                 STAGE_BYTES + 8 * N_BARS;
  static_assert(SMEM <= 232448, "shared memory");
};

// the tensor maps of a launch: the input (stride 1: x[0]; stride 2: the
// parity plane (row & 1, column & 1) in x[2 * (row & 1) + (column & 1)])
// and the weights
struct Maps {
  CUtensorMap x[4];
  CUtensorMap w;
};

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// a[i][e]: this lane's channels 2q + e of n-tile i of four (q = lane & 3,
// an accumulator's column pair); returns in v[c] channel c of n-tile q,
// gathered from the quad's four lanes in two rounds of shuffles
__device__ __forceinline__ void quad_transpose(const float (&a)[4][2],
                                               float (&v)[8], int q) {
  const bool b0 = q & 1, b1 = q & 2;
  // with lane q ^ 1: keep the n-tiles i with i % 2 == q % 2; the pair then
  // holds their channels 4 (q / 2) .. 4 (q / 2) + 3
  float s1[2][4];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float keep = b0 ? a[2 * t + 1][e] : a[2 * t][e];
      const float send = b0 ? a[2 * t][e] : a[2 * t + 1][e];
      const float recv = __shfl_xor_sync(0xffffffffu, send, 1);
      s1[t][e] = b0 ? recv : keep;
      s1[t][2 + e] = b0 ? keep : recv;
    }
  }
  // with lane q ^ 2: keep n-tile q
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float keep = b1 ? s1[1][c] : s1[0][c];
    const float send = b1 ? s1[0][c] : s1[1][c];
    const float recv = __shfl_xor_sync(0xffffffffu, send, 2);
    v[c] = b1 ? recv : keep;
    v[4 + c] = b1 ? keep : recv;
  }
}

// where a block's tile lies: output tile (ty0, tx0) of image b, output
// channels [n0, n0 + 128); for the upsample, the tile of input positions
// at (ty0, tx0) and output phase p = 2 di + dj
struct TileAt {
  int ty0, tx0, n0, b, p;
};

// tiles are numbered with the output-channel tile fastest, then (for the
// upsample) the phase, then the column, the row and the image: the blocks
// in flight at any time share their input halos and all of their weights
// in L2 (with the column fastest, a halo was read from memory once for
// every output-channel tile: PERF.md)
template <int S>
__device__ __forceinline__ TileAt tile_at(int tile, int tiles_w, int tiles_h,
                                          int tiles_n) {
  using T = HTile<S>;
  TileAt t;
  t.n0 = (tile % tiles_n) * kBN;
  tile /= tiles_n;
  t.p = S == 0 ? tile & 3 : 0;
  if (S == 0) tile >>= 2;
  t.tx0 = (tile % tiles_w) * T::TW;
  tile /= tiles_w;
  t.ty0 = (tile % tiles_h) * T::TH;
  t.b = tile / tiles_h;
  return t;
}

// the output row and column of a tile's row r and column c: for the
// upsample (2 (ty0 + r) + di, 2 (tx0 + c) + dj)
template <int S>
__device__ __forceinline__ int out_row(const TileAt& t, int r) {
  return S == 0 ? 2 * (t.ty0 + r) + (t.p >> 1) : t.ty0 + r;
}

template <int S>
__device__ __forceinline__ int out_col(const TileAt& t, int c) {
  return S == 0 ? 2 * (t.tx0 + c) + (t.p & 1) : t.tx0 + c;
}

// PRO: prologue; RES: add a residual [B, Ho, Wo, O] in the epilogue; S: the
// stride (2 only with kNone), or 0 for the upsample (kNone, no residual).
// Output pixel (oy, ox) reads input pixel (S * oy + dy - pad, S * ox + dx -
// pad) at tap (dy, dx).  The upsample's output pixel (2y + di, 2x + dj)
// reads input pixel (y - 1 + di + a, x - 1 + dj + b) at collapsed tap
// (a, b) of phase (di, dj): the stride-1 halo of input position (y, x),
// shifted by (di, dj); its out-of-bounds zero fill is the SAME pad ring of
// the upsampled image.  Persistent: block i takes tiles i, i + gridDim.x,
// ... of the n_tiles = tiles_w x tiles_h x tiles_n x B (x 4 phases) tiles,
// and every role walks the same sequence of (tile, chunk) steps, so the
// producer and the activation run ahead into the next tile while the
// consumers finish this one.
template <int PRO, bool RES, int S>
__global__ void __launch_bounds__(kHThreads, 1)
conv3x3_hopper(const __grid_constant__ Maps maps,
               const float* __restrict__ scale,
               const float* __restrict__ shift,
               const float* __restrict__ bias,
               const __nv_bfloat16* __restrict__ res,
               __nv_bfloat16* __restrict__ out, int H, int W, int C, int O,
               int Ho, int Wo, int pad, int tiles_w, int tiles_h,
               int tiles_n, int n_tiles) {
  static_assert(S == 1 || (PRO == kNone && (S == 2 || (S == 0 && !RES))),
                "mode");
  using T = HTile<S>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* halo = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* wts = halo + T::HS * T::HALO_BYTES;
  // STAGED: a tile's bf16 outputs, [pixel][128 channels], the 16-byte
  // vector v of pixel px at v ^ (px & 7) (conflict-free on both sides)
  unsigned char* stage = wts + T::WS * kWBytes;
  uint64_t* hfull = reinterpret_cast<uint64_t*>(stage + T::STAGE_BYTES);
  uint64_t* hact = hfull + T::HS;    // halo activated (prologues 1, 2)
  uint64_t* hempty = hact + T::HS;   // halo read by the consumers
  uint64_t* wfull = hempty + T::HS;
  uint64_t* wempty = wfull + T::WS;
  uint64_t* sfull = wempty + T::WS;  // STAGED: the stage written
  uint64_t* sempty = sfull + 1;      // STAGED: the stage stored

  const int n_chunks = (C + kCK - 1) / kCK;
  // this block's steps: (tile, chunk) pairs, chunk fastest; step k uses
  // halo stage k % HS
  const int my_tiles = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                       (int)gridDim.x;
  const int n_steps = my_tiles * n_chunks;
  auto step_tile = [&](int k) {
    return tile_at<S>(blockIdx.x + (k / n_chunks) * gridDim.x, tiles_w,
                      tiles_h, tiles_n);
  };
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < T::HS; ++i) {
      mbar_init(&hfull[i], 1);
      mbar_init(&hact[i], kActThreads);
      mbar_init(&hempty[i], kConsumerWarps);
    }
    for (int i = 0; i < T::WS; ++i) {
      mbar_init(&wfull[i], 1);
      mbar_init(&wempty[i], kConsumerWarps);
    }
    if (T::STAGED) {  // every writer and every reader arrives
      mbar_init(sfull, 32 * kConsumerWarps);
      mbar_init(sempty, 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp < kConsumerWarp0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (warp == 0) {
      if (lane != 0) return;
      // the producer: the halo of step k in stage k % HS, the weights of
      // (step, tap) in stage (TAPS * step + tap) % WS.  The halo of step
      // k + HS - 1 is asked for after step k's third tap, when the stage
      // it overwrites (step k - 1's) is about to be released
      auto load_halo = [&](int k) {
        const int s = k % T::HS;
        const TileAt t = step_tile(k);
        const int iy0 = (S == 2 ? 2 * t.ty0 : t.ty0) - pad;
        const int ix0 = (S == 2 ? 2 * t.tx0 : t.tx0) - pad;
        const int c0 = (k % n_chunks) * kCK;
        mbar_wait_asm(&hempty[s], ((k / T::HS) & 1) ^ 1);
        mbar_expect_tx(&hfull[s], T::PLANES * T::BOX_BYTES);
        unsigned char* dst = halo + s * T::HALO_BYTES;
        if (S != 2) {
          tma_load_4d(dst, &maps.x[0], &hfull[s], c0, ix0, iy0, t.b);
        } else {
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            // plane p holds input rows iy0 + (p >> 1) + 2u, columns
            // ix0 + (p & 1) + 2v: row r of the input is row r >> 1 of
            // parity plane r & 1 (floor division, so -1 -> -1: padding)
            const int ry = iy0 + (p >> 1), rx = ix0 + (p & 1);
            tma_load_4d(dst + p * T::PLANE_BYTES,
                        &maps.x[2 * (ry & 1) + (rx & 1)], &hfull[s], c0,
                        rx >> 1, ry >> 1, t.b);
          }
        }
      };
      int ws = 0;
      uint32_t wph = 0;
      for (int k = 0; k < T::HS - 1 && k < n_steps; ++k) load_halo(k);
      for (int k = 0; k < n_steps; ++k) {
        const TileAt t = step_tile(k);
        // the chunk's taps in the weight layout [P][Cp / 64][TAPS][O][64]
        // (P = 4 phases for the upsample, else 1)
        const int d0 = (t.p * n_chunks + k % n_chunks) * T::TAPS;
        for (int tap = 0; tap < T::TAPS; ++tap) {
          mbar_wait_asm(&wempty[ws], wph ^ 1);
          mbar_expect_tx(&wfull[ws], kWBytes);
          tma_load_3d(wts + ws * kWBytes, &maps.w, &wfull[ws], 0, t.n0,
                      d0 + tap);
          if (++ws == T::WS) {
            ws = 0;
            wph ^= 1;
          }
          if (tap == 2 && k + T::HS - 1 < n_steps) load_halo(k + T::HS - 1);
        }
      }
      return;
    }
    if (T::STAGED) {
      // warpgroup 1 stores each staged tile.  Thread t keeps 16-byte
      // vector t % 16 of tile columns t / 16 and t / 16 + 8 of every row:
      // a warp takes two pixels' 256-byte rows a pass, so its reads cover
      // the banks once and its 16-byte stores fill whole sectors
      if (warp < 4 || (O & 7) != 0) return;  // O % 8 != 0: stored directly
      const int vec = threadIdx.x % 16;
      const int c0 = (threadIdx.x - 128) / 16;
      const int sw = (vec ^ c0) << 4;  // its place in a row: px & 7 == c0
      for (int k0 = 0, j = 0; k0 < n_steps; k0 += n_chunks, ++j) {
        const TileAt at = step_tile(k0);
        const int n = at.n0 + 8 * vec;
        mbar_wait_asm(sfull, j & 1);
        if (n < O) {
#pragma unroll 2
          for (int r = 0; r < T::TH; ++r) {
            const int y = out_row<S>(at, r);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = c0 + 8 * h;
              const int xx = out_col<S>(at, c);
              if (y < Ho && xx < Wo) {
                *reinterpret_cast<uint4*>(
                    out + (((size_t)at.b * Ho + y) * Wo + xx) * O + n) =
                    *reinterpret_cast<const uint4*>(
                        stage + (r * T::TW + c) * (kBN * 2) + sw);
              }
            }
          }
        }
        mbar_arrive(sempty);
      }
      return;
    }
    if (PRO == kNone) return;
    // the activation, in place, on every landed halo stage.  A thread
    // keeps one group of 8 channels of the chunk, and its scale and shift
    // in registers, and walks every 28th pixel row; in row `row` the group
    // sits in 16-byte vector grp ^ (row & 7) (the 128-byte swizzle), so 8
    // neighbouring threads cover one row, conflict-free
    const int t = threadIdx.x - 32;
    const int grp = t & 7;
    constexpr int kRowStep = kActThreads / 8;
    for (int k = 0; k < n_steps; ++k) {
      const int s = k % T::HS;
      const TileAt at = step_tile(k);
      const int iy0 = at.ty0 - 1, ix0 = at.tx0 - 1;
      const int c = (k % n_chunks) * kCK + 8 * grp;
      float sc[8], sh[8];
      if (c < C) {
        const size_t bc = PRO == kAffineSilu ? (size_t)at.b * C : 0;
        affine_of<PRO>(sc, sh, scale + bc, shift + bc, c);
      }
      mbar_wait_asm(&hfull[s], (k / T::HS) & 1);
      unsigned char* st = halo + s * T::HALO_BYTES;
#pragma unroll 2
      for (int row = t >> 3; row < T::PH * T::PW; row += kRowStep) {
        const int hy = row / T::PW;
        const int y = iy0 + hy;
        const int xx = ix0 + row - hy * T::PW;
        if (c < C && y >= 0 && y < H && xx >= 0 && xx < W) {
          uint4* q = reinterpret_cast<uint4*>(st + row * 128 +
                                              ((grp ^ (row & 7)) << 4));
          uint4 val = *q;
          prologue<PRO>(val, sc, sh);
          *q = val;
        }
      }
      // these generic-proxy writes precede the next TMA write of the stage
      fence_proxy_async();
      mbar_arrive(&hact[s]);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 200;\n" ::: "memory");
  const int cw = warp - kConsumerWarp0;
  const int cg = cw >> 2;  // consumer warpgroup
  const int wq = cw & 3;   // warp of the warpgroup: 16 rows of each m64
  // ldmatrix lane roles: A row (pixel of the tile row) lane % 16, k half
  // lane / 16
  const int a_px = lane & 15;
  const int a_half = lane >> 4;
  const unsigned wts_s = smem_addr(wts);
  float acc[T::MT][64];
  uint32_t afr[2][T::MT][2][4];  // [group parity][m-tile][k-step][4]
  int ws = 0;
  uint32_t wph = 0;
  for (int k0 = 0; k0 < n_steps; k0 += n_chunks) {
    const TileAt at = step_tile(k0);
    // the upsample's phase (di, dj) shifts every tap's window by (di, dj)
    const int ph_off = S == 0 ? (at.p >> 1) * T::PW + (at.p & 1) : 0;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[mt][i] = 0.f;
      fence_regs(acc[mt]);
    }
    int rel = -1;  // the weight stage to give back after the next wait
    for (int k = k0; k < k0 + n_chunks; ++k) {
      const int s = k % T::HS;
      if (RES && k == k0 + n_chunks - 1) {
        // the epilogue's residual rows into L2 while the last chunk runs:
        // this lane's pixel row, 64 of its 256 bytes
#pragma unroll
        for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int y = at.ty0 + (cg * T::MT + mt) * 4 + wq;
            const int xx = at.tx0 + (lane >> 2) + 8 * half;
            if (y < Ho && xx < Wo && at.n0 + 32 * (lane & 3) < O) {
              prefetch_l2(res + (((size_t)at.b * Ho + y) * Wo + xx) * O +
                          at.n0 + 32 * (lane & 3));
            }
          }
        }
      }
      mbar_wait_asm(PRO == kNone ? &hfull[s] : &hact[s], (k / T::HS) & 1);
      const unsigned hb = smem_addr(halo + s * T::HALO_BYTES);
#pragma unroll
      for (int tap = 0; tap < T::TAPS; ++tap) {
        // (row, column) of the tap; (a, b) of the upsample's collapsed tap
        const int dy = S == 0 ? tap >> 1 : tap / 3;
        const int dx = S == 0 ? tap & 1 : tap % 3;
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // k-steps 2h, 2h + 1 of the tap
#pragma unroll
          for (int mt = 0; mt < T::MT; ++mt) {
            const int r = (cg * T::MT + mt) * 4 + wq;  // tile row
            const int hr =
                S == 2 ? (r + (dy >> 1)) * T::PW + a_px + (dx >> 1)
                       : (r + dy) * T::PW + a_px + dx + ph_off;
            const unsigned base =
                hb +
                (S == 2 ? ((dy & 1) * 2 + (dx & 1)) * T::PLANE_BYTES : 0) +
                hr * 128;
#pragma unroll
            for (int k2 = 0; k2 < 2; ++k2) {
              const int c16 = 2 * (2 * h + k2) + a_half;  // logical 16 B
              ldmatrix_x4(afr[h][mt][k2], base + ((c16 ^ (hr & 7)) << 4));
            }
          }
          if (h == 0) mbar_wait_asm(&wfull[ws], wph);
          wgmma_fence();
#pragma unroll
          for (int mt = 0; mt < T::MT; ++mt) {
#pragma unroll
            for (int k2 = 0; k2 < 2; ++k2) {
              wgmma_rs<kBN, 0>(acc[mt], afr[h][mt][k2],
                               desc_sw128(wts_s + ws * kWBytes +
                                              (2 * h + k2) * 32,
                                          16, 1024),
                               1);
            }
          }
          wgmma_commit();
          // the group before this one has completed, and with it the
          // previous tap's weights and, at a chunk's first tap, the
          // previous chunk's halo.  The halo goes back only now: once
          // wgmma has read the registers that ldmatrix filled from it (an
          // arrive right after the ldmatrix let the next TMA copy
          // overwrite rows still being read)
          wgmma_wait<1>();
          if (h == 0) {
            if (rel >= 0) {
              __syncwarp();
              if (lane == 0) {
                mbar_arrive(&wempty[rel]);
                if (tap == 0) mbar_arrive(&hempty[(k - 1) % T::HS]);
              }
            }
            rel = ws;
          } else if (++ws == T::WS) {
            ws = 0;
            wph ^= 1;
          }
        }
      }
    }
    // the tile's last products, then its last weight and halo stages back
    // before the epilogue, so the producer can fill them meanwhile
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) fence_regs(acc[mt]);
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&wempty[rel]);
      mbar_arrive(&hempty[(k0 + n_chunks - 1) % T::HS]);
    }

    // epilogue: + bias (+ residual) in fp32, one rounding to bf16.  Thread
    // (row g, column pair q) of n-tile jn holds acc[4 jn + 2 half + {0, 1}]:
    // pixel g + 8 half of the warp's tile row, channels 8 jn + 2 q + {0, 1}.
    // Where O % 8 == 0 the quad's four lanes first trade values
    // (quad_transpose), so that each lane holds the 8 channels of one
    // n-tile and writes them with one 16-byte store: a warp's store then
    // fills whole 32-byte sectors, where a 4-byte store fills half of one.
    // Where STAGED, the 16-byte vectors go to the stage instead (once the
    // store warps have taken the tile before), all 128 channels (past O
    // too: masked when stored).
    const int g = lane >> 2;
    const int q = lane & 3;
    if ((O & 7) == 0) {
      if (T::STAGED) mbar_wait_asm(sempty, ((k0 / n_chunks) & 1) ^ 1);
#pragma unroll
      for (int mt = 0; mt < T::MT; ++mt) {
        const int r = (cg * T::MT + mt) * 4 + wq;
        const int y = out_row<S>(at, r);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int xx = out_col<S>(at, g + 8 * half);
          const bool inside = y < Ho && xx < Wo;
          const size_t o_off = (((size_t)at.b * Ho + y) * Wo + xx) * O;
          // the row's residual vectors, all asked for before the first is
          // needed (one at a time, each load's latency showed)
          uint4 rv[kBN / 32];
#pragma unroll
          for (int m = 0; m < kBN / 32; ++m) {
            const int n = at.n0 + 8 * (4 * m + q);
            if (RES && inside && n < O) {
              rv[m] = __ldg(reinterpret_cast<const uint4*>(res + o_off + n));
            }
          }
#pragma unroll
          for (int m = 0; m < kBN / 32; ++m) {
            float a[4][2], v[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              a[i][0] = acc[mt][4 * (4 * m + i) + 2 * half];
              a[i][1] = acc[mt][4 * (4 * m + i) + 2 * half + 1];
            }
            quad_transpose(a, v, q);
            const int n = at.n0 + 8 * (4 * m + q);
            if (T::STAGED) {
              const int px = r * T::TW + g + 8 * half;
              // channels past O take channel 0's bias (a branch here
              // spilled a register): they are not stored
              const float* bn = bias + (n < O ? n : 0);
              const float4 b0 = __ldg(reinterpret_cast<const float4*>(bn));
              const float4 b1 =
                  __ldg(reinterpret_cast<const float4*>(bn + 4));
              uint4 pk;
              __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&pk);
              p2[0] = __floats2bfloat162_rn(v[0] + b0.x, v[1] + b0.y);
              p2[1] = __floats2bfloat162_rn(v[2] + b0.z, v[3] + b0.w);
              p2[2] = __floats2bfloat162_rn(v[4] + b1.x, v[5] + b1.y);
              p2[3] = __floats2bfloat162_rn(v[6] + b1.z, v[7] + b1.w);
              *reinterpret_cast<uint4*>(
                  stage + px * (kBN * 2) + (((4 * m + q) ^ (px & 7)) << 4)) =
                  pk;
              continue;
            }
            if (!inside || n >= O) continue;
            const float4 b0 = __ldg(reinterpret_cast<const float4*>(bias + n));
            const float4 b1 =
                __ldg(reinterpret_cast<const float4*>(bias + n + 4));
            v[0] += b0.x, v[1] += b0.y, v[2] += b0.z, v[3] += b0.w;
            v[4] += b1.x, v[5] += b1.y, v[6] += b1.z, v[7] += b1.w;
            uint4 pk;
            __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&pk);
            if (RES) {
              pk = rv[m];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                v[2 * i] += __low2float(p2[i]);
                v[2 * i + 1] += __high2float(p2[i]);
              }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              p2[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
            }
            *reinterpret_cast<uint4*>(out + o_off + n) = pk;
          }
        }
      }
      if (T::STAGED) mbar_arrive(sfull);
      continue;
    }
    const bool pairs = (O & 1) == 0;
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
      const int y = out_row<S>(at, (cg * T::MT + mt) * 4 + wq);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int xx = out_col<S>(at, g + 8 * half);
        if (y >= Ho || xx >= Wo) continue;
        const size_t o_off = (((size_t)at.b * Ho + y) * Wo + xx) * O;
#pragma unroll
        for (int jn = 0; jn < kBN / 8; ++jn) {
          const int n = at.n0 + jn * 8 + 2 * q;
          if (n >= O) continue;
          const bool two = n + 1 < O;
          float v0 = acc[mt][4 * jn + 2 * half] + bias[n];
          float v1 =
              two ? acc[mt][4 * jn + 2 * half + 1] + bias[n + 1] : 0.f;
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
}

template <int PRO, bool RES, int S>
int launch_hopper(const void* x, const void* scale, const void* shift,
                  const void* w, const void* bias, const void* res, void* out,
                  int B, int H, int W, int C, int O, int Ho, int Wo, int pad,
                  cudaStream_t stream) {
  using T = HTile<S>;
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  Maps maps = {};
  const cuuint64_t e = 2;  // bytes of a bf16
  const int n_chunks = (C + kCK - 1) / kCK;
  {  // weights [P * n_chunks * TAPS][O][64]: box one tap's 128 x 64
    const cuuint64_t dims[3] = {(cuuint64_t)kCK, (cuuint64_t)O,
                                (cuuint64_t)(S == 0 ? 4 : 1) * n_chunks *
                                    T::TAPS};
    const cuuint64_t strides[2] = {kCK * e, (cuuint64_t)O * kCK * e};
    const cuuint32_t box[3] = {kCK, kBN, 1};
    if (!encode_bf16(enc, &maps.w, w, 3, dims, strides, box)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  const cuuint64_t img = (cuuint64_t)H * W * C * e;
  constexpr int SX = S == 2 ? 2 : 1;  // a parity plane steps 2 pixels
  for (int p = 0; p < T::PLANES; ++p) {
    // stride 1 and the upsample: [B, H, W, C]; stride 2: parity plane
    // (py, px), the pixels (py + 2i, px + 2j) of every image
    const int py = p >> 1, px = p & 1;
    const cuuint64_t dims[4] = {
        (cuuint64_t)C, (cuuint64_t)(S == 2 ? (W - px + 1) / 2 : W),
        (cuuint64_t)(S == 2 ? (H - py + 1) / 2 : H), (cuuint64_t)B};
    const cuuint64_t strides[3] = {SX * C * e, SX * (cuuint64_t)W * C * e,
                                   img};
    const cuuint32_t box[4] = {kCK, T::PW, T::PH, 1};
    const __nv_bfloat16* base =
        static_cast<const __nv_bfloat16*>(x) + ((size_t)py * W + px) * C;
    if (!encode_bf16(enc, &maps.x[p], base, 4, dims, strides, box)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  auto kernel = conv3x3_hopper<PRO, RES, S>;
  static std::atomic<bool> smem_set[kMaxDevices];
  cudaError_t err = set_smem(kernel, T::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return (int)err;
  // tiles over the output, or for the upsample over the input's positions
  // (x 4 phases)
  const int tiles_w = ((S == 0 ? W : Wo) + T::TW - 1) / T::TW;
  const int tiles_h = ((S == 0 ? H : Ho) + T::TH - 1) / T::TH;
  const int tiles_n = (O + kBN - 1) / kBN;
  const long long n_tiles =
      (long long)tiles_w * tiles_h * tiles_n * B * (S == 0 ? 4 : 1);
  if (n_tiles > (1LL << 30)) return (int)cudaErrorInvalidValue;
  // one block per SM (its shared memory allows no second)
  const int grid = (int)(n_tiles < sms ? n_tiles : sms);
  kernel<<<grid, kHThreads, T::SMEM, stream>>>(
      maps, static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out), H, W, C, O, Ho, Wo, pad, tiles_w,
      tiles_h, tiles_n, (int)n_tiles);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The mma.sync loop (dc_conv3x3 and dc_upsample_conv3x3 where O <= 16).

constexpr int kThreads = 512;     // 16 warps
constexpr int kStages = 3;        // shared-memory stages of the chunk ring
constexpr int kWarps = kThreads / 32;
constexpr int kMmaBN = 16;         // output channels of a block
constexpr int kTW = 16;           // output columns of a block's tile
constexpr int kTH = 16;           // output rows of a block's tile
constexpr int kBM = kTH * kTW;    // output pixels of a block
constexpr int kHaloW = kTW + 2;
constexpr int kHalo = (kTH + 2) * kHaloW;
constexpr int kBK = 16;           // input channels per chunk
constexpr int kVec = kBK / 8;     // 16-byte vectors per chunk row
constexpr int kLD = kBK + 8;      // bf16 row stride in shared memory

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

template <int TAPS, int BN>
struct Smem {
  static constexpr int kStage = (kHalo + TAPS * BN) * kLD;  // bf16
  static constexpr size_t kBytes =
      kStages * sizeof(__nv_bfloat16) * kStage;
};

// PRO: prologue; RES: add a residual [B, H, W, O] in the epilogue; UP: the
// upsample's 4 phases of 4 collapsed taps, else 9 taps.  A block computes
// BN = 16 output channels (the loop serves O <= 16 only), its 16 warps
// (WARPS_M) down the pixels; KW: the input channels of a chunk of the
// weight layout ([P][Cp / KW][TAPS][O][KW], read 16 channels at a time).
// Output pixel (oy, ox) of the base grid H x W (the output, or for UP the
// input resolution) reads input pixel (oy + dy - 1, ox + dx - 1) at tap
// (dy, dx).
template <int PRO, bool RES, bool UP>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
               const float* __restrict__ scale,
               const float* __restrict__ shift,
               const __nv_bfloat16* __restrict__ w,
               const float* __restrict__ bias,
               const __nv_bfloat16* __restrict__ res,
               __nv_bfloat16* __restrict__ out, int H, int W, int C, int O,
               int tiles_w) {
  constexpr int BN = kMmaBN, WARPS_M = kWarps, KW = kCK;
  constexpr int TAPS = UP ? 4 : 9;
  constexpr int WARPS_N = kWarps / WARPS_M;
  constexpr int WM = kBM / WARPS_M;  // rows (pixels) of a warp
  constexpr int WN = BN / WARPS_N;   // columns (channels) of a warp
  constexpr int MT = WM / 16;
  constexpr int NT = WN / 8;
  constexpr int kStage = Smem<TAPS, BN>::kStage;
  static_assert(WM % 16 == 0 && WN % 16 == 0, "warp tile");
  extern __shared__ __align__(16) unsigned char smem[];
  // kStages stages of [halo kHalo][kLD] then [weights TAPS * BN][kLD]
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem);

  const int ty0 = (blockIdx.x / tiles_w) * kTH;
  const int tx0 = (blockIdx.x % tiles_w) * kTW;
  const int iy0 = ty0 - 1;  // input pixel of the halo's corner
  const int ix0 = tx0 - 1;
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
  // this phase's weights, [Cp / KW][TAPS][O][KW], zero past C
  const __nv_bfloat16* wp =
      w + (size_t)phase * ((C + KW - 1) / KW) * TAPS * O * KW;
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
    const __nv_bfloat16* wc =
        wp + (size_t)(c0 / KW) * TAPS * O * KW + c0 % KW;
    for (int i = threadIdx.x; i < TAPS * BN * kVec; i += kThreads) {
      const int r = i / kVec;  // tap * BN + n
      const int v = i - r * kVec;
      const int tap = r / BN;
      const int n = n0 + r - tap * BN;
      const bool ok = n < O;
      cp_async16(sw + r * kLD + v * 8,
                 ok ? wc + ((size_t)tap * O + n) * KW + v * 8 : wp, ok);
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
        float sc[8], sh[8];
        affine_of<PRO>(sc, sh, scb, shb, c);
        prologue<PRO>(val, sc, sh);
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
        ldmatrix_x4(a[mt], smem_addr(sx + ((py + dy) * kHaloW + dx + a_row) *
                                              kLD + a_k));
      }
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bf[4];  // b0, b1 of n-tiles nt and nt + 1
        ldmatrix_x4(bf, smem_addr(sw + (tap * BN + wn * WN + nt * 8 + b_row) *
                                           kLD + b_k));
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
  const int Ho = UP ? 2 * H : H;
  const int Wo = UP ? 2 * W : W;
  const bool pairs = (O & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * WM + mt * 16 + g + 8 * half;
      const int y = ty0 + r / kTW;
      const int xx = tx0 + r % kTW;
      if (y >= H || xx >= W) continue;
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

template <int PRO, bool RES, bool UP>
int launch(const void* x, const void* scale, const void* shift,
           const void* w, const void* bias, const void* res, void* out,
           int B, int H, int W, int C, int O, cudaStream_t stream) {
  constexpr size_t smem = Smem<UP ? 4 : 9, kMmaBN>::kBytes;
  auto kernel = conv3x3_kernel<PRO, RES, UP>;
  static std::atomic<bool> smem_set[kMaxDevices];
  cudaError_t err = set_smem(kernel, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + kTW - 1) / kTW;
  const int tiles_h = (H + kTH - 1) / kTH;
  const dim3 grid(tiles_w * tiles_h, (O + kMmaBN - 1) / kMmaBN,
                  UP ? 4 * B : B);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(res),
      static_cast<__nv_bfloat16*>(out), H, W, C, O, tiles_w);
  return (int)cudaGetLastError();
}

// dc_conv3x3: the mma.sync loop where O <= 16, else the Hopper loop
template <int PRO, bool RES>
int launch_conv(const void* x, const void* scale, const void* shift,
                const void* w, const void* bias, const void* res, void* out,
                int B, int H, int W, int C, int O, cudaStream_t stream) {
  if (O <= 16) {
    return launch<PRO, RES, false>(x, scale, shift, w, bias, res, out, B, H,
                                   W, C, O, stream);
  }
  return launch_hopper<PRO, RES, 1>(x, scale, shift, w, bias, res, out, B, H,
                                    W, C, O, H, W, 1, stream);
}

bool bad_shape(int B, int H, int W, int C, int O) {
  return B < 1 || H < 1 || W < 1 || C < 8 || C % 8 != 0 || O < 1;
}

}  // namespace

// out [B, H, W, O] = conv3x3 SAME (prologue(x)) + bias (+ res).
// x [B, H, W, C] bf16; w [Cp / 64, 9, O, 64] bf16, C zero-padded to Cp
// (tap = 3 * row + column); bias [O] fp32; scale, shift [B, C] fp32 (read
// only for prologue 2); res [B, H, W, O] bf16 or null.  prologue 1: SiLU
// (no residual: no caller adds one); 2: affine, then SiLU.  x and w
// contiguous and 16-byte aligned, C % 8 == 0.  Launches on `stream` of the
// current device and returns cudaGetLastError() (cudaErrorNotSupported
// where the driver has no cuTensorMapEncodeTiled).
extern "C" int dc_conv3x3(const void* x, const void* scale, const void* shift,
                          const void* w, const void* bias, const void* res,
                          void* out, int B, int H, int W, int C, int O,
                          int prologue, void* stream) {
  if (bad_shape(B, H, W, C, O)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (prologue == kSilu && !res) {
    return launch_conv<kSilu, false>(x, scale, shift, w, bias, res, out, B, H,
                                     W, C, O, s);
  }
  if (prologue == kAffineSilu) {
    if (res) {
      return launch_conv<kAffineSilu, true>(x, scale, shift, w, bias, res,
                                            out, B, H, W, C, O, s);
    }
    return launch_conv<kAffineSilu, false>(x, scale, shift, w, bias, res, out,
                                           B, H, W, C, O, s);
  }
  return (int)cudaErrorInvalidValue;
}

// out [B, 2H, 2W, O] = conv3x3 SAME (nearest_up2(x)) + bias.
// x [B, H, W, C] bf16; w [4, Cp / 64, 4, O, 64] bf16: phase di * 2 + dj,
// collapsed tap a * 2 + b (conv_pallas.py::_collapse_upsample_kernel's
// taps), C zero-padded to Cp; bias [O] fp32.  Same requirements and
// return as dc_conv3x3.  The Hopper loop in its upsample mode where
// O > 16 (a block computes one phase of 16 x 16 input positions by 128
// output channels from their 18 x 18 halo), else the mma.sync loop.
extern "C" int dc_upsample_conv3x3(const void* x, const void* w,
                                   const void* bias, void* out, int B, int H,
                                   int W, int C, int O, void* stream) {
  if (bad_shape(B, H, W, C, O)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (O <= 16) {
    return launch<kNone, false, true>(x, nullptr, nullptr, w, bias, nullptr,
                                      out, B, H, W, C, O, s);
  }
  return launch_hopper<kNone, false, 0>(x, nullptr, nullptr, w, bias,
                                        nullptr, out, B, H, W, C, O, 2 * H,
                                        2 * W, 1, s);
}

// out [B, Ho, Wo, O] = conv3x3 stride 2 (x padded by `pad` rows and
// columns at the top and left and by 1 at the bottom and right) + bias,
// Ho = (H + pad - 2) / 2 + 1 and Wo likewise: pad 0 is the VAE encoder's
// downsampler, pad 1 the UNet's (symmetric).  x [B, H, W, C] bf16, H and
// W >= 2; w, bias as for dc_conv3x3; same requirements and return.  The
// Hopper loop: a block computes 8 x 16 output pixels by 128 output
// channels from four parity planes of its 17 x 33 input halo.
extern "C" int dc_downsample_conv3x3(const void* x, const void* w,
                                     const void* bias, void* out, int B,
                                     int H, int W, int C, int O, int pad,
                                     void* stream) {
  if (bad_shape(B, H, W, C, O) || (pad != 0 && pad != 1) || H < 2 ||
      W < 2) {
    return (int)cudaErrorInvalidValue;
  }
  const int Ho = (H + pad - 2) / 2 + 1;
  const int Wo = (W + pad - 2) / 2 + 1;
  return launch_hopper<kNone, false, 2>(x, nullptr, nullptr, w, bias,
                                        nullptr, out, B, H, W, C, O, Ho, Wo,
                                        pad, (cudaStream_t)stream);
}
