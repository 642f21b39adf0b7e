// 'sum'-mode forward splat (softmax splatting's scatter core), fp32.
//
// Replaces the TPU kernel diffcodec_tpu/ops/softsplat_pallas.py::
// splat_sum_pallas (kernel body _splat_kernel, pallas_call at :139).  The
// TPU has no scatter atomics, so the Pallas kernel recast the scatter as a
// one-hot two-matmul on the MXU; on Hopper the natural form is the scatter
// itself, with fp32 reductions in L2, as in the reference's softsplat_out.
//
// For each source pixel (b, y, x) with flow (u, v):
//   fx = x + u, fy = y + v; non-finite fx or fy is sent to -10 (so every
//   corner falls outside); each of the four integer neighbours (X, Y) of
//   (fx, fy) that lies inside the frame receives
//   vals[b, y, x, :] * wx * wy with the bilinear weights of
//   diffcodec_tpu/ops/softsplat.py::_corner_terms.
//
// What bounds it on an H100: the reductions in L2.  A pixel reads C + 2
// floats and adds 4 C floats into the output; the output is written once.
// Against 3.35 TB/s the training step's largest splat, [16, 64, 64, 161],
// moves 85 MB of inputs and outputs: 0.025 ms.  But its 169 MB of fp32
// adds take L2's reduction units ~0.08 ms (~2.2 TB/s of added bytes),
// whether they come as 42 M scalar operations or as 11 M v4 ones.  Where
// rows are short the count of reduction requests, not their bytes, sets
// the time: the first small-channel kernel (4 or 8 lanes a pixel, one
// scalar reduction a channel and corner) sent ~59 G 16-byte corner rows a
// second at C = 4, 0.14 ms at [8, 512, 512, 4], and slower at C = 3,
// whose 12-byte rows straddle 32-byte sectors (PERF.md).
//
// C >= 16, splat_sum_kernel: a warp a pixel, corner by corner.  Each
// corner's row takes red.global.add.v4.f32 (four channels in one
// operation) over its 16-byte-aligned body and scalar reductions over its
// unaligned head and tail (<= 3 channels each): ~C / 4 + 2 operations a
// corner where there were C.  The source values of a v4 are read as four
// scalars (the source row has its own alignment), through L1, where the
// four corners read them again.
//
// C = 3, 4 (the occlusion checks' 3 channels, the residue transform's 4)
// have two kernels.  Both send each destination row as one vector
// reduction: at C = 3 the output's rows are padded to 4 floats (the
// wrapper allocates [B, H, W, 4] and returns the view of its first 3
// channels), so a row is one v4 onto a 16-byte-aligned address, inside
// one sector; 12-byte rows straddle sectors and take a v2 and a scalar
// each.  What they cut is the count of reduction requests.
//
// C = 3, 4 on images of 256 x 256 and more, 2^21 source pixels a launch
// and more (the residue transform's [16, 512, 512, c], the residual DDPM's
// [32, 256, 256, c]), splat_tile_kernel: a block a tile of 32 x 32 source
// pixels.  It loads its pixels (flow in 8-byte, rows in 16-byte loads),
// counts each corner that lands within 4 pixels of the tile into its slot
// of that 40 x 40 window with integer atomics in shared memory (native; an
// fp32 atomic there is a compare-and-swap loop), scans the counts into
// offsets, sorts the corners by slot, and then a thread a slot sums its
// slot's corners in registers and sends one v4 reduction, consecutive
// slots from consecutive lanes: a destination row takes one request from
// each window that covers it where it took one from each corner (~4), and
// a warp's requests fill whole sectors.  Corners beyond the window go to L2
// at once.  No float is added in shared memory.
//
// C = 3, 4 elsewhere (the decode's occlusion checks, 64 px and smaller),
// splat_rows_kernel<C, P>: a thread a pixel, its target computed once,
// each corner one reduction.  Two choices cut the requests.  Lane pairs: the
// lanes of a pair trade rows (shuffles) so that one instruction sends a
// pixel's two horizontal corners from adjacent lanes, 32 contiguous bytes
// at C = 4, one sector where X0 is even.  Merging: where a pixel's right
// corner is the next lane's left one (a smooth flow), the next lane adds
// it in registers and one reduction goes out for both; a pair whose right
// corners were merged away does not trade, so that its lanes' left rows,
// consecutive, go out in one instruction.
//
// Which of the two (scripts/splat_kernel_ab.py, kernel alone, PERF.md):
// at 64 px and below the rows kernel is 1.4-2x faster under every flow.
// At 2^21 pixels a launch ([8, 512, 512, c], [32, 256, 256, c]) the tile
// kernel wins under i.i.d., local and smooth flows alike.  At 2^20
// ([16, 256, 256, c]) it takes 0.72x the rows kernel's time under i.i.d.
// flows but 1.27-1.32x under a smooth one, and smooth fields are what
// RAFT gives the codec and the residual trainer, so that launch takes the
// rows kernel.  Sizes between were not measured, nor RAFT's real flows.
//
// Each choice is a constexpr below, which scripts/splat_kernel_ab.py
// switches off one at a time.
//
// C = 1, 2 and 5 <= C < 16, which no path splats, splat_small_kernel (the
// first design): a pixel's 8 lanes stride over its channels, one scalar
// reduction a channel and corner, which the lanes' adjacent addresses
// coalesce into one request a corner.
//
// Accumulation order varies from run to run: results agree with the plain
// version within fp32 rounding, not bitwise.
// vals [B, H, W, C] fp32, flow [B, H, W, 2] fp32, both contiguous; out
// [B, H, W, dc_splat_row(C)] fp32, contiguous, zeroed by the caller and
// 16-byte aligned.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

// the body of a corner's row in v4 reductions (else one scalar reduction
// a channel)
constexpr bool kV4 = true;
constexpr int kSmallC = 16;  // below: the small-channel kernels

__device__ __forceinline__ void red_add(float* p, float v) {
  asm volatile("red.global.add.f32 [%0], %1;\n" ::"l"(p), "f"(v)
               : "memory");
}

// p 16-byte aligned
__device__ __forceinline__ void red_add_v4(float* p, float a, float b,
                                           float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

// source pixel p = blockIdx.x * blockDim.y + threadIdx.y of image b: its
// target's floor (x0, y0) and fraction (ax, ay), a non-finite target sent
// to -10; false past the last pixel
__device__ __forceinline__ bool target(const float* __restrict__ flow, int B,
                                       int H, int W, int64_t& p, int64_t& b,
                                       float& x0, float& y0, float& ax,
                                       float& ay) {
  p = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (p >= (int64_t)B * H * W) return false;
  const int x = (int)(p % W);
  const int y = (int)((p / W) % H);
  b = p / ((int64_t)H * W);
  float fx = (float)x + flow[2 * p];
  float fy = (float)y + flow[2 * p + 1];
  if (!(isfinite(fx) && isfinite(fy))) {
    fx = -10.f;
    fy = -10.f;
  }
  x0 = floorf(fx);
  y0 = floorf(fy);
  ax = fx - x0;
  ay = fy - y0;
  return true;
}

// C >= kSmallC: a warp a pixel, corner by corner
__global__ void splat_sum_kernel(const float* __restrict__ vals,
                                 const float* __restrict__ flow,
                                 float* __restrict__ out, int B, int H, int W,
                                 int C) {
  int64_t p, b;
  float x0, y0, ax, ay;
  if (!target(flow, B, H, W, p, b, x0, y0, ax, ay)) return;
  const float* src = vals + p * C;
  const int lane = threadIdx.x;
  const int lanes = blockDim.x;
#pragma unroll 1
  for (int q = 0; q < 4; ++q) {
    const int ky = q >> 1;
    const int kx = q & 1;
    const float Xf = x0 + (float)kx;
    const float Yf = y0 + (float)ky;
    if (!(Xf >= 0.f && Xf < (float)W && Yf >= 0.f && Yf < (float)H)) {
      continue;
    }
    const float wq = (kx ? ax : 1.f - ax) * (ky ? ay : 1.f - ay);
    const int64_t d0 = ((b * H + (int64_t)Yf) * W + (int64_t)Xf) * C;
    float* dst = out + d0;
    if (!kV4) {
      for (int c = lane; c < C; c += lanes) red_add(dst + c, src[c] * wq);
      continue;
    }
    // channels [0, head) up to the row's first 16-byte boundary (out is
    // 16-byte aligned), the body [head, tail0) in v4s, the tail [tail0, C)
    const int head = min(C, (int)(-d0 & 3));
    const int tail0 = head + ((C - head) & ~3);
    if (lane < head) red_add(dst + lane, src[lane] * wq);
    if (lane < C - tail0) {
      red_add(dst + tail0 + lane, src[tail0 + lane] * wq);
    }
    for (int c = head + 4 * lane; c < tail0; c += 4 * lanes) {
      red_add_v4(dst + c, src[c] * wq, src[c + 1] * wq, src[c + 2] * wq,
                 src[c + 3] * wq);
    }
  }
}

// C = 3, 4 below the tiles' sizes: splat_rows_kernel, a thread a pixel
// at C = 3 the output's rows padded to 4 floats (else rows of 3 floats,
// unaligned)
constexpr bool kPad = true;
// each row in vector reductions (v4 where 16-byte aligned, v2 where 8),
// else one scalar reduction a channel
constexpr bool kSmallV4 = true;
// a pixel's two horizontal corners from adjacent lanes in one instruction
constexpr bool kPairs = true;
// a pixel's right corner added into the next lane's left one where they
// are one row
constexpr bool kMerge = true;
constexpr int kRowThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

constexpr int row_width(int C) { return kPad && C == 3 ? 4 : C; }

// the inputs are read once: loads with the evict-first (streaming)
// policy, which leave L2 to the output's rows
template <typename T>
__device__ __forceinline__ T load_once(const T* p) {
  return __ldcs(p);
}

__device__ __forceinline__ void red_add_v2(float* p, float a, float b) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};\n" ::"l"(p), "f"(a),
               "f"(b)
               : "memory");
}

// row[K, P) onto dst[K, P), where dst + K lies A floats past a 16-byte
// boundary: the widest reduction that is aligned there, then the rest
template <int P, int K, int A>
__device__ __forceinline__ void red_row_from(float* dst,
                                             const float (&row)[P]) {
  if constexpr (K < P) {
    if constexpr (kSmallV4 && A % 4 == 0 && P - K >= 4) {
      red_add_v4(dst + K, row[K], row[K + 1], row[K + 2], row[K + 3]);
      red_row_from<P, K + 4, A + 4>(dst, row);
    } else if constexpr (kSmallV4 && A % 2 == 0 && P - K >= 2) {
      red_add_v2(dst + K, row[K], row[K + 1]);
      red_row_from<P, K + 2, A + 2>(dst, row);
    } else {
      red_add(dst + K, row[K]);
      red_row_from<P, K + 1, A + 1>(dst, row);
    }
  }
}

// row onto the output's row d (none where d < 0); out 16-byte aligned
template <int P>
__device__ __forceinline__ void red_row(float* out, int64_t d,
                                        const float (&row)[P]) {
  if (d < 0) return;
  float* dst = out + d * P;
  if constexpr (P % 4 == 0) {
    red_row_from<P, 0, 0>(dst, row);
  } else {
    switch ((int)((d * P) & 3)) {
      case 0: red_row_from<P, 0, 0>(dst, row); break;
      case 1: red_row_from<P, 0, 1>(dst, row); break;
      case 2: red_row_from<P, 0, 2>(dst, row); break;
      default: red_row_from<P, 0, 3>(dst, row); break;
    }
  }
}

// a source row into v[0, C): a 16-byte load where vals is 16-byte
// aligned and C is 4, else scalar ones
template <int C, int P>
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         bool vals16, float (&v)[P]) {
  if constexpr (C % 4 == 0) {
    if (vals16) {
#pragma unroll
      for (int k = 0; k < C; k += 4) {
        const float4 s =
            load_once(reinterpret_cast<const float4*>(src + k));
        v[k] = s.x;
        v[k + 1] = s.y;
        v[k + 2] = s.z;
        v[k + 3] = s.w;
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < C; ++k) v[k] = load_once(src + k);
}

// source pixel p at (x, y): its target's floor (x0, y0) and fraction
// (ax, ay), a non-finite target sent to -10; the flow in one 8-byte load
// where it is 8-byte aligned
__device__ __forceinline__ void pixel_target(const float* __restrict__ flow,
                                             int64_t p, int x, int y,
                                             bool flow8, float& x0,
                                             float& y0, float& ax,
                                             float& ay) {
  float u, v;
  if (flow8) {
    const float2 f = load_once(reinterpret_cast<const float2*>(flow) + p);
    u = f.x;
    v = f.y;
  } else {
    u = load_once(flow + 2 * p);
    v = load_once(flow + 2 * p + 1);
  }
  float fx = (float)x + u;
  float fy = (float)y + v;
  if (!(isfinite(fx) && isfinite(fy))) {
    fx = -10.f;
    fy = -10.f;
  }
  x0 = floorf(fx);
  y0 = floorf(fy);
  ax = fx - x0;
  ay = fy - y0;
}

// n = B * H * W < 2^31 source pixels, one a thread; the warp's lanes are
// consecutive pixels and all of them run to the end (the shuffles), those
// past n with nothing to add
template <int C, int P>
__global__ void __launch_bounds__(kRowThreads)
    splat_rows_kernel(const float* __restrict__ vals,
                      const float* __restrict__ flow, float* __restrict__ out,
                      int n, int H, int W, bool vals16, bool flow8) {
  const int p = blockIdx.x * kRowThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  float v[P];
#pragma unroll
  for (int k = 0; k < P; ++k) v[k] = 0.f;
  int64_t d[4] = {-1, -1, -1, -1};
  float w[4] = {0.f, 0.f, 0.f, 0.f};
  if (p < n) {
    const int x = p % W;
    const int row = p / W;
    const int y = row % H;
    const int b = row / H;
    float x0, y0, ax, ay;
    pixel_target(flow, p, x, y, flow8, x0, y0, ax, ay);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ky = q >> 1;
      const int kx = q & 1;
      const float Xf = x0 + (float)kx;
      const float Yf = y0 + (float)ky;
      if (Xf >= 0.f && Xf < (float)W && Yf >= 0.f && Yf < (float)H) {
        w[q] = (kx ? ax : 1.f - ax) * (ky ? ay : 1.f - ay);
        d[q] = ((int64_t)b * H + (int64_t)Yf) * W + (int64_t)Xf;
      }
    }
    load_row<C, P>(vals + (int64_t)p * C, vals16, v);
  }
  // the previous lane's row, for merging
  float vp[P];
  if constexpr (kMerge) {
#pragma unroll
    for (int k = 0; k < P; ++k) vp[k] = __shfl_up_sync(kFull, v[k], 1);
  }
#pragma unroll
  for (int ky = 0; ky < 2; ++ky) {
    int64_t dl = d[2 * ky];
    int64_t dr = d[2 * ky + 1];
    float L[P], R[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      L[k] = v[k] * w[2 * ky];
      R[k] = v[k] * w[2 * ky + 1];
    }
    if constexpr (kMerge) {
      // the previous lane's right corner is this lane's left one: take
      // it; this lane's right corner is the next lane's left one: drop it
      const int64_t dr_prev = __shfl_up_sync(kFull, dr, 1);
      const float wr_prev = __shfl_up_sync(kFull, w[2 * ky + 1], 1);
      const int64_t dl_next = __shfl_down_sync(kFull, dl, 1);
      if (lane > 0 && dl >= 0 && dr_prev == dl) {
#pragma unroll
        for (int k = 0; k < P; ++k) L[k] += vp[k] * wr_prev;
      }
      if (lane < 31 && dr >= 0 && dl_next == dr) dr = -1;
    }
    if constexpr (kPairs) {
      // where both of a pair's right corners remain, the even lane hands
      // its right row to the odd partner and the odd lane its left row to
      // the even one: the even lane's pixel's two corners go out in one
      // instruction, the odd lane's in the next; else each lane sends its
      // own left row, then its right one
      const bool odd = lane & 1;
      const int partner_right = __shfl_xor_sync(kFull, (int)(dr >= 0), 1);
      const bool trade = dr >= 0 && partner_right != 0;
      const int64_t dx = __shfl_xor_sync(kFull, odd ? dl : dr, 1);
      float X[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        X[k] = __shfl_xor_sync(kFull, odd ? L[k] : R[k], 1);
      }
      // selects, not branches: both lanes must reach each instruction
      const bool take_first = trade && odd;
      const bool take_second = trade && !odd;
      float first[P], second[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        first[k] = take_first ? X[k] : L[k];
        second[k] = take_second ? X[k] : R[k];
      }
      red_row<P>(out, take_first ? dx : dl, first);
      red_row<P>(out, take_second ? dx : dr, second);
    } else {
      red_row<P>(out, dl, L);
      red_row<P>(out, dr, R);
    }
  }
}


// C = 3, 4 from kTileMinImage pixels an image and kTileMinLaunch a
// launch: splat_tile_kernel (see the head of this file)
constexpr bool kTiles = true;
constexpr int64_t kTileMinImage = 256 * 256;
constexpr int64_t kTileMinLaunch = int64_t{1} << 21;
constexpr int kTileX = 32;  // a block's source pixels
constexpr int kTileY = 32;
constexpr int kTilePix = kTileX * kTileY;
constexpr int kTileThreads = 256;
constexpr int kTilePixEach = kTilePix / kTileThreads;
// the window of destination pixels a block sums: its tile and kHalo
// pixels around it
constexpr int kHalo = 4;
constexpr int kWinX = kTileX + 2 * kHalo;
constexpr int kWinY = kTileY + 2 * kHalo;
constexpr int kSlots = kWinX * kWinY;
constexpr int kScanEach = (kSlots + kTileThreads - 1) / kTileThreads;
constexpr uint32_t kNoSlot = 0xffffffffu;
constexpr int kRankBits = 13;  // ranks < 4 kTilePix <= 2^13

// vals' and the output's rows 4 floats (C = 3: the output's padded, vals'
// fourth float read as 0); a block a tile of kTileX x kTileY source
// pixels of one image
template <int C>
__global__ void __launch_bounds__(kTileThreads)
    splat_tile_kernel(const float* __restrict__ vals,
                      const float* __restrict__ flow, float* __restrict__ out,
                      int H, int W, int tiles_x, int tiles_y, bool vals16,
                      bool flow8) {
  __shared__ int off[kSlots + 1];              // counts, then offsets
  __shared__ uint16_t entry[4 * kTilePix];     // pixel << 2 | corner
  __shared__ float4 rows[kTilePix];
  __shared__ float2 fracs[kTilePix];
  __shared__ int warp_total[kTileThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tiles = tiles_x * tiles_y;
  const int b = blockIdx.x / tiles;
  const int t = blockIdx.x % tiles;
  const int sx0 = (t % tiles_x) * kTileX;
  const int sy0 = (t / tiles_x) * kTileY;
  const int wx0 = sx0 - kHalo;
  const int wy0 = sy0 - kHalo;

  // 1: each pixel's target and row (all the loads issued before the
  // first shared-memory atomic), its row and fractions into shared memory
  float x0[kTilePixEach], y0[kTilePixEach], v[kTilePixEach][4];
#pragma unroll
  for (int j = 0; j < kTilePixEach; ++j) {
    const int i = tid + j * kTileThreads;
    const int x = sx0 + i % kTileX;
    const int y = sy0 + i / kTileX;
    x0[j] = -10.f;
    y0[j] = -10.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[j][k] = 0.f;
    if (x >= W || y >= H) continue;
    const int64_t p = ((int64_t)b * H + y) * W + x;
    float ax, ay;
    pixel_target(flow, p, x, y, flow8, x0[j], y0[j], ax, ay);
    load_row<C, 4>(vals + p * C, vals16, v[j]);
    rows[i] = make_float4(v[j][0], v[j][1], v[j][2], v[j][3]);
    fracs[i] = make_float2(ax, ay);
  }
  for (int k = tid; k <= kSlots; k += kTileThreads) off[k] = 0;
  __syncthreads();

  // 2: each corner in the window counted in its slot (its rank there
  // kept), one outside the window added to the output at once
  uint32_t key[4 * kTilePixEach];
#pragma unroll
  for (int j = 0; j < kTilePixEach; ++j) {
    const int i = tid + j * kTileThreads;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      key[4 * j + q] = kNoSlot;
      const int kx = q & 1;
      const int ky = q >> 1;
      const float Xf = x0[j] + (float)kx;
      const float Yf = y0[j] + (float)ky;
      if (!(Xf >= 0.f && Xf < (float)W && Yf >= 0.f && Yf < (float)H)) {
        continue;
      }
      const int X = (int)Xf;
      const int Y = (int)Yf;
      const int lx = X - wx0;
      const int ly = Y - wy0;
      if (lx >= 0 && lx < kWinX && ly >= 0 && ly < kWinY) {
        const int s = ly * kWinX + lx;
        key[4 * j + q] = ((uint32_t)s << kRankBits) |
                         (uint32_t)atomicAdd(&off[s], 1);
      } else {
        const float2 f = fracs[i];
        const float wq = (kx ? f.x : 1.f - f.x) * (ky ? f.y : 1.f - f.y);
        red_add_v4(out + (((int64_t)b * H + Y) * W + X) * 4, v[j][0] * wq,
                   v[j][1] * wq, v[j][2] * wq, v[j][3] * wq);
      }
    }
  }
  __syncthreads();

  // 3: the counts into exclusive offsets, off[kSlots] the total (a thread
  // kScanEach consecutive slots, then the warps' and the block's sums)
  int local[kScanEach];
  int sum = 0;
#pragma unroll
  for (int k = 0; k < kScanEach; ++k) {
    const int s = tid * kScanEach + k;
    local[k] = sum;
    sum += s < kSlots ? off[s] : 0;
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int k = 0; k < kTileThreads / 32; ++k) {
    before += k < warp ? warp_total[k] : 0;
  }
  before += incl - sum;
#pragma unroll
  for (int k = 0; k < kScanEach; ++k) {
    const int s = tid * kScanEach + k;
    if (s < kSlots) off[s] = before + local[k];
  }
  if (tid == kTileThreads - 1) off[kSlots] = before + sum;
  __syncthreads();

  // 4: each counted corner into its slot's entries
#pragma unroll
  for (int j = 0; j < kTilePixEach; ++j) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t k = key[4 * j + q];
      if (k == kNoSlot) continue;
      const int i = tid + j * kTileThreads;
      entry[off[k >> kRankBits] + (k & ((1u << kRankBits) - 1))] =
          (uint16_t)((i << 2) | q);
    }
  }
  __syncthreads();

  // 5: a slot a thread, consecutive slots on consecutive lanes: its
  // entries summed in registers, then one v4 reduction onto its row
  for (int s = tid; s < kSlots; s += kTileThreads) {
    const int e0 = off[s];
    const int e1 = off[s + 1];
    if (e0 == e1) continue;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int e = e0; e < e1; ++e) {
      const int i = entry[e] >> 2;
      const int q = entry[e] & 3;
      const float2 f = fracs[i];
      const float4 r = rows[i];
      const float wq = ((q & 1) ? f.x : 1.f - f.x) *
                       ((q >> 1) ? f.y : 1.f - f.y);
      a0 += r.x * wq;
      a1 += r.y * wq;
      a2 += r.z * wq;
      a3 += r.w * wq;
    }
    const int X = wx0 + s % kWinX;
    const int Y = wy0 + s / kWinX;
    red_add_v4(out + (((int64_t)b * H + Y) * W + X) * 4, a0, a1, a2, a3);
  }
}

// C < kSmallC other than 3 and 4: a pixel's lanes stride over its
// channels, one scalar reduction a channel and corner
__global__ void splat_small_kernel(const float* __restrict__ vals,
                                   const float* __restrict__ flow,
                                   float* __restrict__ out, int B, int H,
                                   int W, int C) {
  int64_t p, b;
  float x0, y0, ax, ay;
  if (!target(flow, B, H, W, p, b, x0, y0, ax, ay)) return;
  float w[4];
  int64_t dst[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int ky = q >> 1;
    const int kx = q & 1;
    const float Xf = x0 + (float)kx;
    const float Yf = y0 + (float)ky;
    const bool inside = Xf >= 0.f && Xf < (float)W && Yf >= 0.f &&
                        Yf < (float)H;
    const float wx = kx ? ax : 1.f - ax;
    const float wy = ky ? ay : 1.f - ay;
    w[q] = inside ? wx * wy : 0.f;
    dst[q] = inside ? ((b * H + (int64_t)Yf) * W + (int64_t)Xf) * C : -1;
  }
  const float* src = vals + p * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float val = src[c];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (dst[q] >= 0) red_add(out + dst[q] + c, val * w[q]);
    }
  }
}

}  // namespace

// The output's row width in floats for C channels: the rows dc_splat_sum
// adds into are that wide, the channels past C left at 0.
extern "C" int dc_splat_row(int C) { return row_width(C); }

// Launches on `stream` of the current device and returns cudaGetLastError()
// (0 on success; cudaErrorInvalidValue where out is not 16-byte aligned, or
// past 2^31 - 257 pixels on the rows kernel).
extern "C" int dc_splat_sum(const void* vals, const void* flow, void* out,
                            int B, int H, int W, int C, void* stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0 || C < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t n_pix = (int64_t)B * H * W;
  const float* v = static_cast<const float*>(vals);
  const float* f = static_cast<const float*>(flow);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vals16 = reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  const bool flow8 = reinterpret_cast<uintptr_t>(flow) % 8 == 0;
  const bool rows = C == 3 || C == 4;
  if (kTiles && rows && row_width(C) == 4 &&
      (int64_t)H * W >= kTileMinImage && n_pix >= kTileMinLaunch) {
    const int tiles_x = (W + kTileX - 1) / kTileX;
    const int tiles_y = (H + kTileY - 1) / kTileY;
    const int64_t blocks = (int64_t)B * tiles_x * tiles_y;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    if (C == 3) {
      splat_tile_kernel<3><<<(unsigned)blocks, kTileThreads, 0, s>>>(
          v, f, o, H, W, tiles_x, tiles_y, vals16, flow8);
    } else {
      splat_tile_kernel<4><<<(unsigned)blocks, kTileThreads, 0, s>>>(
          v, f, o, H, W, tiles_x, tiles_y, vals16, flow8);
    }
  } else if (rows) {
    if (n_pix > 0x7fffffff - kRowThreads) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((n_pix + kRowThreads - 1) / kRowThreads));
    if (C == 3) {
      splat_rows_kernel<3, row_width(3)><<<grid, kRowThreads, 0, s>>>(
          v, f, o, (int)n_pix, H, W, vals16, flow8);
    } else {
      splat_rows_kernel<4, 4><<<grid, kRowThreads, 0, s>>>(
          v, f, o, (int)n_pix, H, W, vals16, flow8);
    }
  } else {
    const int lanes = C < kSmallC ? 8 : 32;
    const int pixels = 256 / lanes;
    const dim3 block(lanes, pixels);
    const dim3 grid((unsigned)((n_pix + pixels - 1) / pixels));
    if (C < kSmallC) {
      splat_small_kernel<<<grid, block, 0, s>>>(v, f, o, B, H, W, C);
    } else {
      splat_sum_kernel<<<grid, block, 0, s>>>(v, f, o, B, H, W, C);
    }
  }
  return (int)cudaGetLastError();
}
