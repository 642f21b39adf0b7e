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
// adds take L2's reduction units ~0.08 ms, whether they come as 42 M
// scalar operations (the first design: 0.100 ms) or as 11 M v4 ones
// (PERF.md).
//
// Design: vector reductions.  red.global.add.v4.f32 (sm_90) adds four
// channels in one operation where they are 16-byte aligned.  A pixel's row
// of C floats is aligned only where (pixel * C) % 4 == 0 (161 * 4 = 644
// bytes), and each of the four corners lands on another row, so for each
// corner a warp (one pixel, from C = 16 on) takes the row's unaligned head
// (<= 3 channels) and tail with scalar reductions and its aligned body
// with v4 ones: ~C / 4 + 2 operations a corner where there were C.  The
// source values of a v4 are read as four scalars (the source row has its
// own alignment), through L1, where the four corners read them again.
// Below 16 channels (the 3-channel occlusion splats) a pixel takes 4 or 8
// lanes striding over its channels with one scalar reduction a channel
// and corner (the first design, kept: with no v4 body to take, it was the
// faster of the two there).  A window of destination pixels in shared
// memory, flushed once, would cut the bytes added in L2, but every form
// tried was slower (its fp32 adds in shared memory are compare-and-swap
// loops: PERF.md).  Accumulation order varies from run to run: results
// agree with the plain version within fp32 rounding, not bitwise.
// vals [B, H, W, C] fp32, flow [B, H, W, 2] fp32, out [B, H, W, C] fp32
// zeroed by the caller; all contiguous.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

// the body of a corner's row in v4 reductions (else one scalar reduction
// a channel)
constexpr bool kV4 = true;
constexpr int kSmallC = 16;  // below: the scalar kernel

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

// C < kSmallC: a pixel's lanes stride over its channels, one scalar
// reduction a channel and corner
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

// Launches on `stream` of the current device and returns cudaGetLastError()
// (0 on success; cudaErrorInvalidValue where out is not 16-byte aligned).
extern "C" int dc_splat_sum(const void* vals, const void* flow, void* out,
                            int B, int H, int W, int C, void* stream) {
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0 || C < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int lanes = C < kSmallC ? (C <= 4 ? 4 : 8) : 32;
  const int pixels = 256 / lanes;
  const int64_t n_pix = (int64_t)B * H * W;
  const dim3 block(lanes, pixels);
  const dim3 grid((unsigned)((n_pix + pixels - 1) / pixels));
  const float* v = static_cast<const float*>(vals);
  const float* f = static_cast<const float*>(flow);
  float* o = static_cast<float*>(out);
  if (C < kSmallC) {
    splat_small_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(v, f, o, B,
                                                                 H, W, C);
  } else {
    splat_sum_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(v, f, o, B, H,
                                                               W, C);
  }
  return (int)cudaGetLastError();
}
