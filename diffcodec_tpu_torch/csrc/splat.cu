// 'sum'-mode forward splat (softmax splatting's scatter core), fp32.
//
// Replaces the TPU kernel diffcodec_tpu/ops/softsplat_pallas.py::
// splat_sum_pallas (kernel body _splat_kernel, pallas_call at :139).  The
// TPU has no scatter atomics, so the Pallas kernel recast the scatter as a
// one-hot two-matmul on the MXU; on Hopper the natural form is the scatter
// itself, with fp32 atomicAdd, as in the reference's softsplat_out.
//
// For each source pixel (b, y, x) with flow (u, v):
//   fx = x + u, fy = y + v; non-finite fx or fy is sent to -10 (so every
//   corner falls outside); each of the four integer neighbours (X, Y) of
//   (fx, fy) that lies inside the frame receives
//   vals[b, y, x, :] * wx * wy with the bilinear weights of
//   diffcodec_tpu/ops/softsplat.py::_corner_terms.
//
// What bounds it on an H100: memory and atomics.  Each pixel reads C + 2
// floats and issues 4 * C fp32 atomic adds (4 * C * 4 bytes of
// read-modify-write in L2); the output plane is written once.  Against
// 3.35 TB/s, the decode's largest splat (B = 14, 64 x 64, C = 161) moves
// 74 MB of inputs and outputs: 0.022 ms.
//
// Design: a block holds `pixels` source pixels, each served by `lanes`
// threads that stride over its channels, so the loads of vals and the
// atomics into one destination row are coalesced across lanes, and the
// corner weights are computed once per thread.  Accumulation order varies
// from run to run: results agree with the plain version within fp32
// rounding, not bitwise.
// vals [B, H, W, C] fp32, flow [B, H, W, 2] fp32, out [B, H, W, C] fp32
// zeroed by the caller; all contiguous.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

__global__ void splat_sum_kernel(const float* __restrict__ vals,
                                 const float* __restrict__ flow,
                                 float* __restrict__ out, int B, int H, int W,
                                 int C) {
  const int64_t n_pix = (int64_t)B * H * W;
  const int64_t p = (int64_t)blockIdx.x * blockDim.y + threadIdx.y;
  if (p >= n_pix) return;
  const int x = (int)(p % W);
  const int y = (int)((p / W) % H);
  const int64_t b = p / ((int64_t)H * W);

  float fx = (float)x + flow[2 * p];
  float fy = (float)y + flow[2 * p + 1];
  if (!(isfinite(fx) && isfinite(fy))) {
    fx = -10.f;
    fy = -10.f;
  }
  const float x0 = floorf(fx);
  const float y0 = floorf(fy);
  const float ax = fx - x0;
  const float ay = fy - y0;

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
      if (dst[q] >= 0) atomicAdd(out + dst[q] + c, val * w[q]);
    }
  }
}

}  // namespace

// Launches on `stream` of the current device and returns cudaGetLastError()
// (0 on success).
extern "C" int dc_splat_sum(const void* vals, const void* flow, void* out,
                            int B, int H, int W, int C, void* stream) {
  int lanes = 1;
  while (lanes < C && lanes < 32) lanes *= 2;
  const int pixels = 256 / lanes;
  const int64_t n_pix = (int64_t)B * H * W;
  const dim3 block(lanes, pixels);
  const dim3 grid((unsigned)((n_pix + pixels - 1) / pixels));
  splat_sum_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(vals), static_cast<const float*>(flow),
      static_cast<float*>(out), B, H, W, C);
  return (int)cudaGetLastError();
}
