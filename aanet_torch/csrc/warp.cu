// Horizontal disparity warp of an image, with its validity mask; forward
// and the backward for the disparity.
//
// Replaces aanet_tpu/ops/warp.py:disp_warp (border padding). For pixel
// (b, h, w) the image is sampled at x = w - disp[b, h, w] with a border
// clamp, xc = clamp(x, 0, W-1), x0 = min(floor(xc), W-2), and the lerp of
// columns x0 and x0+1. The mask is 1 where the zero-padded bilinear
// coverage of the unclamped x is >= 0.9999, i.e. where both taps lie inside
// the image (the reference's grid_sample of an all-ones image).
//
// Bound: bytes (C+1 floats read, C+1 written per pixel, a few operations
// each). Design: one thread per (b, h, w); the thread computes the sample
// position once and loops over the channels, so the disparity is read
// once and neighbouring threads read and write neighbouring columns.
#include "common.cuh"

#include <math.h>

__global__ void warp_kernel(const float* __restrict__ img,
                            const float* __restrict__ disp,
                            float* __restrict__ warped,
                            float* __restrict__ valid, long long pixels,
                            int channels, int height, int width) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= pixels) return;
  int w = static_cast<int>(i % width);
  long long bh = i / width;
  int h = static_cast<int>(bh % height);
  long long b = bh / height;

  float x = static_cast<float>(w) - disp[i];
  float xc = fminf(fmaxf(x, 0.f), static_cast<float>(width - 1));
  int x0 = min(static_cast<int>(floorf(xc)), width - 2);
  float t = xc - static_cast<float>(x0);

  long long plane = static_cast<long long>(height) * width;
  long long row = b * channels * plane + static_cast<long long>(h) * width;
  for (int c = 0; c < channels; ++c) {
    const float* src = img + row + c * plane;
    warped[row + c * plane + w] = src[x0] * (1.f - t) + src[x0 + 1] * t;
  }

  float xf = floorf(x);
  float tf = x - xf;
  float last = static_cast<float>(width - 1);
  float cover = ((xf >= 0.f && xf <= last) ? 1.f - tf : 0.f) +
                ((xf + 1.f >= 0.f && xf + 1.f <= last) ? tf : 0.f);
  valid[i] = cover >= 0.9999f ? 1.f : 0.f;
}

// img, warped: [batch, channels, height, width]; disp, valid:
// [batch, height, width]; all float32, width >= 2.
extern "C" int aanet_warp_f32(const float* img, const float* disp,
                              float* warped, float* valid, int batch,
                              int channels, int height, int width, int device,
                              void* stream) {
  cudaSetDevice(device);
  long long pixels = static_cast<long long>(batch) * height * width;
  if (pixels == 0) return 0;
  const int threads = 256;
  warp_kernel<<<aanet_blocks(pixels, threads), threads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      img, disp, warped, valid, pixels, channels, height, width);
  return static_cast<int>(cudaGetLastError());
}

// Backward for the disparity only (the image is the network's input on
// every path that warps, and the wrapper refuses an image that needs a
// gradient):
//   d loss / d disp[b, h, w] = -clip'(x) * sum_c g[c] * (img[x0+1] - img[x0]),
// with clip'(x) = 1 for 0 < x < W-1, 0 outside, and 1/2 at x = 0 or
// x = W-1: jax.grad of the JAX op's jnp.clip at a tie. The validity mask
// carries no gradient. Bound: bytes (C+1 floats read and one written per
// pixel, like the forward). Design: one thread per pixel with the channel
// loop inside, as in the forward.
__global__ void warp_bwd_kernel(const float* __restrict__ grad_warped,
                                const float* __restrict__ img,
                                const float* __restrict__ disp,
                                float* __restrict__ grad_disp, long long pixels,
                                int channels, int height, int width) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= pixels) return;
  int w = static_cast<int>(i % width);
  long long bh = i / width;
  int h = static_cast<int>(bh % height);
  long long b = bh / height;

  const float last = static_cast<float>(width - 1);
  const float x = static_cast<float>(w) - disp[i];
  const float dclip = (x > 0.f && x < last) ? 1.f : ((x == 0.f || x == last) ? 0.5f : 0.f);
  float acc = 0.f;
  if (dclip != 0.f) {
    const float xc = fminf(fmaxf(x, 0.f), last);
    const int x0 = min(static_cast<int>(floorf(xc)), width - 2);
    const long long plane = static_cast<long long>(height) * width;
    const long long row = b * channels * plane + static_cast<long long>(h) * width;
    for (int c = 0; c < channels; ++c) {
      const float* src = img + row + c * plane;
      acc = fmaf(grad_warped[row + c * plane + w], src[x0 + 1] - src[x0], acc);
    }
  }
  grad_disp[i] = -dclip * acc;
}

// grad_warped, img: [batch, channels, height, width]; disp, grad_disp:
// [batch, height, width]; all float32, width >= 2.
extern "C" int aanet_warp_backward_f32(const float* grad_warped, const float* img,
                                       const float* disp, float* grad_disp, int batch,
                                       int channels, int height, int width, int device,
                                       void* stream) {
  cudaSetDevice(device);
  long long pixels = static_cast<long long>(batch) * height * width;
  if (pixels == 0) return 0;
  const int threads = 256;
  warp_bwd_kernel<<<aanet_blocks(pixels, threads), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      grad_warped, img, disp, grad_disp, pixels, channels, height, width);
  return static_cast<int>(cudaGetLastError());
}
