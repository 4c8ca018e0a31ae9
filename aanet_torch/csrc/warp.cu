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
// each): tens of microseconds at the main path's shapes, so index
// arithmetic and memory latency are what a thread can lose them on.
// Design: a 2-D grid, one (b, h) row per (blockIdx.z, blockIdx.y), with
// 32-bit index arithmetic inside the row (no 64-bit divisions). Each
// thread takes 4 neighbouring pixels: one float4 load of disp (evict-first:
// each value is read once, and its lines should not displace the image
// row's), then the two gathers of every channel for all 4 pixels in flight
// before the first store (the channel count is a template parameter for
// C = 3, the image on every path that warps), then float4 stores of each
// channel's warped run and of the mask. The image row (at most a few KB a channel)
// is served from L1. A row whose width is not a multiple of 4 (rows then
// start unaligned) and the last partial quad take scalar loads and stores.
//
// The forward has a bfloat16 form (aanet_warp_bf16; T = bf16): the image,
// the warped image and the mask in bfloat16, the disparity and the sample
// positions float32, the blend in float32 from the widened taps, each
// output rounded to bf16 once, as the JAX op computes under a bf16 compute
// dtype (warp.py:30,60,66). Its quads are 8 bytes of each channel's row.
// A bf16 kernel of its own (the block's image rows staged in shared memory
// by cp.async, runs of 8 pixels, 16-byte stores) was no faster on an H100
// at the paths' shapes, where a launch costs about as much as the bytes
// (PERF.md section 6).
// The backward has a bf16 form too (aanet_warp_backward_bf16): the bf16
// warped image's gradient and the bf16 image widened as they are loaded,
// the float32 disparity, the sum over channels in float32, and a float32
// gradient for the disparity (its primal's dtype).
#include "common.cuh"

#include <math.h>

namespace {

constexpr int WARP_MAX_THREADS = 256;

// Values read once, evict-first, as float32: one, or four neighbouring ones
// (16-byte aligned float32, 8-byte aligned bfloat16).
__device__ __forceinline__ float ldcs_f32(const float* p) { return __ldcs(p); }

__device__ __forceinline__ float ldcs_f32(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ float4 ldcs4_f32(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 ldcs4_f32(const bf16* p) {
  return widen4(__ldcs(reinterpret_cast<const uint2*>(p)));
}

// The disparity of a thread's 4 pixels from column w0 (n of them inside
// the row), evict-first: each value is read once, and its lines should not
// displace the image row's. One float4 where vec; d keeps its zeros beyond n.
__device__ __forceinline__ void load_disp4(const float* drow, int w0, int n, bool vec,
                                           float (&d)[4]) {
  if (vec) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(drow + w0));
    d[0] = q.x; d[1] = q.y; d[2] = q.z; d[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n) d[i] = __ldcs(drow + w0 + i);
  }
}

template <int C, typename T>  // C > 0: that many channels; C == 0: `channels`
__global__ void __launch_bounds__(WARP_MAX_THREADS)
warp_kernel(const T* __restrict__ img, const float* __restrict__ disp,
            T* __restrict__ warped, T* __restrict__ valid, int channels, int height,
            int width) {
  const int w0 = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (w0 >= width) return;
  const int nch = C > 0 ? C : channels;
  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const size_t plane = static_cast<size_t>(height) * width;
  const float* drow = disp + (b * height + h) * width;
  T* vrow = valid + (b * height + h) * width;
  const T* irow = img + b * nch * plane + static_cast<size_t>(h) * width;
  T* orow = warped + b * nch * plane + static_cast<size_t>(h) * width;
  const bool vec = (width & 3) == 0 && aligned16(disp) && aligned16(valid) && aligned16(img) &&
                   aligned16(warped);
  const int n = min(4, width - w0);

  float d[4] = {0.f, 0.f, 0.f, 0.f};
  load_disp4(drow, w0, n, vec, d);
  int x0[4];
  float t[4], ok[4];
  const float last = static_cast<float>(width - 1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = static_cast<float>(w0 + i) - d[i];
    const float xc = fminf(fmaxf(x, 0.f), last);
    x0[i] = min(static_cast<int>(floorf(xc)), width - 2);
    t[i] = xc - static_cast<float>(x0[i]);
    const float xf = floorf(x);
    const float tf = x - xf;
    const float cover = ((xf >= 0.f && xf <= last) ? 1.f - tf : 0.f) +
                        ((xf + 1.f >= 0.f && xf + 1.f <= last) ? tf : 0.f);
    ok[i] = cover >= 0.9999f ? 1.f : 0.f;
  }

  auto store = [&](T* dst, const float (&v)[4]) {
    if (vec) {
      store4_f32(dst + w0, make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (i < n) store_f32(dst + w0 + i, v[i]);
    }
  };
  if constexpr (C > 0) {
    float lo[C][4], hi[C][4];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[c][i] = load_f32(irow + c * plane + x0[i]);
        hi[c][i] = load_f32(irow + c * plane + x0[i] + 1);
      }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = lo[c][i] * (1.f - t[i]) + hi[c][i] * t[i];
      store(orow + c * plane, v);
    }
  } else {
    for (int c = 0; c < nch; ++c) {
      const T* src = irow + c * plane;
      float lo[4], hi[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = load_f32(src + x0[i]);
        hi[i] = load_f32(src + x0[i] + 1);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = lo[i] * (1.f - t[i]) + hi[i] * t[i];
      store(orow + c * plane, v);
    }
  }
  store(vrow, ok);
}

struct WarpGrid {
  dim3 blocks;
  int threads;
};

// The launch of both kernels: a row's quads over as few blocks as fit, each
// a multiple of 32 threads; one (b, h) row per (blockIdx.z, blockIdx.y).
WarpGrid warp_grid(int batch, int height, int width) {
  const int quads = (width + 3) / 4;
  const int blocks = (quads + WARP_MAX_THREADS - 1) / WARP_MAX_THREADS;
  const int threads = ((quads + blocks - 1) / blocks + 31) / 32 * 32;
  return {dim3(blocks, height, batch), threads};
}

// The checks and the launch of both forms' entry points.
template <typename T>
int launch_warp(const T* img, const float* disp, T* warped, T* valid, int batch, int channels,
                int height, int width, cudaStream_t s) {
  if (batch > 65535 || height > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || height == 0 || width == 0) return 0;
  const WarpGrid grid = warp_grid(batch, height, width);
  if (channels == 3) {
    warp_kernel<3, T><<<grid.blocks, grid.threads, 0, s>>>(img, disp, warped, valid, channels,
                                                            height, width);
  } else {
    warp_kernel<0, T><<<grid.blocks, grid.threads, 0, s>>>(img, disp, warped, valid, channels,
                                                            height, width);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// img, warped: [batch, channels, height, width]; disp, valid:
// [batch, height, width]; all float32, width >= 2; batch and height at
// most 65535 (the grid's y and z).
extern "C" int aanet_warp_f32(const float* img, const float* disp,
                              float* warped, float* valid, int batch,
                              int channels, int height, int width, int device,
                              void* stream) {
  cudaSetDevice(device);
  return launch_warp(img, disp, warped, valid, batch, channels, height, width,
                     static_cast<cudaStream_t>(stream));
}

// The bf16 form: img, warped and valid bfloat16, disp float32, the rest as
// aanet_warp_f32's.
extern "C" int aanet_warp_bf16(const bf16* img, const float* disp, bf16* warped, bf16* valid,
                               int batch, int channels, int height, int width, int device,
                               void* stream) {
  cudaSetDevice(device);
  return launch_warp(img, disp, warped, valid, batch, channels, height, width,
                     static_cast<cudaStream_t>(stream));
}

namespace {

// Backward for the disparity only (the image is the network's input on
// every path that warps, and the wrapper refuses an image that needs a
// gradient):
//   d loss / d disp[b, h, w] = -clip'(x) * sum_c g[c] * (img[x0+1] - img[x0]),
// with clip'(x) = 1 for 0 < x < W-1, 0 outside, and 1/2 at x = 0 or
// x = W-1: jax.grad of the JAX op's jnp.clip at a tie. The validity mask
// carries no gradient.
//
// Bound: bytes (2C + 1 values read and one written per pixel, a few
// operations each), like the forward. Design: the forward's layout (a 2-D
// grid, one (b, h) row per (blockIdx.z, blockIdx.y), 32-bit index
// arithmetic inside the row, 4 neighbouring pixels a thread): the
// disparity as one float4 loaded evict-first, each channel's run of the
// warped image's gradient as one load of 16 bytes (float32) or 8 (bf16),
// also evict-first (each value is read once), and the taps x0 and x0 + 1
// of every channel gathered from L1 with all C = 3 channels' loads in
// flight (C a template parameter, 0 for any other count); then grad_disp as
// one float4. A row whose width is not a multiple of 4 and the last partial
// quad take scalar loads and stores. The arithmetic is the plain twin's per
// pixel: the channels summed by fmaf in ascending c from 0, where clip' is
// not 0, then multiplied by -clip' (so -0 where clip' is 0).
//
// The bf16 form (aanet_warp_backward_bf16; T = bf16): the bf16 warped
// image's gradient and the bf16 image widened as they are loaded (exactly),
// the float32 disparity, the sum over channels in float32, and a float32
// gradient for the disparity (its primal's dtype).
template <int C, typename T>
__global__ void __launch_bounds__(WARP_MAX_THREADS)
warp_bwd_kernel(const T* __restrict__ grad_warped, const T* __restrict__ img,
                const float* __restrict__ disp, float* __restrict__ grad_disp, int channels,
                int height, int width) {
  const int w0 = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (w0 >= width) return;
  const int nch = C > 0 ? C : channels;
  const int h = blockIdx.y;
  const size_t b = blockIdx.z;
  const size_t plane = static_cast<size_t>(height) * width;
  const float* drow = disp + (b * height + h) * width;
  float* orow = grad_disp + (b * height + h) * width;
  const T* irow = img + b * nch * plane + static_cast<size_t>(h) * width;
  const T* grow = grad_warped + b * nch * plane + static_cast<size_t>(h) * width;
  const bool vec = (width & 3) == 0 && aligned16(disp) && aligned16(grad_disp) &&
                   aligned16(img) && aligned16(grad_warped);
  const int n = min(4, width - w0);

  float d[4] = {0.f, 0.f, 0.f, 0.f};
  load_disp4(drow, w0, n, vec, d);
  int x0[4];
  float dclip[4];
  const float last = static_cast<float>(width - 1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = static_cast<float>(w0 + i) - d[i];
    dclip[i] = (x > 0.f && x < last) ? 1.f : ((x == 0.f || x == last) ? 0.5f : 0.f);
    const float xc = fminf(fmaxf(x, 0.f), last);
    x0[i] = min(static_cast<int>(floorf(xc)), width - 2);
  }

  // a channel's run of the gradient, and its taps
  auto gradient = [&](const T* src, float (&g)[4]) {
    if (vec) {
      const float4 q = ldcs4_f32(src + w0);
      g[0] = q.x; g[1] = q.y; g[2] = q.z; g[3] = q.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = i < n ? ldcs_f32(src + w0 + i) : 0.f;
    }
  };
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (C > 0) {
    float g[C][4], lo[C][4], hi[C][4];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      gradient(grow + c * plane, g[c]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[c][i] = load_f32(irow + c * plane + x0[i]);
        hi[c][i] = load_f32(irow + c * plane + x0[i] + 1);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(g[c][i], hi[c][i] - lo[c][i], acc[i]);
  } else {
    for (int c = 0; c < nch; ++c) {
      float g[4], lo[4], hi[4];
      gradient(grow + c * plane, g);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = load_f32(irow + c * plane + x0[i]);
        hi[i] = load_f32(irow + c * plane + x0[i] + 1);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(g[i], hi[i] - lo[i], acc[i]);
    }
  }
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = -dclip[i] * (dclip[i] != 0.f ? acc[i] : 0.f);
  if (vec) {
    *reinterpret_cast<float4*>(orow + w0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < n) orow[w0 + i] = v[i];
  }
}

// The checks and the launch of both backward forms' entry points: the
// forward's grid.
template <typename T>
int launch_warp_bwd(const T* grad_warped, const T* img, const float* disp, float* grad_disp,
                    int batch, int channels, int height, int width, cudaStream_t s) {
  if (batch > 65535 || height > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || height == 0 || width == 0) return 0;
  const WarpGrid grid = warp_grid(batch, height, width);
  if (channels == 3) {
    warp_bwd_kernel<3, T><<<grid.blocks, grid.threads, 0, s>>>(grad_warped, img, disp, grad_disp,
                                                                channels, height, width);
  } else {
    warp_bwd_kernel<0, T><<<grid.blocks, grid.threads, 0, s>>>(grad_warped, img, disp, grad_disp,
                                                                channels, height, width);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grad_warped, img: [batch, channels, height, width]; disp, grad_disp:
// [batch, height, width]; all float32, width >= 2; batch and height at
// most 65535 (the grid's y and z).
extern "C" int aanet_warp_backward_f32(const float* grad_warped, const float* img,
                                       const float* disp, float* grad_disp, int batch,
                                       int channels, int height, int width, int device,
                                       void* stream) {
  cudaSetDevice(device);
  return launch_warp_bwd(grad_warped, img, disp, grad_disp, batch, channels, height, width,
                         static_cast<cudaStream_t>(stream));
}

// The bf16 form: grad_warped and img bfloat16, disp and grad_disp float32,
// the rest as aanet_warp_backward_f32's.
extern "C" int aanet_warp_backward_bf16(const bf16* grad_warped, const bf16* img,
                                        const float* disp, float* grad_disp, int batch,
                                        int channels, int height, int width, int device,
                                        void* stream) {
  cudaSetDevice(device);
  return launch_warp_bwd(grad_warped, img, disp, grad_disp, batch, channels, height, width,
                         static_cast<cudaStream_t>(stream));
}
