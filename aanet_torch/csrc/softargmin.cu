// Fused soft-argmin, forward and backward. The forward:
//   disp[b, p] = sum_d softmax_d(s * cost[b, d, p]) * d.
//
// Replaces aanet_tpu/ops/softargmin.py:soft_argmin (softmax over the
// disparity axis, then the expectation against candidates 0..D-1; s = -1
// when the volume is a matching cost rather than a similarity).
//
// Bound: bytes. Each cost value is read once and used for a handful of
// operations, so the kernel is a pass over the volume at memory speed.
// Design: one thread per pixel, a single pass over D with an online
// softmax (running max, rescaled sum, rescaled weighted sum), so the
// volume is read once and no probability tensor is written. The layout is
// [B, D, H, W], so for each d the threads of a warp read neighbouring
// pixels: every load is coalesced.
#include "common.cuh"

#include <math.h>

__global__ void softargmin_kernel(const float* __restrict__ cost,
                                  float* __restrict__ out, long long pixels,
                                  int depth, long long plane, float sign) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= pixels) return;
  long long b = i / plane;
  long long p = i - b * plane;
  const float* c = cost + b * depth * plane + p;
  float run_max = -INFINITY, sum = 0.f, wsum = 0.f;
  for (int d = 0; d < depth; ++d) {
    float v = sign * c[d * plane];
    if (v > run_max) {
      float r = expf(run_max - v);  // 0 on the first step
      sum = sum * r + 1.f;
      wsum = wsum * r + static_cast<float>(d);
      run_max = v;
    } else {
      float e = expf(v - run_max);
      sum += e;
      wsum += e * static_cast<float>(d);
    }
  }
  out[i] = wsum / sum;
}

// cost: [batch, depth, plane] float32, out: [batch, plane] float32.
extern "C" int aanet_softargmin_f32(const float* cost, float* out, int batch,
                                    int depth, long long plane, int negate,
                                    int device, void* stream) {
  cudaSetDevice(device);
  long long pixels = static_cast<long long>(batch) * plane;
  if (pixels == 0) return 0;
  const int threads = 256;
  softargmin_kernel<<<aanet_blocks(pixels, threads), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      cost, out, pixels, depth, plane, negate ? -1.f : 1.f);
  return static_cast<int>(cudaGetLastError());
}

// Backward: with g = d loss / d disp and p_d the softmax,
//   d loss / d cost[b, d, p] = s * g * p_d * (d - disp),
// jax.grad of soft_argmin. Bound: bytes (the volume is read twice and the
// gradient volume written once). Design: one thread per pixel; a first
// pass recomputes the running max, the normaliser and the expectation
// exactly as the forward does, a second pass writes each disparity's
// gradient. No probability tensor is kept in device memory.
__global__ void softargmin_bwd_kernel(const float* __restrict__ grad_out,
                                      const float* __restrict__ cost,
                                      float* __restrict__ grad_cost, long long pixels,
                                      int depth, long long plane, float sign) {
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= pixels) return;
  long long b = i / plane;
  long long p = i - b * plane;
  const float* c = cost + b * depth * plane + p;
  float* gc = grad_cost + b * depth * plane + p;
  float run_max = -INFINITY, sum = 0.f, wsum = 0.f;
  for (int d = 0; d < depth; ++d) {
    float v = sign * c[d * plane];
    if (v > run_max) {
      float r = expf(run_max - v);
      sum = sum * r + 1.f;
      wsum = wsum * r + static_cast<float>(d);
      run_max = v;
    } else {
      float e = expf(v - run_max);
      sum += e;
      wsum += e * static_cast<float>(d);
    }
  }
  const float mean = wsum / sum;
  const float scale = sign * grad_out[i] / sum;
  for (int d = 0; d < depth; ++d) {
    const float e = expf(sign * c[d * plane] - run_max);
    gc[d * plane] = scale * e * (static_cast<float>(d) - mean);
  }
}

// grad_out: [batch, plane]; cost, grad_cost: [batch, depth, plane]; float32.
extern "C" int aanet_softargmin_backward_f32(const float* grad_out, const float* cost,
                                             float* grad_cost, int batch, int depth,
                                             long long plane, int negate, int device,
                                             void* stream) {
  cudaSetDevice(device);
  long long pixels = static_cast<long long>(batch) * plane;
  if (pixels == 0 || depth == 0) return 0;
  const int threads = 256;
  softargmin_bwd_kernel<<<aanet_blocks(pixels, threads), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      grad_out, cost, grad_cost, pixels, depth, plane, negate ? -1.f : 1.f);
  return static_cast<int>(cudaGetLastError());
}
