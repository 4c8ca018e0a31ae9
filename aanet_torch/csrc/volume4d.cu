// The 4-D cost volumes of the 3-D-aggregation networks (PSMNet, StereoNet,
// GC-Net):
//   difference: out[b, c, d, h, w] = L[b, c, h, w] - R[b, c, h, w - d]
//   concat:     out[b, c, d, h, w] = L[b, c, h, w]          (c <  C)
//               out[b, c, d, h, w] = R[b, c - C, h, w - d]  (c >= C)
// both zero where w < d, laid out [B, C, D, H, W] and [B, 2C, D, H, W].
//
// Replaces aanet_tpu/ops/cost_volume.py:difference_cost_volume and
// concat_cost_volume (the reference's loop over d, nets/cost.py:22-38).
//
// Bound: bytes, and the writes alone: the volume is D times its inputs
// (at 384x1248, max_disp 192: 2 x 4 MB of features in, 184 MB or 368 MB
// out). Design: one block per (b, c, h) row stages the L and R rows in
// shared memory, so each input value is read from device memory once;
// then its threads write the D x W outputs of the row, neighbouring
// threads on neighbouring w, so every store is coalesced. A copy or one
// float32 subtraction per output: the result equals the plain version bit
// for bit.
//
// The backward kernels are XLA's transposes of the shifted copies, for
// grad [B, C', D, H, W]:
//   dL[b, c, h, w]  =  sum_{d <= w}       g[b, c, d, h, w]
//   dR[b, c, h, w'] = -sum_{w' + d < W}   g[b, c, d, h, w' + d]  (difference)
//                   = +sum_{w' + d < W}   g[b, C + c, d, h, w' + d]  (concat)
// with d < D. Bound: bytes, ``grad`` read once and dL, dR written once.
// Design: one thread per output (b, c, h, w) walks d upwards once and sums
// both gradients; neighbouring threads take neighbouring w, so the read of
// g[d, w] and the shifted read of g[d, w + d] are both coalesced (for the
// difference volume the second mostly hits L1). No atomics: deterministic.
// Each sum starts from 0 and adds (or subtracts) in ascending d, as the
// plain twins accumulate their slices, so the result equals them bit for
// bit.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <bool kConcat>
__global__ void __launch_bounds__(THREADS)
volume4d_kernel(const float* __restrict__ left, const float* __restrict__ right,
                float* __restrict__ out, int channels, int height, int width,
                int max_disp) {
  extern __shared__ float rows[];  // the L row, then the R row
  float* l = rows;
  float* r = rows + width;
  const int h = blockIdx.x;
  const int c = blockIdx.y;
  const long long b = blockIdx.z;
  const long long in_row = ((b * channels + c) * height + h) * width;
  for (int w = threadIdx.x; w < width; w += THREADS) {
    l[w] = left[in_row + w];
    r[w] = right[in_row + w];
  }
  __syncthreads();
  const long long plane = static_cast<long long>(height) * width;  // one (c, d) plane
  const int out_channels = kConcat ? 2 * channels : channels;
  // (b, c, d = 0, h, w = 0), and for concat (b, C + c, 0, h, 0)
  float* dst = out + (b * out_channels + c) * max_disp * plane + static_cast<long long>(h) * width;
  float* dst_r = dst + static_cast<long long>(channels) * max_disp * plane;
  const int n = max_disp * width;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int d = i / width;
    const int w = i - d * width;
    const bool valid = w >= d;
    const long long o = d * plane + w;
    if (kConcat) {
      dst[o] = valid ? l[w] : 0.f;
      dst_r[o] = valid ? r[w - d] : 0.f;
    } else {
      dst[o] = valid ? l[w] - r[w - d] : 0.f;
    }
  }
}

template <bool kConcat>
int launch(const float* left, const float* right, float* out, int batch,
           int channels, int height, int width, int max_disp, int device,
           void* stream) {
  cudaSetDevice(device);
  if (batch == 0 || channels == 0 || height == 0 || width == 0 || max_disp == 0) return 0;
  const int smem = 2 * width * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        volume4d_kernel<kConcat>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(height, channels, batch);
  volume4d_kernel<kConcat><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      left, right, out, channels, height, width, max_disp);
  return static_cast<int>(cudaGetLastError());
}

template <bool kConcat>
__global__ void __launch_bounds__(THREADS)
volume4d_backward_kernel(const float* __restrict__ grad, float* __restrict__ grad_left,
                         float* __restrict__ grad_right, long long n, int channels,
                         int height, int width, int max_disp) {
  const long long i = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (i >= n) return;
  const int w = static_cast<int>(i % width);
  const long long row = i / width;  // (b, c, h)
  const int h = static_cast<int>(row % height);
  const long long bc = row / height;
  const long long c = bc % channels;
  const long long b = bc / channels;
  const long long plane = static_cast<long long>(height) * width;  // one (c, d) plane
  const int grad_channels = kConcat ? 2 * channels : channels;
  // g[b, c, 0, h, 0] for dL; for dR the same channel (difference) or C + c
  const float* gl = grad + (b * grad_channels + c) * max_disp * plane + static_cast<long long>(h) * width;
  const float* gr = kConcat ? gl + static_cast<long long>(channels) * max_disp * plane : gl;
  const int left_end = min(max_disp, w + 1);       // d <= w
  const int right_end = min(max_disp, width - w);  // w + d < W
  const int end = max(left_end, right_end);
  float acc_l = 0.f;
  float acc_r = 0.f;
  // one pass over d: thread w's shifted read g[d, w + d] is thread
  // (w + d)'s g[d, w + d] of the same iteration, so for the difference
  // volume it mostly hits L1
  for (int d = 0; d < end; ++d) {
    const float* plane_d = gl + d * plane;
    if (d < left_end) acc_l += plane_d[w];
    if (d < right_end) {
      const float g = (kConcat ? gr + d * plane : plane_d)[w + d];
      if (kConcat) {
        acc_r += g;
      } else {
        acc_r -= g;
      }
    }
  }
  grad_left[i] = acc_l;
  grad_right[i] = acc_r;
}

template <bool kConcat>
int launch_backward(const float* grad, float* grad_left, float* grad_right, int batch,
                    int channels, int height, int width, int max_disp, int device,
                    void* stream) {
  cudaSetDevice(device);
  const long long n = static_cast<long long>(batch) * channels * height * width;
  if (n == 0) return 0;  // with max_disp 0 the kernel writes zeros
  volume4d_backward_kernel<kConcat><<<aanet_blocks(n, THREADS), THREADS, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      grad, grad_left, grad_right, n, channels, height, width, max_disp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// left, right: [batch, channels, height, width] float32;
// out: [batch, channels, max_disp, height, width] float32.
extern "C" int aanet_difference_volume_f32(const float* left, const float* right,
                                           float* out, int batch, int channels,
                                           int height, int width, int max_disp,
                                           int device, void* stream) {
  return launch<false>(left, right, out, batch, channels, height, width, max_disp,
                       device, stream);
}

// out: [batch, 2 * channels, max_disp, height, width] float32.
extern "C" int aanet_concat_volume_f32(const float* left, const float* right,
                                       float* out, int batch, int channels,
                                       int height, int width, int max_disp,
                                       int device, void* stream) {
  return launch<true>(left, right, out, batch, channels, height, width, max_disp,
                      device, stream);
}

// grad: [batch, channels, max_disp, height, width] float32;
// grad_left, grad_right: [batch, channels, height, width] float32.
extern "C" int aanet_difference_volume_backward_f32(const float* grad, float* grad_left,
                                                    float* grad_right, int batch,
                                                    int channels, int height, int width,
                                                    int max_disp, int device, void* stream) {
  return launch_backward<false>(grad, grad_left, grad_right, batch, channels, height, width,
                                max_disp, device, stream);
}

// grad: [batch, 2 * channels, max_disp, height, width] float32.
extern "C" int aanet_concat_volume_backward_f32(const float* grad, float* grad_left,
                                                float* grad_right, int batch, int channels,
                                                int height, int width, int max_disp,
                                                int device, void* stream) {
  return launch_backward<true>(grad, grad_left, grad_right, batch, channels, height, width,
                               max_disp, device, stream);
}
