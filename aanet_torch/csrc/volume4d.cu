// The 4-D cost volumes of the 3-D-aggregation networks (PSMNet, StereoNet):
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
