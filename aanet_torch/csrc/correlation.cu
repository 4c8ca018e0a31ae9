// Correlation cost volume, forward and backward. The forward:
//   cost[b, d, h, w] = (1/C) sum_c L[b, c, h, w] * R[b, c, h, w - d],
//   and 0 where w < d.
//
// Replaces aanet_tpu/ops/cost_volume.py:correlation_cost_volume (the
// banded-matmul formulation with _skew_band_extract; its plain form is
// correlation_cost_volume_reference).
//
// Bound: bytes, narrowly. At the main path's largest shape (C = 128,
// D = 64, 128x416) the band needs 0.8 GFLOP of float32 (12 us at the
// card's 67 TFLOP/s) against 68 MB of inputs and output (20 us at
// 3.35 TB/s). So the design reads each input value from memory once per
// disparity tile and serves every output that uses it from shared memory.
// Design: one block per (b, h, tile of TW columns, tile of TD
// disparities). Per chunk of CK channels the block stages the left tile
// [CK][TW] and the right window [CK][TW+TD-1] -- the columns
// w0-d0-(TD-1) .. w0-d0+TW-1, zero outside the image, which makes the
// w < d region come out as exact zeros -- in shared memory. Thread (tx, dg)
// owns column w0+tx and the disparities d0+dg, d0+dg+4, ..., so for each
// (channel, disparity) the 32 threads of a warp read 32 consecutive words
// (no bank conflicts) and each output row is written coalesced in the
// NCHW layout the aggregation convs read.
#include "common.cuh"

namespace {

constexpr int TW = 64;                     // output columns per block
constexpr int TD = 64;                     // disparities per block
constexpr int CK = 32;                     // channels staged per step
constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / TW;       // disparity groups per column: 4
constexpr int DPT = TD / GROUPS;           // disparities per thread: 16
constexpr int RW = TW + TD - 1;            // right-window width: 127

__global__ void __launch_bounds__(THREADS)
correlation_kernel(const float* __restrict__ left,
                   const float* __restrict__ right, float* __restrict__ out,
                   int channels, int height, int width, int max_disp,
                   int disp_tiles) {
  __shared__ float s_left[CK][TW];
  __shared__ float s_right[CK][RW + 1];

  const int w0 = blockIdx.x * TW;
  const int h = blockIdx.y;
  const int d0 = (blockIdx.z % disp_tiles) * TD;
  const long long b = blockIdx.z / disp_tiles;
  const int tx = threadIdx.x % TW;
  const int dg = threadIdx.x / TW;
  const int r0 = w0 - d0 - (TD - 1);  // image column of window slot 0

  const long long plane = static_cast<long long>(height) * width;
  const float* lrow = left + b * channels * plane + static_cast<long long>(h) * width;
  const float* rrow = right + b * channels * plane + static_cast<long long>(h) * width;

  float acc[DPT];
#pragma unroll
  for (int j = 0; j < DPT; ++j) acc[j] = 0.f;

  for (int c0 = 0; c0 < channels; c0 += CK) {
    for (int e = threadIdx.x; e < CK * TW; e += THREADS) {
      int cc = e / TW, ww = e % TW;
      int c = c0 + cc, w = w0 + ww;
      s_left[cc][ww] = (c < channels && w < width) ? lrow[c * plane + w] : 0.f;
    }
    for (int e = threadIdx.x; e < CK * RW; e += THREADS) {
      int cc = e / RW, ww = e % RW;
      int c = c0 + cc, w = r0 + ww;
      s_right[cc][ww] =
          (c < channels && w >= 0 && w < width) ? rrow[c * plane + w] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int cc = 0; cc < CK; ++cc) {
      const float l = s_left[cc][tx];
      // window slot of (w0 + tx, d0 + dd) is tx - dd + TD - 1
      const float* r = &s_right[cc][tx + TD - 1 - dg];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[j] += l * r[-GROUPS * j];
    }
    __syncthreads();
  }

  const int w = w0 + tx;
  if (w >= width) return;
  float* orow = out + b * max_disp * plane + static_cast<long long>(h) * width + w;
  const float num_c = static_cast<float>(channels);
#pragma unroll
  for (int j = 0; j < DPT; ++j) {
    int d = d0 + dg + GROUPS * j;
    if (d < max_disp) orow[d * plane] = acc[j] / num_c;
  }
}

}  // namespace

// left, right: [batch, channels, height, width]; out: [batch, max_disp,
// height, width]; all float32.
extern "C" int aanet_correlation_f32(const float* left, const float* right,
                                     float* out, int batch, int channels,
                                     int height, int width, int max_disp,
                                     int device, void* stream) {
  cudaSetDevice(device);
  if (batch == 0 || height == 0 || width == 0 || max_disp == 0) return 0;
  const int disp_tiles = (max_disp + TD - 1) / TD;
  dim3 grid((width + TW - 1) / TW, height, batch * disp_tiles);
  correlation_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      left, right, out, channels, height, width, max_disp, disp_tiles);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Backward: with g = d loss / d cost,
//   dL[c, h, w]  = (1/C) sum_d g[d, h, w]      * R[c, h, w - d]   (w >= d)
//   dR[c, h, w'] = (1/C) sum_d g[d, h, w' + d] * L[c, h, w' + d]  (w'+d < W)
// the transposes jax.grad derives for correlation_cost_volume. Where the
// forward wrote its zeros (w < d), g does not reach either input.
//
// Bound: bytes (per pair of outputs 2*D FMAs; the inputs, the gradient
// band and the two outputs each cross device memory once per block).
// Design: one block per (b, h, 64 columns); no atomics, each block owns
// the dL and dR columns of its tile for every channel and writes them as
// gathers. Per chunk of 32 disparities it stages the gradient rows the
// tile needs, g[d][w0 .. w0+63] for dL and g[d][w0+d0 .. w0+d0+94] for dR,
// then per chunk of 8 channels the right window (columns w0-d0-31 ..
// w0-d0+63) and the left window (w0+d0 .. w0+d0+94), zero outside the
// image, in shared memory. Thread (column, channel pair) sums its 32
// disparities from shared memory; the first disparity chunk stores, later
// ones add to the stored value.
// ---------------------------------------------------------------------------
namespace {

constexpr int BW = 64;            // columns per block
constexpr int BD = 32;            // disparities per chunk
constexpr int BC = 8;             // channels per chunk
constexpr int BWIN = BW + BD - 1;  // window width: 95
constexpr int BCPT = BC * BW / THREADS;  // channels per thread: 2

__global__ void __launch_bounds__(THREADS)
correlation_bwd_kernel(const float* __restrict__ grad, const float* __restrict__ left,
                       const float* __restrict__ right, float* __restrict__ grad_left,
                       float* __restrict__ grad_right, int channels, int height,
                       int width, int max_disp) {
  __shared__ float s_gl[BD][BW];    // g[d0+dd][w0+j]
  __shared__ float s_gr[BD][BWIN];  // g[d0+dd][w0+d0+j]
  __shared__ float s_r[BC][BWIN];   // R[c][w0-d0-(BD-1)+j]
  __shared__ float s_l[BC][BWIN];   // L[c][w0+d0+j]

  const int w0 = blockIdx.x * BW;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int tx = threadIdx.x % BW;
  const int tcg = threadIdx.x / BW;  // channels tcg, tcg + 4 of each chunk
  const long long plane = static_cast<long long>(height) * width;
  const long long row = static_cast<long long>(h) * width;
  const float* gb = grad + b * max_disp * plane + row;
  const float* lb = left + b * channels * plane + row;
  const float* rb = right + b * channels * plane + row;
  float* glb = grad_left + b * channels * plane + row;
  float* grb = grad_right + b * channels * plane + row;
  const float inv_c = 1.f / static_cast<float>(channels);
  const int w = w0 + tx;

  for (int d0 = 0; d0 < max_disp; d0 += BD) {
    __syncthreads();  // the previous chunk's readers are done with s_gl / s_gr
    for (int e = threadIdx.x; e < BD * BW; e += THREADS) {
      const int dd = e / BW, j = e % BW, d = d0 + dd, ww = w0 + j;
      s_gl[dd][j] = (d < max_disp && ww < width) ? gb[d * plane + ww] : 0.f;
    }
    for (int e = threadIdx.x; e < BD * BWIN; e += THREADS) {
      const int dd = e / BWIN, j = e % BWIN, d = d0 + dd, ww = w0 + d0 + j;
      s_gr[dd][j] = (d < max_disp && ww < width) ? gb[d * plane + ww] : 0.f;
    }
    for (int c0 = 0; c0 < channels; c0 += BC) {
      __syncthreads();
      for (int e = threadIdx.x; e < BC * BWIN; e += THREADS) {
        const int cc = e / BWIN, j = e % BWIN, c = c0 + cc;
        const int wr = w0 - d0 - (BD - 1) + j, wl = w0 + d0 + j;
        s_r[cc][j] = (c < channels && wr >= 0 && wr < width) ? rb[c * plane + wr] : 0.f;
        s_l[cc][j] = (c < channels && wl < width) ? lb[c * plane + wl] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < BCPT; ++q) {
        const int cc = tcg + (THREADS / BW) * q, c = c0 + cc;
        float al = 0.f, ar = 0.f;
#pragma unroll 8
        for (int dd = 0; dd < BD; ++dd) {
          al = fmaf(s_gl[dd][tx], s_r[cc][tx - dd + BD - 1], al);
          ar = fmaf(s_gr[dd][tx + dd], s_l[cc][tx + dd], ar);
        }
        if (c < channels && w < width) {
          const long long o = c * plane + w;
          if (d0 == 0) {
            glb[o] = al * inv_c;
            grb[o] = ar * inv_c;
          } else {
            glb[o] += al * inv_c;
            grb[o] += ar * inv_c;
          }
        }
      }
    }
  }
}

}  // namespace

// grad: [batch, max_disp, height, width]; left, right, grad_left,
// grad_right: [batch, channels, height, width]; all float32. The gradients
// are written in full.
extern "C" int aanet_correlation_backward_f32(const float* grad, const float* left,
                                              const float* right, float* grad_left,
                                              float* grad_right, int batch, int channels,
                                              int height, int width, int max_disp,
                                              int device, void* stream) {
  cudaSetDevice(device);
  if (batch == 0 || height == 0 || width == 0 || channels == 0) return 0;
  if (max_disp == 0) {  // a volume of no disparities passes no gradient
    const size_t bytes = sizeof(float) * batch * channels * height * static_cast<size_t>(width);
    cudaMemsetAsync(grad_left, 0, bytes, static_cast<cudaStream_t>(stream));
    cudaMemsetAsync(grad_right, 0, bytes, static_cast<cudaStream_t>(stream));
    return static_cast<int>(cudaGetLastError());
  }
  dim3 grid((width + BW - 1) / BW, height, batch);
  correlation_bwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      grad, left, right, grad_left, grad_right, channels, height, width, max_disp);
  return static_cast<int>(cudaGetLastError());
}
