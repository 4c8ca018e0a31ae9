// Modulated deformable convolution (DCNv2), forward.
//
// Replaces aanet_tpu/ops/deform.py:modulated_deform_conv2d (with its
// _make_patches and _sample_coords; deform_conv2d is the mask-less case).
// For output pixel (ho, wo), tap k = ki*kw + kj and deformable group g,
// the input channels of group g are sampled bilinearly at
//   y = ho*stride - pad + ki*dil + dy,  x = wo*stride - pad + kj*dil + dx,
// with corners outside [0, H-1] x [0, W-1] counted as zero, scaled by the
// mask m, and contracted over (tap, input channel) with the weight:
//   out[b, co, ho, wo] = bias[co]
//       + sum_{c, k} weight[co, c, k] * m[b, g(c), k] * x~[b, c, y, x].
// Offsets are [B, G*K*2, Ho, Wo] in the (g, k, (dy, dx)) channel order and
// the mask [B, G*K, Ho, Wo] in the (g, k) order, as the JAX package has it.
//
// Bound: operations. At the main path's largest shape (64 -> 64 channels
// at 128x416) the contraction is 3.9 GFLOP against 39 MB of inputs and
// output. Design: implicit GEMM on the CUDA cores in float32 -- no TF32,
// as the JAX side pins Precision.HIGHEST for this contraction. A block
// owns TP output pixels x TCO output channels. For each tap it first
// computes, for each pixel and group, the four corner offsets and the
// four corner weights (mask folded in) into shared memory; then, per chunk
// of CK input channels, it samples the modulated im2col tile [CK][TP] into
// shared memory, stages the weight slice [CK][TCO], and each thread
// accumulates a 4x4 register tile with FMAs. The gathered columns (490 MB
// at the largest shape if written out) never reach device memory.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int TP = 64;        // output pixels per block
constexpr int TCO = 64;       // output channels per block
constexpr int CK = 16;        // input channels staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, each a 4 x 4 tile
constexpr int MAX_G = 8;      // deformable groups a block can stage

__global__ void __launch_bounds__(THREADS)
deform_conv_kernel(const float* __restrict__ x, const float* __restrict__ offset,
                   long long offset_bstride, const float* __restrict__ mask,
                   long long mask_bstride, const float* __restrict__ weight,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int cin, int height, int width, int cout, int out_h,
                   int out_w, int kh, int kw, int stride, int pad, int dil,
                   int groups) {
  __shared__ float s_col[CK][TP];
  __shared__ float s_w[CK][TCO];
  __shared__ int s_idx[MAX_G][4][TP];
  __shared__ float s_wt[MAX_G][4][TP];

  const int npix = out_h * out_w;
  const int p0 = blockIdx.x * TP;
  const int co0 = blockIdx.y * TCO;
  const long long b = blockIdx.z;
  const int taps = kh * kw;
  const int cg = cin / groups;
  const int t = threadIdx.x;
  const int tp = t % 16;  // pixels tp, tp+16, tp+32, tp+48
  const int tc = t / 16;  // channels tc, tc+16, tc+32, tc+48

  const long long hw = static_cast<long long>(height) * width;
  const float* xb = x + b * cin * hw;
  const float* ob = offset + b * offset_bstride;
  const float* mb = mask ? mask + b * mask_bstride : nullptr;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < taps; ++k) {
    const int ki = k / kw, kj = k % kw;

    // Corner offsets and weights of tap k for every (group, pixel).
    for (int e = t; e < groups * TP; e += THREADS) {
      const int g = e / TP, pl = e % TP, p = p0 + pl;
      int idx[4] = {0, 0, 0, 0};
      float wt[4] = {0.f, 0.f, 0.f, 0.f};
      if (p < npix) {
        const int ho = p / out_w, wo = p % out_w;
        const long long oc = static_cast<long long>((g * taps + k) * 2) * npix + p;
        const float dy = ob[oc], dx = ob[oc + npix];
        const float m = mb ? mb[static_cast<long long>(g * taps + k) * npix + p] : 1.f;
        float py = static_cast<float>(ho * stride - pad + ki * dil) + dy;
        float px = static_cast<float>(wo * stride - pad + kj * dil) + dx;
        // Outside (-1, H) x (-1, W) every corner is padding; the clamp only
        // keeps the integer conversion in range.
        py = fminf(fmaxf(py, -2.f), static_cast<float>(height) + 1.f);
        px = fminf(fmaxf(px, -2.f), static_cast<float>(width) + 1.f);
        const float fy = floorf(py), fx = floorf(px);
        const int y0 = static_cast<int>(fy), x0 = static_cast<int>(fx);
        const float ly = py - fy, lx = px - fx;
        const float wy[2] = {1.f - ly, ly};
        const float wx[2] = {1.f - lx, lx};
#pragma unroll
        for (int cy = 0; cy < 2; ++cy)
#pragma unroll
          for (int cx = 0; cx < 2; ++cx) {
            const int yy = y0 + cy, xx = x0 + cx;
            if (yy >= 0 && yy < height && xx >= 0 && xx < width) {
              idx[cy * 2 + cx] = yy * width + xx;
              wt[cy * 2 + cx] = wy[cy] * wx[cx] * m;
            }
          }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        s_idx[g][q][pl] = idx[q];
        s_wt[g][q][pl] = wt[q];
      }
    }
    __syncthreads();

    for (int c0 = 0; c0 < cin; c0 += CK) {
      // Modulated im2col tile of tap k: CK channels x TP pixels.
      for (int e = t; e < CK * TP; e += THREADS) {
        const int cc = e / TP, pl = e % TP, c = c0 + cc;
        float v = 0.f;
        if (c < cin) {
          const int g = c / cg;
          const float* xc = xb + c * hw;
          v = s_wt[g][0][pl] * xc[s_idx[g][0][pl]] +
              s_wt[g][1][pl] * xc[s_idx[g][1][pl]] +
              s_wt[g][2][pl] * xc[s_idx[g][2][pl]] +
              s_wt[g][3][pl] * xc[s_idx[g][3][pl]];
        }
        s_col[cc][pl] = v;
      }
      // Weight slice of tap k: weight[co, c, ki, kj] for the chunk.
      for (int e = t; e < CK * TCO; e += THREADS) {
        const int cc = e / TCO, cl = e % TCO, c = c0 + cc, co = co0 + cl;
        s_w[cc][cl] = (c < cin && co < cout)
                          ? weight[(static_cast<long long>(co) * cin + c) * taps + k]
                          : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int cc = 0; cc < CK; ++cc) {
        float a[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_col[cc][tp + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = s_w[cc][tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float* outb = out + b * cout * static_cast<long long>(npix);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + tc + 16 * j;
    if (co >= cout) continue;
    const float bv = bias ? bias[co] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + tp + 16 * i;
      if (p < npix) outb[static_cast<long long>(co) * npix + p] = acc[i][j] + bv;
    }
  }
}

}  // namespace

// x: [batch, cin, height, width]; offset: [batch, groups*kh*kw*2, out_h,
// out_w] with batch stride offset_bstride (elements), the rest contiguous;
// mask: [batch, groups*kh*kw, out_h, out_w] likewise, or null; weight:
// [cout, cin, kh, kw]; bias: [cout] or null; out: [batch, cout, out_h,
// out_w]. All float32; groups <= 8 and divides cin.
extern "C" int aanet_deform_conv_f32(
    const float* x, const float* offset, long long offset_bstride,
    const float* mask, long long mask_bstride, const float* weight,
    const float* bias, float* out, int batch, int cin, int height, int width,
    int cout, int out_h, int out_w, int kh, int kw, int stride, int pad,
    int dil, int groups, int device, void* stream) {
  cudaSetDevice(device);
  if (groups < 1 || groups > MAX_G || cin % groups != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long npix = static_cast<long long>(out_h) * out_w;
  if (batch == 0 || npix == 0 || cout == 0) return 0;
  dim3 grid(static_cast<unsigned int>((npix + TP - 1) / TP),
            (cout + TCO - 1) / TCO, batch);
  deform_conv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, offset, offset_bstride, mask, mask_bstride, weight, bias, out, cin,
      height, width, cout, out_h, out_w, kh, kw, stride, pad, dil, groups);
  return static_cast<int>(cudaGetLastError());
}
