// Modulated deformable convolution (DCNv2): the forward, and the two
// kernels of its backward (see the note above each backward kernel).
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

// ---------------------------------------------------------------------------
// Backward (a): the gradients for x, offset and mask.
//
// Replaces the transposes that jax.grad derives from the gather and the
// contraction of aanet_tpu/ops/deform.py:modulated_deform_conv2d. With the
// column gradient gcol[c, k, p] = sum_co weight[co, c, k] * gout[co, p]:
//   grad_x[c, corner] += gcol * m * w_corner            (bilinear scatter)
//   grad_offset[g, k, p] = sum_{c in g} gcol * m * d sample / d position
//   grad_mask[g, k, p]   = sum_{c in g} gcol * sample
// where sample is the unmodulated bilinear sample. The derivative of the
// fractional position is halved where the position is an integer: the JAX
// op clips the fraction to [0, 1] with jnp.clip, whose gradient at a tie
// is one half.
//
// Bound: operations (the gcol contraction has the forward's FLOP count),
// plus 4 atomics per channel, tap and pixel for the scatter. Design: one
// block per (64 output pixels, tap k, batch b). The block tabulates the
// corners of its pixels for tap k once in shared memory; then for each
// chunk of 64 input channels it forms the gcol tile [64 ch x 64 px] as an
// implicit GEMM over Cout (gout and weight slices staged in shared memory,
// a 4x4 register tile per thread, float32 FMA, no TF32) and consumes it
// from registers: atomicAdd to grad_x through the four corners, and
// offset / mask partial sums reduced over the group's channels with
// shared-memory atomics. The block owns every channel of its (b, k,
// pixels), so it writes grad_offset and grad_mask without global atomics.
// gcol never reaches device memory.
// ---------------------------------------------------------------------------
namespace {

constexpr int DP = 64;  // output pixels per block
constexpr int DC = 64;  // input channels per gcol tile
constexpr int DO = 16;  // output channels staged per step
// Words per (group, pixel) of the dynamic shared table: 4 corner indices,
// 4 corner weights, 4 d weight / d y, 4 d weight / d x, the mask, and the
// 3 partial sums (d offset y, d offset x, d mask).
constexpr int TABLE_WORDS = 20;

__global__ void __launch_bounds__(THREADS)
deform_bwd_data_kernel(const float* __restrict__ gout, const float* __restrict__ x,
                       const float* __restrict__ offset, long long offset_bstride,
                       const float* __restrict__ mask, long long mask_bstride,
                       const float* __restrict__ weight, float* __restrict__ grad_x,
                       float* __restrict__ grad_offset, float* __restrict__ grad_mask,
                       int cin, int height, int width, int cout, int out_h,
                       int out_w, int kh, int kw, int stride, int pad, int dil,
                       int groups) {
  extern __shared__ float s_table[];
  __shared__ float s_g[DO][DP];
  __shared__ float s_w[DO][DC];
  const int gp = groups * DP;  // table entries: e = g * DP + pixel
  int* s_idx = reinterpret_cast<int*>(s_table);  // [4][gp]
  float* s_cw = s_table + 4 * gp;                 // [4][gp]
  float* s_dy = s_cw + 4 * gp;                    // [4][gp]
  float* s_dx = s_dy + 4 * gp;                    // [4][gp]
  float* s_m = s_dx + 4 * gp;                     // [gp]
  float* s_part = s_m + gp;                       // [3][gp]

  const int npix = out_h * out_w;
  const int p0 = blockIdx.x * DP;
  const int k = blockIdx.y;
  const long long b = blockIdx.z;
  const int taps = kh * kw, ki = k / kw, kj = k % kw;
  const int cg = cin / groups;
  const int t = threadIdx.x;
  const int tp = t % 16;  // pixels tp, tp+16, tp+32, tp+48
  const int tc = t / 16;  // channels tc, tc+16, tc+32, tc+48 of the chunk
  const long long hw = static_cast<long long>(height) * width;
  const float* ob = offset + b * offset_bstride;
  const float* mb = mask ? mask + b * mask_bstride : nullptr;

  for (int e = t; e < gp; e += THREADS) {
    const int g = e / DP, pl = e % DP, p = p0 + pl;
    int idx[4] = {0, 0, 0, 0};
    float cw[4] = {0.f, 0.f, 0.f, 0.f}, dyw[4] = {0.f, 0.f, 0.f, 0.f},
          dxw[4] = {0.f, 0.f, 0.f, 0.f};
    float m = 0.f;
    if (p < npix) {
      const int ho = p / out_w, wo = p % out_w;
      const long long oc = static_cast<long long>((g * taps + k) * 2) * npix + p;
      const float dy = ob[oc], dx = ob[oc + npix];
      m = mb ? mb[static_cast<long long>(g * taps + k) * npix + p] : 1.f;
      float py = static_cast<float>(ho * stride - pad + ki * dil) + dy;
      float px = static_cast<float>(wo * stride - pad + kj * dil) + dx;
      // as in the forward: outside (-1, H) x (-1, W) every corner is padding
      py = fminf(fmaxf(py, -2.f), static_cast<float>(height) + 1.f);
      px = fminf(fmaxf(px, -2.f), static_cast<float>(width) + 1.f);
      const float fy = floorf(py), fx = floorf(px);
      const int y0 = static_cast<int>(fy), x0 = static_cast<int>(fx);
      const float ly = py - fy, lx = px - fx;
      const float sy = ly == 0.f ? 0.5f : 1.f, sx = lx == 0.f ? 0.5f : 1.f;
      const float wy[2] = {1.f - ly, ly};
      const float wx[2] = {1.f - lx, lx};
#pragma unroll
      for (int cy = 0; cy < 2; ++cy)
#pragma unroll
        for (int cx = 0; cx < 2; ++cx) {
          const int yy = y0 + cy, xx = x0 + cx, q = cy * 2 + cx;
          if (yy >= 0 && yy < height && xx >= 0 && xx < width) {
            idx[q] = yy * width + xx;
            cw[q] = wy[cy] * wx[cx];
            dyw[q] = (cy ? sy : -sy) * wx[cx];
            dxw[q] = wy[cy] * (cx ? sx : -sx);
          }
        }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      s_idx[q * gp + e] = idx[q];
      s_cw[q * gp + e] = cw[q];
      s_dy[q * gp + e] = dyw[q];
      s_dx[q * gp + e] = dxw[q];
    }
    s_m[e] = m;
    s_part[e] = 0.f;
    s_part[gp + e] = 0.f;
    s_part[2 * gp + e] = 0.f;
  }
  __syncthreads();

  const float* gb = gout + b * cout * static_cast<long long>(npix);
  for (int c0 = 0; c0 < cin; c0 += DC) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int co0 = 0; co0 < cout; co0 += DO) {
      for (int e = t; e < DO * DP; e += THREADS) {
        const int r = e / DP, pl = e % DP, co = co0 + r, p = p0 + pl;
        s_g[r][pl] = (co < cout && p < npix) ? gb[static_cast<long long>(co) * npix + p] : 0.f;
      }
      for (int e = t; e < DO * DC; e += THREADS) {
        const int r = e / DC, cc = e % DC, co = co0 + r, c = c0 + cc;
        s_w[r][cc] = (co < cout && c < cin)
                         ? weight[(static_cast<long long>(co) * cin + c) * taps + k]
                         : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < DO; ++r) {
        float a[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s_g[r][tp + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = s_w[r][tc + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
      }
      __syncthreads();
    }
    // Consume the gcol tile from registers.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tc + 16 * j;
      if (c >= cin) continue;
      const int g = c / cg;
      const float* xc = x + (b * cin + c) * hw;
      float* gxc = grad_x + (b * cin + c) * hw;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int pl = tp + 16 * i;
        if (p0 + pl >= npix) continue;
        const int e = g * DP + pl;
        const float gc = acc[i][j];
        const float gm = gc * s_m[e];
        float sample = 0.f, dpy = 0.f, dpx = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int id = s_idx[q * gp + e];
          const float w = s_cw[q * gp + e];
          const float v = xc[id];
          sample = fmaf(w, v, sample);
          dpy = fmaf(s_dy[q * gp + e], v, dpy);
          dpx = fmaf(s_dx[q * gp + e], v, dpx);
          if (w != 0.f) atomicAdd(gxc + id, gm * w);
        }
        atomicAdd(&s_part[e], gm * dpy);
        atomicAdd(&s_part[gp + e], gm * dpx);
        atomicAdd(&s_part[2 * gp + e], gc * sample);
      }
    }
  }
  __syncthreads();

  float* gob = grad_offset + b * groups * taps * 2 * static_cast<long long>(npix);
  float* gmb = grad_mask ? grad_mask + b * groups * taps * static_cast<long long>(npix) : nullptr;
  for (int e = t; e < gp; e += THREADS) {
    const int g = e / DP, pl = e % DP, p = p0 + pl;
    if (p >= npix) continue;
    const long long oc = static_cast<long long>((g * taps + k) * 2) * npix + p;
    gob[oc] = s_part[e];
    gob[oc + npix] = s_part[gp + e];
    if (gmb) gmb[static_cast<long long>(g * taps + k) * npix + p] = s_part[2 * gp + e];
  }
}

// ---------------------------------------------------------------------------
// Backward (b): the weight gradient,
//   grad_w[co, c, k] = sum_{b, p} gout[b, co, p] * col[b, c, k, p],
// with the modulated columns col recomputed in shared memory the way the
// forward samples them; they are never stored in device memory (680 MB
// per conv at scale 0, batch 16, 96x192, if they were).
//
// Bound: operations (the forward's FLOP count once more). Design: a block
// owns a [64 co x 64 c] tile of one tap k and a range of 512 pixels of one
// batch entry. Per step of 32 pixels it tabulates the corners, samples the
// column tile [32 px x 64 c] and stages the gout tile [32 px x 64 co]
// (both padded to 65 words a row, so neither the transposing writes nor
// the reads conflict on banks), and each thread accumulates a 4x4 register
// tile with float32 FMA. Blocks add their partial tiles to grad_w (zeroed
// by the caller) with atomicAdd.
// ---------------------------------------------------------------------------
constexpr int WP = 32;      // pixels per step
constexpr int WT = 64;      // output and input channels per block tile
constexpr int WSTEPS = 16;  // steps per block: 512 pixels

__global__ void __launch_bounds__(THREADS)
deform_bwd_weight_kernel(const float* __restrict__ gout, const float* __restrict__ x,
                         const float* __restrict__ offset, long long offset_bstride,
                         const float* __restrict__ mask, long long mask_bstride,
                         float* __restrict__ grad_w, int cin, int height, int width,
                         int cout, int out_h, int out_w, int kh, int kw, int stride,
                         int pad, int dil, int groups, int c_tiles, int splits) {
  __shared__ float s_col[WP][WT + 1];
  __shared__ float s_g[WP][WT + 1];
  __shared__ int s_idx[MAX_G][4][WP];
  __shared__ float s_wt[MAX_G][4][WP];

  const int npix = out_h * out_w;
  const int co0 = (blockIdx.x / c_tiles) * WT;
  const int c0 = (blockIdx.x % c_tiles) * WT;
  const int k = blockIdx.y;
  const long long b = blockIdx.z / splits;
  const int pbeg = (blockIdx.z % splits) * WSTEPS * WP;
  const int pend = min(npix, pbeg + WSTEPS * WP);
  const int taps = kh * kw, ki = k / kw, kj = k % kw;
  const int cg = cin / groups;
  const int t = threadIdx.x;
  const int ty = t / 16;  // output channels ty, ty+16, ty+32, ty+48
  const int tx = t % 16;  // input channels tx, tx+16, tx+32, tx+48
  const long long hw = static_cast<long long>(height) * width;
  const float* xb = x + b * cin * hw;
  const float* gb = gout + b * cout * static_cast<long long>(npix);
  const float* ob = offset + b * offset_bstride;
  const float* mb = mask ? mask + b * mask_bstride : nullptr;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int q0 = pbeg; q0 < pend; q0 += WP) {
    for (int e = t; e < groups * WP; e += THREADS) {
      const int g = e / WP, pl = e % WP, p = q0 + pl;
      int idx[4] = {0, 0, 0, 0};
      float wt[4] = {0.f, 0.f, 0.f, 0.f};
      if (p < pend) {
        const int ho = p / out_w, wo = p % out_w;
        const long long oc = static_cast<long long>((g * taps + k) * 2) * npix + p;
        const float dy = ob[oc], dx = ob[oc + npix];
        const float m = mb ? mb[static_cast<long long>(g * taps + k) * npix + p] : 1.f;
        float py = static_cast<float>(ho * stride - pad + ki * dil) + dy;
        float px = static_cast<float>(wo * stride - pad + kj * dil) + dx;
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
    for (int e = t; e < WT * WP; e += THREADS) {
      const int cc = e / WP, pl = e % WP, c = c0 + cc;
      float v = 0.f;
      if (c < cin && q0 + pl < pend) {
        const int g = c / cg;
        const float* xc = xb + c * hw;
        v = s_wt[g][0][pl] * xc[s_idx[g][0][pl]] + s_wt[g][1][pl] * xc[s_idx[g][1][pl]] +
            s_wt[g][2][pl] * xc[s_idx[g][2][pl]] + s_wt[g][3][pl] * xc[s_idx[g][3][pl]];
      }
      s_col[pl][cc] = v;
    }
    for (int e = t; e < WT * WP; e += THREADS) {
      const int r = e / WP, pl = e % WP, co = co0 + r, p = q0 + pl;
      s_g[pl][r] = (co < cout && p < pend) ? gb[static_cast<long long>(co) * npix + p] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int pl = 0; pl < WP; ++pl) {
      float a[4], v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_g[pl][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = s_col[pl][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], v[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = co0 + ty + 16 * i;
    if (co >= cout) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < cin) atomicAdd(&grad_w[(static_cast<long long>(co) * cin + c) * taps + k], acc[i][j]);
    }
  }
}

}  // namespace

// gout: [batch, cout, out_h, out_w]; x, offset, mask, weight as for the
// forward; grad_x: [batch, cin, height, width], zeroed by the caller (the
// kernel adds into it); grad_offset: [batch, groups*kh*kw*2, out_h, out_w]
// and grad_mask: [batch, groups*kh*kw, out_h, out_w] (or null), both
// contiguous and written in full. All float32; groups <= 8 and divides cin.
extern "C" int aanet_deform_conv_backward_data_f32(
    const float* gout, const float* x, const float* offset, long long offset_bstride,
    const float* mask, long long mask_bstride, const float* weight, float* grad_x,
    float* grad_offset, float* grad_mask, int batch, int cin, int height, int width,
    int cout, int out_h, int out_w, int kh, int kw, int stride, int pad, int dil,
    int groups, int device, void* stream) {
  cudaSetDevice(device);
  if (groups < 1 || groups > MAX_G || cin % groups != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long npix = static_cast<long long>(out_h) * out_w;
  if (batch == 0 || npix == 0) return 0;
  const int smem = TABLE_WORDS * groups * DP * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      deform_bwd_data_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned int>((npix + DP - 1) / DP), kh * kw, batch);
  deform_bwd_data_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      gout, x, offset, offset_bstride, mask, mask_bstride, weight, grad_x, grad_offset,
      grad_mask, cin, height, width, cout, out_h, out_w, kh, kw, stride, pad, dil, groups);
  return static_cast<int>(cudaGetLastError());
}

// gout, x, offset, mask as above; grad_w: [cout, cin, kh, kw], zeroed by
// the caller (blocks add their partial sums into it).
extern "C" int aanet_deform_conv_backward_weight_f32(
    const float* gout, const float* x, const float* offset, long long offset_bstride,
    const float* mask, long long mask_bstride, float* grad_w, int batch, int cin,
    int height, int width, int cout, int out_h, int out_w, int kh, int kw, int stride,
    int pad, int dil, int groups, int device, void* stream) {
  cudaSetDevice(device);
  if (groups < 1 || groups > MAX_G || cin % groups != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long npix = static_cast<long long>(out_h) * out_w;
  if (batch == 0 || npix == 0 || cout == 0) return 0;
  const int c_tiles = (cin + WT - 1) / WT;
  const int splits = static_cast<int>((npix + WSTEPS * WP - 1) / (WSTEPS * WP));
  dim3 grid((cout + WT - 1) / WT * c_tiles, kh * kw,
            static_cast<unsigned int>(batch) * splits);
  deform_bwd_weight_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      gout, x, offset, offset_bstride, mask, mask_bstride, grad_w, cin, height, width,
      cout, out_h, out_w, kh, kw, stride, pad, dil, groups, c_tiles, splits);
  return static_cast<int>(cudaGetLastError());
}
