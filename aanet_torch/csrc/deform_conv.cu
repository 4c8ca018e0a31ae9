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
// Bound: operations (the gcol contraction has the forward's FLOP count,
// plus the sampling work of every (channel, tap, pixel)). What costs is
// the scatter, 4 adds per (channel, tap, pixel), 36 per input element at
// stride 1, and latency: a float atomicAdd to device memory is a reduction
// in L2 at about 0.15 T adds/s on the H100; one to shared memory compiles
// to a compare-and-swap loop (ATOMS.CAST.SPIN) that runs at about 2.1 T
// adds/s when many warps hide its latency. Even so the window's adds are
// about 40 % of this kernel's time (1.7 of 4.2 ms at the 64-channel
// 96x192 shape at two blocks per SM; PERF.md section 6 has the
// measurements); issuing a quad's four compare-and-swaps together, by
// hand, was slower. Design:
// - A block owns a tile of TH = 4 or 8 rows x 16 columns of output pixels
//   of one batch entry and a chunk of CC = 8 input channels (or 16, with
//   4 rows) of one deformable group (the wrapper picks both per shape:
//   deform.backward_data_plan), and loops over the taps itself: the gout
//   tile [cout x pixels] is staged in shared memory once for all of them.
// - The input window that the tile's taps reach at zero offset, widened by
//   a halo of BD_HALO = 3 pixels on every side (plus the bilinear corner;
//   the wrapper's plan holds the same constant, and the kernel refuses a
//   plan whose shared-memory size is not this layout's), is
//   staged for the chunk with cp.async (zero-filled outside the image: the
//   op's zero padding), beside a grad_x accumulator of the same window. A
//   bilinear quad inside the window is read and scattered there, with
//   shared-memory atomicAdd; a quad that reaches beyond it (an offset
//   beyond the halo) reads x and adds to grad_x in device memory, in the
//   same pass. At the end the window is added to grad_x with one device
//   atomic per non-zero element inside the image: windows of neighbouring
//   tiles overlap by the halo.
// - One thread layout for the contraction and the sampling: a thread owns
//   PPT = TH / 2 neighbouring pixels of a row x CC / 8 channels, and a
//   warp's lanes span 8 pixel groups x 4 channel sets. The contraction
//   runs on the CUDA cores in float32 FMA (route (b): TF32's one product
//   fails the JAX side's Precision.HIGHEST, and the contraction is a fifth
//   or a sixth of this kernel's time). A thread owns 2 or 4 outputs,
//   too few for its own loads to feed its FMAs, so the four lanes of a
//   pixel group split the output channels: each sums all four channel
//   sets' channels (a float4 or two of the weight, laid out [tap, cout,
//   cin] by the wrapper) times its PPT pixels of gout over every fourth
//   output channel, 8 or 16 FMAs for two or three shared loads, then a
//   reduce-scatter of two shuffle steps leaves each lane its own set's
//   sums. gcol stays in registers: the thread samples its own pixels and
//   channels with it. (Chunks of 24 or 32 channels and 8 rows x 16
//   channels, with a thread's own contraction, were slower at every
//   shape timed.)
// - The offset and mask gradients are summed over the thread's channels in
//   registers, over the warp's four channel sets with shuffles and over the
//   block's two halves through shared memory, and written once per (group,
//   tap, pixel); added (grad_offset and grad_mask zeroed by the wrapper)
//   when the group's channels are split over several chunks.
// - Latency: the next tap's weights (cp.async into a second buffer) and
//   offsets (registers) are in flight during a tap, one __syncthreads per
//   tap, and the plan keeps a block at 75 KB where it can, so that three
//   blocks (24 warps) share an SM: the kernel is built for three blocks
//   (80 registers a thread, a few spilled) as well as for two (128), and
//   the plan names the build.
// gcol never reaches device memory.
// ---------------------------------------------------------------------------
namespace {

constexpr int BD_THREADS = 256;  // 8 warps: 2 halves x 4 pixel quarters
constexpr int BD_TILE_W = 16;    // output columns of a tile
constexpr int BD_HALO = 3;       // pixels of the window beyond the zero-offset footprint

// With 2 pixels a thread, the four lanes of a pixel group read 2-float
// runs of four gout rows 64 words apart at once: row co of the gout tile
// is rotated by 16 * (co % 4) words, so that the four runs fall in two
// bank halves.
template <int PPT>
__device__ __forceinline__ int bd_gout_col(int co, int p) {
  return PPT == 2 ? (p + 16 * (co & 3)) & 63 : p;
}

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool valid) {
  // 4 bytes from src, or zeros without reading it when !valid
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_f32x4(float* dst, const float* src) {
  // 16 bytes, both ends 16-byte aligned
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

template <int N>
__device__ __forceinline__ void load_run(float (&v)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    static_assert(N == 8, "runs of 2, 4 or 8 floats");
    const float4 q = reinterpret_cast<const float4*>(p)[0], r = reinterpret_cast<const float4*>(p)[1];
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    v[4] = r.x; v[5] = r.y; v[6] = r.z; v[7] = r.w;
  }
}

// CPT: channels per thread (chunk CC = 8 * CPT); PPT: pixels per thread
// (tile P = 32 * PPT pixels: TH = 2 * PPT rows of BD_TILE_W columns);
// the builds are 8 x 4, 8 x 8 and 16 x 4 (chunk x rows), CPT * PPT <= 4;
// BLOCKS: blocks per SM the registers are budgeted for (128 or 80 a
// thread for 2 or 3), as the plan's shared memory allows.
template <int CPT, int PPT, int BLOCKS>
__global__ void __launch_bounds__(BD_THREADS, BLOCKS)
deform_bwd_data_kernel(const float* __restrict__ gout, const float* __restrict__ x,
                       const float* __restrict__ offset, long long offset_bstride,
                       const float* __restrict__ mask, long long mask_bstride,
                       const float* __restrict__ wt, float* __restrict__ grad_x,
                       float* __restrict__ grad_offset, float* __restrict__ grad_mask,
                       int cin, int height, int width, int cout, int out_h, int out_w, int kh,
                       int kw, int stride, int pad, int dil, int groups, int win_h,
                       int win_w, int win_stride, int tiles_x, bool gout_vec, bool w_vec) {
  constexpr int CC = 8 * CPT;
  constexpr int P = 32 * PPT;
  constexpr int TH = P / BD_TILE_W;
  extern __shared__ float4 s_raw[];
  float* s_gout = reinterpret_cast<float*>(s_raw);  // [cout][P], rows rotated: bd_gout_col
  float* s_w = s_gout + cout * P;                     // [2][cout][CC]: taps k and k + 1
  float* s_x = s_w + 2 * cout * CC;                   // [CC][win_stride]
  float* s_gx = s_x + CC * win_stride;                // [CC][win_stride]
  float* s_part = s_gx + CC * win_stride;             // [tap parity][half][dy, dx, m][P]

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int ho0 = static_cast<int>(blockIdx.x / tiles_x) * TH;
  const int wo0 = static_cast<int>(blockIdx.x % tiles_x) * BD_TILE_W;
  const int cg = cin / groups;
  const int chunks = (cg + CC - 1) / CC;
  const int g = blockIdx.y / chunks;
  const int c0 = g * cg + static_cast<int>(blockIdx.y % chunks) * CC;
  const int nc = min(CC, (g + 1) * cg - c0);  // the group's last chunk may be short
  const long long b = blockIdx.z;
  const int taps = kh * kw;
  const int npix = out_h * out_w;
  const long long hw = static_cast<long long>(height) * width;
  const int win_y = ho0 * stride - pad - BD_HALO, win_x = wo0 * stride - pad - BD_HALO;
  const float* xb = x + (b * cin + c0) * hw;
  float* gxb = grad_x + (b * cin + c0) * hw;
  const float* gb = gout + b * cout * static_cast<long long>(npix);
  const float* ob = offset + b * offset_bstride;
  const float* mb = mask ? mask + b * mask_bstride : nullptr;
  float* gob = grad_offset + b * groups * taps * 2 * static_cast<long long>(npix);
  float* gmb = grad_mask ? grad_mask + b * groups * taps * static_cast<long long>(npix) : nullptr;

  // The thread's channels cset * CPT + j and pixels pl0 + i (one row).
  const int half = warp >> 2;
  const int cset = half * 4 + (lane >> 3);
  const int pl0 = ((warp & 3) * 8 + (lane & 7)) * PPT;
  const int ho = ho0 + pl0 / BD_TILE_W, wo1 = wo0 + pl0 % BD_TILE_W;

  // The chunk's weights of tap k into buffer k & 1.
  auto stage_w = [&](int k) {
    const float* wk = wt + static_cast<long long>(k) * cout * cin + c0;
    float* dst = s_w + (k & 1) * cout * CC;
    if (w_vec) {
      for (int e = t; e < cout * CC / 4; e += BD_THREADS) {
        const int co = e / (CC / 4), q = e % (CC / 4);
        cp_async_f32x4(dst + co * CC + 4 * q, wk + static_cast<long long>(co) * cin + 4 * q);
      }
    } else {
      for (int e = t; e < cout * CC; e += BD_THREADS) {
        const int co = e / CC, cl = e % CC;
        cp_async_f32(dst + e, cl < nc ? wk + static_cast<long long>(co) * cin + cl : wt, cl < nc);
      }
    }
  };
  // Offsets and mask of tap k at the thread's pixels (zeros off the map).
  auto load_tap = [&](int k, float (&dy)[PPT], float (&dx)[PPT], float (&mv)[PPT]) {
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      dy[i] = dx[i] = mv[i] = 0.f;
      if (ho < out_h && wo1 + i < out_w) {
        const int p = ho * out_w + wo1 + i;
        const long long oc = static_cast<long long>((g * taps + k) * 2) * npix + p;
        dy[i] = __ldg(ob + oc);
        dx[i] = __ldg(ob + oc + npix);
        mv[i] = mb ? __ldg(mb + static_cast<long long>(g * taps + k) * npix + p) : 1.f;
      }
    }
  };
  // Tap kk's offset and mask gradients of pixel t of the tile (t < P).
  auto write_tap = [&](int kk) {
    const int oh = ho0 + t / BD_TILE_W, ow = wo0 + t % BD_TILE_W;
    if (t >= P || oh >= out_h || ow >= out_w) return;
    const float* part = s_part + (kk & 1) * 6 * P + t;
    const float sdy = part[0] + part[3 * P], sdx = part[P] + part[4 * P];
    const float sm = part[2 * P] + part[5 * P];
    const int p = oh * out_w + ow;
    const long long oc = static_cast<long long>((g * taps + kk) * 2) * npix + p;
    const long long mc = static_cast<long long>(g * taps + kk) * npix + p;
    if (chunks == 1) {
      gob[oc] = sdy;
      gob[oc + npix] = sdx;
      if (gmb) gmb[mc] = sm;
    } else {
      atomicAdd(gob + oc, sdy);
      atomicAdd(gob + oc + npix, sdx);
      if (gmb) atomicAdd(gmb + mc, sm);
    }
  };

  // The x window of the chunk, the gout tile and tap 0's weights in flight;
  // the grad_x window starts at zero.
  for (int row = warp; row < CC * win_h; row += BD_THREADS / 32) {
    const int cl = row / win_h, r = row - cl * win_h, yy = win_y + r;
    const bool row_in = cl < nc && yy >= 0 && yy < height;
    for (int col = lane; col < win_w; col += 32) {
      const int xx = win_x + col;
      const bool in = row_in && xx >= 0 && xx < width;
      cp_async_f32(s_x + cl * win_stride + r * win_w + col, in ? xb + cl * hw + yy * width + xx : x,
                   in);
    }
  }
  for (int e = t; e < cout * P / 4; e += BD_THREADS) {
    const int co = e / (P / 4), q = e % (P / 4);
    const int r = q / (BD_TILE_W / 4), cq = (q % (BD_TILE_W / 4)) * 4;
    const int oh = ho0 + r, ow = wo0 + cq;
    float* dst = s_gout + co * P + bd_gout_col<PPT>(co, r * BD_TILE_W + cq);
    const float* src = gb + static_cast<long long>(co) * npix + oh * out_w + ow;
    if (gout_vec && oh < out_h && ow + 3 < out_w) {
      cp_async_f32x4(dst, src);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = oh < out_h && ow + i < out_w;
        cp_async_f32(dst + i, in ? src + i : gout, in);
      }
    }
  }
  stage_w(0);
  for (int e = t; e < CC * win_stride; e += BD_THREADS) s_gx[e] = 0.f;
  float dy[PPT], dx[PPT], mv[PPT];
  load_tap(0, dy, dx, mv);
  cp_async_wait_all();
  __syncthreads();

  for (int k = 0; k < taps; ++k) {
    if (k > 0) write_tap(k - 1);
    float ndy[PPT], ndx[PPT], nmv[PPT];
    const bool next = k + 1 < taps;
    if (next) {
      stage_w(k + 1);  // its buffer was last read by tap k - 1
      load_tap(k + 1, ndy, ndx, nmv);
    }

    // gcol of tap k for the thread's channels and pixels
    float acc[CPT][PPT];
    {
      // Each of the four lanes of a pixel group sums all four channel
      // sets' channels over every fourth output channel, then a
      // reduce-scatter over the four lanes leaves each its own set's sums.
      const int s = lane >> 3;  // = cset - 4 * half
      float part[4][CPT][PPT];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
#pragma unroll
          for (int i = 0; i < PPT; ++i) part[q][j][i] = 0.f;
      const float* wrow = s_w + (k & 1) * cout * CC + half * 4 * CPT;
      const float* grow = s_gout + bd_gout_col<PPT>(s, pl0);  // co % 4 == s
#pragma unroll 4
      for (int co = s; co < cout; co += 4) {
        float wv[4 * CPT], gv[PPT];
        load_run<4 * CPT>(wv, wrow + co * CC);
        load_run<PPT>(gv, grow + co * P);
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int j = 0; j < CPT; ++j)
#pragma unroll
            for (int i = 0; i < PPT; ++i)
              part[q][j][i] = fmaf(wv[q * CPT + j], gv[i], part[q][j][i]);
      }
      const bool hi1 = s & 2, hi0 = s & 1;
      float kept[2][CPT][PPT];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < CPT; ++j)
#pragma unroll
          for (int i = 0; i < PPT; ++i) {
            const float send = hi1 ? part[h][j][i] : part[2 + h][j][i];
            kept[h][j][i] = (hi1 ? part[2 + h][j][i] : part[h][j][i]) +
                            __shfl_xor_sync(0xffffffffu, send, 16);
          }
#pragma unroll
      for (int j = 0; j < CPT; ++j)
#pragma unroll
        for (int i = 0; i < PPT; ++i) {
          const float send = hi0 ? kept[0][j][i] : kept[1][j][i];
          acc[j][i] = (hi0 ? kept[1][j][i] : kept[0][j][i]) + __shfl_xor_sync(0xffffffffu, send, 8);
        }
    }

    // Sampling and scatter of the thread's pixels and channels.
    const int ki = k / kw, kj = k - ki * kw;
    float sums[3][PPT];  // d/dy, d/dx, d/dm summed over the thread's channels
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      sums[0][i] = sums[1][i] = sums[2][i] = 0.f;
      if (ho >= out_h || wo1 + i >= out_w) continue;
      float py = static_cast<float>(ho * stride - pad + ki * dil) + dy[i];
      float px = static_cast<float>((wo1 + i) * stride - pad + kj * dil) + dx[i];
      // as in the forward: outside (-1, H) x (-1, W) every corner is padding
      py = fminf(fmaxf(py, -2.f), static_cast<float>(height) + 1.f);
      px = fminf(fmaxf(px, -2.f), static_cast<float>(width) + 1.f);
      const float fy = floorf(py), fx = floorf(px);
      const int y0 = static_cast<int>(fy), x0 = static_cast<int>(fx);
      const float ly = py - fy, lx = px - fx;
      const float sy = ly == 0.f ? 0.5f : 1.f, sx = lx == 0.f ? 0.5f : 1.f;
      const float wy0 = 1.f - ly, wx0 = 1.f - lx, m = mv[i];
      const int ry = y0 - win_y, rx = x0 - win_x;
      if (ry >= 0 && ry + 1 < win_h && rx >= 0 && rx + 1 < win_w) {
        const int wi = ry * win_w + rx;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int cl = cset * CPT + j;
          const float* xs = s_x + cl * win_stride + wi;
          float* gs = s_gx + cl * win_stride + wi;
          const float v00 = xs[0], v01 = xs[1], v10 = xs[win_w], v11 = xs[win_w + 1];
          const float gc = acc[j][i], gm = gc * m;
          const float top = wx0 * v00 + lx * v01, bot = wx0 * v10 + lx * v11;
          sums[0][i] = fmaf(gm, sy * (bot - top), sums[0][i]);
          sums[1][i] = fmaf(gm, sx * (wy0 * (v01 - v00) + ly * (v11 - v10)), sums[1][i]);
          sums[2][i] = fmaf(gc, wy0 * top + ly * bot, sums[2][i]);
          atomicAdd(gs, gm * wy0 * wx0);
          atomicAdd(gs + 1, gm * wy0 * lx);
          atomicAdd(gs + win_w, gm * ly * wx0);
          atomicAdd(gs + win_w + 1, gm * ly * lx);
        }
      } else {
        // beyond the window: the corners inside the image, in device memory
        const bool y0_in = y0 >= 0 && y0 < height, y1_in = y0 + 1 >= 0 && y0 + 1 < height;
        const bool x0_in = x0 >= 0 && x0 < width, x1_in = x0 + 1 >= 0 && x0 + 1 < width;
        const long long i00 = static_cast<long long>(y0) * width + x0;
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          const int cl = cset * CPT + j;
          if (cl >= nc) break;
          const float* xc = xb + cl * hw + i00;
          float* gc_ptr = gxb + cl * hw + i00;
          const float v00 = y0_in && x0_in ? __ldg(xc) : 0.f;
          const float v01 = y0_in && x1_in ? __ldg(xc + 1) : 0.f;
          const float v10 = y1_in && x0_in ? __ldg(xc + width) : 0.f;
          const float v11 = y1_in && x1_in ? __ldg(xc + width + 1) : 0.f;
          const float gc = acc[j][i], gm = gc * m;
          const float top = wx0 * v00 + lx * v01, bot = wx0 * v10 + lx * v11;
          sums[0][i] = fmaf(gm, sy * (bot - top), sums[0][i]);
          sums[1][i] = fmaf(gm, sx * (wy0 * (v01 - v00) + ly * (v11 - v10)), sums[1][i]);
          sums[2][i] = fmaf(gc, wy0 * top + ly * bot, sums[2][i]);
          if (y0_in && x0_in) atomicAdd(gc_ptr, gm * wy0 * wx0);
          if (y0_in && x1_in) atomicAdd(gc_ptr + 1, gm * wy0 * lx);
          if (y1_in && x0_in) atomicAdd(gc_ptr + width, gm * ly * wx0);
          if (y1_in && x1_in) atomicAdd(gc_ptr + width + 1, gm * ly * lx);
        }
      }
    }
    // over the warp's four channel sets, then the block's halves apart
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        sums[q][i] += __shfl_xor_sync(0xffffffffu, sums[q][i], 8);
        sums[q][i] += __shfl_xor_sync(0xffffffffu, sums[q][i], 16);
      }
    if (lane < 8) {
      float* part = s_part + ((k & 1) * 2 + half) * 3 * P + pl0;
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int i = 0; i < PPT; ++i) part[q * P + i] = sums[q][i];
    }
    cp_async_wait_all();
    __syncthreads();
    if (next) {
#pragma unroll
      for (int i = 0; i < PPT; ++i) {
        dy[i] = ndy[i];
        dx[i] = ndx[i];
        mv[i] = nmv[i];
      }
    }
  }

  write_tap(taps - 1);
  // the grad_x window into grad_x: inside the image, non-zero entries only
  for (int row = warp; row < nc * win_h; row += BD_THREADS / 32) {
    const int cl = row / win_h, r = row - cl * win_h, yy = win_y + r;
    if (yy < 0 || yy >= height) continue;
    for (int col = lane; col < win_w; col += 32) {
      const int xx = win_x + col;
      const float v = s_gx[cl * win_stride + r * win_w + col];
      if (xx >= 0 && xx < width && v != 0.f) atomicAdd(gxb + cl * hw + yy * width + xx, v);
    }
  }
}

template <int CPT, int PPT, int BLOCKS>
cudaError_t launch_bwd_data_blocks(dim3 grid, int smem, cudaStream_t stream, const float* gout,
                                   const float* x, const float* offset, long long offset_bstride,
                                   const float* mask, long long mask_bstride, const float* wt,
                                   float* grad_x, float* grad_offset, float* grad_mask, int cin,
                                   int height, int width, int cout, int out_h, int out_w, int kh,
                                   int kw, int stride, int pad, int dil, int groups, int win_h,
                                   int win_w, int win_stride, int tiles_x, bool gout_vec,
                                   bool w_vec) {
  // words: the gout tile, two taps' weights, the x and grad_x windows, the
  // offset and mask sums of two taps and two halves
  constexpr int P = 32 * PPT;
  const long long words = static_cast<long long>(cout) * P +
                          2LL * cout * 8 * CPT + 2LL * 8 * CPT * win_stride + 12LL * P;
  if (words * 4 != smem) return cudaErrorInvalidValue;  // the wrapper's plan has another layout
  auto kernel = deform_bwd_data_kernel<CPT, PPT, BLOCKS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, BD_THREADS, smem, stream>>>(
      gout, x, offset, offset_bstride, mask, mask_bstride, wt, grad_x, grad_offset, grad_mask, cin,
      height, width, cout, out_h, out_w, kh, kw, stride, pad, dil, groups, win_h, win_w,
      win_stride, tiles_x, gout_vec, w_vec);
  return cudaGetLastError();
}

// The kernel built for `blocks` blocks per SM.
template <int CPT, int PPT, typename... Args>
cudaError_t launch_bwd_data(int blocks, Args... args) {
  switch (blocks) {
    case 2: return launch_bwd_data_blocks<CPT, PPT, 2>(args...);
    case 3: return launch_bwd_data_blocks<CPT, PPT, 3>(args...);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15) == 0; }

}  // namespace

// gout: [batch, cout, out_h, out_w]; x, offset, mask as for the forward;
// wt: the weight laid out [kh*kw, cout, cin] (wt[k, co, c] = weight[co, c,
// k / kw, k % kw]); grad_x: [batch, cin, height, width], zeroed by the caller
// (the kernel adds into it); grad_offset: [batch, groups*kh*kw*2, out_h,
// out_w] and grad_mask: [batch, groups*kh*kw, out_h, out_w] (or null), both
// contiguous: written in full when chunk >= cin / groups, else added into
// (zeroed by the caller). The plan (ops/deform.py backward_data_plan):
// chunk (input channels per block) and tile_h (output rows per tile, of 16
// columns): 8 and 4, 8 and 8, or 16 and 4; blocks (per SM, 2 or 3: the register
// budget of the kernel's build), and smem_bytes, the block's shared memory,
// which must be what this layout takes (else cudaErrorInvalidValue). All
// float32.
extern "C" int aanet_deform_conv_backward_data_f32(
    const float* gout, const float* x, const float* offset, long long offset_bstride,
    const float* mask, long long mask_bstride, const float* wt, float* grad_x,
    float* grad_offset, float* grad_mask, int batch, int cin, int height, int width,
    int cout, int out_h, int out_w, int kh, int kw, int stride, int pad, int dil,
    int groups, int chunk, int tile_h, int blocks, int smem_bytes, int device, void* stream) {
  cudaSetDevice(device);
  const bool built = (chunk == 8 && (tile_h == 4 || tile_h == 8)) || (chunk == 16 && tile_h == 4);
  if (groups < 1 || cin % groups != 0 || !built) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long npix = static_cast<long long>(out_h) * out_w;
  if (batch == 0 || npix == 0) return 0;
  const int win_h = (tile_h - 1) * stride + (kh - 1) * dil + 2 * BD_HALO + 2;
  const int win_w = (BD_TILE_W - 1) * stride + (kw - 1) * dil + 2 * BD_HALO + 2;
  // odd: the four channel sets of a warp at one window position hit four banks
  const int win_stride = win_h * win_w | 1;
  const int tiles_x = (out_w + BD_TILE_W - 1) / BD_TILE_W;
  const int tiles_y = (out_h + tile_h - 1) / tile_h;
  const int cg = cin / groups;
  dim3 grid(tiles_x * tiles_y, groups * ((cg + chunk - 1) / chunk), batch);
  // 16-byte copies: gout rows of a multiple of 4 floats; weight runs of
  // whole chunks starting at a multiple of 4 channels
  const bool gout_vec = out_w % 4 == 0 && aligned16(gout);
  const bool w_vec = cin % 4 == 0 && cg % chunk == 0 && cg % 4 == 0 && aligned16(wt);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AANET_BWD_DATA(CPT, PPT)                                                                 \
  launch_bwd_data<CPT, PPT>(blocks, grid, smem_bytes, s, gout, x, offset, offset_bstride, mask,  \
                            mask_bstride, wt, grad_x, grad_offset, grad_mask, cin, height,       \
                            width, cout, out_h, out_w, kh, kw, stride, pad, dil, groups, win_h,  \
                            win_w, win_stride, tiles_x, gout_vec, w_vec)
  const cudaError_t err = chunk == 16 ? AANET_BWD_DATA(2, 2)
                          : tile_h == 8 ? AANET_BWD_DATA(1, 4)
                                        : AANET_BWD_DATA(1, 2);
#undef AANET_BWD_DATA
  return static_cast<int>(err);
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
namespace {

constexpr int WP = 32;     // pixels per step
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
