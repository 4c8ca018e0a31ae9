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
// Each of the three has a float32 and a bfloat16 form (aanet_deform_conv_f32
// and aanet_deform_conv_bf16, and the same suffixes on the backward's entry
// points). The bf16 forms are kernels of their own, on the tensor cores
// (the last sections).
#include "common.cuh"

#include <math.h>

namespace {

constexpr int TILE_W = 16;  // output columns of a tile (forward and backward-data)
constexpr int HALO = 3;     // pixels of a staged window beyond the zero-offset footprint

// Shared by the forward and the weight gradient: a tile's channel-minor
// input window, its (tap, pixel) corner table and the sampling of one
// channel quad from both.

// The x windows of nq channel quads, staged as float32 (stage1): quad
// j's window at sx + 4 j win_size, position i of its channel cl at word 4 i
// + cl, so that a corner's four channels are one 16-byte load. xc: x at the
// first channel; nc: the channels that exist (the rest, and positions
// outside the image, are zero-filled); any: a valid address for the
// zero-fills.
template <typename T>
__device__ __forceinline__ void stage_window(float* sx, const T* xc, int nc, int nq,
                                             long long hw, int win_y, int win_x, int win_h,
                                             int win_w, int win_size, int height, int width,
                                             int warp, int nwarps, int lane, const T* any) {
  for (int j = 0; j < nq; ++j, sx += 4 * win_size, xc += 4 * hw, nc -= 4) {
    for (int r = warp; r < win_h; r += nwarps) {
      const int yy = win_y + r;
      const bool row_in = yy >= 0 && yy < height;
      const T* src = xc + static_cast<long long>(yy) * width;
      for (int e = lane; e < 4 * win_w; e += 32) {
        const int col = e >> 2, cl = e & 3, xx = win_x + col;
        const bool in = row_in && cl < nc && xx >= 0 && xx < width;
        stage1(sx + 4 * r * win_w + e, in ? src + cl * hw + xx : any, in);
      }
    }
  }
}

// The bilinear quad of output pixel (ho, wo), tap (ki, kj) at offset (dy,
// dx) with mask m: the window index of its top-left corner, or -1 - (its
// corner in the image, (y0 + 2) * (W + 4) + x0 + 2) for a quad beyond the
// window (win_y, win_x, win_h x win_w); the fractions and the mask.
__device__ __forceinline__ float4 corner(int ho, int wo, int ki, int kj, float dy, float dx,
                                         float m, int stride, int pad, int dil, int height,
                                         int width, int win_y, int win_x, int win_h, int win_w) {
  float py = static_cast<float>(ho * stride - pad + ki * dil) + dy;
  float px = static_cast<float>(wo * stride - pad + kj * dil) + dx;
  // Outside (-1, H) x (-1, W) every corner is padding; the clamp only keeps
  // the integer conversion in range.
  py = fminf(fmaxf(py, -2.f), static_cast<float>(height) + 1.f);
  px = fminf(fmaxf(px, -2.f), static_cast<float>(width) + 1.f);
  const float fy = floorf(py), fx = floorf(px);
  const int y0 = static_cast<int>(fy), x0 = static_cast<int>(fx);
  const int ry = y0 - win_y, rx = x0 - win_x;
  const int quad = ry >= 0 && ry + 1 < win_h && rx >= 0 && rx + 1 < win_w
                       ? ry * win_w + rx
                       : -1 - ((y0 + 2) * (width + 4) + x0 + 2);
  return make_float4(__int_as_float(quad), py - fy, px - fx, m);
}

// The (tap, pixel) table of deformable group g for the tile of P = tile_h x
// TILE_W output pixels at (ho0, wo0) (ob, mb: this batch entry's offsets
// and mask, mb null for a unit mask; the mask float32 or, in the forward's
// bf16 form, bfloat16): each entry's corner(), or a zero sample off the map.
template <typename T>
__device__ __forceinline__ void tabulate(float4* tab, const float* ob, const T* mb, int g,
                                         int taps, int P, int ho0, int wo0, int out_h,
                                         int out_w, int kw, int stride, int pad, int dil,
                                         int height, int width, int win_y, int win_x, int win_h,
                                         int win_w, int t, int nthreads) {
  const int npix = out_h * out_w;
#pragma unroll 2
  for (int e = t; e < taps * P; e += nthreads) {
    const int k = e / P, pl = e - k * P;
    const int ho = ho0 + pl / TILE_W, wo = wo0 + pl % TILE_W;
    float4 te = make_float4(0.f, 0.f, 0.f, 0.f);  // off the map: a zero sample
    if (ho < out_h && wo < out_w) {
      const int p = ho * out_w + wo, ki = k / kw, kj = k - ki * kw;
      const long long oc = static_cast<long long>((g * taps + k) * 2) * npix + p;
      const float dy = __ldg(ob + oc), dx = __ldg(ob + oc + npix);
      const float m = mb ? load_f32(mb + static_cast<long long>(g * taps + k) * npix + p) : 1.f;
      te = corner(ho, wo, ki, kj, dy, dx, m, stride, pad, dil, height, width, win_y, win_x, win_h,
                  win_w);
    }
    tab[e] = te;
  }
}

// sample_quad's quads beyond the window: the corners inside the image, in
// device memory (float32, or bfloat16 widened as it is loaded).
template <typename T>
__device__ __forceinline__ void sample_far(float* col, int rs, int quad, float w00, float w01,
                                           float w10, float w11, const T* xc, long long hw,
                                           int nc, int height, int width) {
  const int far = -1 - quad, y0 = far / (width + 4) - 2, x0 = far % (width + 4) - 2;
  const bool y0_in = y0 >= 0 && y0 < height, y1_in = y0 + 1 >= 0 && y0 + 1 < height;
  const bool x0_in = x0 >= 0 && x0 < width, x1_in = x0 + 1 >= 0 && x0 + 1 < width;
  xc += static_cast<long long>(y0) * width + x0;
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    float v = 0.f;
    if (cc < nc) {
      const float v00 = y0_in && x0_in ? load_f32(xc) : 0.f;
      const float v01 = y0_in && x1_in ? load_f32(xc + 1) : 0.f;
      const float v10 = y1_in && x0_in ? load_f32(xc + width) : 0.f;
      const float v11 = y1_in && x1_in ? load_f32(xc + width + 1) : 0.f;
      v = w00 * v00 + w01 * v01 + w10 * v10 + w11 * v11;
    }
    col[cc * rs] = v;
    xc += hw;
  }
}

// The same, out of line: rare, and inlined it made the weight gradient's
// step loop larger and slower (the forward is faster with it inline).
template <typename T>
__device__ __noinline__ void sample_far_call(float* col, int rs, int quad, float w00, float w01,
                                             float w10, float w11, const T* xc, long long hw,
                                             int nc, int height, int width) {
  sample_far(col, rs, quad, w00, w01, w10, w11, xc, hw, nc, height, width);
}

// Table entry te's modulated samples of one channel quad into col[0],
// col[rs], col[2 rs], col[3 rs]: from the quad's window xs (float4s), or,
// for a quad beyond it, from x in device memory (xc: x at the quad's first
// channel; nc: its channels that exist, the rest sample zero), inline or,
// with FAR_CALL, out of line.
template <bool FAR_CALL, typename T>
__device__ __forceinline__ void sample_quad(float* col, int rs, float4 te, const float4* xs,
                                            int win_w, const T* xc, long long hw, int nc,
                                            int height, int width) {
  const int quad = __float_as_int(te.x);
  const float ly = te.y, lx = te.z, m = te.w;
  const float w00 = (1.f - ly) * (1.f - lx) * m, w01 = (1.f - ly) * lx * m;
  const float w10 = ly * (1.f - lx) * m, w11 = ly * lx * m;
  if (quad >= 0) {  // channels past the end are zero-filled in the window
    xs += quad;
    const float4 v00 = xs[0], v01 = xs[1], v10 = xs[win_w], v11 = xs[win_w + 1];
    col[0] = w00 * v00.x + w01 * v01.x + w10 * v10.x + w11 * v11.x;
    col[rs] = w00 * v00.y + w01 * v01.y + w10 * v10.y + w11 * v11.y;
    col[2 * rs] = w00 * v00.z + w01 * v01.z + w10 * v10.z + w11 * v11.z;
    col[3 * rs] = w00 * v00.w + w01 * v01.w + w10 * v10.w + w11 * v11.w;
  } else if constexpr (FAR_CALL) {
    sample_far_call(col, rs, quad, w00, w01, w10, w11, xc, hw, nc, height, width);
  } else {
    sample_far(col, rs, quad, w00, w01, w10, w11, xc, hw, nc, height, width);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Forward.
//
// Bound: operations. At the main path's largest shape (64 -> 64 channels
// at 16 x 96x192) the contraction is 21.7 GFLOP against 215 MB of inputs
// and output. The contraction runs on the CUDA cores in float32 FMA
// (route (b): the JAX side pins Precision.HIGHEST, which TF32's one
// product fails). What the first, simpler kernel spent beyond it
// (ablations: PERF.md section 6) was its skeleton -- a corner table
// rebuilt per tap, a weight read 36 bytes apart per tap and 16-channel
// step, two syncs per step with nothing in flight -- then its gathers
// from device memory, then a contraction that read 8 shared words per 16
// FMAs. Design:
// - A block owns a tile of tile_h rows x TILE_W columns of output pixels
//   of one batch entry, and co_tile output channels: all of them up to
//   128 (the wrapper's plan: deform.forward_plan), so each sampled column
//   serves every output channel. Where no multiple of 8 divides cout, the
//   tiles are padded: the wrapper's weight has zero channels up to whole
//   tiles, and the last tile's channels at or above cout are not stored.
// - It walks chunks of FWD_CHUNK = 4 input channels of one group, with
//   all taps inside a chunk. The next chunk's input window (the tile's
//   taps' footprint at zero offset, widened by HALO pixels and the
//   bilinear corner) and weights ([tap][channel][co_tile], laid out [tap,
//   cin, cout] by the wrapper: 16-byte runs) are copied with cp.async,
//   zero-filled outside the image, into the second of two buffers while
//   the block samples and contracts the current one. The window is
//   channel-minor: a corner's four channels are one 16-byte load.
// - Per (tap, pixel) of a group, the window index of the bilinear quad
//   and its fractions and mask are tabulated once per block (a quad
//   beyond the window keeps its corner in the image instead: its corners
//   read device memory, exactly). Each chunk's modulated columns [tap x
//   FWD_CHUNK][pixels] are sampled from the window into shared memory,
//   two table entries in flight per thread.
// - Each thread accumulates an 8 x 8 register tile (8 pixels x 8 output
//   channels, each as two 16-byte runs half a tile apart; a warp spans 8
//   pixel quads by 4 channel quads where the tile allows it, so that a
//   row's four loads are one wavefront each): 64 FMAs for 16 shared
//   words. Where a tile's threads are fewer than 128, ksplit groups of
//   them take alternate rows of the chunk and sum through shared memory
//   at the end.
// - Where the tiles are short of two waves of resident blocks, the plan
//   splits the chunks over `splits` blocks (whole groups each, a few
//   chunks at least). Each split stores its float32 sums in a slab of its
//   own ([splits, B, cout, Ho, Wo]; split 0 adds the bias), and
//   slab_sum_kernel adds the slabs in a fixed order into the output: no
//   atomics, so every launch gives the same bits, split or not.
// Designs that lost on the card (PERF.md section 6): chunks of 8 (less
// occupancy), and the next chunk sampled while this one is contracted
// from a second column tile (more shared memory, fewer resident blocks).
// The columns (490 MB at the largest shape if written out) never reach
// device memory.
//
// This kernel serves float32 values (T = TO = float). The bf16 forward is
// deform_fwd_mma_kernel (the last section): its products run on the tensor
// cores, with its own plan.
// ---------------------------------------------------------------------------
namespace {

// The launch bounds: the largest block, and the blocks of it an SM holds
// (FWD_MAX_THREADS, FWD_MIN_BLOCKS and FWD_REGISTERS in ops/deform.py).
constexpr int FWD_MAX_THREADS = 256;
constexpr int FWD_MIN_BLOCKS = 2;
constexpr int FWD_CHUNK = 4;  // input channels of a chunk: one float4 per window position

// Words of the forward's shared memory: the (tap, pixel) table (a float4
// each), two x windows, the column tile and two chunks' weights; the
// ksplit - 1 partial tiles of the final sum reuse the same space.
__host__ __device__ inline long long fwd_smem_words(int taps, int pixels, int co_tile,
                                                    int win_size, int ksplit) {
  const long long main = 4LL * taps * pixels + 2LL * FWD_CHUNK * win_size +
                         static_cast<long long>(taps) * FWD_CHUNK * pixels +
                         2LL * taps * FWD_CHUNK * co_tile;
  const long long partial = static_cast<long long>(ksplit - 1) * co_tile * pixels;
  return main > partial ? main : partial;
}

template <typename T, typename TO>
__global__ void __launch_bounds__(FWD_MAX_THREADS, FWD_MIN_BLOCKS)
deform_fwd_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                  long long offset_bstride, const T* __restrict__ mask,
                  long long mask_bstride, const T* __restrict__ wt,
                  const float* __restrict__ bias, TO* __restrict__ out, int cin, int height,
                  int width, int cout, int out_h, int out_w, int kh, int kw, int stride, int pad,
                  int dil, int groups, int tile_h, int co_tile, int wt_stride, int ksplit,
                  int splits, long long slab, int win_h, int win_w, int win_size, int tiles_x,
                  bool out_vec) {
  extern __shared__ float4 s_raw[];
  const int P = tile_h * TILE_W;
  const int taps = kh * kw;
  const int rows = taps * FWD_CHUNK;                        // contraction rows of a chunk
  float4* s_tab = s_raw;                                    // [taps][P]: (quad, ly, lx, m)
  float* s_x = reinterpret_cast<float*>(s_raw + taps * P);  // [2][win_h * win_w][FWD_CHUNK]
  float* s_col = s_x + 2 * FWD_CHUNK * win_size;          // [rows][P]
  float* s_w = s_col + rows * P;                            // [2][rows][co_tile]

  const int t = threadIdx.x, nthreads = blockDim.x;
  const int warp = t >> 5, nwarps = nthreads >> 5;
  // The thread's 8 x 8 tile: pixel quads px_t and output-channel quads
  // co_t (see the contraction). A warp spans 32 / co_lanes pixel quads by
  // co_lanes channel quads, 4 where the tile allows it: its loads of a row
  // then cover 128 bytes of columns and 64 of weights, one wavefront each.
  const int npx = P / 8, nco = co_tile / 8;
  int co_lanes = 4;
  while (co_lanes > 1 && (nco % co_lanes != 0 || npx % (32 / co_lanes) != 0)) co_lanes /= 2;
  int px_t, co_t, kg;
  if (npx % (32 / co_lanes) == 0 && nco % co_lanes == 0) {
    const int pl_lanes = 32 / co_lanes, lane = t & 31;
    const int px_hi = warp % (npx / pl_lanes), rest = warp / (npx / pl_lanes);
    px_t = lane % pl_lanes + pl_lanes * px_hi;
    co_t = lane / pl_lanes + co_lanes * (rest % (nco / co_lanes));
    kg = rest / (nco / co_lanes);
  } else {
    px_t = t % npx;
    co_t = (t / npx) % nco;
    kg = t / (npx * nco);
  }
  const int ho0 = static_cast<int>(blockIdx.x / tiles_x) * tile_h;
  const int wo0 = static_cast<int>(blockIdx.x % tiles_x) * TILE_W;
  const int co0 = static_cast<int>(blockIdx.y / splits) * co_tile;
  const int split = static_cast<int>(blockIdx.y % splits);
  const long long b = blockIdx.z;
  const int cg = cin / groups;
  const int per_group = (cg + FWD_CHUNK - 1) / FWD_CHUNK;
  const int nchunks = groups * per_group;
  const int q_beg = split * nchunks / splits, q_end = (split + 1) * nchunks / splits;
  const int npix = out_h * out_w;
  const long long hw = static_cast<long long>(height) * width;
  const int win_y = ho0 * stride - pad - HALO, win_x = wo0 * stride - pad - HALO;
  const T* xb = x + b * cin * hw;
  const float* ob = offset + b * offset_bstride;
  const T* mb = mask ? mask + b * mask_bstride : nullptr;

  auto chunk_c0 = [&](int q) { return (q / per_group) * cg + (q % per_group) * FWD_CHUNK; };
  auto chunk_nc = [&](int q) { return min(FWD_CHUNK, (q / per_group + 1) * cg - chunk_c0(q)); };

  // The x window of chunk q into window buffer q & 1.
  auto stage_x = [&](int q) {
    stage_window(s_x + (q & 1) * FWD_CHUNK * win_size, xb + chunk_c0(q) * hw, chunk_nc(q), 1, hw,
                 win_y, win_x, win_h, win_w, win_size, height, width, warp, nwarps, t & 31, x);
  };
  // The weights of chunk q, [tap][channel][co_tile], into weight buffer q & 1
  // (rows of wt_stride >= the tiles' channels: the last tile's channels at
  // or above cout are zero in wt).
  auto stage_w = [&](int q) {
    const int c0 = chunk_c0(q), nc = chunk_nc(q);
    float* sw = s_w + (q & 1) * rows * co_tile;
    const int quads = co_tile / 4;
    for (int e = t; e < rows * quads; e += nthreads) {
      const int r = e / quads, q4 = e - r * quads;
      const int k = r / FWD_CHUNK, cc = r - k * FWD_CHUNK;
      float* dst = sw + r * co_tile + 4 * q4;
      const T* src = wt + (static_cast<long long>(k) * cin + c0 + cc) * wt_stride + co0 + 4 * q4;
      if (cc < nc && is_bf16<T>) {
        *reinterpret_cast<float4*>(dst) = load4_f32(src);
      } else if (cc < nc) {
        cp_async_f32x4(dst, reinterpret_cast<const float*>(src));
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };

  auto tabulate_group = [&](int g) {
    tabulate(s_tab, ob, mb, g, taps, P, ho0, wo0, out_h, out_w, kw, stride, pad, dil, height,
             width, win_y, win_x, win_h, win_w, t, nthreads);
  };
  // Table entry e's modulated samples of chunk q's FWD_CHUNK channels
  // (window buffer q & 1) into the column tile.
  auto sample = [&](int e, const float4* xs, const T* xq, int ncq) {
    const int k = e / P, pl = e - k * P;
    sample_quad<false>(s_col + k * FWD_CHUNK * P + pl, P, s_tab[e], xs, win_w, xq, hw, ncq,
                       height, width);
  };

  // The thread's pixels 4 px_t + {0..3} and P/2 + 4 px_t + {0..3}, and
  // output channels 4 co_t + {0..3} and co_tile/2 + 4 co_t + {0..3}.
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  auto contract = [&](int r, const float* a_ptr, const float* w_ptr) {
    const float4 a0 = *reinterpret_cast<const float4*>(a_ptr + r * P);
    const float4 a1 = *reinterpret_cast<const float4*>(a_ptr + r * P + P / 2);
    const float4 b0 = *reinterpret_cast<const float4*>(w_ptr + r * co_tile);
    const float4 b1 = *reinterpret_cast<const float4*>(w_ptr + r * co_tile + co_tile / 2);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float wv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
  };

  // Chunk q + 1's window and weights are in flight while chunk q is
  // sampled and contracted.
  stage_x(q_beg);
  stage_w(q_beg);
  tabulate_group(q_beg / per_group);  // while the first chunk is in flight
  for (int q = q_beg; q < q_end; ++q) {
    cp_async_wait_all();
    __syncthreads();  // chunk q has landed; chunk q - 1 is contracted
    if (q + 1 < q_end) {
      stage_x(q + 1);
      stage_w(q + 1);
    }
    const int g = q / per_group;
    if (q > q_beg && g != (q - 1) / per_group) {
      tabulate_group(g);
      __syncthreads();
    }
    {
      const float4* xs = reinterpret_cast<const float4*>(s_x + (q & 1) * FWD_CHUNK * win_size);
      const T* xq = xb + chunk_c0(q) * hw;
      const int ncq = chunk_nc(q);
#pragma unroll 2
      for (int e = t; e < taps * P; e += nthreads) sample(e, xs, xq, ncq);
    }
    __syncthreads();
    const float* a_ptr = s_col + 4 * px_t;
    const float* w_ptr = s_w + (q & 1) * rows * co_tile + 4 * co_t;
#pragma unroll 1  // unrolled, the loop was 3 % slower at every step shape
    for (int r = kg; r < rows; r += ksplit) contract(r, a_ptr, w_ptr);
  }

  // The ksplit groups' partial tiles: groups 1.. through shared memory.
  if (ksplit > 1) {
    __syncthreads();
    float* s_part = reinterpret_cast<float*>(s_raw);  // [ksplit - 1][co_tile][P]
    if (kg > 0) {
      float* dst = s_part + (kg - 1) * co_tile * P;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = 4 * co_t + (j & 3) + (j >> 2) * (co_tile / 2);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float4*>(dst + cl * P + 4 * px_t + h * (P / 2)) =
              make_float4(acc[4 * h][j], acc[4 * h + 1][j], acc[4 * h + 2][j], acc[4 * h + 3][j]);
      }
    }
    __syncthreads();
    if (kg > 0) return;
    for (int s = 0; s < ksplit - 1; ++s) {
      const float* src = s_part + s * co_tile * P;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int cl = 4 * co_t + (j & 3) + (j >> 2) * (co_tile / 2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v = *reinterpret_cast<const float4*>(src + cl * P + 4 * px_t + h * (P / 2));
          acc[4 * h][j] += v.x;
          acc[4 * h + 1][j] += v.y;
          acc[4 * h + 2][j] += v.z;
          acc[4 * h + 3][j] += v.w;
        }
      }
    }
  }

  // a split of a slab plan stores its partial sums in its own slab
  TO* outb = out + (slab ? split * slab : 0) + b * cout * static_cast<long long>(npix);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int co = co0 + 4 * co_t + (j & 3) + (j >> 2) * (co_tile / 2);
    if (co >= cout) continue;  // an idle channel of the last tile
    const float bv = bias && split == 0 ? bias[co] : 0.f;
    TO* oc = outb + static_cast<long long>(co) * npix;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pl = 4 * px_t + h * (P / 2);  // four pixels of one row
      const int ho = ho0 + pl / TILE_W, wo = wo0 + pl % TILE_W;
      if (ho >= out_h) continue;
      TO* o = oc + ho * out_w + wo;
      const float v[4] = {acc[4 * h][j] + bv, acc[4 * h + 1][j] + bv, acc[4 * h + 2][j] + bv,
                          acc[4 * h + 3][j] + bv};
      if (out_vec && wo + 3 < out_w) {
        store4_f32(o, make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (wo + i < out_w) store_f32(o + i, v[i]);
      }
    }
  }
}

// out[e] = the sum of the slabs' entries e in a fixed order, rounded once
// where TO is bf16: thread (x, y) of a block sums slabs y, y + blockDim.y,
// ... of entry 32 b + x in slab order, then row 0 adds the blockDim.y
// partial sums in row order. The epilogue of the weight gradient, of a
// split forward, and of the backward-data kernel's offset and mask slabs:
// bit-reproducible, where atomic adds are not.
template <typename TO>
__global__ void __launch_bounds__(1024)
slab_sum_kernel(const float* __restrict__ ws, TO* __restrict__ out, int slabs, long long n) {
  __shared__ float part[32][33];
  const long long e = static_cast<long long>(blockIdx.x) * 32 + threadIdx.x;
  float s = 0.f;
  if (e < n) {
#pragma unroll 4
    for (int i = threadIdx.y; i < slabs; i += blockDim.y) s += __ldg(ws + i * n + e);
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y > 0 || e >= n) return;
  float total = part[0][threadIdx.x];
  for (int y = 1; y < blockDim.y; ++y) total += part[y][threadIdx.x];
  store_f32(out + e, total);
}

// The sum of `slabs` slabs of n floats into out (slab_sum_kernel).
template <typename TO>
int sum_slabs(const float* ws, TO* out, int slabs, long long n, cudaStream_t s) {
  if (n == 0) return 0;
  // rows of a sum block: enough threads for the card, at most one a slab
  int rows = 1;
  while (rows < 32 && rows < slabs && n * rows < (1 << 18)) rows *= 2;
  slab_sum_kernel<<<aanet_blocks(n, 32), dim3(32, rows), 0, s>>>(ws, out, slabs, n);
  return static_cast<int>(cudaGetLastError());
}

// The forward of values T into an output TO (the checks and the launch of
// both entry points).
template <typename T, typename TO>
int launch_deform_fwd(const T* x, const float* offset, long long offset_bstride, const T* mask,
                      long long mask_bstride, const T* wt, const float* bias, TO* out,
                      int batch, int cin, int height, int width, int cout, int out_h, int out_w,
                      int kh, int kw, int stride, int pad, int dil, int groups, int tile_h,
                      int co_tile, int wt_stride, int ksplit, int splits, long long slab,
                      int smem_bytes, cudaStream_t stream) {
  const int threads = (co_tile / 8) * (tile_h * TILE_W / 8) * ksplit;
  if (groups < 1 || cin % groups != 0 || tile_h < 2 || tile_h % 2 != 0 || co_tile < 8 ||
      co_tile % 8 != 0 || co_tile > 128 || ksplit < 1 || splits < 1 ||
      threads % 32 != 0 || threads > FWD_MAX_THREADS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (splits > 1 && slab == 0) return static_cast<int>(cudaErrorInvalidValue);  // a split needs its slab
  const int co_tiles = (cout + co_tile - 1) / co_tile;
  if (wt_stride % 4 != 0 || wt_stride < co_tiles * co_tile) {
    return static_cast<int>(cudaErrorInvalidValue);  // the weight's rows are not the tiles'
  }
  const int nchunks = groups * ((cin / groups + FWD_CHUNK - 1) / FWD_CHUNK);
  if (splits > nchunks) return static_cast<int>(cudaErrorInvalidValue);  // a block without work
  if (!aligned16(wt) || !aligned16(out)) return static_cast<int>(cudaErrorInvalidValue);
  const long long npix = static_cast<long long>(out_h) * out_w;
  if (batch == 0 || npix == 0 || cout == 0) return 0;
  const int win_h = (tile_h - 1) * stride + (kh - 1) * dil + 2 * HALO + 2;
  const int win_w = (TILE_W - 1) * stride + (kw - 1) * dil + 2 * HALO + 2;
  const int win_size = win_h * win_w;
  const int pixels = tile_h * TILE_W;
  if (fwd_smem_words(kh * kw, pixels, co_tile, win_size, ksplit) * 4 != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);  // the wrapper's plan has another layout
  }
  auto kernel = deform_fwd_kernel<T, TO>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tiles_x = (out_w + TILE_W - 1) / TILE_W;
  const int tiles_y = (out_h + tile_h - 1) / tile_h;
  dim3 grid(tiles_x * tiles_y, co_tiles * splits, batch);
  const bool out_vec = out_w % 4 == 0;
  kernel<<<grid, threads, smem_bytes, stream>>>(
      x, offset, offset_bstride, mask, mask_bstride, wt, bias, out, cin, height, width, cout,
      out_h, out_w, kh, kw, stride, pad, dil, groups, tile_h, co_tile, wt_stride, ksplit, splits,
      slab, win_h, win_w, win_size, tiles_x, out_vec);
  return static_cast<int>(cudaGetLastError());
}

// Both forms' entry: where splits > 1 each split stores its partial sums
// in its slab of sums, and sum_slabs adds the slabs into out in a fixed
// order (rounding once where T is bf16).
template <typename T>
int deform_fwd_entry(const T* x, const float* offset, long long offset_bstride, const T* mask,
                     long long mask_bstride, const T* wt, const float* bias, T* out, float* sums,
                     int batch, int cin, int height, int width, int cout, int out_h, int out_w,
                     int kh, int kw, int stride, int pad, int dil, int groups, int tile_h,
                     int co_tile, int wt_stride, int ksplit, int splits, int smem_bytes,
                     int device, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits <= 1) {
    return launch_deform_fwd(x, offset, offset_bstride, mask, mask_bstride, wt, bias, out, batch,
                             cin, height, width, cout, out_h, out_w, kh, kw, stride, pad, dil,
                             groups, tile_h, co_tile, wt_stride, ksplit, splits, 0LL, smem_bytes,
                             st);
  }
  if (sums == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long n = static_cast<long long>(batch) * cout * out_h * out_w;
  const int err = launch_deform_fwd(x, offset, offset_bstride, mask, mask_bstride, wt, bias, sums,
                                    batch, cin, height, width, cout, out_h, out_w, kh, kw, stride,
                                    pad, dil, groups, tile_h, co_tile, wt_stride, ksplit, splits,
                                    n, smem_bytes, st);
  if (err != 0) return err;
  return sum_slabs(sums, out, splits, n, st);
}

}  // namespace

// x: [batch, cin, height, width]; offset: [batch, groups*kh*kw*2, out_h,
// out_w] with batch stride offset_bstride (elements), the rest contiguous;
// mask: [batch, groups*kh*kw, out_h, out_w] likewise, or null; wt: the
// weight laid out [kh*kw, cin, cout] (wt[k, c, co] = weight[co, c, k / kw,
// k % kw], rows of wt_stride channels: the output channels padded with
// zeros to a whole number of tiles); bias: [cout] or null; out: [batch,
// cout, out_h, out_w]; sums: where splits > 1, [splits, batch, cout,
// out_h, out_w], every entry written (no zeroing), else unused (may be
// null); wt, out and sums 16-byte aligned. All float32; groups divides
// cin. The plan (ops/deform.py forward_plan): tile_h (output rows of a
// tile of 16 columns, even), co_tile (output channels of a block: a
// multiple of 8, at most 128; the grid takes ceil(cout / co_tile) tiles,
// and the last one's channels at or above cout are idle), wt_stride (a
// multiple of 4, at least the tiles' channels), ksplit (thread groups that
// split a chunk's rows), splits (blocks that split a tile's chunks, at
// most their number), and smem_bytes, the block's shared memory, which
// must be what this layout takes. Anything else is cudaErrorInvalidValue.
extern "C" int aanet_deform_conv_f32(
    const float* x, const float* offset, long long offset_bstride, const float* mask,
    long long mask_bstride, const float* wt, const float* bias, float* out, float* sums,
    int batch, int cin, int height, int width, int cout, int out_h, int out_w, int kh, int kw,
    int stride, int pad, int dil, int groups, int tile_h, int co_tile, int wt_stride, int ksplit,
    int splits, int smem_bytes, int device, void* stream) {
  return deform_fwd_entry(x, offset, offset_bstride, mask, mask_bstride, wt, bias, out, sums,
                          batch, cin, height, width, cout, out_h, out_w, kh, kw, stride, pad,
                          dil, groups, tile_h, co_tile, wt_stride, ksplit, splits, smem_bytes,
                          device, stream);
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
// stride 1, and latency.
//
// Determinism: grad_x is summed in 64-bit fixed point. Integer addition is
// associative, so the order in which blocks and threads add no longer
// matters, and every launch gives the same bits (float atomics add in an
// order that changes from launch to launch). The rule:
// - A first kernel (fixed_bound_kernel) takes, over the finite values,
//   G = max |gout|, W = max over (c, k) of sum_co |weight[co, c, k]| and
//   M = max |mask| (1 without a mask). Every finite scattered term
//   gcol * m * w_corner (w_corner <= 1) is at most T = G * W * M in size.
// - With T < 2^E and `bits` (below), the scale is 2^e, e = bits - 1 - E,
//   clamped to [-126, 127] (a float; a finite term is below 2^128, so the
//   lower clamp cannot overflow, and the upper one only coarsens terms
//   below 2^-88 of the bound). Each term v enters as q = rint(v * 2^e), an
//   integer below 2^bits in size. The exponent is computed on the device,
//   by every block from the same three maxima: no host synchronisation.
// - bits = min(62 - 2 L, 62 - ceil(log2(taps * Ho * Wo))), L = ceil(log2(
//   taps * P)) for a tile of P pixels. An element receives at most taps *
//   Ho * Wo terms, so its int64 sum stays below 2^62; a window element at
//   most taps * P = 2^L from one block (below).
// - The window's adds are shared-memory atomics, and on the H100 a 64-bit
//   shared atomicAdd compiles to a compare-and-swap loop (ATOMS.CAST.SPIN.64,
//   as a float one does: ATOMS.CAST.SPIN), a 32-bit integer one to a native
//   ATOMS.ADD (cuobjdump -sass). So the window holds each element as two
//   32-bit words: q = hi * 2^s + lo with lo = q mod 2^s in [0, 2^s), s =
//   32 - L, added to an unsigned word, and hi = floor(q / 2^s) to a signed
//   one. The lo words sum below 2^L * 2^s = 2^32, the hi words below 2^(L +
//   bits - s) <= 2^30 in size: neither wraps. The flush adds hi * 2^s + lo
//   to the int64 scratch exactly; far corners add q there directly
//   (REDG.E.ADD.64, native).
// - fixed_to_value_kernel converts: a float32 grad_x is the integer sum
//   rounded to float once (I2F.S64) and scaled by 2^-e exactly; a bf16 one
//   rounded to bf16 once (I2F.BF16.S64) and scaled likewise (results in
//   the subnormal range round a second time).
// - Error: each term rounds by at most 2^-(e + 1) <= 2^(1 - bits) T; an
//   element reached by n terms is within n 2^(1 - bits) T of the exact sum
//   of its float terms before its one rounding to the output's type. At
//   the train steps' shapes bits is 40 or 42: 2^-39 T a term (float32's own
//   rounding of one add is 2^-24 of the running sum).
// - A non-finite term (gcol * m is NaN or infinite: a non-finite gout,
//   weight or mask, or an overflowed gcol) adds no integer. It sets the
//   element's two bits in a flag array instead (x_flags, 16 elements a
//   word: 1 for +inf, 2 for -inf, both for NaN), and the element reads
//   +inf, -inf or NaN, as it would under float adds.
//
// Design:
// - A block owns a tile of TH = 4 or 8 rows x 16 columns of output pixels
//   of one batch entry and a chunk of CC = 8 input channels (or 16, with
//   4 rows) of one deformable group (the wrapper picks both per shape:
//   deform.backward_data_plan), and loops over the taps itself: the gout
//   tile [cout x pixels] is staged in shared memory once for all of them.
// - The input window that the tile's taps reach at zero offset, widened by
//   a halo of HALO = 3 pixels on every side (plus the bilinear corner;
//   the wrapper's plan holds the same constant, and the kernel refuses a
//   plan whose shared-memory size is not this layout's), is
//   staged for the chunk with cp.async (zero-filled outside the image: the
//   op's zero padding), beside a fixed-point grad_x accumulator of the
//   same window (two 32-bit words an element, above). A bilinear quad
//   inside the window is read and scattered there with integer
//   shared-memory atomics; a quad that reaches beyond it (an offset beyond
//   the halo) reads x and adds to the int64 scratch in device memory, in
//   the same pass. At the end the window is added to the scratch with one
//   device atomic per non-zero element inside the image: windows of
//   neighbouring tiles overlap by the halo.
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
//   block's two halves through shared memory, in a fixed order, and
//   written once per (group, tap, pixel) and chunk: where the group's
//   channels span several chunks, each chunk writes a slab of its own
//   ([chunks, ...]) and slab_sum_kernel adds the slabs in a fixed order.
// - Latency: the next tap's weights (cp.async into a second buffer) and
//   offsets (registers) are in flight during a tap, one __syncthreads per
//   tap, and the plan keeps a block at 75 KB where it can, so that three
//   blocks (24 warps) share an SM: the kernel is built for three blocks
//   (80 registers a thread) as well as for two (128), and the plan names
//   the build.
// gcol never reaches device memory.
//
// This kernel serves float32 values (T = float). The bf16 gradient is
// deform_bwd_data_mma_kernel (the last section): the same fixed-point
// scatter, its column gradient on the tensor cores, with its own plan.
// ---------------------------------------------------------------------------
namespace {

constexpr int BD_THREADS = 256;  // 8 warps: 2 halves x 4 pixel quarters

// The least L with 2^L >= n (n >= 1).
inline int ceil_log2(long long n) {
  int l = 0;
  while ((1LL << l) < n) ++l;
  return l;
}

// The fixed-point scale's exponent e (above) from the three maxima that
// fixed_bound_kernel wrote (bound[2] unused without a mask).
__device__ __forceinline__ int fixed_exponent(const double* bound, bool has_mask, int bits) {
  const double t = bound[0] * bound[1] * (has_mask ? bound[2] : 1.0);
  int ex;
  frexp(t, &ex);  // t < 2^ex (ex = 0 for t = 0)
  return max(-126, min(127, bits - 1 - ex));
}

// The maxima over the finite values of |gout|, of the weight's column sums
// sum_co |wt[k, co, c]| (wt laid out [taps, cout, cin]) and of |mask|
// (mask: [batch, mask_n] with batch stride mask_bstride, or null) into
// bound[0..2] (zeroed by the caller; non-negative doubles order as their
// bits, so atomicMax on the bits is exact and order-free).
template <typename T>
__global__ void __launch_bounds__(256)
fixed_bound_kernel(const T* __restrict__ gout, long long n_gout, const float* __restrict__ wt,
                   int taps, int cout, int cin, const T* __restrict__ mask,
                   long long mask_bstride, long long mask_n, int batch, double* bound) {
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  double v[3] = {0.0, 0.0, 0.0};
  for (long long i = t0; i < n_gout; i += step) {
    const float a = fabsf(load_f32(gout + i));
    if (isfinite(a)) v[0] = fmax(v[0], static_cast<double>(a));
  }
  for (long long i = t0; i < static_cast<long long>(taps) * cin; i += step) {
    const float* col = wt + (i / cin) * cout * static_cast<long long>(cin) + i % cin;
    double s = 0.0;
    for (int co = 0; co < cout; ++co) {
      const float a = fabsf(__ldg(col + static_cast<long long>(co) * cin));
      if (isfinite(a)) s += a;
    }
    v[1] = fmax(v[1], s);
  }
  if (mask != nullptr) {
    for (long long i = t0; i < batch * mask_n; i += step) {
      const float a = fabsf(load_f32(mask + (i / mask_n) * mask_bstride + i % mask_n));
      if (isfinite(a)) v[2] = fmax(v[2], static_cast<double>(a));
    }
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[q] = fmax(v[q], __shfl_xor_sync(0xffffffffu, v[q], o));
    if ((threadIdx.x & 31) == 0 && v[q] > 0.0) {
      atomicMax(reinterpret_cast<unsigned long long*>(bound + q),
                static_cast<unsigned long long>(__double_as_longlong(v[q])));
    }
  }
}

// One scaled term t (t = v * 2^e) into a window element: its integer's low
// `split` bits into the unsigned word lo, the rest into the signed word hi
// (native 32-bit shared atomics; a zero part adds nothing).
__device__ __forceinline__ void window_add(unsigned* lo, int* hi, float t, int split,
                                           unsigned lo_mask) {
  const long long q = __float2ll_rn(t);
  const unsigned l = static_cast<unsigned>(q) & lo_mask;
  const int h = static_cast<int>(q >> split);
  if (l) atomicAdd(lo, l);
  if (h) atomicAdd(hi, h);
}

// One scaled term into the int64 scratch (a far corner).
__device__ __forceinline__ void scratch_add(long long* acc, float t) {
  const long long q = __float2ll_rn(t);
  if (q) atomicAdd(reinterpret_cast<unsigned long long*>(acc), static_cast<unsigned long long>(q));
}

// A non-finite term t at element i: its bits in the flags (1 +inf, 2 -inf,
// 3 NaN), 16 elements a word.
__device__ __forceinline__ void flag_add(unsigned* flags, long long i, float t) {
  const unsigned bits = isnan(t) ? 3u : (t > 0.f ? 1u : 2u);
  atomicOr(flags + (i >> 4), bits << (2 * (i & 15)));
}

// The scratch's fixed-point sums (and flags) as values of T.
template <typename T>
__global__ void __launch_bounds__(256)
fixed_to_value_kernel(const long long* __restrict__ acc, const unsigned* __restrict__ flags,
                      T* __restrict__ out, long long n, const double* __restrict__ bound,
                      bool has_mask, int bits) {
  const int e = fixed_exponent(bound, has_mask, bits);
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const unsigned f = (flags[i >> 4] >> (2 * (i & 15))) & 3u;
    if (f) {
      store_f32(out + i, f == 1u ? INFINITY : f == 2u ? -INFINITY : NAN);
    } else if constexpr (is_bf16<T>) {  // rounded to bf16 once; the scaling is exact
      out[i] = __float2bfloat16_rn(ldexpf(__bfloat162float(__ll2bfloat16_rn(acc[i])), -e));
    } else {  // rounded to float once; the scaling is exact
      out[i] = ldexpf(__ll2float_rn(acc[i]), -e);
    }
  }
}

// With 2 pixels a thread, the four lanes of a pixel group read 2-float
// runs of four gout rows 64 words apart at once: row co of the gout tile
// is rotated by 16 * (co % 4) words, so that the four runs fall in two
// bank halves.
template <int PPT>
__device__ __forceinline__ int bd_gout_col(int co, int p) {
  return PPT == 2 ? (p + 16 * (co & 3)) & 63 : p;
}

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
// (tile P = 32 * PPT pixels: TH = 2 * PPT rows of TILE_W columns);
// the builds are 8 x 4, 8 x 8 and 16 x 4 (chunk x rows), CPT * PPT <= 4;
// BLOCKS: blocks per SM the registers are budgeted for (128 or 80 a
// thread for 2 or 3), as the plan's shared memory allows. x_acc: the int64
// fixed-point scratch of grad_x (zeroed), x_flags its non-finite flags
// (zeroed); bound, bits, split: the fixed point's (above). grad_offset and
// grad_mask: the chunk's slab at blockIdx.y % chunks times off_slab and
// mask_slab (0 where the group is one chunk).
template <int CPT, int PPT, int BLOCKS, typename T>
__global__ void __launch_bounds__(BD_THREADS, BLOCKS)
deform_bwd_data_kernel(const T* __restrict__ gout, const T* __restrict__ x,
                       const float* __restrict__ offset, long long offset_bstride,
                       const T* __restrict__ mask, long long mask_bstride,
                       const float* __restrict__ wt, long long* __restrict__ x_acc,
                       unsigned* __restrict__ x_flags, const double* __restrict__ bound,
                       int bits, int split, float* __restrict__ grad_offset,
                       long long off_slab, float* __restrict__ grad_mask, long long mask_slab,
                       int cin, int height, int width, int cout, int out_h, int out_w, int kh,
                       int kw, int stride, int pad, int dil, int groups, int win_h,
                       int win_w, int win_stride, int tiles_x, bool gout_vec, bool w_vec) {
  constexpr int CC = 8 * CPT;
  constexpr int P = 32 * PPT;
  constexpr int TH = P / TILE_W;
  extern __shared__ float4 s_raw[];
  float* s_gout = reinterpret_cast<float*>(s_raw);  // [cout][P], rows rotated: bd_gout_col
  float* s_w = s_gout + cout * P;                     // [2][cout][CC]: taps k and k + 1
  float* s_x = s_w + 2 * cout * CC;                   // [CC][win_stride]
  unsigned* s_lo = reinterpret_cast<unsigned*>(s_x + CC * win_stride);  // [CC][win_stride]
  int* s_hi = reinterpret_cast<int*>(s_lo + CC * win_stride);           // [CC][win_stride]
  float* s_part = reinterpret_cast<float*>(s_hi + CC * win_stride);  // [tap parity][half][dy, dx, m][P]

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int ho0 = static_cast<int>(blockIdx.x / tiles_x) * TH;
  const int wo0 = static_cast<int>(blockIdx.x % tiles_x) * TILE_W;
  const int cg = cin / groups;
  const int chunks = (cg + CC - 1) / CC;
  const int g = blockIdx.y / chunks;
  const int c0 = g * cg + static_cast<int>(blockIdx.y % chunks) * CC;
  const int nc = min(CC, (g + 1) * cg - c0);  // the group's last chunk may be short
  const long long b = blockIdx.z;
  const int taps = kh * kw;
  const int npix = out_h * out_w;
  const long long hw = static_cast<long long>(height) * width;
  const int win_y = ho0 * stride - pad - HALO, win_x = wo0 * stride - pad - HALO;
  const T* xb = x + (b * cin + c0) * hw;
  const long long xe0 = (b * cin + c0) * hw;  // grad_x's element of the chunk's first channel
  const T* gb = gout + b * cout * static_cast<long long>(npix);
  const float* ob = offset + b * offset_bstride;
  const T* mb = mask ? mask + b * mask_bstride : nullptr;
  const long long chunk_i = blockIdx.y % chunks;
  float* gob = grad_offset + chunk_i * off_slab + b * groups * taps * 2 * static_cast<long long>(npix);
  float* gmb = grad_mask ? grad_mask + chunk_i * mask_slab +
                               b * groups * taps * static_cast<long long>(npix)
                         : nullptr;
  // the fixed point: terms are scaled by 2^e, the window's words split at bit `split`
  const float scale = ldexpf(1.f, fixed_exponent(bound, mask != nullptr, bits));
  const unsigned lo_mask = (1u << split) - 1u;

  // The thread's channels cset * CPT + j and pixels pl0 + i (one row).
  const int half = warp >> 2;
  const int cset = half * 4 + (lane >> 3);
  const int pl0 = ((warp & 3) * 8 + (lane & 7)) * PPT;
  const int ho = ho0 + pl0 / TILE_W, wo1 = wo0 + pl0 % TILE_W;

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
        mv[i] = mb ? load_f32(mb + static_cast<long long>(g * taps + k) * npix + p) : 1.f;
      }
    }
  };
  // Tap kk's offset and mask gradients of pixel t of the tile (t < P), in
  // the chunk's slab.
  auto write_tap = [&](int kk) {
    const int oh = ho0 + t / TILE_W, ow = wo0 + t % TILE_W;
    if (t >= P || oh >= out_h || ow >= out_w) return;
    const float* part = s_part + (kk & 1) * 6 * P + t;
    const int p = oh * out_w + ow;
    const long long oc = static_cast<long long>((g * taps + kk) * 2) * npix + p;
    gob[oc] = part[0] + part[3 * P];
    gob[oc + npix] = part[P] + part[4 * P];
    if (gmb) gmb[static_cast<long long>(g * taps + kk) * npix + p] = part[2 * P] + part[5 * P];
  };
  // The four corners of a non-finite term gm at (y0, x0) with weights
  // (wy0, ly) x (wx0, lx), channel cl: flagged where they lie in the image.
  auto flag_corners = [&](int cl, int y0, int x0, float gm, float wy0, float ly, float wx0,
                          float lx) {
#pragma unroll
    for (int cy = 0; cy < 2; ++cy)
#pragma unroll
      for (int cx = 0; cx < 2; ++cx) {
        const int yy = y0 + cy, xx = x0 + cx;
        if (yy >= 0 && yy < height && xx >= 0 && xx < width) {
          flag_add(x_flags, xe0 + cl * hw + static_cast<long long>(yy) * width + xx,
                   gm * (cy ? ly : wy0) * (cx ? lx : wx0));
        }
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
      stage1(s_x + cl * win_stride + r * win_w + col, in ? xb + cl * hw + yy * width + xx : x, in);
    }
  }
  for (int e = t; e < cout * P / 4; e += BD_THREADS) {
    const int co = e / (P / 4), q = e % (P / 4);
    const int r = q / (TILE_W / 4), cq = (q % (TILE_W / 4)) * 4;
    const int oh = ho0 + r, ow = wo0 + cq;
    float* dst = s_gout + co * P + bd_gout_col<PPT>(co, r * TILE_W + cq);
    const T* src = gb + static_cast<long long>(co) * npix + oh * out_w + ow;
    if (gout_vec && oh < out_h && ow + 3 < out_w) {
      stage4(dst, src, true);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = oh < out_h && ow + i < out_w;
        stage1(dst + i, in ? src + i : gout, in);
      }
    }
  }
  stage_w(0);
  for (int e = t; e < 2 * CC * win_stride; e += BD_THREADS) s_lo[e] = 0u;  // and s_hi
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
          const float v00 = xs[0], v01 = xs[1], v10 = xs[win_w], v11 = xs[win_w + 1];
          const float gc = acc[j][i], gm = gc * m;
          const float top = wx0 * v00 + lx * v01, bot = wx0 * v10 + lx * v11;
          sums[0][i] = fmaf(gm, sy * (bot - top), sums[0][i]);
          sums[1][i] = fmaf(gm, sx * (wy0 * (v01 - v00) + ly * (v11 - v10)), sums[1][i]);
          sums[2][i] = fmaf(gc, wy0 * top + ly * bot, sums[2][i]);
          if (isfinite(gm)) {
            const int o = cl * win_stride + wi;
            const float gs = gm * scale;  // exact: a power of two
            window_add(s_lo + o, s_hi + o, gs * wy0 * wx0, split, lo_mask);
            window_add(s_lo + o + 1, s_hi + o + 1, gs * wy0 * lx, split, lo_mask);
            window_add(s_lo + o + win_w, s_hi + o + win_w, gs * ly * wx0, split, lo_mask);
            window_add(s_lo + o + win_w + 1, s_hi + o + win_w + 1, gs * ly * lx, split, lo_mask);
          } else if (cl < nc) {
            flag_corners(cl, y0, x0, gm, wy0, ly, wx0, lx);
          }
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
          const T* xc = xb + cl * hw + i00;
          long long* ac = x_acc + xe0 + cl * hw + i00;
          const float v00 = y0_in && x0_in ? load_f32(xc) : 0.f;
          const float v01 = y0_in && x1_in ? load_f32(xc + 1) : 0.f;
          const float v10 = y1_in && x0_in ? load_f32(xc + width) : 0.f;
          const float v11 = y1_in && x1_in ? load_f32(xc + width + 1) : 0.f;
          const float gc = acc[j][i], gm = gc * m;
          const float top = wx0 * v00 + lx * v01, bot = wx0 * v10 + lx * v11;
          sums[0][i] = fmaf(gm, sy * (bot - top), sums[0][i]);
          sums[1][i] = fmaf(gm, sx * (wy0 * (v01 - v00) + ly * (v11 - v10)), sums[1][i]);
          sums[2][i] = fmaf(gc, wy0 * top + ly * bot, sums[2][i]);
          if (isfinite(gm)) {
            const float gs = gm * scale;
            if (y0_in && x0_in) scratch_add(ac, gs * wy0 * wx0);
            if (y0_in && x1_in) scratch_add(ac + 1, gs * wy0 * lx);
            if (y1_in && x0_in) scratch_add(ac + width, gs * ly * wx0);
            if (y1_in && x1_in) scratch_add(ac + width + 1, gs * ly * lx);
          } else {
            flag_corners(cl, y0, x0, gm, wy0, ly, wx0, lx);
          }
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
  // the grad_x window into the scratch: inside the image, non-zero entries only
  for (int row = warp; row < nc * win_h; row += BD_THREADS / 32) {
    const int cl = row / win_h, r = row - cl * win_h, yy = win_y + r;
    if (yy < 0 || yy >= height) continue;
    for (int col = lane; col < win_w; col += 32) {
      const int xx = win_x + col, wi = cl * win_stride + r * win_w + col;
      const long long v = static_cast<long long>(s_hi[wi]) * (1LL << split) + s_lo[wi];
      if (xx >= 0 && xx < width && v != 0) {
        atomicAdd(reinterpret_cast<unsigned long long*>(x_acc + xe0 + cl * hw + yy * width + xx),
                  static_cast<unsigned long long>(v));
      }
    }
  }
}

template <int CPT, int PPT, int BLOCKS, typename T>
cudaError_t launch_bwd_data_blocks(dim3 grid, int smem, cudaStream_t stream, const T* gout,
                                   const T* x, const float* offset, long long offset_bstride,
                                   const T* mask, long long mask_bstride, const float* wt,
                                   long long* x_acc, unsigned* x_flags, const double* bound,
                                   int bits, int split, float* grad_offset, long long off_slab,
                                   float* grad_mask, long long mask_slab, int cin, int height,
                                   int width, int cout, int out_h, int out_w, int kh, int kw,
                                   int stride, int pad, int dil, int groups, int win_h, int win_w,
                                   int win_stride, int tiles_x, bool gout_vec, bool w_vec) {
  // words: the gout tile, two taps' weights, the x window and the grad_x
  // window's two words an element, the offset and mask sums of two taps
  // and two halves
  constexpr int P = 32 * PPT;
  const long long words = static_cast<long long>(cout) * P +
                          2LL * cout * 8 * CPT + 3LL * 8 * CPT * win_stride + 12LL * P;
  if (words * 4 != smem) return cudaErrorInvalidValue;  // the wrapper's plan has another layout
  auto kernel = deform_bwd_data_kernel<CPT, PPT, BLOCKS, T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, BD_THREADS, smem, stream>>>(
      gout, x, offset, offset_bstride, mask, mask_bstride, wt, x_acc, x_flags, bound, bits,
      split, grad_offset, off_slab, grad_mask, mask_slab, cin, height, width, cout, out_h, out_w,
      kh, kw, stride, pad, dil, groups, win_h, win_w, win_stride, tiles_x, gout_vec, w_vec);
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

// Both forms' entry (T: the values' type): the checks, then the bound, the
// kernel, the conversion of grad_x and the offset and mask slabs' sums.
template <typename T>
int bwd_data_entry(const T* gout, const T* x, const float* offset, long long offset_bstride,
                   const T* mask, long long mask_bstride, const float* wt, double* bound,
                   long long* x_acc, unsigned* x_flags, T* grad_x, float* offset_sums,
                   float* grad_offset, float* mask_sums, T* grad_mask, int batch, int cin,
                   int height, int width, int cout, int out_h, int out_w, int kh, int kw,
                   int stride, int pad, int dil, int groups, int chunk, int tile_h, int blocks,
                   int smem_bytes, int device, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool built = (chunk == 8 && (tile_h == 4 || tile_h == 8)) || (chunk == 16 && tile_h == 4);
  if (groups < 1 || cin % groups != 0 || !built) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cg = cin / groups;
  const int chunks = (cg + chunk - 1) / chunk;
  // slabs where a group spans several chunks; the bf16 mask gradient
  // always goes through its float32 slab, rounded once by the slabs' sum
  const bool off_slabs = chunks > 1, mask_slabs = mask && (chunks > 1 || is_bf16<T>);
  if ((mask == nullptr) != (grad_mask == nullptr) || off_slabs != (offset_sums != nullptr) ||
      mask_slabs != (mask_sums != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long npix = static_cast<long long>(out_h) * out_w;
  const long long n_x = static_cast<long long>(batch) * cin * height * width;
  if (batch == 0 || n_x == 0) return 0;
  if (npix == 0) {  // no output pixel reaches x: zero gradients
    const cudaError_t err = cudaMemsetAsync(grad_x, 0, n_x * sizeof(T), s);
    return static_cast<int>(err);
  }
  const int taps = kh * kw;
  const int win_h = (tile_h - 1) * stride + (kh - 1) * dil + 2 * HALO + 2;
  const int win_w = (TILE_W - 1) * stride + (kw - 1) * dil + 2 * HALO + 2;
  // odd: the four channel sets of a warp at one window position hit four banks
  const int win_stride = win_h * win_w | 1;
  const int tiles_x = (out_w + TILE_W - 1) / TILE_W;
  const int tiles_y = (out_h + tile_h - 1) / tile_h;
  // the fixed point: terms below 2^bits, the window's words split at bit `split`
  const int l = ceil_log2(static_cast<long long>(taps) * tile_h * TILE_W);
  const int split = 32 - l;
  const int bits = min(62 - 2 * l, 62 - ceil_log2(taps * npix));
  if (bits < 8) return static_cast<int>(cudaErrorInvalidValue);  // too many terms an element
  const long long mask_n = static_cast<long long>(groups) * taps * npix;
  const long long n_gout = static_cast<long long>(batch) * cout * npix;
  const long long bound_blocks = (n_gout + 255) / 256;  // at least 1: x has an element
  fixed_bound_kernel<T><<<static_cast<unsigned int>(bound_blocks < 1 ? 1
                                                    : bound_blocks < 1024 ? bound_blocks : 1024), 256,
                          0, s>>>(gout, n_gout, wt, taps, cout, cin, mask, mask_bstride, mask_n,
                                  batch, bound);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(tiles_x * tiles_y, groups * chunks, batch);
  // 16-byte copies (8-byte loads of bf16): gout rows of a multiple of 4
  // values; weight runs of whole chunks starting at a multiple of 4 channels
  const bool gout_vec = out_w % 4 == 0 && aligned16(gout);
  const bool w_vec = cin % 4 == 0 && cg % chunk == 0 && cg % 4 == 0 && aligned16(wt);
  const long long n_off = static_cast<long long>(batch) * mask_n * 2;
  float* off_out = off_slabs ? offset_sums : grad_offset;
  float* mask_out = mask_slabs ? mask_sums : reinterpret_cast<float*>(grad_mask);
#define AANET_BWD_DATA(CPT, PPT)                                                                 \
  launch_bwd_data<CPT, PPT>(blocks, grid, smem_bytes, s, gout, x, offset, offset_bstride, mask,  \
                            mask_bstride, wt, x_acc, x_flags, bound, bits, split, off_out,       \
                            off_slabs ? n_off : 0LL, mask_out,                                   \
                            mask_slabs ? batch * mask_n : 0LL, cin, height, width, cout, out_h,  \
                            out_w, kh, kw, stride, pad, dil, groups, win_h, win_w, win_stride,   \
                            tiles_x, gout_vec, w_vec)
  err = chunk == 16 ? AANET_BWD_DATA(2, 2) : tile_h == 8 ? AANET_BWD_DATA(1, 4) : AANET_BWD_DATA(1, 2);
#undef AANET_BWD_DATA
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long conv_blocks = (n_x + 255) / 256;
  fixed_to_value_kernel<T><<<static_cast<unsigned int>(conv_blocks < 65535 * 8 ? conv_blocks
                                                                              : 65535 * 8),
                             256, 0, s>>>(x_acc, x_flags, grad_x, n_x, bound, mask != nullptr,
                                          bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int e = off_slabs ? sum_slabs(offset_sums, grad_offset, chunks, n_off, s) : 0;
  if (e != 0 || !mask_slabs) return e;
  return sum_slabs(mask_sums, grad_mask, chunks, batch * mask_n, s);
}

}  // namespace

// gout: [batch, cout, out_h, out_w]; x, offset, mask as for the forward;
// wt: the weight laid out [kh*kw, cout, cin] (wt[k, co, c] = weight[co, c,
// k / kw, k % kw]); bound: 3 doubles, zeroed by the caller; x_acc: int64
// [batch, cin, height, width] and x_flags: ceil(its size / 16) 32-bit
// words, both zeroed by the caller (the fixed-point scratch and its
// non-finite flags); grad_x: x's shape, written in full; grad_offset:
// [batch, groups*kh*kw*2, out_h, out_w] and grad_mask: [batch,
// groups*kh*kw, out_h, out_w] (or null without a mask), contiguous,
// written in full; offset_sums: where a group's channels span several
// chunks (chunk < cin / groups), [chunks, grad_offset's shape], else null;
// mask_sums likewise for grad_mask (null without a mask). Every entry of
// the slabs is written (no zeroing). The plan (ops/deform.py
// backward_data_plan): chunk (input channels per block) and tile_h (output
// rows per tile, of 16 columns): 8 and 4, 8 and 8, or 16 and 4; blocks (per
// SM, 2 or 3: the register budget of the kernel's build), and smem_bytes,
// the block's shared memory, which must be what this layout takes (else
// cudaErrorInvalidValue). All float32 but x_acc and x_flags.
extern "C" int aanet_deform_conv_backward_data_f32(
    const float* gout, const float* x, const float* offset, long long offset_bstride,
    const float* mask, long long mask_bstride, const float* wt, double* bound, long long* x_acc,
    unsigned* x_flags, float* grad_x, float* offset_sums, float* grad_offset, float* mask_sums,
    float* grad_mask, int batch, int cin, int height, int width, int cout, int out_h, int out_w,
    int kh, int kw, int stride, int pad, int dil, int groups, int chunk, int tile_h, int blocks,
    int smem_bytes, int device, void* stream) {
  return bwd_data_entry(gout, x, offset, offset_bstride, mask, mask_bstride, wt, bound, x_acc,
                        x_flags, grad_x, offset_sums, grad_offset, mask_sums, grad_mask, batch,
                        cin, height, width, cout, out_h, out_w, kh, kw, stride, pad, dil, groups,
                        chunk, tile_h, blocks, smem_bytes, device, stream);
}

// ---------------------------------------------------------------------------
// Backward (b): the weight gradient,
//   grad_w[co, c, k] = sum_{b, p} gout[b, co, p] * col[b, c, k, p],
// with the modulated columns col sampled the way the forward samples them;
// they never reach device memory (680 MB per conv at the main path's
// largest shape, batch 16 at 96x192, if they were).
//
// Replaces the weight half of the transpose that jax.grad derives from the
// contraction of aanet_tpu/ops/deform.py:modulated_deform_conv2d.
//
// Bound: operations (the forward's FLOP count once more, float32 FMA on the
// CUDA cores: the JAX side pins Precision.HIGHEST, which TF32's one product
// fails). It is a split-K matrix product: M = output channels, N = (input
// channel, tap), K = the pixels of the batch. A first, simpler kernel re-sampled a
// tap's columns for every output-channel tile, rebuilt the corner table per
// tap, re-read gout per tap, idled most of its 64-wide tiles at 16 to 48
// channels, and added every partial tile into grad_w with float atomics
// (576 per address at the largest shape, in no fixed order). Design:
// - A block owns co_tile output channels (all of them up to 128; where no
//   multiple of 8 divides cout, the last tile's gout rows at or above cout
//   are staged as zeros and their sums not written), a chunk
//   of cc input channels of one group with all their taps (N = cc * 9; the
//   plan takes cc among the group's divisors, so no channel idles), and a
//   run of tiles of tile_h x TILE_W output pixels, contiguous in (batch,
//   tile) order: its split's share of them.
// - Each thread keeps a register tile of WG_TM = 8 output channels x the 9
//   taps of one channel (72 sums) for the block's whole run, and reads both
//   operands as float4 runs of 4 pixels at fixed offsets (its rows are
//   contiguous; rows padded by WG_PAD words, so the 8 channels of a
//   quarter-warp hit 8 bank groups): 8 + 9 16-byte loads for 288 FMAs.
//   Where a block has fewer threads than the plan's, ksplit thread groups
//   take alternate pixel quads and meet in shared memory at the end.
// - A tile's channel-minor x window (the forward's, with the HALO) is
//   copied once with cp.async, two steps before it is needed, as a group of
//   its own; the tile is walked in steps of STEP_H rows. While step s is
//   contracted, step s + 1 is sampled into a second column tile, step s +
//   1's gout and step s + 2's offsets and mask are in flight: one
//   __syncthreads a step. Each sample finds its bilinear quad from the
//   staged offsets and mask (no table pass) and reads the window, corners
//   beyond it exactly from device memory. Each value is read once per block
//   and step.
// - Each split writes its sums once, with plain stores, to its own slab of a
//   workspace [splits][cout][cin * taps]; a second kernel adds the slabs in
//   a fixed order into grad_w. No float atomics: the weight gradient is
//   bit-reproducible for a given plan.
// What set the pace, on an H100 (PERF.md section 6): latency around the
// barriers, not FMA or shared-memory throughput (operands broadcast to a
// whole warp ran no faster). Larger steps (more FMAs a barrier) at 8
// resident warps beat more resident warps with small steps, and 255
// registers a thread (one 256-thread block an SM) beat 128 where the plan
// keeps 8 warps an SM; the plan picks the build.
//
// This kernel serves float32 values (T = float). The bf16 weight gradient
// is deform_wgrad_mma_kernel (the last section): its products run on the
// tensor cores, with its own plan.
// ---------------------------------------------------------------------------
namespace {

// The launch bounds: the largest block (WG_MAX_THREADS in ops/deform.py);
// the kernel is built for 1 and for 2 such blocks an SM (WG_BUILDS there),
// so a thread may take 255 or 128 registers, and the plan names the build.
constexpr int WG_MAX_THREADS = 256;
constexpr int WG_TM = 8;        // output channels of a thread's register tile
constexpr int WG_MAX_TAPS = 9;  // taps of a thread's register tile: all of one channel's
                                // (rows past a conv's taps are zero)
constexpr int WG_PAD = 4;       // words after each row of the gout and column tiles
constexpr int WG_VEC = 4;       // pixels of an operand load in the contraction

// Words of the weight gradient's shared memory: two steps' offsets and
// masks ([dy, dx per tap, then m per tap][pixels]), gout tiles and column
// tiles, two x windows of the chunk; the ksplit - 1 groups' partial sums at
// the end reuse the space. pixels: a step's.
__host__ __device__ inline long long wg_smem_words(int taps, int pixels, int co_tile, int cc,
                                                   int win_size, int ksplit) {
  const long long rs = pixels + WG_PAD;
  const long long main = 6LL * taps * pixels + 2LL * co_tile * rs + 2LL * cc * win_size +
                         2LL * WG_MAX_TAPS * cc * rs;
  const long long partial =
      static_cast<long long>(ksplit - 1) * WG_TM * WG_MAX_TAPS * (co_tile / WG_TM) * cc;
  return main > partial ? main : partial;
}

template <int STEP_H, int BLOCKS, typename T>
__global__ void __launch_bounds__(WG_MAX_THREADS, BLOCKS)
deform_wgrad_kernel(const T* __restrict__ gout, const T* __restrict__ x,
                    const float* __restrict__ offset, long long offset_bstride,
                    const T* __restrict__ mask, long long mask_bstride,
                    float* __restrict__ ws, int cin, int height, int width, int cout, int out_h,
                    int out_w, int kh, int kw, int stride, int pad, int dil, int groups,
                    int tile_h, int co_tile, int cc, int ksplit, int splits, int win_h, int win_w,
                    int win_size, int tiles_x, int tiles, int units, bool gout_vec, bool off_vec) {
  constexpr int P = STEP_H * TILE_W, RS = P + WG_PAD;  // a step's pixels; a row's words
  extern __shared__ float4 s_raw[];
  const int taps = kh * kw, nq = cc / 4;
  float* s_off = reinterpret_cast<float*>(s_raw);  // [2][3 * taps][P]: dy, dx per tap, then m
  float* s_g = s_off + 6 * taps * P;               // [2][co_tile][RS]
  float* s_x = s_g + 2 * co_tile * RS;             // [2][nq][win_size][4]
  float* s_col = s_x + 2 * cc * win_size;          // [2][cc * WG_MAX_TAPS][RS]: row c * 9 + k

  const int t = threadIdx.x, nthreads = blockDim.x;
  const int warp = t >> 5, nwarps = nthreads >> 5;
  const int nco = co_tile / WG_TM;
  // The thread's channel c_t (a quarter-warp spans 8 channels), output
  // channels WG_TM * co_t + i and pixel quads kg, kg + ksplit, ... of a step.
  const int c_t = t % cc, co_t = (t / cc) % nco, kg = t / (cc * nco);
  const int cg = cin / groups, per_group = (cg + cc - 1) / cc;
  const int g = blockIdx.x / per_group;
  const int c0 = g * cg + (blockIdx.x % per_group) * cc;
  const int nc = min(cc, (g + 1) * cg - c0);  // the group's last chunk may be short
  const int split = blockIdx.y;
  const int co0 = blockIdx.z * co_tile;
  const int u_beg = static_cast<int>(static_cast<long long>(split) * units / splits);
  const int u_end = static_cast<int>(static_cast<long long>(split + 1) * units / splits);
  const int npix = out_h * out_w;
  const long long hw = static_cast<long long>(height) * width;

  // Unit u: a tile of tile_h x TILE_W output pixels of batch entry b, with
  // its window at (win_y, win_x), walked in steps of STEP_H rows.
  struct Tile {
    long long b;
    int ho0, wo0, win_y, win_x, steps;
  };
  auto tile_of = [&](int u) {
    Tile tl;
    tl.b = u / tiles;
    const int i = u - static_cast<int>(tl.b) * tiles;
    tl.ho0 = (i / tiles_x) * tile_h;
    tl.wo0 = (i % tiles_x) * TILE_W;
    tl.win_y = tl.ho0 * stride - pad - HALO;
    tl.win_x = tl.wo0 * stride - pad - HALO;
    tl.steps = (min(tile_h, out_h - tl.ho0) + STEP_H - 1) / STEP_H;
    return tl;
  };
  // Rows [rows][P] of a map at output rows ho0.. of a tile: row r from src +
  // r * src_stride (a [.., out_h, out_w] map of float32 or T), zero off the
  // map and for r >= valid, into dst + r * dst_stride.
  auto stage_rows = [&](float* dst, int dst_stride, const auto* src, long long src_stride,
                        int rows, int valid, int ho0, int wo0, bool vec) {
    for (int e = t; e < rows * (P / 4); e += nthreads) {
      const int r = e / (P / 4), q = e - r * (P / 4);
      const int oh = ho0 + q / (TILE_W / 4), ow = wo0 + (q % (TILE_W / 4)) * 4;
      float* d = dst + r * dst_stride + 4 * q;
      const auto* sp = src + r * src_stride + oh * out_w + ow;
      const bool row_in = r < valid && oh < out_h;
      if (vec && (!row_in || ow + 3 < out_w)) {
        stage4(d, row_in ? sp : src, row_in);  // src: aligned where vec
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const bool in = row_in && ow + i < out_w;
          stage1(d + i, in ? sp + i : src, in);
        }
      }
    }
  };
  // Unit u's x window into window buffer (u - u_beg) & 1; step i of unit
  // u: its gout rows into gout buffer buf, its offsets and mask into offset
  // buffer buf.
  auto stage_window_of = [&](int u) {
    const Tile tl = tile_of(u);
    stage_window(s_x + ((u - u_beg) & 1) * cc * win_size, x + (tl.b * cin + c0) * hw, nc, nq, hw,
                 tl.win_y, tl.win_x, win_h, win_w, win_size, height, width, warp, nwarps, t & 31,
                 x);
  };
  auto stage_gout = [&](int u, int i, int buf) {
    const Tile tl = tile_of(u);
    stage_rows(s_g + buf * co_tile * RS, RS, gout + (tl.b * cout + co0) * npix, npix, co_tile,
               cout - co0, tl.ho0 + i * STEP_H, tl.wo0, gout_vec);
  };
  auto stage_offsets = [&](int u, int i, int buf) {
    const Tile tl = tile_of(u);
    float* so = s_off + buf * 3 * taps * P;
    const int ho0 = tl.ho0 + i * STEP_H;
    stage_rows(so, P, offset + tl.b * offset_bstride + 2LL * g * taps * npix, npix, 2 * taps,
               2 * taps, ho0, tl.wo0, off_vec);
    if (mask) {
      stage_rows(so + 2 * taps * P, P,
                 mask + tl.b * mask_bstride + static_cast<long long>(g) * taps * npix, npix, taps,
                 taps, ho0, tl.wo0, off_vec);
    }
  };
  // The column tile of step i of unit u into column buffer buf. Each (tap,
  // pixel) item finds its bilinear quad from the staged offsets and mask
  // once, and samples all the chunk's channel quads from the window.
  auto sample_step = [&](int u, int i, int buf) {
    const Tile tl = tile_of(u);
    const T* xc = x + (tl.b * cin + c0) * hw;
    const float* so = s_off + buf * 3 * taps * P;
    const float* sx = s_x + ((u - u_beg) & 1) * cc * win_size;
    float* col = s_col + buf * cc * WG_MAX_TAPS * RS;
#pragma unroll 2
    for (int e = t; e < taps * P; e += nthreads) {
      const int k = e / P, pl = e - k * P;
      const int ho = tl.ho0 + i * STEP_H + pl / TILE_W, wo = tl.wo0 + pl % TILE_W;
      float4 te = make_float4(0.f, 0.f, 0.f, 0.f);  // off the map: a zero sample
      if (ho < out_h && wo < out_w) {
        const int ki = k / kw;
        te = corner(ho, wo, ki, k - ki * kw, so[2 * k * P + pl], so[(2 * k + 1) * P + pl],
                    mask ? so[(2 * taps + k) * P + pl] : 1.f, stride, pad, dil, height, width,
                    tl.win_y, tl.win_x, win_h, win_w);
      }
      for (int j = 0; j < nq; ++j) {
        sample_quad<true>(col + (4 * j * WG_MAX_TAPS + k) * RS + pl, WG_MAX_TAPS * RS, te,
                    reinterpret_cast<const float4*>(sx + 4 * j * win_size), win_w,
                    xc + 4 * j * hw, hw, nc - 4 * j, height, width);
      }
    }
  };

  float acc[WG_TM][WG_MAX_TAPS];
#pragma unroll
  for (int i = 0; i < WG_TM; ++i)
#pragma unroll
    for (int k = 0; k < WG_MAX_TAPS; ++k) acc[i][k] = 0.f;
  // The thread's rows are contiguous: output channels WG_TM * co_t + i of
  // the gout tile, taps c_t * 9 + k of the column tile (those past taps are
  // zero), all at fixed offsets.
  auto contract = [&](int buf) {
    const float* ap = s_g + (buf * co_tile + co_t * WG_TM) * RS + WG_VEC * kg;
    const float* bp = s_col + (buf * cc + c_t) * WG_MAX_TAPS * RS + WG_VEC * kg;
#pragma unroll 1
    for (int q = kg; q < P / WG_VEC; q += ksplit, ap += WG_VEC * ksplit, bp += WG_VEC * ksplit) {
      float a[WG_TM][WG_VEC];
#pragma unroll
      for (int i = 0; i < WG_TM; ++i) load_run<WG_VEC>(a[i], ap + i * RS);
#pragma unroll
      for (int k = 0; k < WG_MAX_TAPS; ++k) {
        float v[WG_VEC];
        load_run<WG_VEC>(v, bp + k * RS);
#pragma unroll
        for (int i = 0; i < WG_TM; ++i)
#pragma unroll
          for (int j = 0; j < WG_VEC; ++j) acc[i][k] = fmaf(a[i][j], v[j], acc[i][k]);
      }
    }
  };

  // Steps s, s + 1, s + 2 and s + 3 as (unit, step of the unit); a unit
  // at u_end is past the block's run. While step s is contracted, step s +
  // 1 is sampled into the other column buffer, and step s + 1's gout and
  // step s + 2's offsets are in flight: one __syncthreads a step. A unit's
  // window is copied while the two steps before it are worked on (one step,
  // after a unit of a single step), as a cp.async group of its own.
  auto advance = [&](int& u, int& i) {
    if (u < u_end && ++i == tile_of(u).steps) {
      ++u;
      i = 0;
    }
  };
  if (taps < WG_MAX_TAPS) {  // the column rows past the taps stay zero
    for (int e = t; e < 2 * cc * WG_MAX_TAPS * RS; e += nthreads) {
      if ((e / RS) % WG_MAX_TAPS >= taps) s_col[e] = 0.f;
    }
  }
  int u0 = u_beg, i0 = 0, u1 = u0, i1 = 0;
  advance(u1, i1);
  int u2 = u1, i2 = i1;
  advance(u2, i2);
  int u3 = u2, i3 = i2;
  advance(u3, i3);
  stage_window_of(u0);
  stage_offsets(u0, i0, 0);
  stage_gout(u0, i0, 0);
  if (u1 < u_end) {
    if (i1 == 0) stage_window_of(u1);
    stage_offsets(u1, i1, 1);
  }
  if (u2 < u_end && i2 == 0 && u1 == u0) stage_window_of(u2);
  cp_async_wait_all();
  __syncthreads();
  sample_step(u0, i0, 0);
  bool window_pending = false;  // the newest cp.async group is a window, needed a step later
  for (int buf = 0; u0 < u_end; buf ^= 1) {
    if (window_pending) {
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();  // step s's gout and column tile are in; s + 1's offsets have landed
    if (u2 < u_end && i2 == 0 && u1 != u0 && u1 + 1 == u2) {
      stage_window_of(u2);  // after a unit of one step: one step ahead
    }
    if (u1 < u_end) stage_gout(u1, i1, buf ^ 1);
    if (u2 < u_end) stage_offsets(u2, i2, buf);
    cp_async_commit();
    window_pending = u3 < u_end && i3 == 0 && u2 + 1 == u3 && u1 == u2;
    if (window_pending) {
      stage_window_of(u3);
      cp_async_commit();
    }
    if (u1 < u_end) sample_step(u1, i1, buf ^ 1);
    contract(buf);
    u0 = u1;
    i0 = i1;
    u1 = u2;
    i1 = i2;
    u2 = u3;
    i2 = i3;
    advance(u3, i3);
  }

  // The ksplit groups' sums: groups 1.. through shared memory, added in
  // group order by group 0.
  const int group_threads = cc * nco, lt = t % group_threads;
  if (ksplit > 1) {
    __syncthreads();
    float* s_part = reinterpret_cast<float*>(s_raw);  // [ksplit - 1][WG_TM * WG_MAX_TAPS][threads]
    if (kg > 0) {
      float* d = s_part + (kg - 1) * WG_TM * WG_MAX_TAPS * group_threads + lt;
#pragma unroll
      for (int i = 0; i < WG_TM; ++i)
#pragma unroll
        for (int k = 0; k < WG_MAX_TAPS; ++k)
          if (k < taps) d[(i * WG_MAX_TAPS + k) * group_threads] = acc[i][k];
    }
    __syncthreads();
    if (kg > 0) return;
    for (int s = 0; s < ksplit - 1; ++s) {
      const float* src = s_part + s * WG_TM * WG_MAX_TAPS * group_threads + lt;
#pragma unroll
      for (int i = 0; i < WG_TM; ++i)
#pragma unroll
        for (int k = 0; k < WG_MAX_TAPS; ++k)
          if (k < taps) acc[i][k] += src[(i * WG_MAX_TAPS + k) * group_threads];
    }
  }

  // The sums into this split's slab, once, in grad_w's [cout][cin][taps]
  // order: the real output channels only (the slab has cout rows).
  if (c_t < nc) {
    const long long row = static_cast<long long>(cin) * taps;
    float* w = ws + (static_cast<long long>(split) * cout + co0 + co_t * WG_TM) * row +
               static_cast<long long>(c0 + c_t) * taps;
    const int real = cout - co0 - co_t * WG_TM;  // the thread's channels below cout
#pragma unroll
    for (int i = 0; i < WG_TM; ++i)
#pragma unroll
      for (int k = 0; k < WG_MAX_TAPS; ++k)
        if (i < real && k < taps) w[i * row + k] = acc[i][k];
  }
}

// The checks and the two launches of the float32 weight gradient (T: the
// values' type and grad_w's).
template <typename T>
int launch_wgrad(const T* gout, const T* x, const float* offset, long long offset_bstride,
                 const T* mask, long long mask_bstride, float* ws, T* grad_w, int batch, int cin,
                 int height, int width, int cout, int out_h, int out_w, int kh, int kw,
                 int stride, int pad, int dil, int groups, int tile_h, int step_h, int co_tile,
                 int chunk, int ksplit, int splits, int blocks, int smem_bytes, cudaStream_t s) {
  const int taps = kh * kw;
  const int threads = (co_tile / WG_TM) * chunk * ksplit;
  if (groups < 1 || cin % groups != 0 || taps < 1 || taps > WG_MAX_TAPS ||
      (step_h != 2 && step_h != 4 && step_h != 8) || tile_h < step_h || tile_h % step_h != 0 || co_tile < WG_TM || co_tile % WG_TM != 0 ||
      co_tile > 128 || chunk < 4 || chunk % 4 != 0 || ksplit < 1 ||
      ksplit > step_h * TILE_W / WG_VEC || splits < 1 || threads % 32 != 0 ||
      threads > WG_MAX_THREADS || (blocks != 1 && blocks != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(cout) * cin * taps;
  if (n == 0) return 0;
  const int tiles_x = (out_w + TILE_W - 1) / TILE_W;
  const int tiles = ((out_h + tile_h - 1) / tile_h) * tiles_x;
  const long long units = static_cast<long long>(batch) * tiles;
  if (units == 0) {
    return static_cast<int>(cudaMemsetAsync(grad_w, 0, n * sizeof(T), s));
  }
  if (splits > units || splits > 65535 || units > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int win_h = (tile_h - 1) * stride + (kh - 1) * dil + 2 * HALO + 2;
  const int win_w = (TILE_W - 1) * stride + (kw - 1) * dil + 2 * HALO + 2;
  const int win_size = win_h * win_w;
  if (wg_smem_words(taps, step_h * TILE_W, co_tile, chunk, win_size, ksplit) * 4 != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);  // the wrapper's plan has another layout
  }
  const int cg = cin / groups;
  dim3 grid(groups * ((cg + chunk - 1) / chunk), splits, (cout + co_tile - 1) / co_tile);
  // 16-byte copies of rows of the maps: whole rows of 4 floats, aligned
  const bool gout_vec = out_w % 4 == 0 && aligned16(gout);
  const bool off_vec = out_w % 4 == 0 && aligned16(offset) && offset_bstride % 4 == 0 &&
                       (!mask || (aligned16(mask) && mask_bstride % 4 == 0));
  auto kernel = blocks == 1 ? (step_h == 2   ? deform_wgrad_kernel<2, 1, T>
                               : step_h == 4 ? deform_wgrad_kernel<4, 1, T>
                                             : deform_wgrad_kernel<8, 1, T>)
                            : (step_h == 2   ? deform_wgrad_kernel<2, 2, T>
                               : step_h == 4 ? deform_wgrad_kernel<4, 2, T>
                                             : deform_wgrad_kernel<8, 2, T>);
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kernel<<<grid, threads, smem_bytes, s>>>(
      gout, x, offset, offset_bstride, mask, mask_bstride, ws, cin, height, width, cout, out_h,
      out_w, kh, kw, stride, pad, dil, groups, tile_h, co_tile, chunk, ksplit, splits, win_h,
      win_w, win_size, tiles_x, tiles, static_cast<int>(units), gout_vec, off_vec);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return sum_slabs(ws, grad_w, splits, n, s);
}

}  // namespace

// gout: [batch, cout, out_h, out_w]; x, offset, mask as for the forward;
// ws: the workspace, splits slabs of cout * cin * kh * kw floats (every
// entry written: no zeroing); grad_w: [cout, cin, kh, kw], written (zeros
// for an empty batch or map). All float32; at most WG_MAX_TAPS taps. The
// plan (ops/deform.py backward_weight_plan): tile_h (output rows of a tile
// of 16 columns: the window's), step_h (rows of a step: 2, 4 or 8,
// dividing tile_h), co_tile (output channels of a block: a multiple of 8,
// at most 128; the grid takes ceil(cout / co_tile) tiles, and the last
// one's channels at or above cout are idle), chunk (input channels of a block, a
// multiple of 4), ksplit (thread groups that split a step's pixel quads),
// splits (blocks that split the batch's tiles, at most their number),
// blocks (per SM, 1 or 2: the register budget of the kernel's build), and
// smem_bytes, the block's shared memory, which must be what this layout
// takes. Anything else is cudaErrorInvalidValue. Two launches: the
// products into the slabs, then their sum.
extern "C" int aanet_deform_conv_backward_weight_f32(
    const float* gout, const float* x, const float* offset, long long offset_bstride,
    const float* mask, long long mask_bstride, float* ws, float* grad_w, int batch, int cin,
    int height, int width, int cout, int out_h, int out_w, int kh, int kw, int stride, int pad,
    int dil, int groups, int tile_h, int step_h, int co_tile, int chunk, int ksplit, int splits,
    int blocks, int smem_bytes, int device, void* stream) {
  cudaSetDevice(device);
  return launch_wgrad(gout, x, offset, offset_bstride, mask, mask_bstride, ws, grad_w, batch, cin,
                      height, width, cout, out_h, out_w, kh, kw, stride, pad, dil, groups, tile_h,
                      step_h, co_tile, chunk, ksplit, splits, blocks, smem_bytes,
                      static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// The bf16 forward and input/offset/mask gradient on the tensor cores.
//
// Both replace the bf16 form of aanet_tpu/ops/deform.py:modulated_deform_conv2d
// (its bf16 handling at :181-224: x, the mask and the weight in bfloat16, the
// offsets float32) and the transposes jax.vjp derives from it. They compute
// what the float32 kernels above compute on the widened values (the
// samples, their blend, the scatter and the offset and mask gradients in
// float32, each output rounded once), but their products run as
// mma.sync.aligned.m16n8k16 bf16 x bf16 with float32 accumulators on the
// tensor cores, and x, gout and the window are staged raw, in bfloat16,
// with cp.async. A bf16 x bf16 product is exact in float32, so only the
// order of the float32 sums differs from the twins'.
//
// Shared by both: the raw x window. A chunk's channels are staged
// channel-major, as bf16, each row a whole number of 16-byte pieces that
// start at a multiple of 8 columns (x's rows are 16-byte aligned where its
// width is a multiple of 8: x_vec; else the pieces are copied value by
// value): column win_x - xoff of the image is the row's first, xoff =
// (win_x mod 8) the same for every tile of a launch (win_x = wo0 * stride -
// pad - HALO, wo0 a multiple of 16). A channel's rows are win_wa values
// apart and channels xcs values apart (xcs: a multiple of 8, padded so that
// the channels the lanes of a warp read at once fall in different banks).
// ---------------------------------------------------------------------------
namespace {

constexpr int MMA_FWD_TH = 4;           // forward: output rows of a tile
constexpr int MMA_FWD_THREADS = 256;    // forward: 8 warps, 8 pixels (half a row) each
constexpr int MMA_FWD_CHUNK = 16;       // forward: input channels of a chunk (one k-step a tap)
constexpr int MMA_BD_CHUNK = 8;         // backward-data: input channels of a block (one n-tile)

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// The raw window's row: win_w columns after xoff, rounded up to whole
// 16-byte pieces.
__host__ __device__ inline int raw_row(int win_w, int xoff) { return (xoff + win_w + 7) / 8 * 8; }

// A channel's values in the raw window: win_h rows of win_wa, rounded up
// to an odd multiple of `unit` (8 or 16 values), so that the channels the
// lanes of a warp read at once start 8 x odd words (8 banks, modulo 32)
// apart: unit 8 for channels two apart (the backward-data kernel's lanes),
// unit 16 for neighbouring channels (the forward's).
__host__ __device__ inline int raw_channel(int win_h, int win_wa, int unit) {
  int n = (win_h * win_wa + unit - 1) / unit;
  if (n % 2 == 0) ++n;
  return n * unit;
}

// The fixed-point window's words a channel: at least win_h x win_w, 4
// modulo 16, so that the four channel pairs of a warp (two channels apart)
// start 8 banks apart.
__host__ __device__ inline int fixed_channel(int win_h, int win_w) {
  int n = win_h * win_w;
  while (n % 16 != 4) ++n;
  return n;
}

// The raw x window of CC channels (nc of them exist: the rest zero) of x
// at channel xc into sx: rows win_y.., columns win_x0.. (a multiple of 8).
__device__ __forceinline__ void stage_raw_window(bf16* sx, const bf16* xc, int cc, int nc,
                                                 long long hw, int win_y, int win_x0, int win_h,
                                                 int win_wa, int xcs, int height, int width,
                                                 bool x_vec, int t, int nthreads,
                                                 const bf16* any) {
  const int pieces = win_wa / 8;
  const int n = cc * win_h * pieces;
  for (int e = t; e < n; e += nthreads) {
    const int q = e % pieces, rest = e / pieces;
    const int r = rest % win_h, cl = rest / win_h;
    const int yy = win_y + r, xx = win_x0 + 8 * q;
    bf16* dst = sx + cl * xcs + r * win_wa + 8 * q;
    // a piece left of the image lies wholly outside it (win_x0 and 0 are multiples of 8)
    const bool in = cl < nc && yy >= 0 && yy < height && xx >= 0 && xx < width;
    const bf16* src = in ? xc + cl * hw + static_cast<long long>(yy) * width + xx : any;
    if (x_vec) {
      cp_async_16(dst, src, in ? 2 * min(8, width - xx) : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[i] = in && xx + i < width ? src[i] : __ushort_as_bfloat16(0);
    }
  }
}

// A float32 value as three bf16 planes: hi, the next 8 significand bits
// times 2^8 and the last 8 times 2^16, so that v = hi + 2^-8 mid + 2^-16 lo
// exactly for every finite float32 (subnormals included: the scaling keeps
// the low planes above bf16's least subnormal) and each plane is exactly a
// bf16 (ops/deform.py split_planes is the same split in PyTorch). A
// non-finite v is hi, the others zero.
__device__ __forceinline__ void split_planes(float v, unsigned short& hi, unsigned short& mid,
                                             unsigned short& lo) {
  if (!isfinite(v)) {
    hi = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    mid = lo = 0;
    return;
  }
  const float h = __uint_as_float(__float_as_uint(v) & 0xffff0000u);  // truncated: exact
  const float r1 = __fmul_rn(__fsub_rn(v, h), 256.f);                  // exact
  const float m = __uint_as_float(__float_as_uint(r1) & 0xffff0000u);
  const float r2 = __fmul_rn(__fsub_rn(r1, m), 256.f);  // exact, at most 8 significant bits
  hi = static_cast<unsigned short>(__float_as_uint(h) >> 16);
  mid = static_cast<unsigned short>(__float_as_uint(m) >> 16);
  lo = static_cast<unsigned short>(__float_as_uint(r2) >> 16);
}

// ---------------------------------------------------------------------------
// Kernel B: the bf16 forward, out = W . col + bias, on the tensor cores.
//
// Bound (H100 SXM at 700 W; chip_smoke.py's bf16_kernel_specs): the
// contraction is three bf16 x bf16 products of the column's planes at 989
// TFLOP/s, the sampling (the bilinear blend, 8 operations a sample) at the
// float32 peak of 67 TFLOP/s. The products bound the 64- and 128-channel
// convs (0.0660 ms at the aanet step's [16, 64, 96, 192]), the bytes the
// narrower ones: 0.4201 ms over the step's 21 first-pass launches, 0.0759
// at aanet inference. The float32 design above (kept for float32) spent
// most of its time outside its products and samples (PERF.md, a profile
// of its bf16 form): a staging by a load and a store with nothing in
// flight, two barriers a chunk of 4 channels, and an 8 x 8 FMA tile.
// Design:
// - A block owns a tile of MMA_FWD_TH = 4 rows x TILE_W columns of one batch
//   entry and co_tile = 16 MT output channels (all up to 128; the plan
//   pads co_tile with zero weights), and walks chunks of 16 input channels
//   of one group (channels past the group's end are zero). Each of its 8
//   warps owns 8 pixels, half a tile row.
// - The next chunk's raw x window is in flight (cp.async, double-buffered)
//   behind the current chunk's work: one __syncthreads a chunk.
// - Each warp tabulates its own pixels' bilinear quads (corner) once per
//   group, and then, tap by tap, samples its 8 pixels x 16 channels (a lane:
//   one pixel, channels cq + 4 i), splits each float32 sample into three
//   bf16 planes (split_planes) into a tile of its own, and multiplies it by
//   the tap's weights: A = W (16 output channels x 16 input channels, read
//   from device memory in fragment order, ops/deform.py
//   weight_fwd_fragments: one 16-byte load a lane), B = a plane (16 input
//   channels x 8 pixels, ldmatrix), three mma.sync a 16-channel tile of
//   co_tile into three float32 accumulators, one a plane. No barrier
//   between warps inside a chunk: sampling and products of different
//   warps overlap.
// - The output is hi + 2^-8 (mid + 2^-8 lo) (+ bias), rounded to bf16 once;
//   a split plan stores each split's float32 sum in its slab and
//   slab_sum_kernel adds the slabs in a fixed order and rounds once. Every
//   launch gives the same bits.
// The JAX op rounds each sample to bf16 before its contraction; this
// kernel, as its twin, keeps the sample's float32 value (its exact planes).
// ---------------------------------------------------------------------------

template <int MT, int BLOCKS>
__global__ void __launch_bounds__(MMA_FWD_THREADS, BLOCKS)
deform_fwd_mma_kernel(const bf16* __restrict__ x, const float* __restrict__ offset,
                      long long offset_bstride, const bf16* __restrict__ mask,
                      long long mask_bstride, const uint4* __restrict__ wf,
                      const float* __restrict__ bias, bf16* __restrict__ out,
                      float* __restrict__ slabs, int cin, int height, int width, int cout,
                      int out_h, int out_w, int kh, int kw, int stride, int pad, int dil,
                      int groups, int m_tiles, int splits, int win_h, int win_w, int win_wa,
                      int xoff, int xcs, int tiles_x, bool x_vec, bool out_vec) {
  constexpr int P = MMA_FWD_TH * TILE_W;
  constexpr int CC = MMA_FWD_CHUNK;
  extern __shared__ float4 s_raw[];
  const int taps = kh * kw;
  float4* s_tab = s_raw;                                        // [warp][taps][8]
  bf16* s_x = reinterpret_cast<bf16*>(s_raw + taps * P);        // [2][CC][xcs]
  bf16* s_col = s_x + 2 * CC * xcs;                             // [warp][3][8][16]

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g8 = lane >> 2, t4 = lane & 3;
  const int ho0 = static_cast<int>(blockIdx.x / tiles_x) * MMA_FWD_TH;
  const int wo0 = static_cast<int>(blockIdx.x % tiles_x) * TILE_W;
  const int co0 = static_cast<int>(blockIdx.y / splits) * 16 * MT;
  const int split = static_cast<int>(blockIdx.y % splits);
  const long long b = blockIdx.z;
  const int cg = cin / groups;
  const int per_group = (cg + CC - 1) / CC;
  const int nchunks = groups * per_group;
  const int q_beg = split * nchunks / splits, q_end = (split + 1) * nchunks / splits;
  const int npix = out_h * out_w;
  const long long hw = static_cast<long long>(height) * width;
  const int win_y = ho0 * stride - pad - HALO, win_x = wo0 * stride - pad - HALO;
  const bf16* xb = x + b * cin * hw;
  const float* ob = offset + b * offset_bstride;
  const bf16* mb = mask ? mask + b * mask_bstride : nullptr;
  // the warp's pixels: row prow of the tile, columns pcol .. pcol + 7
  const int prow = warp >> 1, pcol = (warp & 1) * 8;
  float4* tab = s_tab + warp * taps * 8;  // [taps][8]
  bf16* colw = s_col + warp * 3 * 8 * CC;  // [plane][pixel][16 channels], halves swizzled

  auto chunk_c0 = [&](int q) { return (q / per_group) * cg + (q % per_group) * CC; };
  auto chunk_nc = [&](int q) { return min(CC, (q / per_group + 1) * cg - chunk_c0(q)); };
  auto stage_x = [&](int q) {
    stage_raw_window(s_x + (q & 1) * CC * xcs, xb + chunk_c0(q) * hw, CC, chunk_nc(q), hw, win_y,
                     win_x - xoff, win_h, win_wa, xcs, height, width, x_vec, t, MMA_FWD_THREADS,
                     x);
  };
  // the warp's (tap, pixel) quads of group g
  auto tabulate_warp = [&](int g) {
    for (int e = lane; e < taps * 8; e += 32) {
      const int k = e >> 3, j = e & 7;
      const int ho = ho0 + prow, wo = wo0 + pcol + j;
      float4 te = make_float4(0.f, 0.f, 0.f, 0.f);  // off the map: a zero sample
      if (ho < out_h && wo < out_w) {
        const int p = ho * out_w + wo, ki = k / kw, kj = k - ki * kw;
        const long long oc = static_cast<long long>((g * taps + k) * 2) * npix + p;
        const float dy = __ldg(ob + oc), dx = __ldg(ob + oc + npix);
        const float m = mb ? load_f32(mb + static_cast<long long>(g * taps + k) * npix + p) : 1.f;
        te = corner(ho, wo, ki, kj, dy, dx, m, stride, pad, dil, height, width, win_y, win_x,
                    win_h, win_w);
        const int quad = __float_as_int(te.x);  // inside the window: its index in the raw one
        if (quad >= 0) te.x = __int_as_float(quad / win_w * win_wa + quad % win_w + xoff);
      }
      tab[e] = te;
    }
  };

  float acc[MT][3][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int pl = 0; pl < 3; ++pl)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][pl][j] = 0.f;

  // the sampling lane: pixel sj, channels cq + 4 i of the chunk, stored at
  // positions 4 cq + i of the tile's 16 (the weight fragments take the
  // chunk's channels in the same order)
  const int sj = lane & 7, cq = lane >> 3;
  bf16* mine = colw + sj * CC + 8 * ((cq >> 1) ^ ((sj >> 2) & 1)) + 4 * (cq & 1);
  // ldmatrix rows: planes 0 and 1 (x4), plane 2 (x2); pixel l & 7, half (l >> 3) & 1
  const int lr = lane & 7, lh = (lane >> 3) & 1;
  const bf16* b01 = colw + (lane >> 4) * 8 * CC + lr * CC + 8 * (lh ^ ((lr >> 2) & 1));
  const bf16* b2 = colw + 2 * 8 * CC + lr * CC + 8 * (lh ^ ((lr >> 2) & 1));
  const int m_tile0 = co0 / 16;

  stage_x(q_beg);
  cp_async_commit();
  tabulate_warp(q_beg / per_group);
  for (int q = q_beg; q < q_end; ++q) {
    cp_async_wait_all();
    __syncthreads();  // chunk q's window has landed; every warp is done with chunk q - 1's
    if (q + 1 < q_end) {
      stage_x(q + 1);
      cp_async_commit();
    }
    const int g = q / per_group;
    if (q > q_beg && g != (q - 1) / per_group) tabulate_warp(g);
    __syncwarp();
    const bf16* xs = s_x + (q & 1) * CC * xcs + cq * xcs;
    const bf16* xq = xb + (chunk_c0(q) + cq) * hw;
    const int nq = chunk_nc(q) > cq ? (chunk_nc(q) - cq + 3) / 4 : 0;  // the lane's channels that exist
    const uint4* wq = wf + (static_cast<long long>(q) * taps * m_tiles + m_tile0) * 32 + lane;
    for (int k = 0; k < taps; ++k) {
      uint4 a[MT];  // the tap's weights, in flight while the warp samples
#pragma unroll
      for (int i = 0; i < MT; ++i) a[i] = __ldg(wq + (k * m_tiles + i) * 32);
      {
        const float4 te = tab[k * 8 + sj];
        const int quad = __float_as_int(te.x);
        const float ly = te.y, lx = te.z, m = te.w;
        const float w00 = (1.f - ly) * (1.f - lx) * m, w01 = (1.f - ly) * lx * m;
        const float w10 = ly * (1.f - lx) * m, w11 = ly * lx * m;
        float v[4];
        if (quad >= 0) {  // channels past the end are zero in the window
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bf16* p = xs + 4 * i * xcs + quad;
            v[i] = w00 * bf(p[0]) + w01 * bf(p[1]) + w10 * bf(p[win_wa]) + w11 * bf(p[win_wa + 1]);
          }
        } else {
          sample_far(v, 1, quad, w00, w01, w10, w11, xq, 4 * hw, nq, height, width);
        }
        unsigned short h[4], md[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_planes(v[i], h[i], md[i], lo[i]);
        *reinterpret_cast<uint2*>(mine) =
            make_uint2(h[0] | (static_cast<unsigned>(h[1]) << 16), h[2] | (static_cast<unsigned>(h[3]) << 16));
        *reinterpret_cast<uint2*>(mine + 8 * CC) = make_uint2(
            md[0] | (static_cast<unsigned>(md[1]) << 16), md[2] | (static_cast<unsigned>(md[3]) << 16));
        *reinterpret_cast<uint2*>(mine + 16 * CC) = make_uint2(
            lo[0] | (static_cast<unsigned>(lo[1]) << 16), lo[2] | (static_cast<unsigned>(lo[3]) << 16));
      }
      __syncwarp();
      unsigned bp[4], b2r0, b2r1;
      ldmatrix_x4(bp, b01);  // plane 0: bp[0], bp[1]; plane 1: bp[2], bp[3]
      ldmatrix_x2(b2r0, b2r1, b2);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const unsigned av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
        mma_bf16(acc[i][0], av, bp[0], bp[1]);
        mma_bf16(acc[i][1], av, bp[2], bp[3]);
        mma_bf16(acc[i][2], av, b2r0, b2r1);
      }
      __syncwarp();  // the tile is read before the next tap's samples overwrite it
    }
  }

  // out[co, pixel]: the accumulators' rows co0 + 16 i + g8 (+ 8), columns
  // (pixels) 2 t4, 2 t4 + 1 of the warp's 8
  const int oh = ho0 + prow, ow = wo0 + pcol + 2 * t4;
  if (oh >= out_h) return;
  const long long ob0 = b * cout * static_cast<long long>(npix) + static_cast<long long>(oh) * out_w + ow;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int co = co0 + 16 * i + g8 + 8 * rr;
      if (co >= cout) continue;  // an idle channel of the last tile
      const float bv = bias && split == 0 ? bias[co] : 0.f;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * rr + e;
        v[e] = (acc[i][2][c] * 0x1p-8f + acc[i][1][c]) * 0x1p-8f + acc[i][0][c] + bv;
      }
      const long long o = ob0 + static_cast<long long>(co) * npix;
      if (slabs) {  // a split's float32 sums, into its slab
        float* d = slabs + split * (static_cast<long long>(cout) * npix * gridDim.z) + o;
        if (out_vec && ow + 1 < out_w) {
          *reinterpret_cast<float2*>(d) = make_float2(v[0], v[1]);
        } else {
          for (int e = 0; e < 2; ++e)
            if (ow + e < out_w) d[e] = v[e];
        }
      } else if (out_vec && ow + 1 < out_w) {
        *reinterpret_cast<__nv_bfloat162*>(out + o) = __floats2bfloat162_rn(v[0], v[1]);
      } else {
        for (int e = 0; e < 2; ++e)
          if (ow + e < out_w) out[o + e] = __float2bfloat16_rn(v[e]);
      }
    }
  }
}

// Bytes of the forward's shared memory: the warps' quad tables, two raw x
// windows of a chunk and the warps' plane tiles (ops/deform.py
// _fwd_mma_smem; the kernel refuses a plan whose smem_bytes differ).
__host__ __device__ inline long long fwd_mma_smem_bytes(int taps, int xcs) {
  return 16LL * taps * MMA_FWD_TH * TILE_W + 2LL * 2 * MMA_FWD_CHUNK * xcs +
         2LL * (MMA_FWD_THREADS / 32) * 3 * 8 * MMA_FWD_CHUNK;
}

template <int MT, int BLOCKS>
cudaError_t launch_fwd_mma(dim3 grid, int smem, cudaStream_t s, const bf16* x, const float* offset,
                           long long offset_bstride, const bf16* mask, long long mask_bstride,
                           const uint4* wf, const float* bias, bf16* out, float* slabs, int cin,
                           int height, int width, int cout, int out_h, int out_w, int kh, int kw,
                           int stride, int pad, int dil, int groups, int m_tiles, int splits,
                           int win_h, int win_w, int win_wa, int xoff, int xcs, int tiles_x,
                           bool x_vec, bool out_vec) {
  auto kernel = deform_fwd_mma_kernel<MT, BLOCKS>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, MMA_FWD_THREADS, smem, s>>>(
      x, offset, offset_bstride, mask, mask_bstride, wf, bias, out, slabs, cin, height, width,
      cout, out_h, out_w, kh, kw, stride, pad, dil, groups, m_tiles, splits, win_h, win_w, win_wa,
      xoff, xcs, tiles_x, x_vec, out_vec);
  return cudaGetLastError();
}

}  // namespace

// Kernel B's entry, the bf16 forward: x, mask and out bfloat16; offset,
// bias and sums float32; wf: the weight in fragment order
// (ops/deform.py weight_fwd_fragments: [chunks of 16 channels of each
// group][taps][co_pad / 16][32 lanes][8 bf16], co_pad = the tiles'
// channels, zero beyond cout and beyond each group's channels, the chunk's
// channels in the kernel's order), 16-byte aligned. The plan
// (ops/deform.py forward_plan_bf16): co_tile (16, 32, 64 or 128: the
// kernel's builds; the grid takes ceil(cout / co_tile) tiles), splits
// (blocks that split a tile's chunks, at most their number; each stores
// its float32 sums in its slab of sums [splits, batch, cout, out_h,
// out_w], which slab_sum_kernel adds in a fixed order and rounds into out
// once) and smem_bytes, which must be what this layout takes. Anything
// else is cudaErrorInvalidValue.
extern "C" int aanet_deform_conv_bf16(
    const bf16* x, const float* offset, long long offset_bstride, const bf16* mask,
    long long mask_bstride, const bf16* wf, const float* bias, bf16* out, float* sums, int batch,
    int cin, int height, int width, int cout, int out_h, int out_w, int kh, int kw, int stride,
    int pad, int dil, int groups, int co_tile, int splits, int smem_bytes, int device,
    void* stream) {
  cudaSetDevice(device);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int mt = co_tile / 16;
  if (groups < 1 || cin % groups != 0 || co_tile % 16 != 0 ||
      (mt != 1 && mt != 2 && mt != 4 && mt != 8) || splits < 1 || (splits > 1 && sums == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nchunks = groups * ((cin / groups + MMA_FWD_CHUNK - 1) / MMA_FWD_CHUNK);
  if (splits > nchunks) return static_cast<int>(cudaErrorInvalidValue);  // a block without work
  if (!aligned16(wf)) return static_cast<int>(cudaErrorInvalidValue);
  const long long npix = static_cast<long long>(out_h) * out_w;
  if (batch == 0 || npix == 0 || cout == 0) return 0;
  const int win_h = (MMA_FWD_TH - 1) * stride + (kh - 1) * dil + 2 * HALO + 2;
  const int win_w = (TILE_W - 1) * stride + (kw - 1) * dil + 2 * HALO + 2;
  const int xoff = (((-pad - HALO) % 8) + 8) % 8;
  const int win_wa = raw_row(win_w, xoff);
  const int xcs = raw_channel(win_h, win_wa, 16);
  if (fwd_mma_smem_bytes(kh * kw, xcs) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);  // the wrapper's plan has another layout
  }
  const int co_tiles = (cout + co_tile - 1) / co_tile;
  const int tiles_x = (out_w + TILE_W - 1) / TILE_W;
  const int tiles_y = (out_h + MMA_FWD_TH - 1) / MMA_FWD_TH;
  dim3 grid(tiles_x * tiles_y, co_tiles * splits, batch);
  const bool x_vec = width % 8 == 0 && aligned16(x);
  const bool out_vec = out_w % 2 == 0 && aligned16(splits > 1 ? static_cast<const void*>(sums)
                                                              : static_cast<const void*>(out));
  float* slabs = splits > 1 ? sums : nullptr;
#define AANET_FWD_MMA(MT, B)                                                                      \
  launch_fwd_mma<MT, B>(grid, smem_bytes, st, x, offset, offset_bstride, mask, mask_bstride,      \
                        reinterpret_cast<const uint4*>(wf), bias, out, slabs, cin, height, width,  \
                        cout, out_h, out_w, kh, kw, stride, pad, dil, groups, co_tiles * mt,       \
                        splits, win_h, win_w, win_wa, xoff, xcs, tiles_x, x_vec, out_vec)
  // the builds: 128 output channels for one block an SM (255 registers), the rest for two
  const cudaError_t err = mt == 8   ? AANET_FWD_MMA(8, 1)
                          : mt == 4 ? AANET_FWD_MMA(4, 2)
                          : mt == 2 ? AANET_FWD_MMA(2, 2)
                                    : AANET_FWD_MMA(1, 2);
#undef AANET_FWD_MMA
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits <= 1) return 0;
  return sum_slabs(sums, out, splits, static_cast<long long>(batch) * cout * npix, st);
}

// ---------------------------------------------------------------------------
// Kernel A: the bf16 input/offset/mask gradient, its column gradient
// gcol = W^T . gout on the tensor cores.
//
// Bound (H100 SXM at 700 W; chip_smoke.py's bf16_backward_specs): the
// gout . W products at 989 TFLOP/s, the sampling and the scatter (28
// operations a sample) at 67; bytes at some path shapes, the float32
// operations at others: 0.3752 ms over the aanet step's 21 launches. What
// the float32 design above spent beyond its products (PERF.md, a profile
// of it in bf16: without its contraction 22.2 of 25.7 ms a step,
// without its sampling and scatter 20.1) was its skeleton: a
// load-and-store staging with nothing in flight and a barrier after every
// tap of every block, with 2 or 4 samples a thread between them. Design:
// - A block owns a tile of TH = 8 or 4 rows x TILE_W columns of one batch
//   entry and a chunk of MMA_BD_CHUNK = 8 input channels of one group
//   (the plan: backward_data_plan_bf16), one warp a row. It stages, with
//   16-byte cp.async, the raw bf16 gout tile [cout rounded up to 16][TH x
//   16 pixels] (16-byte pieces swizzled by the row's channel, so that
//   ldmatrix.trans reads without bank conflicts) and the raw x window, and
//   keeps the fixed-point grad_x window of the float32 kernel (two 32-bit
//   words an element), all at once: one barrier before the taps and one
//   after.
// - Tap by tap, each warp computes its row's column gradient with
//   mma.sync m16n8k16: A = gout^T (16 pixels x 16 output channels,
//   ldmatrix.trans), B = the tap's weights (16 output channels x 8 input
//   channels, read from device memory in fragment order, one 8-byte load a
//   lane: ops/deform.py weight_bwd_fragments), float32 accumulators. A
//   lane's accumulators are 2 pixels (columns g, g + 8 of the row) x 2
//   channels (2 t, 2 t + 1): it samples, scatters and sums exactly those,
//   as the float32 kernel does per element (the same arithmetic, the same
//   fixed-point rule, far corners into the int64 scratch), with no barrier
//   between taps: warps drift apart and overlap.
// - The offset and mask gradients are summed over the lane's two channels,
//   then over the four lanes of a pixel pair by two shuffle steps, in a
//   fixed order, and stored by the warp once per (tap, pixel) and chunk:
//   where the group spans several chunks, each chunk stores a slab of its
//   own, summed in a fixed order by slab_sum_kernel (the bf16 mask
//   gradient always: its float32 slab is rounded once).
// - fixed_bound_fragments_kernel takes the bound from gout, the weight's
//   fragments and the mask; fixed_to_value_kernel rounds grad_x to bf16
//   once. Every launch gives the same bits.
// gcol never reaches device memory.
// ---------------------------------------------------------------------------
namespace {

// fixed_bound_kernel's maxima, the weight's column sums read from its
// fragments (wf: [columns / 8][ksteps][8][16] bf16: for column i, its 8
// tiles' lane group i % 8, the 16 values of 4 lanes; zeros where padded).
template <typename T>
__global__ void __launch_bounds__(256)
fixed_bound_fragments_kernel(const T* __restrict__ gout, long long n_gout,
                             const bf16* __restrict__ wf, long long columns, int ksteps,
                             const T* __restrict__ mask, long long mask_bstride, long long mask_n,
                             int batch, double* bound) {
  const long long t0 = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  double v[3] = {0.0, 0.0, 0.0};
  for (long long i = t0; i < n_gout; i += step) {
    const float a = fabsf(load_f32(gout + i));
    if (isfinite(a)) v[0] = fmax(v[0], static_cast<double>(a));
  }
  for (long long i = t0; i < columns; i += step) {
    const bf16* col = wf + (i / 8) * ksteps * 128 + (i % 8) * 16;
    double s = 0.0;
    for (int kk = 0; kk < ksteps; ++kk)
      for (int j = 0; j < 16; ++j) {
        const float a = fabsf(load_f32(col + kk * 128 + j));
        if (isfinite(a)) s += a;
      }
    v[1] = fmax(v[1], s);
  }
  if (mask != nullptr) {
    for (long long i = t0; i < batch * mask_n; i += step) {
      const float a = fabsf(load_f32(mask + (i / mask_n) * mask_bstride + i % mask_n));
      if (isfinite(a)) v[2] = fmax(v[2], static_cast<double>(a));
    }
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[q] = fmax(v[q], __shfl_xor_sync(0xffffffffu, v[q], o));
    if ((threadIdx.x & 31) == 0 && v[q] > 0.0) {
      atomicMax(reinterpret_cast<unsigned long long*>(bound + q),
                static_cast<unsigned long long>(__double_as_longlong(v[q])));
    }
  }
}

template <int TH, int BLOCKS>
__global__ void __launch_bounds__(32 * TH, BLOCKS)
deform_bwd_data_mma_kernel(const bf16* __restrict__ gout, const bf16* __restrict__ x,
                           const float* __restrict__ offset, long long offset_bstride,
                           const bf16* __restrict__ mask, long long mask_bstride,
                           const uint2* __restrict__ wf, long long* __restrict__ x_acc,
                           unsigned* __restrict__ x_flags, const double* __restrict__ bound,
                           int bits, int split, float* __restrict__ grad_offset, long long off_slab,
                           float* __restrict__ grad_mask, long long mask_slab, int cin,
                           int height, int width, int cout, int cout16, int out_h, int out_w,
                           int kh, int kw, int stride, int pad, int dil, int groups, int win_h,
                           int win_w, int win_wa, int xoff, int xcs, int ws, int tiles_x,
                           bool gout_vec, bool x_vec) {
  constexpr int CC = MMA_BD_CHUNK, P = TH * TILE_W, NTHREADS = 32 * TH;
  extern __shared__ float4 s_raw[];
  bf16* s_gout = reinterpret_cast<bf16*>(s_raw);                 // [cout16][P], pieces swizzled
  bf16* s_x = s_gout + cout16 * P;                               // [CC][xcs]
  unsigned* s_lo = reinterpret_cast<unsigned*>(s_x + CC * xcs);  // [CC][ws]
  int* s_hi = reinterpret_cast<int*>(s_lo + CC * ws);            // [CC][ws]

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g8 = lane >> 2, t4 = lane & 3;
  const int ho0 = static_cast<int>(blockIdx.x / tiles_x) * TH;
  const int wo0 = static_cast<int>(blockIdx.x % tiles_x) * TILE_W;
  const int cg = cin / groups;
  const int chunks = (cg + CC - 1) / CC;
  const int g = blockIdx.y / chunks;
  const int chunk_i = blockIdx.y % chunks;
  const int c0 = g * cg + chunk_i * CC;
  const int nc = min(CC, (g + 1) * cg - c0);  // the group's last chunk may be short
  const long long b = blockIdx.z;
  const int taps = kh * kw;
  const int npix = out_h * out_w;
  const long long hw = static_cast<long long>(height) * width;
  const int win_y = ho0 * stride - pad - HALO, win_x = wo0 * stride - pad - HALO;
  const bf16* xb = x + (b * cin + c0) * hw;
  const long long xe0 = (b * cin + c0) * hw;  // grad_x's element of the chunk's first channel
  const bf16* gb = gout + b * cout * static_cast<long long>(npix);
  const float* ob = offset + b * offset_bstride;
  const bf16* mb = mask ? mask + b * mask_bstride : nullptr;
  float* gob = grad_offset + chunk_i * off_slab + b * groups * taps * 2 * static_cast<long long>(npix);
  float* gmb = grad_mask ? grad_mask + chunk_i * mask_slab +
                               b * groups * taps * static_cast<long long>(npix)
                         : nullptr;
  const float scale = ldexpf(1.f, fixed_exponent(bound, mask != nullptr, bits));
  const unsigned lo_mask = (1u << split) - 1u;

  // the gout tile: 16-byte pieces of 8 pixels, piece j of row co at j ^ (co & 7)
  for (int e = t; e < cout16 * 2 * TH; e += NTHREADS) {
    const int co = e / (2 * TH), piece = e % (2 * TH);
    const int oh = ho0 + (piece >> 1), ow = wo0 + 8 * (piece & 1);
    bf16* dst = s_gout + co * P + 8 * (piece ^ (co & 7));
    const bool in = co < cout && oh < out_h && ow < out_w;
    const bf16* src = in ? gb + static_cast<long long>(co) * npix + oh * out_w + ow : gout;
    if (gout_vec) {
      cp_async_16(dst, src, in ? 2 * min(8, out_w - ow) : 0);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[i] = in && ow + i < out_w ? src[i] : __ushort_as_bfloat16(0);
    }
  }
  stage_raw_window(s_x, xb, CC, nc, hw, win_y, win_x - xoff, win_h, win_wa, xcs, height, width,
                   x_vec, t, NTHREADS, x);
  cp_async_commit();
  for (int e = t; e < 2 * CC * ws; e += NTHREADS) s_lo[e] = 0u;  // and s_hi
  cp_async_wait_all();
  __syncthreads();

  // the lane's pixels: row `warp` of the tile, columns g8 and g8 + 8; its
  // channels 2 t4 and 2 t4 + 1 of the chunk
  const int ho = ho0 + warp;
  const int ksteps = cout16 / 16;
  // ldmatrix.trans rows: output channel 16 kk + (lane & 7) + 8 (lane >> 4),
  // pixels 16 warp + 8 ((lane >> 3) & 1) ..
  const int piece = 2 * warp + ((lane >> 3) & 1);
  const bf16* arow = s_gout + ((lane & 7) + 8 * (lane >> 4)) * P + 8 * (piece ^ (lane & 7));
  // the chunk's weight fragments: [taps][groups][chunks][ksteps][32]
  const uint2* wg = wf + (static_cast<long long>(g) * chunks + chunk_i) * ksteps * 32 + lane;
  const long long wtap = static_cast<long long>(groups) * chunks * ksteps * 32;

  auto load_tap = [&](int k, float (&dy)[2], float (&dx)[2], float (&mv)[2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      dy[i] = dx[i] = mv[i] = 0.f;
      const int wo = wo0 + g8 + 8 * i;
      if (ho < out_h && wo < out_w) {
        const int p = ho * out_w + wo;
        const long long oc = static_cast<long long>((g * taps + k) * 2) * npix + p;
        dy[i] = __ldg(ob + oc);
        dx[i] = __ldg(ob + oc + npix);
        mv[i] = mb ? load_f32(mb + static_cast<long long>(g * taps + k) * npix + p) : 1.f;
      }
    }
  };
  auto flag_corners = [&](int cl, int y0, int x0, float gm, float wy0, float ly, float wx0,
                          float lx) {
#pragma unroll
    for (int cy = 0; cy < 2; ++cy)
#pragma unroll
      for (int cx = 0; cx < 2; ++cx) {
        const int yy = y0 + cy, xx = x0 + cx;
        if (yy >= 0 && yy < height && xx >= 0 && xx < width) {
          flag_add(x_flags, xe0 + cl * hw + static_cast<long long>(yy) * width + xx,
                   gm * (cy ? ly : wy0) * (cx ? lx : wx0));
        }
      }
  };

  float dy[2], dx[2], mv[2];
  load_tap(0, dy, dx, mv);
  for (int k = 0; k < taps; ++k) {
    // gcol of tap k: acc[0] (pixel g8, channel 2 t4), acc[1] (g8, 2 t4 + 1),
    // acc[2] (g8 + 8, 2 t4), acc[3] (g8 + 8, 2 t4 + 1)
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    {
      const uint2* wk = wg + k * wtap;
#pragma unroll 4
      for (int kk = 0; kk < ksteps; ++kk) {
        unsigned a[4];
        ldmatrix_x4_trans(a, arow + 16 * kk * P);
        const uint2 bw = __ldg(wk + kk * 32);
        mma_bf16(acc, a, bw.x, bw.y);
      }
    }
    float ndy[2], ndx[2], nmv[2];
    if (k + 1 < taps) load_tap(k + 1, ndy, ndx, nmv);

    const int ki = k / kw, kj = k - ki * kw;
    float sums[3][2];  // d/dy, d/dx, d/dm of the lane's pixels over its channels
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sums[0][i] = sums[1][i] = sums[2][i] = 0.f;
      const int wo = wo0 + g8 + 8 * i;
      if (ho >= out_h || wo >= out_w) continue;
      float py = static_cast<float>(ho * stride - pad + ki * dil) + dy[i];
      float px = static_cast<float>(wo * stride - pad + kj * dil) + dx[i];
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
        const int wi = ry * win_w + rx, xi = ry * win_wa + rx + xoff;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = 2 * t4 + e;
          const bf16* xs = s_x + cl * xcs + xi;
          const float v00 = bf(xs[0]), v01 = bf(xs[1]), v10 = bf(xs[win_wa]),
                      v11 = bf(xs[win_wa + 1]);
          const float gc = acc[2 * i + e], gm = gc * m;
          const float top = wx0 * v00 + lx * v01, bot = wx0 * v10 + lx * v11;
          sums[0][i] = fmaf(gm, sy * (bot - top), sums[0][i]);
          sums[1][i] = fmaf(gm, sx * (wy0 * (v01 - v00) + ly * (v11 - v10)), sums[1][i]);
          sums[2][i] = fmaf(gc, wy0 * top + ly * bot, sums[2][i]);
          if (isfinite(gm)) {
            const int o = cl * ws + wi;
            const float gs = gm * scale;  // exact: a power of two
            window_add(s_lo + o, s_hi + o, gs * wy0 * wx0, split, lo_mask);
            window_add(s_lo + o + 1, s_hi + o + 1, gs * wy0 * lx, split, lo_mask);
            window_add(s_lo + o + win_w, s_hi + o + win_w, gs * ly * wx0, split, lo_mask);
            window_add(s_lo + o + win_w + 1, s_hi + o + win_w + 1, gs * ly * lx, split, lo_mask);
          } else if (cl < nc) {
            flag_corners(cl, y0, x0, gm, wy0, ly, wx0, lx);
          }
        }
      } else {
        // beyond the window: the corners inside the image, in device memory
        const bool y0_in = y0 >= 0 && y0 < height, y1_in = y0 + 1 >= 0 && y0 + 1 < height;
        const bool x0_in = x0 >= 0 && x0 < width, x1_in = x0 + 1 >= 0 && x0 + 1 < width;
        const long long i00 = static_cast<long long>(y0) * width + x0;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = 2 * t4 + e;
          if (cl >= nc) continue;
          const bf16* xc = xb + cl * hw + i00;
          long long* ac = x_acc + xe0 + cl * hw + i00;
          const float v00 = y0_in && x0_in ? load_f32(xc) : 0.f;
          const float v01 = y0_in && x1_in ? load_f32(xc + 1) : 0.f;
          const float v10 = y1_in && x0_in ? load_f32(xc + width) : 0.f;
          const float v11 = y1_in && x1_in ? load_f32(xc + width + 1) : 0.f;
          const float gc = acc[2 * i + e], gm = gc * m;
          const float top = wx0 * v00 + lx * v01, bot = wx0 * v10 + lx * v11;
          sums[0][i] = fmaf(gm, sy * (bot - top), sums[0][i]);
          sums[1][i] = fmaf(gm, sx * (wy0 * (v01 - v00) + ly * (v11 - v10)), sums[1][i]);
          sums[2][i] = fmaf(gc, wy0 * top + ly * bot, sums[2][i]);
          if (isfinite(gm)) {
            const float gs = gm * scale;
            if (y0_in && x0_in) scratch_add(ac, gs * wy0 * wx0);
            if (y0_in && x1_in) scratch_add(ac + 1, gs * wy0 * lx);
            if (y1_in && x0_in) scratch_add(ac + width, gs * ly * wx0);
            if (y1_in && x1_in) scratch_add(ac + width + 1, gs * ly * lx);
          } else {
            flag_corners(cl, y0, x0, gm, wy0, ly, wx0, lx);
          }
        }
      }
    }
    // over the four lanes of the pixel pair (channel pairs 0..3), then lane
    // t4 stores d/dy (0), d/dx (1), d/dm (2) of both pixels
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sums[q][i] += __shfl_xor_sync(0xffffffffu, sums[q][i], 1);
        sums[q][i] += __shfl_xor_sync(0xffffffffu, sums[q][i], 2);
      }
    if (t4 < 2 || (t4 == 2 && gmb)) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int wo = wo0 + g8 + 8 * i;
        if (ho >= out_h || wo >= out_w) continue;
        const int p = ho * out_w + wo;
        const float s = t4 == 0 ? sums[0][i] : t4 == 1 ? sums[1][i] : sums[2][i];
        if (t4 < 2) {
          gob[static_cast<long long>((g * taps + k) * 2 + t4) * npix + p] = s;
        } else {
          gmb[static_cast<long long>(g * taps + k) * npix + p] = s;
        }
      }
    }
    if (k + 1 < taps) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        dy[i] = ndy[i];
        dx[i] = ndx[i];
        mv[i] = nmv[i];
      }
    }
  }

  __syncthreads();
  // the grad_x window into the scratch: inside the image, non-zero entries only
  for (int row = warp; row < nc * win_h; row += TH) {
    const int cl = row / win_h, r = row - cl * win_h, yy = win_y + r;
    if (yy < 0 || yy >= height) continue;
    for (int col = lane; col < win_w; col += 32) {
      const int xx = win_x + col, wi = cl * ws + r * win_w + col;
      const long long v = static_cast<long long>(s_hi[wi]) * (1LL << split) + s_lo[wi];
      if (xx >= 0 && xx < width && v != 0) {
        atomicAdd(reinterpret_cast<unsigned long long*>(x_acc + xe0 + cl * hw + yy * width + xx),
                  static_cast<unsigned long long>(v));
      }
    }
  }
}

// Bytes of kernel A's shared memory (ops/deform.py _bwd_data_mma_smem; the
// kernel refuses a plan whose smem_bytes differ).
__host__ __device__ inline long long bwd_data_mma_smem_bytes(int cout16, int tile_h, int xcs,
                                                             int ws) {
  return 2LL * cout16 * tile_h * TILE_W + 2LL * MMA_BD_CHUNK * xcs + 8LL * MMA_BD_CHUNK * ws;
}

template <int TH, int BLOCKS>
cudaError_t launch_bwd_data_mma(dim3 grid, int smem, cudaStream_t s, const bf16* gout,
                                const bf16* x, const float* offset, long long offset_bstride,
                                const bf16* mask, long long mask_bstride, const uint2* wf,
                                long long* x_acc, unsigned* x_flags, const double* bound,
                                int bits, int split, float* grad_offset, long long off_slab,
                                float* grad_mask, long long mask_slab, int cin, int height,
                                int width, int cout, int cout16, int out_h, int out_w, int kh,
                                int kw, int stride, int pad, int dil, int groups, int win_h,
                                int win_w, int win_wa, int xoff, int xcs, int ws, int tiles_x,
                                bool gout_vec, bool x_vec) {
  auto kernel = deform_bwd_data_mma_kernel<TH, BLOCKS>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, 32 * TH, smem, s>>>(gout, x, offset, offset_bstride, mask, mask_bstride, wf, x_acc,
                                     x_flags, bound, bits, split, grad_offset, off_slab, grad_mask,
                                     mask_slab, cin, height, width, cout, cout16, out_h, out_w, kh,
                                     kw, stride, pad, dil, groups, win_h, win_w, win_wa, xoff, xcs,
                                     ws, tiles_x, gout_vec, x_vec);
  return cudaGetLastError();
}

}  // namespace

// Kernel A's entry, the bf16 input/offset/mask gradient: gout, x, mask,
// grad_x and grad_mask bfloat16; offset, grad_offset and the slabs
// float32; wf: the weight in fragment order (ops/deform.py
// weight_bwd_fragments: [taps][groups][chunks][cout16 / 16][32 lanes][4
// bf16], cout16 = cout rounded up to 16, zero beyond cout and beyond each
// group's channels), 8-byte aligned; bound, x_acc and x_flags as for
// aanet_deform_conv_backward_data_f32 (zeroed by the caller); mask_sums,
// with a mask, always ([chunks, grad_mask's shape]: the mask gradient is
// rounded to bf16 once, by the slabs' sum); offset_sums where a group spans
// several chunks. The plan (ops/deform.py backward_data_plan_bf16): chunk
// (8), tile_h (8 or 4), blocks (per SM: 2 or 3 for 8 rows, 4 or 6 for 4:
// the register budget of the kernel's build) and smem_bytes, which must be
// what this layout takes. Anything else is cudaErrorInvalidValue.
extern "C" int aanet_deform_conv_backward_data_bf16(
    const bf16* gout, const bf16* x, const float* offset, long long offset_bstride,
    const bf16* mask, long long mask_bstride, const bf16* wf, double* bound, long long* x_acc,
    unsigned* x_flags, bf16* grad_x, float* offset_sums, float* grad_offset, float* mask_sums,
    bf16* grad_mask, int batch, int cin, int height, int width, int cout, int out_h, int out_w,
    int kh, int kw, int stride, int pad, int dil, int groups, int chunk, int tile_h, int blocks,
    int smem_bytes, int device, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool built = chunk == MMA_BD_CHUNK &&
                     ((tile_h == 8 && (blocks == 2 || blocks == 3)) ||
                      (tile_h == 4 && (blocks == 4 || blocks == 6)));
  if (groups < 1 || cin % groups != 0 || !built) return static_cast<int>(cudaErrorInvalidValue);
  const int cg = cin / groups;
  const int chunks = (cg + chunk - 1) / chunk;
  const bool off_slabs = chunks > 1, mask_slabs = mask != nullptr;
  if ((mask == nullptr) != (grad_mask == nullptr) || off_slabs != (offset_sums != nullptr) ||
      mask_slabs != (mask_sums != nullptr) || (reinterpret_cast<unsigned long long>(wf) & 7)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long npix = static_cast<long long>(out_h) * out_w;
  const long long n_x = static_cast<long long>(batch) * cin * height * width;
  if (batch == 0 || n_x == 0) return 0;
  if (npix == 0) {  // no output pixel reaches x: zero gradients
    return static_cast<int>(cudaMemsetAsync(grad_x, 0, n_x * sizeof(bf16), s));
  }
  const int taps = kh * kw;
  const int cout16 = (cout + 15) / 16 * 16;
  const int win_h = (tile_h - 1) * stride + (kh - 1) * dil + 2 * HALO + 2;
  const int win_w = (TILE_W - 1) * stride + (kw - 1) * dil + 2 * HALO + 2;
  const int xoff = (((-pad - HALO) % 8) + 8) % 8;
  const int win_wa = raw_row(win_w, xoff);
  const int xcs = raw_channel(win_h, win_wa, 8);
  const int ws = fixed_channel(win_h, win_w);
  if (bwd_data_mma_smem_bytes(cout16, tile_h, xcs, ws) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);  // the wrapper's plan has another layout
  }
  const int tiles_x = (out_w + TILE_W - 1) / TILE_W;
  const int tiles_y = (out_h + tile_h - 1) / tile_h;
  // the fixed point: terms below 2^bits, the window's words split at bit `split`
  const int l = ceil_log2(static_cast<long long>(taps) * tile_h * TILE_W);
  const int split = 32 - l;
  const int bits = min(62 - 2 * l, 62 - ceil_log2(taps * npix));
  if (bits < 8) return static_cast<int>(cudaErrorInvalidValue);  // too many terms an element
  const long long mask_n = static_cast<long long>(groups) * taps * npix;
  const long long n_gout = static_cast<long long>(batch) * cout * npix;
  const long long bound_blocks = (n_gout + 255) / 256;
  fixed_bound_fragments_kernel<bf16><<<static_cast<unsigned int>(
                                           bound_blocks < 1 ? 1 : bound_blocks < 1024 ? bound_blocks : 1024),
                                       256, 0, s>>>(
      gout, n_gout, wf, static_cast<long long>(taps) * groups * chunks * 8, cout16 / 16, mask,
      mask_bstride, mask_n, batch, bound);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(tiles_x * tiles_y, groups * chunks, batch);
  // 16-byte copies: gout rows and x rows of a multiple of 8 values, aligned
  const bool gout_vec = out_w % 8 == 0 && aligned16(gout);
  const bool x_vec = width % 8 == 0 && aligned16(x);
  const long long n_off = static_cast<long long>(batch) * mask_n * 2;
  float* off_out = off_slabs ? offset_sums : grad_offset;
#define AANET_BWD_DATA_MMA(TH, B)                                                                  \
  launch_bwd_data_mma<TH, B>(grid, smem_bytes, s, gout, x, offset, offset_bstride, mask,           \
                             mask_bstride, reinterpret_cast<const uint2*>(wf), x_acc, x_flags,     \
                             bound, bits, split, off_out, off_slabs ? n_off : 0LL, mask_sums,      \
                             mask ? batch * mask_n : 0LL, cin, height, width, cout, cout16,        \
                             out_h, out_w, kh, kw, stride, pad, dil, groups, win_h, win_w, win_wa, \
                             xoff, xcs, ws, tiles_x, gout_vec, x_vec)
  err = tile_h == 8 ? (blocks == 3 ? AANET_BWD_DATA_MMA(8, 3) : AANET_BWD_DATA_MMA(8, 2))
                    : (blocks == 6 ? AANET_BWD_DATA_MMA(4, 6) : AANET_BWD_DATA_MMA(4, 4));
#undef AANET_BWD_DATA_MMA
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long conv_blocks = (n_x + 255) / 256;
  fixed_to_value_kernel<bf16><<<static_cast<unsigned int>(conv_blocks < 65535 * 8 ? conv_blocks
                                                                                : 65535 * 8),
                                256, 0, s>>>(x_acc, x_flags, grad_x, n_x, bound, mask != nullptr,
                                             bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int e = off_slabs ? sum_slabs(offset_sums, grad_offset, chunks, n_off, s) : 0;
  if (e != 0 || !mask_slabs) return e;
  return sum_slabs(mask_sums, grad_mask, chunks, batch * mask_n, s);
}

// ---------------------------------------------------------------------------
// Kernel C: the bf16 weight gradient on the tensor cores,
//   grad_w[co, c, k] = sum_{b, p} gout[b, co, p] * col[b, c, k, p].
//
// Replaces the bf16 form of the weight half of the transpose jax.vjp
// derives from aanet_tpu/ops/deform.py:modulated_deform_conv2d (its bf16
// handling at :181-224: gout, x and the mask in bfloat16, the offsets
// float32, the weight gradient rounded to the weight's bf16 once).
//
// Bound (H100 SXM at 700 W; chip_smoke.py's bf16_backward_specs): the
// contraction as three bf16 x bf16 products (the column's planes) at 989
// TFLOP/s, the sampling at the float32 peak of 67 TFLOP/s. The float32
// kernel above (which served bf16 too, its operands widened through
// registers where they were staged) ran its products as float32 FMAs from
// register tiles, and its bf16 staging, with nothing in flight, took 4 of
// its 9.9 ms an aanet step (PERF.md section 6). Design:
// - It is a split-K product: M = a block's co_tile = 16 MT output channels
//   (zero gout rows past cout), N = a chunk of MMA_WG_CHUNK = 8 input
//   channels of one group by the taps, K = the pixels of the block's run of
//   tiles (tile_h x TILE_W output pixels of one batch entry, contiguous in
//   (batch, tile) order: its split's share), walked in steps of
//   MMA_WG_STEP_H = 4 rows (4 k-steps of a row's 16 pixels).
// - gout's tile [co_tile][64 pixels], the step's offsets and raw mask
//   [taps][64 pixels] and the chunk's raw x window (the forward's
//   channel-major layout, with the HALO) are staged raw by 16-byte cp.async
//   (4-byte copies, or values, where rows are not whole pieces), all
//   double-buffered and in flight a step ahead. Once a tile, the block
//   turns the landed raw window channel-minor (a position's 8 channels in
//   16 bytes) in shared memory, a step before it is sampled.
// - Warp w owns tap w (MMA_WG_WARPS = 9 warps; warps past a smaller
//   conv's taps only stage): it samples the tap's 8 channels at the step's
//   64 pixels (a lane: a pair of pixels of one row, each corner's 8
//   channels one 16-byte load) into a float32 column tile of its own [8
//   channels][64 pixels], and multiplies: A = gout (16 output channels x 16
//   pixels, ldmatrix), B = the column's 16 pixels x 8 channels, each value
//   split where the fragment is built into three bf16 planes (split_planes,
//   as the forward), three mma.sync m16n8k16 an m-tile into three float32
//   accumulators. The column never leaves the warp: no barrier between the
//   taps' sampling and their products. While step s is multiplied, step s +
//   1 is sampled into the warp's second column tile; one __syncthreads a
//   step.
// - A lane's accumulators hold grad_w[co0 + 16 i + g (+ 8), c0 + 2 t (+ 1),
//   w]: each entry is one lane's, summed over the block's pixels in step
//   order (no warp splits the pixels). A block stores hi + 2^-8 (mid +
//   2^-8 lo) once into its split's float32 slab ([splits][cout][cin *
//   taps]) and slab_sum_kernel adds the slabs in a fixed order, rounding
//   each entry to bf16 once. Every launch gives the same bits.
// What sets its pace on an H100 (PERF.md section 6, variants with a part
// removed): the products (about 40 % of an aanet step's time), the staging
// and the sampling (about a fifth each). Integer divisions a step (the
// tile of a unit), a division a sample and 2-byte loads a channel from a
// channel-major window cost more than the products did; the steps walk
// the tiles by counters. The JAX op rounds each sample to bf16 before its
// contraction; this kernel, as its twin, keeps the sample's float32 value
// (its exact planes).
// ---------------------------------------------------------------------------
namespace {

constexpr int MMA_WG_WARPS = 9;    // weight gradient: a warp a tap (at most 9 taps)
constexpr int MMA_WG_CHUNK = 8;    // weight gradient: input channels of a block (one n-tile)
constexpr int MMA_WG_STEP_H = 4;   // weight gradient: output rows of a step
constexpr int MMA_WG_RS = 72;      // weight gradient: bf16 a row of its gout tile (a step's 64
                                   // pixels and 16 bytes: ldmatrix reads 8 rows in 8 bank groups)
constexpr int MMA_WG_CS = 72;      // weight gradient: floats a row of its column tiles (8 words
                                   // past a multiple of 32: a fragment's rows in distinct banks)

// Bytes of kernel C's shared memory: the warps' two float32 column tiles,
// two gout tiles, two raw x windows of the chunk and two channel-minor ones
// (win_h x win_wa positions of 16 bytes), and two steps' offsets (float32)
// and raw masks, a row of the step's pixels a tap (ops/deform.py
// _wgrad_mma_smem; the kernel refuses a plan whose smem_bytes differ).
__host__ __device__ inline long long wgrad_mma_smem_bytes(int co_tile, int xcs, int win_h,
                                                          int win_wa) {
  return 4LL * MMA_WG_WARPS * 2 * MMA_WG_CHUNK * MMA_WG_CS + 2LL * 2 * co_tile * MMA_WG_RS +
         2LL * 2 * MMA_WG_CHUNK * xcs + 2LL * 16 * win_h * win_wa +
         2LL * MMA_WG_WARPS * MMA_WG_STEP_H * TILE_W * (2 * 4 + 2);
}

// Channel c of 8 raw bf16 values in 16 bytes, widened.
__device__ __forceinline__ float channel_of(const uint4& q, int c) {
  const unsigned w = c < 2 ? q.x : c < 4 ? q.y : c < 6 ? q.z : q.w;
  return __uint_as_float(c % 2 ? w & 0xffff0000u : w << 16);
}

// Two bf16 bit patterns as one 32-bit fragment register (a first).
__device__ __forceinline__ unsigned pack2(unsigned short a, unsigned short b) {
  return a | (static_cast<unsigned>(b) << 16);
}

template <int MT, int BLOCKS>
__global__ void __launch_bounds__(32 * MMA_WG_WARPS, BLOCKS)
deform_wgrad_mma_kernel(const bf16* __restrict__ gout, const bf16* __restrict__ x,
                        const float* __restrict__ offset, long long offset_bstride,
                        const bf16* __restrict__ mask, long long mask_bstride,
                        float* __restrict__ ws, int cin, int height, int width, int cout,
                        int out_h, int out_w, int kh, int kw, int stride, int pad, int dil,
                        int groups, int tile_h, int splits, int win_h, int win_w, int win_wa,
                        int xoff, int xcs, int tiles_x, int tiles, int units, bool gout_vec,
                        bool x_vec, bool off_vec, bool mask_vec) {
  constexpr int CC = MMA_WG_CHUNK, SH = MMA_WG_STEP_H, RS = MMA_WG_RS, CS = MMA_WG_CS;
  constexpr int CO = 16 * MT, NTHREADS = 32 * MMA_WG_WARPS, P = SH * TILE_W;
  extern __shared__ float4 s_raw[];
  float* s_col = reinterpret_cast<float*>(s_raw);                  // [warp][2][CC][CS]
  bf16* s_g = reinterpret_cast<bf16*>(s_col + MMA_WG_WARPS * 2 * CC * CS);  // [2][CO][RS]
  bf16* s_x = s_g + 2 * CO * RS;                                   // [2][CC][xcs], raw
  uint4* s_xt = reinterpret_cast<uint4*>(s_x + 2 * CC * xcs);      // [2][win_h * win_wa]
  float* s_off = reinterpret_cast<float*>(s_xt + 2 * win_h * win_wa);  // [2][2 * WARPS][P]
  bf16* s_m = reinterpret_cast<bf16*>(s_off + 2 * 2 * MMA_WG_WARPS * P);  // [2][WARPS][P]

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, g8 = lane >> 2, t4 = lane & 3;
  const int taps = kh * kw;
  const bool tap_warp = warp < taps;  // warp w samples and multiplies tap w
  const int ki = warp / kw, kj = warp - ki * kw;
  const int cg = cin / groups, per_group = (cg + CC - 1) / CC;
  const int g = blockIdx.x / per_group;
  const int c0 = g * cg + (blockIdx.x % per_group) * CC;
  const int nc = min(CC, (g + 1) * cg - c0);  // the group's last chunk may be short
  const int split = blockIdx.y;
  const int co0 = blockIdx.z * CO;
  const int u_beg = static_cast<int>(static_cast<long long>(split) * units / splits);
  const int u_end = static_cast<int>(static_cast<long long>(split + 1) * units / splits);
  const int npix = out_h * out_w;
  const long long hw = static_cast<long long>(height) * width;
  const int xt_size = win_h * win_wa;
  // the lane's pixels in a step: row pr, columns pc and pc + 1
  const int pr = lane >> 3, pc = 2 * (lane & 7);

  // A step of the block's run: step i of unit u, the tile (ty, tx) of
  // tile_h x TILE_W output pixels of batch entry b (units in (b, ty, tx)
  // order), walked in steps of SH rows; u = u_end: past the run. Advanced
  // without a division.
  struct Step {
    int u, i, b, ty, tx;
  };
  const int tiles_y = tiles / tiles_x;
  auto step_at = [&](int u) {
    Step c;
    c.u = u;
    c.i = 0;
    c.b = u / tiles;
    const int r = u - c.b * tiles;
    c.ty = r / tiles_x;
    c.tx = r - c.ty * tiles_x;
    return c;
  };
  auto advance = [&](Step& c) {
    if (c.u >= u_end) return;
    if (++c.i * SH < min(tile_h, out_h - c.ty * tile_h)) return;
    c.i = 0;
    ++c.u;
    if (++c.tx == tiles_x) {
      c.tx = 0;
      if (++c.ty == tiles_y) {
        c.ty = 0;
        ++c.b;
      }
    }
  };
  auto win_y_of = [&](const Step& c) { return c.ty * tile_h * stride - pad - HALO; };
  auto win_x_of = [&](const Step& c) { return c.tx * TILE_W * stride - pad - HALO; };
  // the raw window of c's unit into raw buffer (u - u_beg) & 1
  auto stage_window = [&](const Step& c) {
    stage_raw_window(s_x + ((c.u - u_beg) & 1) * CC * xcs,
                     x + (static_cast<long long>(c.b) * cin + c0) * hw, CC, nc, hw, win_y_of(c),
                     win_x_of(c) - xoff, win_h, win_wa, xcs, height, width, x_vec, t, NTHREADS, x);
  };
  // unit u's landed raw window, channel-minor: position e (row e / win_wa,
  // column e % win_wa of the raw row) holds its 8 channels in 16 bytes
  auto transpose_window = [&](int u) {
    const int buf = (u - u_beg) & 1;
    const unsigned short* sr = reinterpret_cast<const unsigned short*>(s_x + buf * CC * xcs);
    uint4* dst = s_xt + buf * xt_size;
    for (int e = t; e < xt_size; e += NTHREADS) {
      unsigned short v[CC];
#pragma unroll
      for (int c = 0; c < CC; ++c) v[c] = sr[c * xcs + e];
      dst[e] = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                          pack2(v[6], v[7]));
    }
  };
  // step c's gout rows into gout buffer buf: 16-byte pieces of 8 pixels,
  // piece 2 r + h of a row holding pixels 16 r + 8 h ..
  auto stage_gout = [&](const Step& c, int buf) {
    const int ho0 = c.ty * tile_h + c.i * SH, wo0 = c.tx * TILE_W;
    const bf16* gb = gout + (static_cast<long long>(c.b) * cout + co0) * npix;
    bf16* sg = s_g + buf * CO * RS;
    for (int e = t; e < CO * 2 * SH; e += NTHREADS) {
      const int co = e / (2 * SH), piece = e % (2 * SH);
      const int oh = ho0 + (piece >> 1), ow = wo0 + 8 * (piece & 1);
      bf16* dst = sg + co * RS + 8 * piece;
      const bool in = co0 + co < cout && oh < out_h && ow < out_w;
      const bf16* src = in ? gb + static_cast<long long>(co) * npix + oh * out_w + ow : gout;
      if (gout_vec) {
        cp_async_16(dst, src, in ? 2 * min(8, out_w - ow) : 0);
      } else {
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          dst[v] = in && ow + v < out_w ? src[v] : __ushort_as_bfloat16(0);
        }
      }
    }
  };
  // step c's offsets (rows (dy, dx) of each tap, float32) and raw mask (a
  // row a tap) into offset buffer buf, zero off the map: 16-byte pieces
  // where the rows allow, else 4-byte copies (offsets) or values (mask)
  auto stage_offsets = [&](const Step& c, int buf) {
    const int ho0 = c.ty * tile_h + c.i * SH, wo0 = c.tx * TILE_W;
    const long long p0 = static_cast<long long>(ho0) * out_w + wo0;
    const float* ob = offset + c.b * offset_bstride + static_cast<long long>(g * taps * 2) * npix + p0;
    float* so = s_off + buf * 2 * MMA_WG_WARPS * P;
    for (int e = t; e < 2 * taps * (P / 4); e += NTHREADS) {
      const int row = e / (P / 4), q = e - row * (P / 4);
      const int oh = ho0 + q / (TILE_W / 4), ow = wo0 + 4 * (q % (TILE_W / 4));
      const float* src = ob + row * static_cast<long long>(npix) + (oh - ho0) * out_w + ow - wo0;
      float* d = so + row * P + 4 * q;
      const bool row_in = oh < out_h;
      if (off_vec && (!row_in || ow + 3 < out_w)) {
        stage4(d, row_in ? src : offset, row_in);
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const bool in = row_in && ow + v < out_w;
          stage1(d + v, in ? src + v : offset, in);
        }
      }
    }
    if (!mask) return;
    const bf16* mb = mask + c.b * mask_bstride + static_cast<long long>(g * taps) * npix + p0;
    bf16* sm = s_m + buf * MMA_WG_WARPS * P;
    for (int e = t; e < taps * (P / 8); e += NTHREADS) {
      const int k = e / (P / 8), q = e - k * (P / 8);
      const int oh = ho0 + q / (TILE_W / 8), ow = wo0 + 8 * (q % (TILE_W / 8));
      const bf16* src = mb + k * static_cast<long long>(npix) + (oh - ho0) * out_w + ow - wo0;
      bf16* d = sm + k * P + 8 * q;
      const bool in = oh < out_h && ow < out_w;
      if (mask_vec) {
        cp_async_16(d, in ? src : mask, in ? 2 * min(8, out_w - ow) : 0);
      } else {
#pragma unroll
        for (int v = 0; v < 8; ++v) d[v] = in && ow + v < out_w ? src[v] : __ushort_as_bfloat16(0);
      }
    }
  };
  // step c of the warp's tap into its column tile buf (the step's offsets
  // and mask in offset buffer buf): the lane's two pixels, one after the
  // other, by the chunk's 8 channels, float32 (zero off the map and for
  // channels past the chunk's)
  auto sample = [&](const Step& st, int buf) {
    const uint4* sx = s_xt + ((st.u - u_beg) & 1) * xt_size;
    const bf16* xc = x + (static_cast<long long>(st.b) * cin + c0) * hw;
    const int ho = st.ty * tile_h + st.i * SH + pr, wo0 = st.tx * TILE_W + pc;
    const int win_y = win_y_of(st), win_x = win_x_of(st);
    const float* so = s_off + (buf * 2 * MMA_WG_WARPS + 2 * warp) * P + 16 * pr + pc;
    const bf16* sm = s_m + (buf * MMA_WG_WARPS + warp) * P + 16 * pr + pc;
    float* col = s_col + (warp * 2 + buf) * CC * CS + 16 * pr + pc;
    const float ys = static_cast<float>(ho * stride - pad + ki * dil);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v[CC];
#pragma unroll
      for (int c = 0; c < CC; ++c) v[c] = 0.f;
      const int wo = wo0 + e;
      if (ho < out_h && wo < out_w) {
        // corner() with the window's own index (no division)
        float py = ys + so[e];
        float px = static_cast<float>(wo * stride - pad + kj * dil) + so[P + e];
        py = fminf(fmaxf(py, -2.f), static_cast<float>(height) + 1.f);
        px = fminf(fmaxf(px, -2.f), static_cast<float>(width) + 1.f);
        const float fy = floorf(py), fx = floorf(px);
        const int y0 = static_cast<int>(fy), x0 = static_cast<int>(fx);
        const int ry = y0 - win_y, rx = x0 - win_x;
        const float ly = py - fy, lx = px - fx, m = mask ? bf(sm[e]) : 1.f;
        const float w00 = (1.f - ly) * (1.f - lx) * m, w01 = (1.f - ly) * lx * m;
        const float w10 = ly * (1.f - lx) * m, w11 = ly * lx * m;
        if (ry >= 0 && ry + 1 < win_h && rx >= 0 && rx + 1 < win_w) {
          // channels past the end are zero in the window
          const uint4* q = sx + ry * win_wa + rx + xoff;
          const uint4 q00 = q[0], q01 = q[1], q10 = q[win_wa], q11 = q[win_wa + 1];
#pragma unroll
          for (int c = 0; c < CC; ++c) {
            v[c] = w00 * channel_of(q00, c) + w01 * channel_of(q01, c) +
                   w10 * channel_of(q10, c) + w11 * channel_of(q11, c);
          }
        } else {
          const int quad = -1 - ((y0 + 2) * (width + 4) + x0 + 2);
          sample_far(v, 1, quad, w00, w01, w10, w11, xc, hw, nc, height, width);
          sample_far(v + 4, 1, quad, w00, w01, w10, w11, xc + 4 * hw, hw, nc - 4, height, width);
        }
      }
#pragma unroll
      for (int c = 0; c < CC; ++c) col[c * CS + e] = v[c];
    }
  };

  float acc[MT][3][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int pl = 0; pl < 3; ++pl)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][pl][j] = 0.f;
  // ldmatrix rows of A (gout): output channel (lane & 7) + 8 ((lane >> 3) &
  // 1), pixels 8 (lane >> 4) ..; B: the lane's channel g, pixels 2 t, 2 t +
  // 1 (b0) and 2 t + 8, 2 t + 9 (b1) of a k-step, split into the planes
  const int arow = ((lane & 7) + 8 * ((lane >> 3) & 1)) * RS + 8 * (lane >> 4);
  auto multiply = [&](int buf) {
    const bf16* ga = s_g + buf * CO * RS + arow;
    const float* cw = s_col + (warp * 2 + buf) * CC * CS + g8 * CS + 2 * t4;
#pragma unroll
    for (int ks = 0; ks < SH; ++ks) {
      const float2 lo = *reinterpret_cast<const float2*>(cw + 16 * ks);
      const float2 hi = *reinterpret_cast<const float2*>(cw + 16 * ks + 8);
      unsigned short h[4], md[4], l[4];
      split_planes(lo.x, h[0], md[0], l[0]);
      split_planes(lo.y, h[1], md[1], l[1]);
      split_planes(hi.x, h[2], md[2], l[2]);
      split_planes(hi.y, h[3], md[3], l[3]);
      const unsigned b[3][2] = {{pack2(h[0], h[1]), pack2(h[2], h[3])},
                                {pack2(md[0], md[1]), pack2(md[2], md[3])},
                                {pack2(l[0], l[1]), pack2(l[2], l[3])}};
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        unsigned a[4];
        ldmatrix_x4(a, ga + 16 * i * RS + 16 * ks);
#pragma unroll
        for (int pl = 0; pl < 3; ++pl) mma_bf16(acc[i][pl], a, b[pl][0], b[pl][1]);
      }
    }
  };

  // Steps s .. s + 3 of the block's run. Iteration s multiplies step s and samples step s + 1
  // (its window turned channel-minor in iteration s - 1; its offsets and
  // mask landed); it turns the raw window of step s + 2's unit channel-minor
  // where that unit is new (landed: staged in iteration s - 1), and has
  // step s + 1's gout, step s + 2's offsets and mask and the raw window of
  // step s + 3's unit in flight.
  int u0 = u_beg;  // step s: only whether it exists
  Step s0 = step_at(u_beg), s1 = s0;
  advance(s1);
  Step s2 = s1;
  advance(s2);
  Step s3 = s2;
  advance(s3);
  stage_window(s0);
  if (s1.u < u_end && s1.u != s0.u) stage_window(s1);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  transpose_window(s0.u);
  if (s1.u < u_end && s1.u != s0.u) transpose_window(s1.u);
  __syncthreads();  // the raw buffers are free
  if (s2.u < u_end && s2.u != s1.u) stage_window(s2);
  stage_gout(s0, 0);
  stage_offsets(s0, 0);
  if (s1.u < u_end) stage_offsets(s1, 1);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (tap_warp) sample(s0, 0);
  for (int buf = 0; u0 < u_end; buf ^= 1) {
    cp_async_wait_all();
    __syncthreads();  // step s's gout and column tiles are in; s + 1's offsets, s + 2's raw window have landed
    if (s1.u < u_end) stage_gout(s1, buf ^ 1);
    if (s2.u < u_end) stage_offsets(s2, buf);
    if (s3.u < u_end && s3.u != s2.u) stage_window(s3);
    cp_async_commit();
    if (s2.u < u_end && s2.u != s1.u) transpose_window(s2.u);
    if (tap_warp) {
      if (s1.u < u_end) sample(s1, buf ^ 1);
      __syncwarp();
      multiply(buf);
    }
    u0 = s1.u;
    s1 = s2;
    s2 = s3;
    advance(s3);
  }
  cp_async_wait_all();

  // the sums into this split's slab, once, in grad_w's [cout][cin][taps]
  // order: the real output channels and the chunk's channels only
  if (!tap_warp) return;
  const long long row = static_cast<long long>(cin) * taps;
  float* w = ws + static_cast<long long>(split) * cout * row + static_cast<long long>(c0) * taps +
             warp;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int co = co0 + 16 * i + g8 + 8 * rr;
      if (co >= cout) continue;  // an idle channel of the last tile
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 2 * t4 + e, j = 2 * rr + e;
        if (c < nc) {
          w[co * row + c * taps] = (acc[i][2][j] * 0x1p-8f + acc[i][1][j]) * 0x1p-8f + acc[i][0][j];
        }
      }
    }
}

template <int MT, int BLOCKS>
cudaError_t launch_wgrad_mma(dim3 grid, int smem, cudaStream_t s, const bf16* gout, const bf16* x,
                             const float* offset, long long offset_bstride, const bf16* mask,
                             long long mask_bstride, float* ws, int cin, int height, int width,
                             int cout, int out_h, int out_w, int kh, int kw, int stride, int pad,
                             int dil, int groups, int tile_h, int splits, int win_h, int win_w,
                             int win_wa, int xoff, int xcs, int tiles_x, int tiles, int units,
                             bool gout_vec, bool x_vec, bool off_vec, bool mask_vec) {
  auto kernel = deform_wgrad_mma_kernel<MT, BLOCKS>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, 32 * MMA_WG_WARPS, smem, s>>>(
      gout, x, offset, offset_bstride, mask, mask_bstride, ws, cin, height, width, cout, out_h,
      out_w, kh, kw, stride, pad, dil, groups, tile_h, splits, win_h, win_w, win_wa, xoff, xcs,
      tiles_x, tiles, units, gout_vec, x_vec, off_vec, mask_vec);
  return cudaGetLastError();
}

}  // namespace

// Kernel C's entry, the bf16 weight gradient: gout, x, mask and grad_w
// bfloat16, offset and ws float32; ws: the workspace, splits slabs of cout
// * cin * kh * kw floats (every entry written: no zeroing); grad_w: [cout,
// cin, kh, kw], written (zeros for an empty batch or map); at most
// MMA_WG_WARPS taps. The plan (ops/deform.py backward_weight_plan_bf16):
// tile_h (output rows of a tile of 16 columns, the window's: a multiple of
// MMA_WG_STEP_H), co_tile (16, 32, 64 or 128: the kernel's builds; the grid
// takes ceil(cout / co_tile) tiles), splits (blocks that split the batch's
// tiles, at most their number), blocks (per SM: the build's register
// budget, 1 for 128 channels, else 2) and smem_bytes, which must be what
// this layout takes. Anything else is cudaErrorInvalidValue. Two launches:
// the products into the slabs, then their sum, rounded to bf16 once.
extern "C" int aanet_deform_conv_backward_weight_bf16(
    const bf16* gout, const bf16* x, const float* offset, long long offset_bstride,
    const bf16* mask, long long mask_bstride, float* ws, bf16* grad_w, int batch, int cin,
    int height, int width, int cout, int out_h, int out_w, int kh, int kw, int stride, int pad,
    int dil, int groups, int tile_h, int co_tile, int splits, int blocks, int smem_bytes,
    int device, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int taps = kh * kw, mt = co_tile / 16;
  const bool built = co_tile % 16 == 0 && ((mt == 8 && blocks == 1) ||
                                           ((mt == 1 || mt == 2 || mt == 4) && blocks == 2));
  if (groups < 1 || cin % groups != 0 || taps < 1 || taps > MMA_WG_WARPS || !built ||
      tile_h < MMA_WG_STEP_H || tile_h % MMA_WG_STEP_H != 0 || splits < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(cout) * cin * taps;
  if (n == 0) return 0;
  const int tiles_x = (out_w + TILE_W - 1) / TILE_W;
  const int tiles = ((out_h + tile_h - 1) / tile_h) * tiles_x;
  const long long units = static_cast<long long>(batch) * tiles;
  if (units == 0) {
    return static_cast<int>(cudaMemsetAsync(grad_w, 0, n * sizeof(bf16), s));
  }
  if (splits > units || splits > 65535 || units > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int win_h = (tile_h - 1) * stride + (kh - 1) * dil + 2 * HALO + 2;
  const int win_w = (TILE_W - 1) * stride + (kw - 1) * dil + 2 * HALO + 2;
  const int xoff = (((-pad - HALO) % 8) + 8) % 8;
  const int win_wa = raw_row(win_w, xoff);
  const int xcs = raw_channel(win_h, win_wa, 8);
  if (wgrad_mma_smem_bytes(co_tile, xcs, win_h, win_wa) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);  // the wrapper's plan has another layout
  }
  const int cg = cin / groups;
  dim3 grid(groups * ((cg + MMA_WG_CHUNK - 1) / MMA_WG_CHUNK), splits, (cout + co_tile - 1) / co_tile);
  // 16-byte copies: gout, x and mask rows of a multiple of 8 values and
  // offset rows of a multiple of 4, aligned
  const bool gout_vec = out_w % 8 == 0 && aligned16(gout);
  const bool x_vec = width % 8 == 0 && aligned16(x);
  const bool off_vec = out_w % 4 == 0 && aligned16(offset) && offset_bstride % 4 == 0;
  const bool mask_vec = out_w % 8 == 0 && aligned16(mask) && mask_bstride % 8 == 0;
#define AANET_WGRAD_MMA(MT, B)                                                                     \
  launch_wgrad_mma<MT, B>(grid, smem_bytes, s, gout, x, offset, offset_bstride, mask,              \
                          mask_bstride, ws, cin, height, width, cout, out_h, out_w, kh, kw, stride, \
                          pad, dil, groups, tile_h, splits, win_h, win_w, win_wa, xoff, xcs,       \
                          tiles_x, tiles, static_cast<int>(units), gout_vec, x_vec, off_vec,      \
                          mask_vec)
  // the builds: 128 output channels for one block an SM, the rest for two
  const cudaError_t err = mt == 8   ? AANET_WGRAD_MMA(8, 1)
                          : mt == 4 ? AANET_WGRAD_MMA(4, 2)
                          : mt == 2 ? AANET_WGRAD_MMA(2, 2)
                                    : AANET_WGRAD_MMA(1, 2);
#undef AANET_WGRAD_MMA
  if (err != cudaSuccess) return static_cast<int>(err);
  return sum_slabs(ws, grad_w, splits, n, s);
}
