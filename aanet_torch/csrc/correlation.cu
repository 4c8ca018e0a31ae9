// Correlation cost volume, forward and backward, on the CUDA cores (the
// bf16 forms on the tensor cores):
//   cost[b, d, h, w] = (1/C) sum_c L[b, c, h, w] * R[b, c, h, w - d],
//   and 0 where w < d; the backward gives dL and dR from g = d loss / d cost.
//
// Both kernels are banded contractions: each value of L and R meets D
// values of the other (or of g) along one image row. Both are bound by
// bytes on the H100 at every shape of the port's paths, but narrowly: they
// do about 8 FMAs per byte they must move, and the card's float32 rate (67
// TFLOP/s, 33.5 T FMA/s) against its 3.35 TB/s is 10. So the FMAs run from
// register tiles, with the copies from device memory in flight behind
// them. What sets the pace of both is shared memory: an SM delivers 32
// values a clock to its lanes (a warp's 16-byte load takes 4 clocks, and
// lanes that read the same address pay all the same) against 128 FMAs, so
// a tile must load few values per FMA.
//
// Both have a float32 and a bfloat16 form (aanet_correlation_f32,
// aanet_correlation_bf16, aanet_correlation_backward_f32,
// aanet_correlation_backward_bf16).
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// Forward.
//
// Replaces aanet_tpu/ops/cost_volume.py:72 correlation_cost_volume (the
// banded-matmul formulation with _skew_band_extract; its plain form is
// correlation_cost_volume_reference).
//
// Bound: bytes. At the aanet train step's largest shape (L and R [16, 128,
// 96, 192], D = 64) it reads L and R once (151 MB each) and writes the
// volume (75 MB): 0.113 ms at 3.35 TB/s; the 2.0 G FMAs of the band take
// 0.060 ms at 67 TFLOP/s. The step's three scales: 0.113, 0.025 and 0.006
// ms; the inference forward's ([1, 128, 128, 416], D = 64, and its halves):
// 0.020, 0.005 and 0.001 ms. (The float32 form does its FMAs in float64,
// at half that rate: 0.120 ms at the largest shape, past the bytes; the
// bound is the function's, in float32.)
//
// Design: a block owns a row tile of `tw` columns of one (b, h) and all D
// disparities, so no FMA is spent on d >= D beyond the last disparity
// tile. A thread owns a register tile of FWD_CW = 4 columns x DD
// disparities (DD = 8 or 16, a template): per channel it reads its 4 left
// values (one 16-byte load) and the DD + 4 right values its tile needs
// (DD / 4 + 1 aligned 16-byte loads) for 4 * DD FMAs: 24 values for 64
// FMAs at DD = 16. The staging walks its rows without a division per
// copy, and the store multiplies by 1 / C (a division there takes a slow
// path of a few dozen instructions per value). Channels are walked in
// chunks: the next chunk's left tile [chunk][tw] and right window
// [chunk][tw + dtot] (columns w0 - dtot .. w0 + tw - 1, zero outside the
// image, so w < d comes out as exact zeros) are copied with cp.async (16
// bytes where the width is a multiple of 4) into a second buffer while the
// current one is contracted.
// `ksplit` groups of threads split a chunk's channels where the grid alone
// is short of the card; group 0 adds the others' tiles in a fixed order at
// the end (no atomics: the result is the same bits every launch). Each
// output row is written once, coalesced, in the [B, D, H, W] layout the
// aggregation convs read. The tiling is the plan of ops/cost_volume.py
// forward_plan; the kernel refuses a plan whose shared memory is not its
// layout's.
//
// The float32 form sums in float64: a product of two floats is exact in
// float64, and C of them (C < 2^20) add with a relative error below
// C * 2^-53, so the mean, C's float64 sum times 1 / C (both float64),
// rounds to float32 once and is the correctly rounded mean wherever it
// lies farther than that error from a tie between two floats. The plain
// version with `exact` (ops/cost_volume.py correlation_cost_volume_plain)
// computes the same float64 mean, so the two agree to the bit but at such
// ties and a kernel train step's forward equals the plain step's here:
// float32 sums in either order differ by an ulp or two, enough for some
// gradients of the step to change branch. The float64 tile takes twice
// the registers: the float32 form's blocks run one an SM
// (CORR_F32_MIN_BLOCKS), its FMAs at half the float32 rate, and its ksplit
// groups pass their float64 tiles through the partial space in two
// halves. The bf16 form is a kernel of its own, on the tensor cores
// (corr_fwd_mma_kernel, below).
// ---------------------------------------------------------------------------

// Calls f(r, q) for the units t, t + blockDim.x, ... of a rows x cols grid
// in row-major order (t = threadIdx.x), stepping (r, q) without a division
// per unit.
template <class F>
__device__ __forceinline__ void for_each_unit(int rows, int cols, F f) {
  const int dr = blockDim.x / cols, dq = blockDim.x % cols;
  for (int r = threadIdx.x / cols, q = threadIdx.x % cols; r < rows;) {
    f(r, q);
    r += dr;
    q += dq;
    if (q >= cols) {
      q -= cols;
      ++r;
    }
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

constexpr int FWD_CW = 4;             // columns of a thread's register tile
constexpr int FWD_LX = 8;             // neighbouring column groups of a warp
constexpr int FWD_MAX_THREADS = 256;  // __launch_bounds__: the largest block,
constexpr int FWD_MIN_BLOCKS = 1;     // and the blocks of that size an SM holds (float64 tiles)

// Words of the forward's shared memory: two buffers of a chunk's left tile
// [chunk][tw] and right window [chunk][tw + dtot]; the ksplit - 1 partial
// tiles [tw * dtot] of the final sum reuse the space.
inline int fwd_smem_words(int tw, int dtot, int chunk, int ksplit) {
  const int stage = 2 * chunk * (2 * tw + dtot);
  const int partial = (ksplit - 1) * tw * dtot;
  return stage > partial ? stage : partial;
}

template <int DD>
__global__ void __launch_bounds__(FWD_MAX_THREADS, FWD_MIN_BLOCKS)
corr_fwd_kernel(const float* __restrict__ left, const float* __restrict__ right,
                float* __restrict__ out, int channels, int height, int width, int max_disp,
                int tw, int ny, int ksplit, int chunk, bool vec) {
  extern __shared__ float4 corr_smem[];
  float* smem = reinterpret_cast<float*>(corr_smem);
  const int dtot = ny * DD;      // disparities of the block, D rounded up to DD
  const int rw = tw + dtot;      // right-window width
  const int stage_words = chunk * (tw + rw);
  const int group = (tw / FWD_CW) * ny;  // threads of one channel group

  // thread -> channel group k, disparity group y, column group x: a warp
  // holds FWD_LX neighbouring column groups of 32 / FWD_LX disparity groups
  const int k = threadIdx.x / group;
  const int t = threadIdx.x % group;
  const int y = (t / FWD_LX) % ny;
  const int x = t % FWD_LX + FWD_LX * (t / (FWD_LX * ny));

  const int w0 = blockIdx.x * tw;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long plane = static_cast<long long>(height) * width;
  const float* lrow = left + b * channels * plane + static_cast<long long>(h) * width;
  const float* rrow = right + b * channels * plane + static_cast<long long>(h) * width;
  const int r0 = w0 - dtot;  // image column of right-window slot 0

  // chunk n's left tile and right window into buffer n % 2, zero outside
  // the image and beyond the channels
  auto stage = [&](int n) {
    float* sl = smem + (n & 1) * stage_words;
    float* sr = sl + chunk * tw;
    const int c0 = n * chunk;
    if (vec) {  // a quad of columns lies wholly inside the row or outside
      for_each_unit(chunk, tw / 4, [&](int cc, int q) {
        const int w = w0 + 4 * q;
        const bool in = c0 + cc < channels && w < width;
        stage4(sl + cc * tw + 4 * q, in ? lrow + (c0 + cc) * plane + w : left, in);
      });
      for_each_unit(chunk, rw / 4, [&](int cc, int q) {
        const int w = r0 + 4 * q;
        const bool in = c0 + cc < channels && w >= 0 && w < width;
        stage4(sr + cc * rw + 4 * q, in ? rrow + (c0 + cc) * plane + w : right, in);
      });
    } else {
      for_each_unit(chunk, tw, [&](int cc, int q) {
        const int w = w0 + q;
        const bool in = c0 + cc < channels && w < width;
        stage1(sl + cc * tw + q, in ? lrow + (c0 + cc) * plane + w : left, in);
      });
      for_each_unit(chunk, rw, [&](int cc, int q) {
        const int w = r0 + q;
        const bool in = c0 + cc < channels && w >= 0 && w < width;
        stage1(sr + cc * rw + q, in ? rrow + (c0 + cc) * plane + w : right, in);
      });
    }
  };

  using Acc = double;
  Acc acc[FWD_CW][DD];
#pragma unroll
  for (int i = 0; i < FWD_CW; ++i) {
#pragma unroll
    for (int j = 0; j < DD; ++j) acc[i][j] = 0;
  }

  const int nchunks = (channels + chunk - 1) / chunk;
  if (nchunks > 0) {
    stage(0);
    cp_async_commit();
  }
  for (int n = 0; n < nchunks; ++n) {
    if (n + 1 < nchunks) {
      stage(n + 1);
      cp_async_commit();
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();
    // the thread's left quad and the start of its right window: window
    // value m is column w0 + 4x - (y + 1) DD + m, so (column i,
    // disparity y DD + j) takes value i - j + DD
    const float* sl = smem + (n & 1) * stage_words + FWD_CW * x;
    const float* sr = smem + (n & 1) * stage_words + chunk * tw + FWD_CW * x + (ny - 1 - y) * DD;
    const int nc = min(chunk, channels - n * chunk);
    for (int cc = k; cc < nc; cc += ksplit) {
      const float4 l4 = ld4(sl + cc * tw);
      const float l[FWD_CW] = {l4.x, l4.y, l4.z, l4.w};
      float r[DD + 4];
#pragma unroll
      for (int q = 0; q < DD / 4 + 1; ++q) {
        const float4 v = ld4(sr + cc * rw + 4 * q);
        r[4 * q] = v.x;
        r[4 * q + 1] = v.y;
        r[4 * q + 2] = v.z;
        r[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < FWD_CW; ++i) {
#pragma unroll
        for (int j = 0; j < DD; ++j) {
          acc[i][j] = fma(static_cast<Acc>(l[i]), static_cast<Acc>(r[i - j + DD]), acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  if (ksplit > 1) {  // the buffers are free: every thread passed the last barrier
    // the groups' tiles pass through the partial space in PASSES parts of
    // CPP columns each (float64 tiles take two words a value)
    constexpr int PASSES = sizeof(Acc) / sizeof(float), CPP = FWD_CW / PASSES;
    Acc* part = reinterpret_cast<Acc*>(smem) + t;
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      if (pass > 0) __syncthreads();  // group 0 has read the last part
      if (k > 0) {
#pragma unroll
        for (int i = 0; i < CPP; ++i) {
#pragma unroll
          for (int j = 0; j < DD; ++j) {
            part[((k - 1) * CPP * DD + i * DD + j) * group] = acc[pass * CPP + i][j];
          }
        }
      }
      __syncthreads();
      if (k == 0) {
        for (int kk = 1; kk < ksplit; ++kk) {
#pragma unroll
          for (int i = 0; i < CPP; ++i) {
#pragma unroll
            for (int j = 0; j < DD; ++j) {
              acc[pass * CPP + i][j] += part[((kk - 1) * CPP * DD + i * DD + j) * group];
            }
          }
        }
      }
    }
    if (k > 0) return;
  }

  const int w = w0 + FWD_CW * x;
  if (w >= width) return;
  float* ob = out + b * max_disp * plane + static_cast<long long>(h) * width + w;
  const Acc inv_c = Acc(1) / static_cast<Acc>(channels);
#pragma unroll
  for (int j = 0; j < DD; ++j) {
    const int d = y * DD + j;
    if (d < max_disp) {
      float* o = ob + d * plane;
      float m[FWD_CW];  // the means, each rounded to float32 once
#pragma unroll
      for (int i = 0; i < FWD_CW; ++i) m[i] = static_cast<float>(acc[i][j] * inv_c);
      if (vec) {
        store4_f32(o, make_float4(m[0], m[1], m[2], m[3]));
      } else {
#pragma unroll
        for (int i = 0; i < FWD_CW; ++i) {
          if (w + i < width) store_f32(o + i, m[i]);
        }
      }
    }
  }
}

int launch_corr_fwd(const float* left, const float* right, float* out, int batch, int channels,
                    int height, int width, int max_disp, int tw, int dd, int ksplit, int chunk,
                    int smem_bytes, cudaStream_t stream) {
  if (batch == 0 || height == 0 || width == 0 || max_disp == 0) return 0;
  if ((dd != 8 && dd != 16) || tw < FWD_CW * FWD_LX || tw % (FWD_CW * FWD_LX) != 0 ||
      ksplit < 1 || chunk < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ny = (max_disp + dd - 1) / dd;
  const int threads = (tw / FWD_CW) * ny * ksplit;
  if (threads > FWD_MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  if (fwd_smem_words(tw, ny * dd, chunk, ksplit) * 4 != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);  // the wrapper's plan has another layout
  }
  auto kernel = dd == 8 ? corr_fwd_kernel<8> : corr_fwd_kernel<16>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const bool vec = width % 4 == 0 && aligned16(left) && aligned16(right) && aligned16(out);
  dim3 grid((width + tw - 1) / tw, height, batch);
  kernel<<<grid, threads, smem_bytes, stream>>>(left, right, out, channels, height, width,
                                                 max_disp, tw, ny, ksplit, chunk, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// left, right: [batch, channels, height, width]; out: [batch, max_disp,
// height, width]; all float32. The plan (ops/cost_volume.py forward_plan):
// tw (columns of a block, a multiple of 4 * FWD_LX), dd (disparities of a
// thread's tile: 8 or 16), ksplit (thread groups that split a chunk's
// channels), chunk (channels staged at a time), and smem_bytes, the block's
// shared memory, which must be what this layout takes. Anything else is
// cudaErrorInvalidValue.
extern "C" int aanet_correlation_f32(const float* left, const float* right, float* out,
                                     int batch, int channels, int height, int width,
                                     int max_disp, int tw, int dd, int ksplit, int chunk,
                                     int smem_bytes, int device, void* stream) {
  cudaSetDevice(device);
  return launch_corr_fwd(left, right, out, batch, channels, height, width, max_disp, tw, dd,
                         ksplit, chunk, smem_bytes, static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// Forward, bf16, on the tensor cores.
//
// Replaces aanet_tpu/ops/cost_volume.py:72 correlation_cost_volume under a
// bf16 compute dtype: L, R and the volume in bfloat16, the products and
// sums in float32, the mean rounded to bf16 once. For one image row the
// volume is the band 0 <= w - w' < D of the product L^T . R over the
// channels (w a column of L and of the volume, w' a column of R).
//
// Bound: bytes. At the aanet bf16 step's three scales it reads L and R once
// and writes the volume: 0.072 ms at 3.35 TB/s. Its 5.5 GFLOP of products
// take 0.082 ms at the CUDA cores' 67 TFLOP/s, so no design on the CUDA
// cores reaches the bound; every product is bf16 x bf16, which the tensor
// cores take raw, and at the 220-300 TFLOP/s that mma.sync reached in the
// deform kernels they take about 0.02 ms. The form this replaces widened L
// and R to float32 through registers as it staged them (a load and a
// store, nothing in flight): 0.30 of its 0.48 ms at the aanet step.
//
// Design: a block owns a tile of tw output columns (a multiple of 16) of
// one (b, h) row and all D. Channels are walked in chunks (a multiple of
// 16): the next chunk's left tile [chunk][tw] and right window [chunk][tw +
// dtot] (columns w0 - dtot .. w0 + tw - 1, dtot = D rounded up to 8; zeros
// outside the image and beyond C, so w < d and a C off the chunks come out
// exact) are copied raw with cp.async into a second buffer while the
// current one is contracted (a ring of three or four buffers measured no
// faster): 16-byte copies where W is a multiple of 8, 8-byte ones where it
// is a multiple of 4, 4-byte ones where it is even (78, on psmnet-aa's
// path), a load and a store a value otherwise (only the edge shapes). A
// staged row is an odd number of 16-byte pieces (mma_row), so the 8
// channels an ldmatrix reads fall in different banks. Each warp owns 16
// output columns (the m16 of
// mma.sync.m16n8k16 bf16, float32 accumulators) and multiplies them only by
// the 8-column n-tiles of the window that meet its band: nt = ceil((D + 15)
// / 8) tiles (10 at D = 64: 80 % of the products are kept), split over ny
// warps of at most NTG tiles each (NTG: the build). A and B both come by
// ldmatrix.trans from the [channel][column] layout. The epilogue writes
// the band through shared memory: accumulator (m, n) of the n-tile at
// window slot s is disparity d = (wl + m) - (s + n - dtot) at column wl + m
// of the tile; it is scaled by 1/C in float32 and rounded to bf16 once;
// then the rows of [B, D, H, W] are written coalesced, each once. No
// channel split and no atomics: two launches give the same bits.
//
// mma.sync and not wgmma: the products are a fifth of the bytes' time even
// at mma.sync's rate, and wgmma's 64-row tiles would waste more of a banded
// 16 x (D + 16) contraction. The tiling is ops/cost_volume.py
// forward_plan_bf16; the kernel refuses a plan whose shared memory is not
// its layout's.
// ---------------------------------------------------------------------------
namespace {

constexpr int MMA_CW = 16;              // output columns of a warp (mma.sync's m16)
constexpr int MMA_K = 16;               // channels of a k-step
constexpr int MMA_MAX_THREADS = 256;    // __launch_bounds__: the largest block,
constexpr int MMA_MIN_BLOCKS = 2;       // and the blocks of that size an SM holds

// bf16 values of a staged row of n: an odd number of 16-byte pieces.
__host__ __device__ inline int mma_row(int n) {
  int pieces = (n + 7) / 8;
  if (pieces % 2 == 0) ++pieces;
  return 8 * pieces;
}

// Bytes of the bf16 forward's shared memory: two buffers of a chunk's left
// tile [chunk][mma_row(tw)] and right window [chunk][mma_row(tw + dtot)],
// raw bf16; the epilogue's band [max_disp][mma_row(tw)] reuses them.
inline int fwd_mma_smem_bytes(int tw, int max_disp, int chunk) {
  const int dtot = (max_disp + 7) / 8 * 8;
  const int stage = 2 * chunk * (mma_row(tw) + mma_row(tw + dtot));
  const int band = max_disp * mma_row(tw);
  return 2 * (stage > band ? stage : band);
}

// `piece` raw bf16 values (8, 4, 2 or 1) from src into shared memory, zeros
// where !in (src is then not read but must be a valid address): by one
// cp.async of 16, 8 or 4 bytes (both ends aligned to its size), or a load
// and a store.
__device__ __forceinline__ void stage_piece(bf16* dst, const bf16* src, bool in, int piece) {
  if (piece == 8) {
    cp_async_16(dst, src, in ? 16 : 0);
  } else if (piece == 4) {
    cp_async_8(dst, src, in ? 8 : 0);
  } else if (piece == 2) {
    cp_async_4(dst, src, in ? 4 : 0);
  } else {
    *dst = in ? *src : __ushort_as_bfloat16(0);
  }
}

// `piece` bf16 values from shared memory to dst, one store, both ends
// aligned to its size.
__device__ __forceinline__ void copy_piece(bf16* dst, const bf16* src, int piece) {
  if (piece == 8) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
  } else if (piece == 4) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else if (piece == 2) {
    *reinterpret_cast<unsigned*>(dst) = *reinterpret_cast<const unsigned*>(src);
  } else {
    *dst = *src;
  }
}

// The values a copy of a bf16 kernel's rows: 8 where W is a multiple of 8
// and every pointer 16-byte aligned, 4 where W is a multiple of 4 and every
// pointer 8-byte aligned, 2 where W is even and every pointer 4-byte
// aligned, else 1 (rows of W values start at a multiple of W).
template <typename... P>
int mma_piece(int width, const P*... ptrs) {
  const auto aligned = [&](unsigned long long bytes) {
    return ((reinterpret_cast<unsigned long long>(ptrs) % bytes == 0) && ...);
  };
  return width % 8 == 0 && aligned(16)  ? 8
         : width % 4 == 0 && aligned(8) ? 4
         : width % 2 == 0 && aligned(4) ? 2
                                        : 1;
}

template <int NTG>
__global__ void __launch_bounds__(MMA_MAX_THREADS, MMA_MIN_BLOCKS)
corr_fwd_mma_kernel(const bf16* __restrict__ left, const bf16* __restrict__ right,
                    bf16* __restrict__ out, int channels, int height, int width, int max_disp,
                    int tw, int chunk, int ls, int rs, int piece) {
  extern __shared__ float4 corr_smem[];
  bf16* smem = reinterpret_cast<bf16*>(corr_smem);
  const int dtot = (max_disp + 7) / 8 * 8;
  const int nt = (max_disp + 15 + 7) / 8;  // n-tiles of a warp's band
  const int stage_elems = chunk * (ls + rs);

  // warp -> its 16 columns wl .. wl + 15 of the tile (x) and its n-tiles
  // j0 .. j0 + ntw - 1 (y); window slot s0 is n-tile 0's first column
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nx = tw / MMA_CW;
  const int wl = MMA_CW * (warp % nx);
  const int j0 = NTG * (warp / nx);
  const int ntw = min(NTG, nt - j0);
  const int s0 = wl + dtot + MMA_CW - 8 * nt;

  const int w0 = blockIdx.x * tw;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long plane = static_cast<long long>(height) * width;
  const bf16* lrow = left + b * channels * plane + static_cast<long long>(h) * width;
  const bf16* rrow = right + b * channels * plane + static_cast<long long>(h) * width;

  // chunk n's left tile and right window into buffer n % 2, raw, zero
  // outside the image and beyond the channels: `cols` columns from image
  // column `first` into rows of `stride`, `piece` values a copy
  auto stage = [&](int n) {
    bf16* sl = smem + (n & 1) * stage_elems;
    const int c0 = n * chunk;
    auto rows = [&](bf16* dst0, int stride, const bf16* row, const bf16* any, int first,
                    int cols) {
      for_each_unit(chunk, cols / piece, [&](int cc, int q) {
        const int w = first + piece * q;
        const bool in = c0 + cc < channels && w >= 0 && w < width;
        stage_piece(dst0 + cc * stride + piece * q, in ? row + (c0 + cc) * plane + w : any, in,
                    piece);
      });
    };
    rows(sl, ls, lrow, left, w0, tw);
    rows(sl + chunk * ls, rs, rrow, right, w0 - dtot, tw + dtot);
  };

  // the lane's ldmatrix rows: A's four matrices are channels 0-7 and 8-15
  // by columns wl .. wl + 7 and wl + 8 .. wl + 15 (a0 .. a3); B's are, for
  // two n-tiles, channels 0-7 and 8-15 of the first (b0, b1), then of the
  // second (.x2: lanes 0 .. 15, the first only)
  const int lr = lane & 7, li = lane >> 3;
  const int a_off = ((li >> 1) * 8 + lr) * ls + wl + 8 * (li & 1);
  const int b_off = ((li & 1) * 8 + lr) * rs + s0 + 8 * j0 + 8 * (li >> 1);

  float acc[NTG][4];
#pragma unroll
  for (int j = 0; j < NTG; ++j) {
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
  }

  const int nchunks = (channels + chunk - 1) / chunk;
  if (nchunks > 0) {
    stage(0);
    cp_async_commit();
  }
  for (int n = 0; n < nchunks; ++n) {
    if (n + 1 < nchunks) {
      stage(n + 1);
      cp_async_commit();
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();
    const bf16* sa = smem + (n & 1) * stage_elems + a_off;
    const bf16* sb = smem + (n & 1) * stage_elems + chunk * ls + b_off;
    for (int k = 0; k < chunk; k += MMA_K) {
      unsigned a[4];
      ldmatrix_x4_trans(a, sa + k * ls);
#pragma unroll
      for (int j = 0; j < NTG; j += 2) {
        if (j + 1 < ntw) {
          unsigned bq[4];
          ldmatrix_x4_trans(bq, sb + k * rs + 8 * j);
          mma_bf16(acc[j], a, bq[0], bq[1]);
          mma_bf16(acc[j + 1], a, bq[2], bq[3]);
        } else if (j < ntw) {
          unsigned b0, b1;
          ldmatrix_x2_trans(b0, b1, sb + k * rs + 8 * j);
          mma_bf16(acc[j], a, b0, b1);
        }
      }
    }
    __syncthreads();
  }

  // the band [max_disp][ls] in the buffers' space (every warp has passed
  // the last barrier): lane (g, t) holds columns wl + g and wl + g + 8 by
  // window slots 2t, 2t + 1 of each n-tile
  bf16* band = smem;
  const float inv_c = 1.f / static_cast<float>(channels);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NTG; ++j) {
    if (j < ntw) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = g + 8 * (r >> 1);
        const int d = wl + m + dtot - (s0 + 8 * (j0 + j) + 2 * t + (r & 1));
        if (d >= 0 && d < max_disp) band[d * ls + wl + m] = __float2bfloat16_rn(acc[j][r] * inv_c);
      }
    }
  }
  __syncthreads();
  bf16* ob = out + b * max_disp * plane + static_cast<long long>(h) * width + w0;
  const int ncol = min(tw, width - w0);
  for_each_unit(max_disp, tw / piece, [&](int d, int q) {
    const int j = piece * q;
    if (j >= ncol) return;
    copy_piece(ob + d * plane + j, band + d * ls + j, piece);
  });
}

using CorrMmaKernel = void (*)(const bf16*, const bf16*, bf16*, int, int, int, int, int, int,
                               int, int, int);

// The builds, by NTG (n-tiles of a warp at most): 2, 4, .., 16
constexpr int MMA_NTG_MAX = 16;
const CorrMmaKernel corr_fwd_mma_builds[] = {
    corr_fwd_mma_kernel<2>,  corr_fwd_mma_kernel<4>,  corr_fwd_mma_kernel<6>,
    corr_fwd_mma_kernel<8>,  corr_fwd_mma_kernel<10>, corr_fwd_mma_kernel<12>,
    corr_fwd_mma_kernel<14>, corr_fwd_mma_kernel<16>,
};

int launch_corr_fwd_mma(const bf16* left, const bf16* right, bf16* out, int batch, int channels,
                        int height, int width, int max_disp, int tw, int chunk, int ntg,
                        int smem_bytes, cudaStream_t stream) {
  if (batch == 0 || height == 0 || width == 0 || max_disp == 0) return 0;
  if (tw < MMA_CW || tw % MMA_CW != 0 || chunk < MMA_K || chunk % MMA_K != 0 || ntg < 2 ||
      ntg > MMA_NTG_MAX || ntg % 2 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nt = (max_disp + 15 + 7) / 8;
  const int threads = 32 * (tw / MMA_CW) * ((nt + ntg - 1) / ntg);
  if (threads > MMA_MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  if (fwd_mma_smem_bytes(tw, max_disp, chunk) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);  // the wrapper's plan has another layout
  }
  const CorrMmaKernel kernel = corr_fwd_mma_builds[ntg / 2 - 1];
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int piece = mma_piece(width, left, right, out);
  const int dtot = (max_disp + 7) / 8 * 8;
  dim3 grid((width + tw - 1) / tw, height, batch);
  kernel<<<grid, threads, smem_bytes, stream>>>(left, right, out, channels, height, width, max_disp,
                                                tw, chunk, mma_row(tw), mma_row(tw + dtot), piece);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 form, on the tensor cores: left, right and out bfloat16, the
// rest as aanet_correlation_f32's but the plan (ops/cost_volume.py
// forward_plan_bf16): tw (columns of a block, a multiple of 16), chunk
// (channels staged at a time, a multiple of 16), ntg (the build: n-tiles of
// a warp at most, even, 2 .. 16) and smem_bytes, which must be this
// layout's. Anything else is cudaErrorInvalidValue.
extern "C" int aanet_correlation_bf16(const bf16* left, const bf16* right, bf16* out,
                                      int batch, int channels, int height, int width,
                                      int max_disp, int tw, int chunk, int ntg, int smem_bytes,
                                      int device, void* stream) {
  cudaSetDevice(device);
  return launch_corr_fwd_mma(left, right, out, batch, channels, height, width, max_disp, tw,
                             chunk, ntg, smem_bytes, static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// Backward: with g = d loss / d cost,
//   dL[c, h, w]  = (1/C) sum_d g[d, h, w]      * R[c, h, w - d]   (w >= d)
//   dR[c, h, w'] = (1/C) sum_d g[d, h, w' + d] * L[c, h, w' + d]  (w'+d < W)
// the transposes jax.grad derives for correlation_cost_volume (XLA's
// transpose of aanet_tpu/ops/cost_volume.py:72). Where the forward wrote
// its zeros (w < d), g does not reach either input.
//
// Bound: bytes. At the aanet train step's largest shape it reads g (75 MB),
// L and R and writes dL and dR (151 MB each): 0.203 ms at 3.35 TB/s; its 4.0
// G FMAs take 0.121 ms at 67 TFLOP/s. The step's three scales: 0.203, 0.048
// and 0.012 ms.
//
// Design: one pass, each output written once, no atomics. A block owns a
// tile of `bw` columns of one (b, h) row, all channels and all D. It stages
// the gradient rows once: g[d][w0 .. w0+bw) for dL and the skewed copy
// g[d][w0+d .. w0+d+bw) for dR (both zero for d >= D and beyond the row),
// so a thread's columns of either are one aligned 16-byte load. It walks
// the channels in chunks, the next chunk's right window (columns w0 - dtot
// .. w0 + bw - 1) and left window (w0 .. w0 + bw + dtot - 1), zero outside
// the image, copied with cp.async into a second buffer while the current
// chunk runs. The first half of the block's warps sums dL, the second dR: a
// thread keeps BWD_CC = 8 channels x BWD_CW = 4 columns of one gradient in
// registers and sums all D disparities there. Over d its window slides by
// one value per channel and step, taken four at a time as one 16-byte load
// per channel; each g quad serves all 8 channels. A lane pays for every
// value it loads from shared memory (an SM delivers 32 a clock, against 128
// FMAs), so the tile's 48 values per 128 FMAs set the pace, where a tile of
// both gradients (4 x 4 each, the same 32 sums) loads 64. Then dL and dR
// are written once, coalesced. The tiling is the plan of ops/cost_volume.py
// backward_plan; the kernel refuses a plan whose shared memory is not its
// layout's. The bf16 form is a kernel of its own, on the tensor cores
// (corr_bwd_mma_kernel, below).
// ---------------------------------------------------------------------------
namespace {

constexpr int BWD_CW = 4;             // columns of a thread's register tile
constexpr int BWD_CC = 8;             // channels of a thread's register tile
constexpr int BWD_LX = 8;             // neighbouring column groups of a warp
constexpr int BWD_DSTEP = 8;          // disparities of one trip of the slide (two turns)
constexpr int BWD_MAX_THREADS = 256;  // __launch_bounds__: the largest block,
constexpr int BWD_MIN_BLOCKS = 2;     // and the blocks of that size an SM holds

// Words of the backward's shared memory: the two gradient tiles [dtot][bw]
// and two buffers of a chunk's right and left windows [chunk][bw + dtot].
inline int bwd_smem_words(int bw, int dtot, int chunk) {
  return 2 * dtot * bw + 2 * 2 * chunk * (bw + dtot);
}

// Four disparities d0 .. d0 + 3 of dL for BWD_CC channels: the right
// window [rn, ro] is columns w - d0 - 4 .. w - d0 + 3 of the thread's first
// column w; g quads at g + d * bw.
__device__ __forceinline__ void turn_left(float (&acc)[BWD_CC][BWD_CW], const float* g, int bw,
                                          int d0, const float4 (&rn)[BWD_CC],
                                          const float4 (&ro)[BWD_CC]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float4 a = ld4(g + (d0 + e) * bw);
    const float ga[BWD_CW] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int q = 0; q < BWD_CC; ++q) {
      const float r[8] = {rn[q].x, rn[q].y, rn[q].z, rn[q].w, ro[q].x, ro[q].y, ro[q].z, ro[q].w};
#pragma unroll
      for (int i = 0; i < BWD_CW; ++i) acc[q][i] = fmaf(ga[i], r[4 + i - e], acc[q][i]);
    }
  }
}

// The same for dR: the left window [lc, ln] is columns w + d0 .. w + d0 + 7;
// g quads (the skewed copy) at g + d * bw.
__device__ __forceinline__ void turn_right(float (&acc)[BWD_CC][BWD_CW], const float* g, int bw,
                                           int d0, const float4 (&lc)[BWD_CC],
                                           const float4 (&ln)[BWD_CC]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float4 a = ld4(g + (d0 + e) * bw);
    const float ga[BWD_CW] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int q = 0; q < BWD_CC; ++q) {
      const float l[8] = {lc[q].x, lc[q].y, lc[q].z, lc[q].w, ln[q].x, ln[q].y, ln[q].z, ln[q].w};
#pragma unroll
      for (int i = 0; i < BWD_CW; ++i) acc[q][i] = fmaf(ga[i], l[i + e], acc[q][i]);
    }
  }
}

__global__ void __launch_bounds__(BWD_MAX_THREADS, BWD_MIN_BLOCKS)
corr_bwd_kernel(const float* __restrict__ grad, const float* __restrict__ left,
                const float* __restrict__ right, float* __restrict__ grad_left,
                float* __restrict__ grad_right, int channels, int height, int width,
                int max_disp, int bw, int dtot, int chunk, bool vec) {
  extern __shared__ float4 corr_smem[];
  float* smem = reinterpret_cast<float*>(corr_smem);
  const int ncg = chunk / BWD_CC;  // channel groups
  const int ww = bw + dtot;        // window width
  float* s_gl = smem;                   // [dtot][bw]: g[d][w0 + j]
  float* s_gr = smem + dtot * bw;       // [dtot][bw]: g[d][w0 + j + d]
  float* s_win = smem + 2 * dtot * bw;  // two buffers of {R [chunk][ww], L [chunk][ww]}
  const int stage_words = 2 * chunk * ww;

  // thread -> gradient (0: dL, 1: dR; whole warps), channel group cg,
  // column group x: a warp holds BWD_LX neighbouring column groups of
  // 32 / BWD_LX channel groups
  const int per_side = (bw / BWD_CW) * ncg;
  const int side = threadIdx.x / per_side;
  const int t = threadIdx.x % per_side;
  const int cg = (t / BWD_LX) % ncg;
  const int x = t % BWD_LX + BWD_LX * (t / (BWD_LX * ncg));

  const int w0 = blockIdx.x * bw;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long plane = static_cast<long long>(height) * width;
  const long long row = static_cast<long long>(h) * width;
  const float* gb = grad + b * max_disp * plane + row;
  const float* lb = left + b * channels * plane + row;
  const float* rb = right + b * channels * plane + row;

  // the gradient tiles, once
  for_each_unit(dtot, bw / 4, [&](int d, int q) {
    const int j = 4 * q, w = w0 + j;
    float* dst_l = s_gl + d * bw + j;
    float* dst_r = s_gr + d * bw + j;
    if (vec) {
      const bool in = d < max_disp && w < width;
      stage4(dst_l, in ? gb + d * plane + w : grad, in);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = d < max_disp && w + i < width;
        stage1(dst_l + i, in ? gb + d * plane + w + i : grad, in);
      }
    }
    if (vec && d % 4 == 0) {
      const bool in = d < max_disp && w + d < width;
      stage4(dst_r, in ? gb + d * plane + w + d : grad, in);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool in = d < max_disp && w + d + i < width;
        stage1(dst_r + i, in ? gb + d * plane + w + d + i : grad, in);
      }
    }
  });

  // chunk n's windows into buffer n % 2: R slot s is column w0 - dtot + s,
  // L slot s column w0 + s; zero outside the image and beyond the channels
  auto stage = [&](int n) {
    float* sr = s_win + (n & 1) * stage_words;
    float* sl = sr + chunk * ww;
    const int c0 = n * chunk;
    if (vec) {  // a quad of columns lies wholly inside the row or outside
      for_each_unit(chunk, ww / 4, [&](int cc, int q) {
        const int s = 4 * q, c = c0 + cc, wr = w0 - dtot + s, wl = w0 + s;
        const bool rin = c < channels && wr >= 0 && wr < width;
        const bool lin = c < channels && wl < width;
        stage4(sr + cc * ww + s, rin ? rb + c * plane + wr : right, rin);
        stage4(sl + cc * ww + s, lin ? lb + c * plane + wl : left, lin);
      });
    } else {
      for_each_unit(chunk, ww, [&](int cc, int s) {
        const int c = c0 + cc, wr = w0 - dtot + s, wl = w0 + s;
        const bool rin = c < channels && wr >= 0 && wr < width;
        const bool lin = c < channels && wl < width;
        stage1(sr + cc * ww + s, rin ? rb + c * plane + wr : right, rin);
        stage1(sl + cc * ww + s, lin ? lb + c * plane + wl : left, lin);
      });
    }
  };

  const int nchunks = (channels + chunk - 1) / chunk;
  stage(0);
  cp_async_commit();  // with the gradient tiles
  const float inv_c = 1.f / static_cast<float>(channels);
  const float* g = (side == 0 ? s_gl : s_gr) + BWD_CW * x;
  float* out = (side == 0 ? grad_left : grad_right) + b * channels * plane + row;
  for (int n = 0; n < nchunks; ++n) {
    if (n + 1 < nchunks) {
      stage(n + 1);
      cp_async_commit();
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();
    // the thread's window rows: R for dL, L for dR
    const float* win = s_win + (n & 1) * stage_words + (side * chunk + cg * BWD_CC) * ww + BWD_CW * x;
    float acc[BWD_CC][BWD_CW];
    float4 a[BWD_CC], z[BWD_CC];
#pragma unroll
    for (int q = 0; q < BWD_CC; ++q) {
#pragma unroll
      for (int i = 0; i < BWD_CW; ++i) acc[q][i] = 0.f;
    }
    // two turns a trip, the registers swapping roles
    if (side == 0) {
#pragma unroll
      for (int q = 0; q < BWD_CC; ++q) a[q] = ld4(win + q * ww + dtot);  // columns w .. w + 3
      for (int d0 = 0; d0 < dtot; d0 += BWD_DSTEP) {
#pragma unroll
        for (int q = 0; q < BWD_CC; ++q) z[q] = ld4(win + q * ww + dtot - d0 - 4);
        turn_left(acc, g, bw, d0, z, a);
#pragma unroll
        for (int q = 0; q < BWD_CC; ++q) a[q] = ld4(win + q * ww + dtot - d0 - 8);
        turn_left(acc, g, bw, d0 + 4, a, z);
      }
    } else {
#pragma unroll
      for (int q = 0; q < BWD_CC; ++q) a[q] = ld4(win + q * ww);  // columns w .. w + 3
      for (int d0 = 0; d0 < dtot; d0 += BWD_DSTEP) {
#pragma unroll
        for (int q = 0; q < BWD_CC; ++q) z[q] = ld4(win + q * ww + d0 + 4);
        turn_right(acc, g, bw, d0, a, z);
#pragma unroll
        for (int q = 0; q < BWD_CC; ++q) a[q] = ld4(win + q * ww + d0 + 8);
        turn_right(acc, g, bw, d0 + 4, z, a);
      }
    }
    const int w = w0 + BWD_CW * x;
    if (w < width) {
#pragma unroll
      for (int q = 0; q < BWD_CC; ++q) {
        const int c = n * chunk + cg * BWD_CC + q;
        if (c >= channels) continue;
        float* o = out + c * plane + w;
        if (vec) {
          store4_f32(o, make_float4(acc[q][0] * inv_c, acc[q][1] * inv_c, acc[q][2] * inv_c,
                                    acc[q][3] * inv_c));
        } else {
#pragma unroll
          for (int i = 0; i < BWD_CW; ++i) {
            if (w + i < width) store_f32(o + i, acc[q][i] * inv_c);
          }
        }
      }
    }
    __syncthreads();
  }
}

// D = 0: a volume of no disparities passes no gradient.
template <typename T>
int zero_gradients(T* grad_left, T* grad_right, int batch, int channels, int height, int width,
                   cudaStream_t stream) {
  const size_t bytes = sizeof(T) * batch * channels * height * static_cast<size_t>(width);
  cudaMemsetAsync(grad_left, 0, bytes, stream);
  cudaMemsetAsync(grad_right, 0, bytes, stream);
  return static_cast<int>(cudaGetLastError());
}

int launch_corr_bwd(const float* grad, const float* left, const float* right, float* grad_left,
                    float* grad_right, int batch, int channels, int height, int width,
                    int max_disp, int bw, int chunk, int smem_bytes, cudaStream_t stream) {
  if (batch == 0 || height == 0 || width == 0 || channels == 0) return 0;
  if (max_disp == 0) return zero_gradients(grad_left, grad_right, batch, channels, height, width, stream);
  if (bw < BWD_CW * BWD_LX || bw % (BWD_CW * BWD_LX) != 0 || chunk < BWD_CC ||
      chunk % BWD_CC != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 2 * (bw / BWD_CW) * (chunk / BWD_CC);
  if (threads > BWD_MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  const int dtot = (max_disp + BWD_DSTEP - 1) / BWD_DSTEP * BWD_DSTEP;
  if (bwd_smem_words(bw, dtot, chunk) * static_cast<int>(sizeof(float)) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);  // the wrapper's plan has another layout
  }
  const cudaError_t attr =
      cudaFuncSetAttribute(corr_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const bool vec = width % 4 == 0 && aligned16(grad) && aligned16(left) && aligned16(right) &&
                   aligned16(grad_left) && aligned16(grad_right);
  dim3 grid((width + bw - 1) / bw, height, batch);
  corr_bwd_kernel<<<grid, threads, smem_bytes, stream>>>(grad, left, right, grad_left, grad_right,
                                                         channels, height, width, max_disp, bw,
                                                         dtot, chunk, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// grad: [batch, max_disp, height, width]; left, right, grad_left,
// grad_right: [batch, channels, height, width]; all float32. The gradients
// are written in full. The plan (ops/cost_volume.py backward_plan): bw
// (columns of a block, a multiple of 4 * BWD_LX), chunk (channels staged at
// a time, a multiple of BWD_CC), and smem_bytes, the block's shared memory,
// which must be what this layout takes. Anything else is
// cudaErrorInvalidValue. With max_disp == 0 the plan is not read.
extern "C" int aanet_correlation_backward_f32(const float* grad, const float* left,
                                              const float* right, float* grad_left,
                                              float* grad_right, int batch, int channels,
                                              int height, int width, int max_disp, int bw,
                                              int chunk, int smem_bytes, int device,
                                              void* stream) {
  cudaSetDevice(device);
  return launch_corr_bwd(grad, left, right, grad_left, grad_right, batch, channels, height,
                         width, max_disp, bw, chunk, smem_bytes, static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// Backward, bf16, on the tensor cores.
//
// Replaces XLA's transpose of aanet_tpu/ops/cost_volume.py:72 under a bf16
// compute dtype: g, L, R, dL and dR in bfloat16, the products and sums in
// float32, each gradient scaled by 1/C and rounded to bf16 once. For one
// (b, h) row both gradients are products of one banded matrix,
// G[w, w'] = g[w - w', w] for 0 <= w - w' < D (0 elsewhere), with the
// feature rows:
//   dL^T[w, c]  = (1/C) sum_w' G[w, w'] R^T[w', c]
//   dR^T[w', c] = (1/C) sum_w  G[w, w'] L^T[w, c]
// the forward's band, transposed.
//
// Bound: bytes. At the aanet bf16 step's three scales it reads g, L and R
// once and writes dL and dR: 0.131 ms at 3.35 TB/s. Its 11 GFLOP of
// products, all bf16 x bf16, take 0.16 ms at the CUDA cores' 67 TFLOP/s
// (the form this replaces, the float32 design's FMAs on widened values,
// read 0.51 ms) and about 0.04 ms at the 220-300 TFLOP/s that mma.sync
// reached in the deform kernels.
//
// Design: a block owns a tile of tw output columns (a multiple of 16) of
// one (b, h) row, all channels and all D, for both gradients; the first
// half of its warps computes dL, the second dR, each warp 16 output
// columns (the m16 of mma.sync.m16n8k16 bf16, float32 accumulators) by a
// chunk's channels (n). The contraction runs over window columns (k) in
// nk = ceil((D + 15) / 16) k-steps of 16, the band's reach from the
// warp's columns, rounded: the right window for dL holds columns w0 - dtot
// .. w0 + tw - 1 and the left window for dR columns w0 .. w0 + tw + dtot -
// 1, dtot = 16 (nk - 1) >= D - 1, so warp j's k-steps start at window slot
// j in both. The block first builds the band once in shared memory, as two
// matrices in the layout an ldmatrix reads: row j of GL (dL's A) holds
// column u of warp j / 16's k-steps, g[jj + dtot - u][w0 + j], and row j
// of GR (dR's A, the skewed form) g[u - jj][w0 + j - jj + u] (jj = j %
// 16); zero off the band and beyond the row. Each entry comes from one
// coalesced 2-byte load of g (the unskewed tile g[d][w0 + j] and the
// skewed one g[d][w0 + j + d]), a thread's loads of 8 disparities in
// flight at once, and is stored once. Channels are walked in chunks; the
// windows are copied raw with cp.async into two buffers, chunks 0 and 1
// while the band is built, chunk n + 2 as soon as chunk n is contracted
// (16-, 8- or 4-byte copies as W allows, a load and a store a value for
// odd W). Every staged
// row is an odd number of 16-byte pieces (mma_row), so the 8 rows an
// ldmatrix reads fall in different banks. A comes from the band by
// ldmatrix, B from the window's [channel][column] rows by ldmatrix (no
// transpose: the window columns are the contraction). The epilogue scales
// by 1/C in float32, rounds to bf16 once and writes the chunk's dL and dR
// tiles through shared memory, then as coalesced rows of [B, C, H, W],
// each value once. No channel split and no atomics: two launches give the
// same bits.
//
// mma.sync and not wgmma, for the forward's reason: a banded 16 x (D + 16)
// contraction wastes wgmma's 64-row tiles. The tiling is
// ops/cost_volume.py backward_plan_bf16; the kernel refuses a plan whose
// shared memory is not its layout's.
// ---------------------------------------------------------------------------
namespace {

constexpr int BMMA_CW = 16;            // output columns of a warp (mma.sync's m16)
constexpr int BMMA_K = 16;             // window columns of a k-step
constexpr int BMMA_MAX_THREADS = 512;  // __launch_bounds__: the largest block,
constexpr int BMMA_MIN_BLOCKS = 1;     // and the blocks of that size an SM holds
constexpr int BAND_BATCH = 8;          // disparities of a thread's band loads in flight

// k-steps of a warp's band: ceil((D + 15) / 16).
__host__ __device__ inline int bwd_mma_steps(int max_disp) { return (max_disp + 30) / BMMA_K; }

// Bytes of the bf16 backward's shared memory: two buffers of a chunk's
// right and left windows [chunk][mma_row(tw + dtot)], the two band
// matrices [tw][mma_row(16 nk)] and the chunk's dL and dR tiles
// [chunk][mma_row(tw)], raw bf16.
inline int bwd_mma_smem_bytes(int tw, int max_disp, int chunk) {
  const int nk = bwd_mma_steps(max_disp), dtot = BMMA_K * (nk - 1);
  return 2 * (2 * 2 * chunk * mma_row(tw + dtot) + 2 * tw * mma_row(BMMA_K * nk) +
              2 * chunk * mma_row(tw));
}

template <int CHUNK>
__global__ void __launch_bounds__(BMMA_MAX_THREADS, BMMA_MIN_BLOCKS)
corr_bwd_mma_kernel(const bf16* __restrict__ grad, const bf16* __restrict__ left,
                    const bf16* __restrict__ right, bf16* __restrict__ grad_left,
                    bf16* __restrict__ grad_right, int channels, int height, int width,
                    int max_disp, int tw, int piece) {
  extern __shared__ float4 corr_smem[];
  bf16* smem = reinterpret_cast<bf16*>(corr_smem);
  const int nk = bwd_mma_steps(max_disp), span = BMMA_K * nk, dtot = span - BMMA_K;
  const int lw = mma_row(tw + dtot), lg = mma_row(span), lo = mma_row(tw);
  const int stage_elems = 2 * CHUNK * lw;  // a buffer: R [CHUNK][lw], then L
  bf16* s_band = smem + 2 * stage_elems;   // GL [tw][lg], then GR
  bf16* s_out = s_band + 2 * tw * lg;      // dL [CHUNK][lo], then dR

  // warp -> its gradient (0: dL, 1: dR) and its 16 columns jw .. jw + 15
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nx = tw / BMMA_CW;
  const int side = warp / nx;
  const int jw = BMMA_CW * (warp % nx);

  const int w0 = blockIdx.x * tw;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long plane = static_cast<long long>(height) * width;
  const long long row = static_cast<long long>(h) * width;
  const bf16* gb = grad + b * max_disp * plane + row;
  const bf16* lb = left + b * channels * plane + row;
  const bf16* rb = right + b * channels * plane + row;

  // chunk n's right window (slot s: column w0 - dtot + s) and left window
  // (slot s: column w0 + s) into buffer n % 2, raw, zero outside the image
  // and beyond the channels, `piece` values a copy
  auto stage = [&](int n) {
    bf16* buf = smem + (n & 1) * stage_elems;
    const int c0 = n * CHUNK;
    auto rows = [&](bf16* dst0, const bf16* base, const bf16* any, int first) {
      for_each_unit(CHUNK, (tw + dtot) / piece, [&](int cc, int q) {
        const int w = first + piece * q;
        const bool in = c0 + cc < channels && w >= 0 && w < width;
        stage_piece(dst0 + cc * lw + piece * q, in ? base + (c0 + cc) * plane + w : any, in, piece);
      });
    };
    rows(buf, rb, right, w0 - dtot);
    rows(buf + CHUNK * lw, lb, left, w0);
  };

  // chunks 0 and 1 in flight while the band is built
  const int nchunks = (channels + CHUNK - 1) / CHUNK;
  stage(0);
  cp_async_commit();
  if (nchunks > 1) {
    stage(1);
    cp_async_commit();
  }

  // the band, once: row j of GL holds d = jj + dtot - u at column u, row j
  // of GR d = u - jj (jj = j % 16); over a row's span of 16 nk columns
  // that is -15 <= d < span. Thread (q, j) loads column j's gradient at d
  // = q, q + nq, ... < D of both tiles, the unskewed g[d][w0 + j] and the
  // skewed g[d][w0 + j + d] (coalesced 2-byte loads, zero beyond the row),
  // BAND_BATCH of each in flight before it stores them; then the entries
  // of d off the band are zeroed. Every (j, u < span) is written once.
  unsigned short* band = reinterpret_cast<unsigned short*>(s_band);
  const unsigned short* graw = reinterpret_cast<const unsigned short*>(gb);
  {
    const int nq = blockDim.x / tw, j = threadIdx.x % tw, jj = j & (BMMA_CW - 1);
    for (int d0 = threadIdx.x / tw; d0 < max_disp; d0 += nq * BAND_BATCH) {
      unsigned short vl[BAND_BATCH], vr[BAND_BATCH];
#pragma unroll
      for (int i = 0; i < BAND_BATCH; ++i) {
        const int d = d0 + nq * i;
        const long long at = d * plane + w0 + j;
        vl[i] = d < max_disp && w0 + j < width ? __ldg(graw + at) : 0;
        vr[i] = d < max_disp && w0 + j + d < width ? __ldg(graw + at + d) : 0;
      }
#pragma unroll
      for (int i = 0; i < BAND_BATCH; ++i) {
        const int d = d0 + nq * i;
        if (d < max_disp) {
          band[j * lg + jj + dtot - d] = vl[i];
          band[(tw + j) * lg + jj + d] = vr[i];
        }
      }
    }
  }
  for_each_unit(span - max_disp + 15, tw, [&](int r, int j) {
    const int d = r < 15 ? r - 15 : max_disp + r - 15, jj = j & (BMMA_CW - 1);
    if (jj + dtot - d >= 0 && jj + dtot - d < span) band[j * lg + jj + dtot - d] = 0;
    if (jj + d >= 0 && jj + d < span) band[(tw + j) * lg + jj + d] = 0;
  });

  // the lane's ldmatrix rows: A's four matrices are the warp's columns 0-7
  // and 8-15 by band columns 0-7 (a0, a1), then 8-15 (a2, a3); B's are, for
  // two n-tiles, channels 0-7 by window columns 0-7 and 8-15 (b0, b1 of the
  // first), then channels 8-15
  const int lr = lane & 7, li = lane >> 3;
  const bf16* sa = s_band + (side * tw + jw + lr + 8 * (li & 1)) * lg + 8 * (li >> 1);
  const int b_off = (side * CHUNK + lr + 8 * (li >> 1)) * lw + jw + 8 * (li & 1);
  // the lane's accumulators: (g, t) holds columns jw + g and jw + g + 8 by
  // channels 2t, 2t + 1 of each n-tile
  const int g = lane >> 2, t = lane & 3;
  const float inv_c = 1.f / static_cast<float>(channels);
  bf16* so = s_out + side * CHUNK * lo + jw + g;

  for (int n = 0; n < nchunks; ++n) {
    if (n + 1 < nchunks) {
      cp_async_wait_group<1>();
    } else {
      cp_async_wait_group<0>();
    }
    __syncthreads();  // chunk n landed, the band built, the last tiles written out
    float acc[CHUNK / 8][4];
#pragma unroll
    for (int j = 0; j < CHUNK / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
    }
    const bf16* sb = smem + (n & 1) * stage_elems + b_off;
    for (int k = 0; k < nk; ++k) {
      unsigned a[4];
      ldmatrix_x4(a, sa + BMMA_K * k);
#pragma unroll
      for (int p = 0; p < CHUNK / 16; ++p) {
        unsigned bq[4];
        ldmatrix_x4(bq, sb + 16 * p * lw + BMMA_K * k);
        mma_bf16(acc[2 * p], a, bq[0], bq[1]);
        mma_bf16(acc[2 * p + 1], a, bq[2], bq[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < CHUNK / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        so[(8 * j + 2 * t + (r & 1)) * lo + 8 * (r >> 1)] = __float2bfloat16_rn(acc[j][r] * inv_c);
      }
    }
    __syncthreads();  // the tiles written, the buffer read
    if (n + 2 < nchunks) {  // into the buffer just read, while the tiles go out
      stage(n + 2);
      cp_async_commit();
    }
    const int c0 = n * CHUNK;
    for_each_unit(2 * CHUNK, tw / piece, [&](int sc, int q) {
      const int c = c0 + sc % CHUNK, j = piece * q;
      if (c >= channels || w0 + j >= width) return;
      bf16* out = (sc < CHUNK ? grad_left : grad_right) + (b * channels + c) * plane + row + w0;
      copy_piece(out + j, s_out + sc * lo + j, piece);
    });
  }
}

using CorrBwdMmaKernel = void (*)(const bf16*, const bf16*, const bf16*, bf16*, bf16*, int, int,
                                  int, int, int, int);

// The builds, by the channels of a chunk: 16, 32, 64
const CorrBwdMmaKernel corr_bwd_mma_builds[] = {
    corr_bwd_mma_kernel<16>, corr_bwd_mma_kernel<32>, corr_bwd_mma_kernel<64>};

int launch_corr_bwd_mma(const bf16* grad, const bf16* left, const bf16* right, bf16* grad_left,
                        bf16* grad_right, int batch, int channels, int height, int width,
                        int max_disp, int tw, int chunk, int smem_bytes, cudaStream_t stream) {
  if (batch == 0 || height == 0 || width == 0 || channels == 0) return 0;
  if (max_disp == 0) return zero_gradients(grad_left, grad_right, batch, channels, height, width, stream);
  if (tw < BMMA_CW || tw % BMMA_CW != 0 || (chunk != 16 && chunk != 32 && chunk != 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int threads = 2 * 32 * (tw / BMMA_CW);
  if (threads > BMMA_MAX_THREADS) return static_cast<int>(cudaErrorInvalidValue);
  if (bwd_mma_smem_bytes(tw, max_disp, chunk) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);  // the wrapper's plan has another layout
  }
  const CorrBwdMmaKernel kernel = corr_bwd_mma_builds[chunk / 32];
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int piece = mma_piece(width, grad, left, right, grad_left, grad_right);
  dim3 grid((width + tw - 1) / tw, height, batch);
  kernel<<<grid, threads, smem_bytes, stream>>>(grad, left, right, grad_left, grad_right, channels,
                                                height, width, max_disp, tw, piece);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bf16 form, on the tensor cores: every tensor bfloat16, the rest as
// aanet_correlation_backward_f32's but the plan (ops/cost_volume.py
// backward_plan_bf16): tw (columns of a block, a multiple of 16, at most
// 128), chunk (channels staged at a time: 16, 32 or 64, the build) and
// smem_bytes, which must be this layout's. Anything else is
// cudaErrorInvalidValue. With max_disp == 0 the plan is not read.
extern "C" int aanet_correlation_backward_bf16(const bf16* grad, const bf16* left,
                                               const bf16* right, bf16* grad_left,
                                               bf16* grad_right, int batch, int channels,
                                               int height, int width, int max_disp, int tw,
                                               int chunk, int smem_bytes, int device,
                                               void* stream) {
  cudaSetDevice(device);
  return launch_corr_bwd_mma(grad, left, right, grad_left, grad_right, batch, channels, height,
                             width, max_disp, tw, chunk, smem_bytes,
                             static_cast<cudaStream_t>(stream));
}
