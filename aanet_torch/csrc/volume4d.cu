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
// Forward. Bound: bytes, and the writes alone: the volume is D times its
// inputs (at 384x1248, max_disp 192: 2 x 4 MB of features in, 184 MB or
// 368 MB out). The first kernel (one block per (b, c, h) row, one thread
// per output) spent an integer division and 64-bit index arithmetic on
// every 4-byte store. Design: a thread owns a quad of 4 columns of one
// (b, c, h) row and walks its run of D (the plan's dchunk: all of D, or a
// quarter of it where the quads are fewer than two waves of the card's
// threads, as at inference) plane by plane: one 16-byte store a plane (two for concat;
// four 4-byte ones each where W % 4 != 0). It keeps its
// quad of L in registers, and a window of the two R quads that the shifted
// read R[w - d] spans for four consecutive d: one 16-byte load of R (through
// the read-only cache) every four planes, and the shift a register choice.
// Neighbouring threads take neighbouring quads, so a warp's stores at one
// plane are 512 contiguous bytes. The stores are streaming (__stcs): every
// path volume exceeds the 50 MB L2, and on an H100 they beat plain stores
// at every path shape (PERF.md section 6).
//
// Backward: XLA's transposes of the shifted copies, for grad [B, C', D, H, W]:
//   dL[b, c, h, w]  =  sum_{d <= w}       g[b, c, d, h, w]
//   dR[b, c, h, w'] = -sum_{w' + d < W}   g[b, c, d, h, w' + d]  (difference)
//                   = +sum_{w' + d < W}   g[b, C + c, d, h, w' + d]  (concat)
// with d < D. Bound: bytes, the band of grad (w >= d) read once and dL, dR
// written once. The first kernel ran one thread per (b, c, h, w) with
// 64-bit divisions, walked d serially with two 4-byte loads a step (one
// misaligned), few loads in flight, and fetched every g value twice.
// Design: a block owns `rows` (b, c, h) rows (a column tile of one row
// where a row is wider than a block: `tile` columns); a thread a quad of
// 4 columns of one of them. The block streams the rows' planes of g, d by
// d, with 16-byte cp.async into a ring of two stages of BWD_CHUNK = 4 planes
// in shared memory (each thread copies its own quad of every plane: each g
// value read from device memory once); while chunk k + 1 is in flight, each
// thread sums dL down its columns and dR along the diagonals g[d][w' + d],
// read from the staged rows as two aligned quads and a shift fixed by d % 4.
// Concat stages the second channel half for dR beside the first; a tile of
// a wider row also stages, for each plane, the tile + 4 columns from w0 +
// 4 floor(d / 4) that its dR reads. dL and dR are written once, 16 bytes a
// thread where W % 4 == 0. No atomics: deterministic. Each sum starts from 0
// and adds (or subtracts) in ascending d, as the plain twins accumulate
// their slices, so the result equals them bit for bit.
//
// Both kernels take every shape: any B, C, H, W and D >= 0.
//
// Each has a float32 and a bfloat16 form (the JAX ops under a bf16 compute
// dtype: the volumes in the features' dtype), with the same plans; the
// bound of the bf16 forms is bytes at 2 a value, half the float32 bound.
// Forward: bf16 L and R, a bf16 volume. A thread widens its quads as it
// loads them (8-byte loads) and rounds once where it stores (8-byte
// streaming stores): concat's values come back as they were (a NaN stays
// a NaN), difference's L - R(w - d) is the float32 difference rounded to
// bf16 once, which is what XLA computes for a bf16 subtraction. Backward:
// a bf16 grad, staged as it is (8-byte cp.async copies into the float32
// form's ring, which it half fills) and widened where it is read; dL and dR
// summed in float32 in ascending d as the float32 form sums, and rounded
// to bf16 once. (XLA's own transpose on the CPU adds the D slices in
// descending d and rounds every partial sum to bf16:
// tests/test_torch_bf16_volumes.py holds the two apart.)
#include "common.cuh"

namespace {

// The forward's block, the backward's launch bounds and the planes of a
// stage of its ring (VOL_FWD_THREADS, VOL_BWD_MAX_THREADS, VOL_BWD_MIN_BLOCKS
// and VOL_BWD_CHUNK in ops/cost_volume.py). Stages of 4 planes were the
// fastest, or within 1 % of it, at every path shape on an H100.
constexpr int FWD_THREADS = 256;
constexpr int BWD_MAX_THREADS = 512;
constexpr int BWD_MIN_BLOCKS = 2;
constexpr int BWD_CHUNK = 4;  // d % 4 is the plane's index in its stage

// A quad of 4 values is one aligned load or store where kVec: 16 bytes of
// float32, 8 of bf16.
template <typename T>
__host__ __device__ inline bool quad_aligned(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & (4 * sizeof(T) - 1)) == 0;
}

// Quad j (columns 4 j .. 4 j + 3) of a row of `width` values, widened to
// float32, zero outside [0, width); one aligned load where kVec.
template <bool kVec, typename T>
__device__ __forceinline__ void load_quad(float (&v)[4], const T* row, long long j,
                                          int width) {
  if (kVec) {
    float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j >= 0 && 4 * j < width) q = load4_f32(row + 4 * j);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long i = 4 * j + e;
      v[e] = i >= 0 && i < width ? load_f32(row + i) : 0.f;
    }
  }
}

// v into p, p .. p + 3 (those below `valid` where !kVec), rounded once
// where T is bf16; streaming stores where kStream.
template <bool kVec, bool kStream>
__device__ __forceinline__ void store_quad(float* p, const float (&v)[4], int valid) {
  if (kVec) {
    const float4 q = make_float4(v[0], v[1], v[2], v[3]);
    if (kStream) {
      __stcs(reinterpret_cast<float4*>(p), q);
    } else {
      *reinterpret_cast<float4*>(p) = q;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < valid) {
        if (kStream) {
          __stcs(p + e, v[e]);
        } else {
          p[e] = v[e];
        }
      }
    }
  }
}

template <bool kVec, bool kStream>
__device__ __forceinline__ void store_quad(bf16* p, const float (&v)[4], int valid) {
  if (kVec) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 q;
    q.x = *reinterpret_cast<const unsigned int*>(&lo);
    q.y = *reinterpret_cast<const unsigned int*>(&hi);
    if (kStream) {
      __stcs(reinterpret_cast<uint2*>(p), q);
    } else {
      *reinterpret_cast<uint2*>(p) = q;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < valid) {
        const bf16 b = __float2bfloat16_rn(v[e]);
        if (kStream) {
          __stcs(reinterpret_cast<unsigned short*>(p + e), __bfloat16_as_ushort(b));
        } else {
          p[e] = b;
        }
      }
    }
  }
}

template <bool kConcat, bool kVec, typename T>
__global__ void __launch_bounds__(FWD_THREADS)
volume4d_fwd_kernel(const T* __restrict__ left, const T* __restrict__ right,
                    T* __restrict__ out, long long quads, int channels, int height,
                    int width, int max_disp, int nq, int dchunk) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= quads) return;
  const long long row = i / nq;  // (b, c, h)
  const int q = static_cast<int>(i - row * nq);
  const int w = 4 * q;  // the thread's first column
  const long long bc = row / height;
  const int h = static_cast<int>(row - bc * height);
  const long long hw = static_cast<long long>(height) * width;  // one (channel, d) plane
  // (b, c, d = 0, h, w); concat: out channel b * 2C + c, and C + that for R
  const long long oc = kConcat ? bc + (bc / channels) * channels : bc;
  T* dst = out + oc * max_disp * hw + static_cast<long long>(h) * width + w;
  T* dst_r = dst + static_cast<long long>(channels) * max_disp * hw;
  const T* lrow = left + row * width;
  const T* rrow = right + row * width;
  const int valid = min(4, width - w);

  float l[4], cur[4], prev[4];
  load_quad<kVec>(l, lrow, q, width);
  const int d_beg = blockIdx.y * dchunk;  // a multiple of 4
  const int d_end = min(max_disp, d_beg + dchunk);
  // For d = 4 a + s, R[w + e - d] is word 4 - s + e of the window [R quad
  // q - a - 1, R quad q - a] (prev, cur).
  load_quad<kVec>(cur, rrow, q - (d_beg >> 2), width);
  load_quad<kVec>(prev, rrow, q - (d_beg >> 2) - 1, width);
  for (int d0 = d_beg; d0 < d_end; d0 += 4) {
    float next[4];  // the window's new quad for d0 + 4, in flight during these four planes
    load_quad<kVec>(next, rrow, q - (d0 >> 2) - 2, width);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int d = d0 + s;
      if (d >= d_end) break;
      float a[4], r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = w + e >= d;
        r[e] = e < s ? prev[4 - s + e] : cur[e - s];
        if (kConcat) {
          a[e] = in ? l[e] : 0.f;
          r[e] = in ? r[e] : 0.f;
        } else {
          a[e] = in ? l[e] - r[e] : 0.f;
        }
      }
      const long long o = static_cast<long long>(d) * hw;
      store_quad<kVec, true>(dst + o, a, valid);
      if (kConcat) store_quad<kVec, true>(dst_r + o, r, valid);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cur[e] = prev[e];
      prev[e] = next[e];
    }
  }
}

template <bool kConcat, typename T>
int launch(const T* left, const T* right, T* out, int batch, int channels, int height,
           int width, int max_disp, int dchunk, int device, void* stream) {
  cudaSetDevice(device);
  if (dchunk < 4 || dchunk % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || channels == 0 || height == 0 || width == 0 || max_disp == 0) return 0;
  const int nq = (width + 3) / 4;
  const long long quads = static_cast<long long>(batch) * channels * height * nq;
  const long long blocks_x = (quads + FWD_THREADS - 1) / FWD_THREADS;
  const long long blocks_y = (static_cast<long long>(max_disp) + dchunk - 1) / dchunk;
  if (blocks_x > 0x7fffffff || blocks_y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned int>(blocks_x), static_cast<unsigned int>(blocks_y));
  const bool vec = width % 4 == 0 && quad_aligned<T>(left) && quad_aligned<T>(right) &&
                   quad_aligned<T>(out);
  auto kernel = vec ? volume4d_fwd_kernel<kConcat, true, T> : volume4d_fwd_kernel<kConcat, false, T>;
  kernel<<<grid, FWD_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      left, right, out, quads, channels, height, width, max_disp, nq, dchunk);
  return static_cast<int>(cudaGetLastError());
}

// Words of one stage of the backward's ring: BWD_CHUNK planes of the rows'
// dL pieces [BWD_CHUNK][rows][tile], then of their dR pieces
// [BWD_CHUNK][rows][b_w]:
// none where the dR reads come from the dL pieces (the difference volume's
// whole rows), the second channel half's rows (concat, whole rows), or the
// tile + 4 columns from w0 + 4 floor(d / 4) (a tile of a wider row).
__host__ __device__ inline int bwd_piece_words(int tile, bool whole, bool concat) {
  return whole ? (concat ? tile : 0) : tile + 4;
}

__host__ __device__ inline long long bwd_smem_words(int rows, int tile, bool whole, bool concat) {
  return 2LL * BWD_CHUNK * rows * (tile + bwd_piece_words(tile, whole, concat));
}

// Columns col .. col + 3 of a staged plane row (src: the row at column 0)
// into dst, where they hold band values (d <= column < width); 16 bytes
// where kVec (rows of a multiple of 4 floats: a quad lies wholly inside).
template <bool kVec>
__device__ __forceinline__ void stage_quad(float* dst, const float* src, int col, int d,
                                           int width) {
  if (kVec) {
    if (col < width && col + 3 >= d) cp_async_f32x4(dst, src + col);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = col + e;
      if (c >= d && c < width) cp_async_f32(dst + e, src + c, true);
    }
  }
}

// The bf16 form's: the quad's bf16 values as they are, 8 bytes where kVec
// (cp.async copies 4, 8 or 16 bytes), else each 2-byte value by a load and
// a store; widened where they are read (load_staged).
template <bool kVec>
__device__ __forceinline__ void stage_quad(bf16* dst, const bf16* src, int col, int d, int width) {
  if (kVec) {
    if (col < width && col + 3 >= d) {
      const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src + col));
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = col + e;
      if (c >= d && c < width) dst[e] = src[c];
    }
  }
}

// Four staged values (at a multiple of 4) as float32.
__device__ __forceinline__ float4 load_staged(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load_staged(const bf16* p) {
  return widen4(*reinterpret_cast<const uint2*>(p));
}

template <bool kConcat, bool kVec, typename T>
__global__ void __launch_bounds__(BWD_MAX_THREADS, BWD_MIN_BLOCKS)
volume4d_bwd_kernel(const T* __restrict__ grad, T* __restrict__ grad_left,
                    T* __restrict__ grad_right, long long nrows, int channels, int height,
                    int width, int max_disp, int depth, int rows, int tile, int tiles_x) {
  extern __shared__ float4 s_raw[];
  T* smem = reinterpret_cast<T*>(s_raw);  // the plan's size is the float32 form's
  const bool whole = tiles_x == 1;  // each row in one tile: tile >= width
  const int nq = tile / 4;
  const int b_w = bwd_piece_words(tile, whole, kConcat);
  const int a_words = BWD_CHUNK * rows * tile;
  const int stage_words = a_words + BWD_CHUNK * rows * b_w;
  const int t = threadIdx.x;
  const int r = t / nq, q = t - r * nq;  // the thread's row of the block and quad of its tile
  const long long row = static_cast<long long>(blockIdx.x / tiles_x) * rows + r;
  const int w0 = static_cast<int>(blockIdx.x % tiles_x) * tile;
  const int w = w0 + 4 * q;  // the thread's first column
  const bool active = r < rows && row < nrows && w < width;
  const long long hw = static_cast<long long>(height) * width;
  // the row's plane 0: g[b, c, 0, h, :] for dL, and for dR the same
  // (difference) or g[b, C + c, 0, h, :] (concat)
  const long long bc = row / height;
  const long long h = row - bc * height;
  const long long gc = kConcat ? bc + (bc / channels) * channels : bc;
  const T* ga = grad + gc * max_disp * hw + h * width;
  const T* gb = kConcat ? ga + static_cast<long long>(channels) * max_disp * hw : ga;
  // where the thread reads its dR quads of plane j of a stage: the dL
  // pieces (difference, whole rows; 4 floor(d / 4) further) or the dR
  // pieces (4 floor(d / 4) further where whole)
  const int dr_stride = b_w ? rows * b_w : rows * tile;
  const int dr_base = (b_w ? a_words + r * b_w : r * tile) + 4 * q;

  // chunk k's planes into stage k & 1: each thread its own quads
  auto stage = [&](int k) {
    T* sa = smem + (k & 1) * stage_words;
#pragma unroll 1  // unrolled, the 4-byte copies' variant spilled at 64 registers
    for (int j = 0; j < BWD_CHUNK; ++j) {
      const int d = k * BWD_CHUNK + j;
      if (d >= depth || !active) break;
      stage_quad<kVec>(sa + (j * rows + r) * tile + 4 * q, ga + d * hw, w, d, width);
      if (b_w) {
        T* sb = sa + a_words + (j * rows + r) * b_w;
        const int b0 = whole ? 0 : w0 + (d & ~3);  // the dR piece's first column
        stage_quad<kVec>(sb + 4 * q, gb + d * hw, b0 + 4 * q, d, width);
        if (!whole && q == 0) stage_quad<kVec>(sb + tile, gb + d * hw, b0 + tile, d, width);
      }
    }
  };

  float acc_l[4] = {0.f, 0.f, 0.f, 0.f}, acc_r[4] = {0.f, 0.f, 0.f, 0.f};
  const int nchunks = (depth + BWD_CHUNK - 1) / BWD_CHUNK;
  if (nchunks > 0) stage(0);
  cp_async_commit();
  for (int k = 0; k < nchunks; ++k) {
    if (k + 1 < nchunks) stage(k + 1);
    cp_async_commit();
    cp_async_wait_group<1>();
    __syncthreads();  // chunk k has landed
    if (active) {
      const T* sa = smem + (k & 1) * stage_words + r * tile + 4 * q;
      const T* sr = smem + (k & 1) * stage_words + dr_base;
#pragma unroll
      for (int s = 0; s < BWD_CHUNK; ++s) {  // d % 4 == s
        const int d = k * BWD_CHUNK + s;
        if (d >= depth) break;
        if (w + 3 >= d) {  // dL: the band's values of the thread's columns
          const float4 g = load_staged(sa + s * rows * tile);
          const float v[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (w + e >= d) acc_l[e] += v[e];
        }
        if (w + d < width) {  // dR: columns w + d .. w + d + 3, where below width
          const int off = s * dr_stride + (whole ? d - s : 0);
          const float4 lo = load_staged(sr + off);
          float4 hi = make_float4(0.f, 0.f, 0.f, 0.f);
          if (s > 0 && w + d - s + 4 < width) hi = load_staged(sr + off + 4);
          const float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (w + e + d < width) {
              if (kConcat) {
                acc_r[e] += v[s + e];
              } else {
                acc_r[e] -= v[s + e];
              }
            }
          }
        }
      }
    }
    __syncthreads();  // stage k & 1 is free for chunk k + 2
  }
  if (!active) return;
  const int valid = min(4, width - w);
  store_quad<kVec, false>(grad_left + row * width + w, acc_l, valid);
  store_quad<kVec, false>(grad_right + row * width + w, acc_r, valid);
}

template <bool kConcat, typename T>
int launch_backward(const T* grad, T* grad_left, T* grad_right, int batch, int channels,
                    int height, int width, int max_disp, int rows, int tile, int smem_bytes,
                    int device, void* stream) {
  cudaSetDevice(device);
  const long long nrows = static_cast<long long>(batch) * channels * height;
  if (nrows == 0 || width == 0) return 0;
  const int threads = ((rows * (tile / 4) + 31) / 32) * 32;
  if (rows < 1 || tile < 4 || tile % 4 != 0 || threads > BWD_MAX_THREADS ||
      (rows > 1 && tile < width)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_x = (width + tile - 1) / tile;
  const bool whole = tiles_x == 1;
  if (bwd_smem_words(rows, tile, whole, kConcat) * 4 != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);  // the wrapper's plan has another layout
  }
  const long long blocks = (nrows + rows - 1) / rows * tiles_x;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const int depth = min(max_disp, width);  // planes d >= W hold no band value
  const bool vec = width % 4 == 0 && quad_aligned<T>(grad) && quad_aligned<T>(grad_left) &&
                   quad_aligned<T>(grad_right);
  auto kernel = vec ? volume4d_bwd_kernel<kConcat, true, T> : volume4d_bwd_kernel<kConcat, false, T>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned int>(blocks), threads, smem_bytes,
           static_cast<cudaStream_t>(stream)>>>(grad, grad_left, grad_right, nrows, channels,
                                                height, width, max_disp, depth, rows, tile,
                                                tiles_x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// left, right: [batch, channels, height, width] float32; out: [batch,
// channels, max_disp, height, width] float32. The plan (ops/cost_volume.py
// volume_forward_plan): dchunk, the planes a thread walks, a multiple of 4
// (else cudaErrorInvalidValue).
extern "C" int aanet_difference_volume_f32(const float* left, const float* right, float* out,
                                           int batch, int channels, int height, int width,
                                           int max_disp, int dchunk, int device, void* stream) {
  return launch<false>(left, right, out, batch, channels, height, width, max_disp, dchunk,
                       device, stream);
}

// out: [batch, 2 * channels, max_disp, height, width] float32.
extern "C" int aanet_concat_volume_f32(const float* left, const float* right, float* out,
                                       int batch, int channels, int height, int width,
                                       int max_disp, int dchunk, int device, void* stream) {
  return launch<true>(left, right, out, batch, channels, height, width, max_disp, dchunk, device,
                      stream);
}

// The bf16 forms: left, right and out bfloat16, the rest as the float32
// forms' (the same plan).
extern "C" int aanet_difference_volume_bf16(const bf16* left, const bf16* right, bf16* out,
                                            int batch, int channels, int height, int width,
                                            int max_disp, int dchunk, int device, void* stream) {
  return launch<false>(left, right, out, batch, channels, height, width, max_disp, dchunk,
                       device, stream);
}

extern "C" int aanet_concat_volume_bf16(const bf16* left, const bf16* right, bf16* out,
                                        int batch, int channels, int height, int width,
                                        int max_disp, int dchunk, int device, void* stream) {
  return launch<true>(left, right, out, batch, channels, height, width, max_disp, dchunk, device,
                      stream);
}

// grad: [batch, channels, max_disp, height, width] float32; grad_left,
// grad_right: [batch, channels, height, width] float32, written in full
// (zeros where max_disp is 0). The plan (ops/cost_volume.py
// volume_backward_plan): rows (of a block; more than one only where tile >=
// width), tile (columns of a block, a multiple of 4), and smem_bytes, the
// block's shared memory, which must be what this layout takes. Anything
// else is cudaErrorInvalidValue.
extern "C" int aanet_difference_volume_backward_f32(const float* grad, float* grad_left,
                                                    float* grad_right, int batch, int channels,
                                                    int height, int width, int max_disp,
                                                    int rows, int tile, int smem_bytes,
                                                    int device, void* stream) {
  return launch_backward<false>(grad, grad_left, grad_right, batch, channels, height, width,
                                max_disp, rows, tile, smem_bytes, device, stream);
}

// grad: [batch, 2 * channels, max_disp, height, width] float32.
extern "C" int aanet_concat_volume_backward_f32(const float* grad, float* grad_left,
                                                float* grad_right, int batch, int channels,
                                                int height, int width, int max_disp, int rows,
                                                int tile, int smem_bytes, int device,
                                                void* stream) {
  return launch_backward<true>(grad, grad_left, grad_right, batch, channels, height, width,
                               max_disp, rows, tile, smem_bytes, device, stream);
}

// The bf16 forms: grad, grad_left and grad_right bfloat16, the rest as the
// float32 forms' (the same plan and shared-memory layout: the stages hold
// float32).
extern "C" int aanet_difference_volume_backward_bf16(const bf16* grad, bf16* grad_left,
                                                     bf16* grad_right, int batch, int channels,
                                                     int height, int width, int max_disp,
                                                     int rows, int tile, int smem_bytes,
                                                     int device, void* stream) {
  return launch_backward<false>(grad, grad_left, grad_right, batch, channels, height, width,
                                max_disp, rows, tile, smem_bytes, device, stream);
}

extern "C" int aanet_concat_volume_backward_bf16(const bf16* grad, bf16* grad_left,
                                                 bf16* grad_right, int batch, int channels,
                                                 int height, int width, int max_disp, int rows,
                                                 int tile, int smem_bytes, int device,
                                                 void* stream) {
  return launch_backward<true>(grad, grad_left, grad_right, batch, channels, height, width,
                               max_disp, rows, tile, smem_bytes, device, stream);
}
