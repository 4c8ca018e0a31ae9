// Fused soft-argmin, forward and backward. The forward:
//   disp[b, p] = sum_d softmax_d(s * cost[b, d, p]) * d,
// and 0 where D = 0 (an empty softmax sums to nothing); the backward, with
// g = d loss / d disp and p_d the softmax,
//   d loss / d cost[b, d, p] = s * g * p_d * (d - disp).
//
// Replaces aanet_tpu/ops/softargmin.py:16 soft_argmin (softmax over the
// disparity axis, then the expectation against candidates 0..D-1; s = -1
// when the volume is a matching cost rather than a similarity) and the
// gradient jax.vjp derives for it.
//
// Bound: bytes, in both. The forward reads the volume once and writes one
// value a pixel; the backward reads the volume and g once and writes the
// volume's gradient once. Each value takes a handful of operations (an
// expf, a max, two sums), far below the card's 20 operations per byte.
//
// What holds a soft-argmin back on this card is latency, not bytes: the
// layout is [B, D, H, W], so one pixel's D values lie a plane apart, and a
// thread that walks them one after the other has one load in flight. Both
// kernels therefore cut the work the same way. A block owns a tile of
// pixels of one batch element's flattened H*W plane (tiles never straddle
// batch elements) and all of D. A thread owns four pixels of the tile, a
// quad, and one slice of D: the slices of a quad are split over the block's
// threads, so even a short grid has many warps in flight. Where the plane
// is a multiple of 4 (and the pointers 16-byte aligned) a quad is 4
// neighbouring pixels, read and written 16 bytes wide; otherwise (an odd
// plane, as GC-Net's) it is 4 pixels a quarter tile apart, so each load of a
// warp reads neighbouring words. A thread walks its slice in chunks of
// UNROLL candidates: all UNROLL loads are issued before the first expf, the
// chunk's max is taken first and the running sums rescaled once a chunk
// (no branch per value). The slices' (max, sum, weighted sum) triples are
// merged through shared memory: every slice publishes its max, rescales its
// own sums to the largest, and the sums are added in slice order (no
// atomics, the same bits every launch, and no thread merges the slices one
// after the other while the block waits).
//
// The forward reads the volume straight into registers. The backward stages
// its tile's [D x tile] slab in shared memory with cp.async (16-byte copies
// where aligned, 4-byte ones otherwise; each thread copies its own quad of
// every slices-th row, no division per copy) while its quad's g is loaded,
// takes each pixel's max, normaliser and mean from the slab as the forward
// does (chunks of SLAB_UNROLL: the slab answers fast, and fewer registers
// keep four blocks an SM without spills), then writes the gradient from the
// same slab: the volume is read from device memory once. The forward's
// loads are marked evict-first (each value is read once), so its lines
// displace each other in the L2 rather than lines that wait to be written
// back; the same marks on the backward's copies and stores made it slower.
// The tiling is the plan of ops/softargmin.py (forward_plan, backward_plan);
// each kernel refuses a plan whose shared memory is not its layout's.
// PERF.md section 6 has the times on an H100 and what holds each.
//
// The forward has a bfloat16 form (aanet_softargmin_bf16, the same plan): a
// bf16 volume, widened to float32 as it is loaded, the softmax and the
// expectation in float32 and a float32 disparity, as the JAX op computes
// under a bf16 compute dtype (softargmin.py:28). A thread's quad is four
// values of 8 bytes there, not 16: the quads and the plan stay the float32
// form's, and a warp still reads 256 neighbouring bytes of a row at once.
// Its bytes are half the float32 form's and the rest unchanged. The
// backward has a bf16 form too (aanet_softargmin_backward_bf16, with a plan
// of its own, ops/softargmin.py backward_plan_bf16): its slab holds the
// bf16 volume raw, 2 bytes a value, staged by 8-byte cp.async a quad where
// the plane is a multiple of 4 (while the quad's g loads are in flight);
// each quad is widened to float32 where the statistics pass and the
// gradient pass read it from the slab. The merge slots stay float32, so the
// merge and the sums are the float32 form's, in the same order; the softmax
// and its backward run in float32 from the float32 g, and the volume's
// gradient is rounded to bf16 once, where it is stored. Where the plane is
// odd (GC-Net's 383 x 1247 at D = 191) a quad's pixels lie a quarter tile
// apart, and a 2-byte value cannot be copied by cp.async: those values are
// staged raw by a load and a store. (The form this replaced widened the
// slab to float32 through registers as it staged it, a load and a store
// with nothing in flight, and took the float32 form's time on half its
// bytes.)
#include "common.cuh"

#include <math.h>

namespace {

constexpr int UNROLL = 8;             // candidates of a slice loaded before the first expf
constexpr int SLAB_UNROLL = 4;        // the same for the backward, from its slab in shared memory
constexpr int FWD_TILE = 128;         // pixels of a forward block: 32 quads
constexpr int FWD_MAX_THREADS = 256;  // __launch_bounds__: the largest block,
constexpr int FWD_MIN_BLOCKS = 4;     // and the blocks of that size an SM holds
constexpr int BWD_MAX_THREADS = 256;
constexpr int BWD_MIN_BLOCKS = 4;

// Bytes of the forward's shared memory: the slices' merge slots
// [slices][2][FWD_TILE] (none for one slice).
inline int fwd_smem_bytes(int slices) { return slices > 1 ? 4 * 2 * FWD_TILE * slices : 0; }

// Bytes of the backward's shared memory: the slab [depth][tile] and the
// slices' merge slots [slices][2][tile].
inline int bwd_smem_bytes(int tile, int depth, int slices) {
  return 4 * tile * (depth + 2 * slices);
}

// The bf16 form's: the slab raw, 2 bytes a value; the merge slots float32.
inline int bwd_smem_bytes_bf16(int tile, int depth, int slices) {
  return 2 * tile * (depth + 4 * slices);
}

// Evict-first loads of the volume (each value is read once), widened to
// float32: one value, and four neighbours (16-byte aligned float32, 8-byte
// aligned bfloat16).
__device__ __forceinline__ float load_first(const float* p) { return __ldcs(p); }

__device__ __forceinline__ float load_first(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ float4 load4_first(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4_first(const bf16* p) {
  return widen4(__ldcs(reinterpret_cast<const uint2*>(p)));
}

// Pixel i of quad q in a tile of TP pixels: 4 neighbours where rows are read
// 16 bytes wide (VEC), else a quarter tile apart.
template <int TP, bool VEC>
__device__ __forceinline__ int pixel(int q, int i) {
  return VEC ? 4 * q + i : q + (TP / 4) * i;
}

// The four values of quad q in one row of a tile (in shared or device
// memory): float32, or raw bf16 widened.
template <int TP, bool VEC>
__device__ __forceinline__ void load_quad(float (&v)[4], const float* row, int q) {
  if (VEC) {
    const float4 x = *reinterpret_cast<const float4*>(row + 4 * q);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = row[pixel<TP, VEC>(q, i)];
  }
}

template <int TP, bool VEC>
__device__ __forceinline__ void load_quad(float (&v)[4], const bf16* row, int q) {
  if (VEC) {
    const float4 x = widen4(*reinterpret_cast<const uint2*>(row + 4 * q));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __bfloat162float(row[pixel<TP, VEC>(q, i)]);
  }
}

// The online softmax of a quad: running max, and the sums of e^(v - max)
// and of e^(v - max) * d.
struct Quad {
  float m[4], sum[4], wsum[4];
  __device__ __forceinline__ Quad() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      sum[i] = 0.f;
      wsum[i] = 0.f;
    }
  }

  // Adds candidates d0 .. d0 + U - 1 (v = -inf where beyond the slice; the
  // first is always inside): the chunk's max first, then one rescale.
  template <int U>
  __device__ __forceinline__ void add(const float (&v)[U][4], int d0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, v[u][i]);
      const float r = expf(m[i] - mx);  // 0 on the first chunk
      float s = 0.f, w = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float e = expf(v[u][i] - mx);
        s += e;
        w = fmaf(e, static_cast<float>(d0 + u), w);
      }
      sum[i] = fmaf(sum[i], r, s);
      wsum[i] = fmaf(wsum[i], r, w);
      m[i] = mx;
    }
  }

  // Merges the block's `slices` slices of this quad through `part`
  // ([slices][2] float4 a quad): publish the maxima; take the largest and
  // rescale this slice's sums to it (an empty slice's to 0); publish the
  // sums in the same slots; add them in slice order. Every thread of the
  // quad ends with the same bits.
  __device__ __forceinline__ void merge(float4* part, int nq, int slices, int s, int q) {
    part[(s * 2) * nq + q] = make_float4(m[0], m[1], m[2], m[3]);
    __syncthreads();
    float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    for (int k = 0; k < slices; ++k) {
      const float4 x = part[(k * 2) * nq + q];
      mx[0] = fmaxf(mx[0], x.x);
      mx[1] = fmaxf(mx[1], x.y);
      mx[2] = fmaxf(mx[2], x.z);
      mx[3] = fmaxf(mx[3], x.w);
    }
    float r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[i] = m[i] == -INFINITY ? 0.f : expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
    __syncthreads();  // every maximum read before the slots are reused
    part[(s * 2) * nq + q] = make_float4(sum[0] * r[0], sum[1] * r[1], sum[2] * r[2], sum[3] * r[3]);
    part[(s * 2 + 1) * nq + q] =
        make_float4(wsum[0] * r[0], wsum[1] * r[1], wsum[2] * r[2], wsum[3] * r[3]);
    __syncthreads();
    float4 a = part[q], w = part[nq + q];
    for (int k = 1; k < slices; ++k) {
      const float4 b = part[(k * 2) * nq + q], c = part[(k * 2 + 1) * nq + q];
      a = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
      w = make_float4(w.x + c.x, w.y + c.y, w.z + c.z, w.w + c.w);
    }
    sum[0] = a.x, sum[1] = a.y, sum[2] = a.z, sum[3] = a.w;
    wsum[0] = w.x, wsum[1] = w.y, wsum[2] = w.z, wsum[3] = w.w;
  }
};

// Slice s of D: candidates [begin, end), ceil(D / slices) of them (the last
// slices may hold fewer, or none).
__device__ __forceinline__ void slice_range(int depth, int slices, int s, int& begin, int& end) {
  const int per = (depth + slices - 1) / slices;
  begin = min(depth, s * per);
  end = min(depth, begin + per);
}

// ---------------------------------------------------------------------------
// Forward. A block: FWD_TILE pixels x all D; thread (quad q, slice s), 32
// quads a warp, so one warp a slice.
// ---------------------------------------------------------------------------
template <bool VEC, typename T>
__global__ void __launch_bounds__(FWD_MAX_THREADS, FWD_MIN_BLOCKS)
softargmin_fwd_kernel(const T* __restrict__ cost, float* __restrict__ out, int depth,
                      long long plane, int slices, float sign) {
  extern __shared__ float4 sa_smem[];  // [slices][2][NQ] float4: the merge slots
  constexpr int NQ = FWD_TILE / 4;
  const int q = threadIdx.x % NQ, s = threadIdx.x / NQ;
  const long long p0 = static_cast<long long>(blockIdx.x) * FWD_TILE;
  const long long b = blockIdx.y;
  const T* c = cost + b * depth * plane + p0;
  bool in[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) in[i] = p0 + pixel<FWD_TILE, VEC>(q, i) < plane;

  int begin, end;
  slice_range(depth, slices, s, begin, end);
  Quad st;
  for (int d0 = begin; d0 < end; d0 += UNROLL) {
    float v[UNROLL][4];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const T* row = c + static_cast<long long>(d0 + u) * plane;
      const bool live = d0 + u < end;
      if (VEC) {
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live && in[0]) x = load4_first(row + 4 * q);
        v[u][0] = x.x;
        v[u][1] = x.y;
        v[u][2] = x.z;
        v[u][3] = x.w;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[u][i] = live && in[i] ? load_first(row + pixel<FWD_TILE, VEC>(q, i)) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) v[u][i] = live ? sign * v[u][i] : -INFINITY;
    }
    st.add(v, d0);
  }

  if (slices > 1) {
    st.merge(sa_smem, NQ, slices, s, q);
    if (s > 0) return;
  }

  float r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = st.sum[i] > 0.f ? st.wsum[i] / st.sum[i] : 0.f;
  float* o = out + b * plane + p0;
  if (VEC) {
    if (in[0]) reinterpret_cast<float4*>(o)[q] = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (in[i]) o[pixel<FWD_TILE, VEC>(q, i)] = r[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Backward. A block: TP pixels x all D, the slab staged once (float32, or
// the bf16 form's raw bf16: T); thread (quad q, slice s) takes its slice's
// statistics, then, after the merge, writes its slice's rows of the
// gradient.
// ---------------------------------------------------------------------------
template <int TP, bool VEC, typename T>
__global__ void __launch_bounds__(BWD_MAX_THREADS, BWD_MIN_BLOCKS)
softargmin_bwd_kernel(const float* __restrict__ grad_out, const T* __restrict__ cost,
                      T* __restrict__ grad_cost, int depth, long long plane, int slices,
                      float sign) {
  constexpr int NQ = TP / 4;
  extern __shared__ float4 sa_smem[];
  T* slab = reinterpret_cast<T*>(sa_smem);                      // [depth][TP]
  float4* part = reinterpret_cast<float4*>(slab + depth * TP);  // [slices][2][NQ]: merge slots
  const int q = threadIdx.x % NQ, s = threadIdx.x / NQ;
  const long long p0 = static_cast<long long>(blockIdx.x) * TP;
  const long long b = blockIdx.y;
  const long long base = b * depth * plane + p0;
  bool in[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) in[i] = p0 + pixel<TP, VEC>(q, i) < plane;

  // the slab: rows d, pixels p0 .. p0 + TP - 1, zeros beyond the plane;
  // thread (q, s) copies its quad of rows s, s + slices, ...
  const T* c = cost + base;
  for (int d = s; d < depth; d += slices) {
    const T* src = c + d * plane;
    T* dst = slab + d * TP;
    if constexpr (is_bf16<T>) {  // raw: 8-byte copies of a quad, else a load and a store a value
      if (VEC) {
        cp_async_8(dst + 4 * q, in[0] ? src + 4 * q : cost, in[0] ? 8 : 0);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = pixel<TP, VEC>(q, i);
          dst[j] = in[i] ? src[j] : __ushort_as_bfloat16(0);
        }
      }
    } else if (VEC) {
      stage4(dst + 4 * q, in[0] ? src + 4 * q : cost, in[0]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = pixel<TP, VEC>(q, i);
        stage1(dst + j, in[i] ? src + j : cost, in[i]);
      }
    }
  }
  // the quad's g, on its way while the slab arrives
  float g[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) g[i] = in[i] ? grad_out[b * plane + p0 + pixel<TP, VEC>(q, i)] : 0.f;
  cp_async_wait_all();
  __syncthreads();

  int begin, end;
  slice_range(depth, slices, s, begin, end);
  Quad st;
  for (int d0 = begin; d0 < end; d0 += SLAB_UNROLL) {
    float v[SLAB_UNROLL][4];
#pragma unroll
    for (int u = 0; u < SLAB_UNROLL; ++u) {
      const bool live = d0 + u < end;
      if (live) load_quad<TP, VEC>(v[u], slab + (d0 + u) * TP, q);
#pragma unroll
      for (int i = 0; i < 4; ++i) v[u][i] = live ? sign * v[u][i] : -INFINITY;
    }
    st.add(v, d0);
  }

  // every thread of a quad merges the slices, so each has the pixels' max,
  // s * g / sum and mean (the sum is positive: slice 0 is never empty)
  st.merge(part, NQ, slices, s, q);
  float coef[4], mean[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    coef[i] = sign * g[i] / st.sum[i];
    mean[i] = st.wsum[i] / st.sum[i];
  }
  const float* m = st.m;
  T* gc = grad_cost + base;
#pragma unroll 2
  for (int d = begin; d < end; ++d) {
    float v[4], r[4];
    load_quad<TP, VEC>(v, slab + d * TP, q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[i] = coef[i] * expf(sign * v[i] - m[i]) * (static_cast<float>(d) - mean[i]);
    }
    T* out = gc + static_cast<long long>(d) * plane;
    if (VEC) {
      if (in[0]) store4_f32(out + 4 * q, make_float4(r[0], r[1], r[2], r[3]));
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (in[i]) store_f32(out + pixel<TP, VEC>(q, i), r[i]);
      }
    }
  }
}

template <int TP, bool VEC, typename T>
cudaError_t launch_bwd_kernel(const float* grad_out, const T* cost, T* grad_cost,
                              int batch, int depth, long long plane, int slices, int smem_bytes,
                              float sign, cudaStream_t stream) {
  auto kernel = softargmin_bwd_kernel<TP, VEC, T>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid(static_cast<unsigned int>((plane + TP - 1) / TP), batch);
  kernel<<<grid, (TP / 4) * slices, smem_bytes, stream>>>(grad_out, cost, grad_cost, depth,
                                                          plane, slices, sign);
  return cudaGetLastError();
}

template <int TP, typename T>
cudaError_t launch_bwd(bool vec, const float* grad_out, const T* cost, T* grad_cost,
                       int batch, int depth, long long plane, int slices, int smem_bytes,
                       float sign, cudaStream_t stream) {
  return vec ? launch_bwd_kernel<TP, true>(grad_out, cost, grad_cost, batch, depth, plane,
                                           slices, smem_bytes, sign, stream)
             : launch_bwd_kernel<TP, false>(grad_out, cost, grad_cost, batch, depth, plane,
                                            slices, smem_bytes, sign, stream);
}

// The checks and the launch of both backward forms' entry points (T: the
// volume's type).
template <typename T>
int launch_bwd_entry(const float* grad_out, const T* cost, T* grad_cost, int batch, int depth,
                     long long plane, int negate, int tile, int slices, int smem_bytes,
                     cudaStream_t st) {
  if (batch == 0 || plane == 0 || depth == 0) return 0;
  if ((tile != 32 && tile != 64 && tile != 128 && tile != 256) || slices < 1 ||
      (tile / 4) * slices > BWD_MAX_THREADS || depth < 0 || batch > 65535 ||
      (plane + tile - 1) / tile > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int layout = is_bf16<T> ? bwd_smem_bytes_bf16(tile, depth, slices)
                                 : bwd_smem_bytes(tile, depth, slices);
  if (layout != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);  // the wrapper's plan has another layout
  }
  const bool vec = plane % 4 == 0 && aligned16(cost) && aligned16(grad_cost);
  const float sign = negate ? -1.f : 1.f;
  cudaError_t err;
  switch (tile) {
    case 32:
      err = launch_bwd<32>(vec, grad_out, cost, grad_cost, batch, depth, plane, slices, smem_bytes,
                           sign, st);
      break;
    case 64:
      err = launch_bwd<64>(vec, grad_out, cost, grad_cost, batch, depth, plane, slices, smem_bytes,
                           sign, st);
      break;
    case 128:
      err = launch_bwd<128>(vec, grad_out, cost, grad_cost, batch, depth, plane, slices,
                            smem_bytes, sign, st);
      break;
    default:
      err = launch_bwd<256>(vec, grad_out, cost, grad_cost, batch, depth, plane, slices,
                            smem_bytes, sign, st);
      break;
  }
  return static_cast<int>(err);
}

// The checks and the launch of both forms' entry points (T: the volume's type).
template <typename T>
int launch_fwd(const T* cost, float* out, int batch, int depth, long long plane, int negate,
               int tile, int slices, int smem_bytes, cudaStream_t stream) {
  if (batch == 0 || plane == 0) return 0;
  const long long tiles = (plane + FWD_TILE - 1) / FWD_TILE;
  if (tile != FWD_TILE || slices < 1 || (FWD_TILE / 4) * slices > FWD_MAX_THREADS ||
      depth < 0 || batch > 65535 || tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (fwd_smem_bytes(slices) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);  // the wrapper's plan has another layout
  }
  const bool vec = plane % 4 == 0 && aligned16(cost) && aligned16(out);
  auto kernel = vec ? softargmin_fwd_kernel<true, T> : softargmin_fwd_kernel<false, T>;
  dim3 grid(static_cast<unsigned int>(tiles), batch);
  kernel<<<grid, (FWD_TILE / 4) * slices, smem_bytes, stream>>>(cost, out, depth, plane, slices,
                                                                 negate ? -1.f : 1.f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cost: [batch, depth, plane] float32, out: [batch, plane] float32. The plan
// (ops/softargmin.py forward_plan): tile (FWD_TILE pixels a block), slices
// (of D a block: one warp each) and smem_bytes, which must be this layout's.
// Anything else is cudaErrorInvalidValue.
extern "C" int aanet_softargmin_f32(const float* cost, float* out, int batch, int depth,
                                    long long plane, int negate, int tile, int slices,
                                    int smem_bytes, int device, void* stream) {
  cudaSetDevice(device);
  return launch_fwd(cost, out, batch, depth, plane, negate, tile, slices, smem_bytes,
                    static_cast<cudaStream_t>(stream));
}

// The bf16 form: cost bfloat16, out float32, the rest as
// aanet_softargmin_f32's (the same plan).
extern "C" int aanet_softargmin_bf16(const bf16* cost, float* out, int batch, int depth,
                                     long long plane, int negate, int tile, int slices,
                                     int smem_bytes, int device, void* stream) {
  cudaSetDevice(device);
  return launch_fwd(cost, out, batch, depth, plane, negate, tile, slices, smem_bytes,
                    static_cast<cudaStream_t>(stream));
}

// grad_out: [batch, plane]; cost, grad_cost: [batch, depth, plane]; float32.
// The plan (ops/softargmin.py backward_plan): tile (32, 64, 128 or 256
// pixels a block), slices (of D a block; tile / 4 * slices threads) and
// smem_bytes, which must be this layout's. Anything else is
// cudaErrorInvalidValue.
extern "C" int aanet_softargmin_backward_f32(const float* grad_out, const float* cost,
                                             float* grad_cost, int batch, int depth,
                                             long long plane, int negate, int tile, int slices,
                                             int smem_bytes, int device, void* stream) {
  cudaSetDevice(device);
  return launch_bwd_entry(grad_out, cost, grad_cost, batch, depth, plane, negate, tile, slices,
                          smem_bytes, static_cast<cudaStream_t>(stream));
}

// The bf16 form: cost and grad_cost bfloat16, grad_out float32, the rest as
// aanet_softargmin_backward_f32's but the plan (ops/softargmin.py
// backward_plan_bf16), whose smem_bytes is the raw slab's layout
// (bwd_smem_bytes_bf16).
extern "C" int aanet_softargmin_backward_bf16(const float* grad_out, const bf16* cost,
                                              bf16* grad_cost, int batch, int depth,
                                              long long plane, int negate, int tile, int slices,
                                              int smem_bytes, int device, void* stream) {
  cudaSetDevice(device);
  return launch_bwd_entry(grad_out, cost, grad_cost, batch, depth, plane, negate, tile, slices,
                          smem_bytes, static_cast<cudaStream_t>(stream));
}
