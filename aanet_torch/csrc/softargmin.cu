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
// expf, a max, two sums), far below the card's 20 operations per byte; but
// an accurate expf is about ten instructions, and at 2 bytes a value (the
// bf16 forward) they took as long as the bytes on an H100 (PERF.md section
// 6), so the bf16 forward takes 2^x from the SFU instead.
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
// The forward has a bfloat16 form, a kernel and a plan of its own
// (aanet_softargmin_bf16, softargmin_fwd_bf16_kernel, ops/softargmin.py
// forward_plan_bf16): a bf16 volume, widened to float32 where each value is
// used, the softmax and the expectation in float32 and a float32 disparity,
// as the JAX op computes under a bf16 compute dtype (softargmin.py:28). A
// thread owns 8 pixels and reads a row of them 16 bytes wide, UNROLL rows
// in flight before their exponentials; the online softmax
// runs in the log2 domain (an fma and an ex2 a value); the slices merge
// after one barrier. (The form this replaced was the float32 kernel
// with 8-byte quads: as many instructions a value on half the bytes, it
// took longer than the float32 form.) The backward has a bf16 form too (aanet_softargmin_backward_bf16, with a plan
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

constexpr int UNROLL = 8;             // candidates of a slice loaded before the first exp
constexpr int SLAB_UNROLL = 4;        // the same for the backward, from its slab in shared memory
constexpr int FWD_TILE = 128;         // pixels of a forward block: 32 quads
constexpr int FWD_MAX_THREADS = 256;  // __launch_bounds__: the largest block,
constexpr int FWD_MIN_BLOCKS = 4;     // and the blocks of that size an SM holds
constexpr int BWD_MAX_THREADS = 256;
constexpr int BWD_MIN_BLOCKS = 4;
constexpr int BF16_TILE = 256;         // pixels of a bf16 forward tile: 32 octets
constexpr int BF16_MAX_THREADS = 256;  // its __launch_bounds__: 8 slices, and such
constexpr int BF16_MIN_BLOCKS = 3;     // blocks an SM where rows are read 16 bytes wide,
constexpr int BF16_ODD_MIN_BLOCKS = 2; // and where a value a load (more registers)

// Bytes of the forward's shared memory: the slices' merge slots
// [slices][2][FWD_TILE] (none for one slice).
inline int fwd_smem_bytes(int slices) { return slices > 1 ? 4 * 2 * FWD_TILE * slices : 0; }

// Bytes of the bf16 forward's shared memory: the slices' merge slots
// [slices][3][BF16_TILE] (none for one slice).
inline int fwd_bf16_smem_bytes(int slices) { return slices > 1 ? 4 * 3 * BF16_TILE * slices : 0; }

// Bytes of the backward's shared memory: the slab [depth][tile] and the
// slices' merge slots [slices][2][tile].
inline int bwd_smem_bytes(int tile, int depth, int slices) {
  return 4 * tile * (depth + 2 * slices);
}

// The bf16 form's: the slab raw, 2 bytes a value; the merge slots float32.
inline int bwd_smem_bytes_bf16(int tile, int depth, int slices) {
  return 2 * tile * (depth + 4 * slices);
}

// Evict-first loads of the volume (each value is read once): one float32
// value, and four neighbours (16-byte aligned).
__device__ __forceinline__ float load_first(const float* p) { return __ldcs(p); }

__device__ __forceinline__ float4 load4_first(const float* p) {
  return __ldcs(reinterpret_cast<const float4*>(p));
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
template <bool VEC>
__global__ void __launch_bounds__(FWD_MAX_THREADS, FWD_MIN_BLOCKS)
softargmin_fwd_kernel(const float* __restrict__ cost, float* __restrict__ out, int depth,
                      long long plane, int slices, float sign) {
  extern __shared__ float4 sa_smem[];  // [slices][2][NQ] float4: the merge slots
  constexpr int NQ = FWD_TILE / 4;
  const int q = threadIdx.x % NQ, s = threadIdx.x / NQ;
  const long long p0 = static_cast<long long>(blockIdx.x) * FWD_TILE;
  const long long b = blockIdx.y;
  const float* c = cost + b * depth * plane + p0;
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
      const float* row = c + static_cast<long long>(d0 + u) * plane;
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
// The bf16 forward, a kernel of its own. A block: BF16_TILE pixels of one
// batch element's plane by all D; thread (octet o, slice s): a warp's 32
// octets cover the tile, one warp a slice. A thread loads UNROLL rows of its
// slice at once, 16 bytes a row (8 neighbouring bf16 where the plane is a
// multiple of 8 and the pointers 16-byte aligned: VEC), else 8 values a row
// BF16_TILE / 8 pixels apart (a warp's load reads 64 neighbouring bytes),
// raw into registers, and widens each value exactly where it is used. The
// online softmax runs in the log2 domain: the running max m of a = v *
// log2(e) (of -v for a matching cost: NEG, the max taken from the min of v),
// each value's 2^(a - m) one fma and one ex2, the chunk's max first and the
// sums rescaled by 2^(m_old - m) once a chunk, from the same rounded maxima,
// so the rescales and the values agree. The slices publish their (max, sum,
// weighted sum) triples in shared memory; after one barrier warp s merges
// the slices of its 1/slices of the tile's pixels in slice order and
// stores them (no atomics: the same bits every launch).
// ---------------------------------------------------------------------------

// 2^x by the SFU (ex2.approx: relative error about 2^-22; 0 below 2^-126).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Evict-first loads of raw bf16: 16 bytes (8 values), and one value's bits.
__device__ __forceinline__ uint4 ldcs16(const bf16* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ unsigned ldcs2(const bf16* p) {
  return __ldcs(reinterpret_cast<const unsigned short*>(p));
}

// Value i of the 8 bf16 in r (value 0 in the low half of r.x), widened
// exactly; i a constant once unrolled.
__device__ __forceinline__ float bf16_at(const uint4& r, int i) {
  const unsigned w = i < 2 ? r.x : i < 4 ? r.y : i < 6 ? r.z : r.w;
  return __uint_as_float(i & 1 ? w & 0xffff0000u : w << 16);
}

// Pixel i of octet o of a tile where rows are not read 16 bytes wide: a
// warp's loads of one i read 32 neighbouring values.
__device__ __forceinline__ int pixel_of(int o, int i) { return o + (BF16_TILE / 8) * i; }

// Rows d0 .. d0 + UNROLL - 1 (zeros from `end` on) of octet o of the tile at
// `c` (the volume at the tile's first pixel of row 0; `left` pixels of the
// plane from there on), raw.
template <bool VEC>
__device__ __forceinline__ void load_rows(uint4 (&raw)[UNROLL], const bf16* c, long long plane,
                                          long long left, int o, int d0, int end) {
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const bf16* row = c + static_cast<long long>(d0 + u) * plane;
    const bool live = d0 + u < end;
    if (VEC) {
      const bool in = 8 * o < left;  // an octet lies wholly inside the plane or beyond it
      raw[u] = live && in ? ldcs16(row + 8 * o) : make_uint4(0u, 0u, 0u, 0u);
    } else {
      unsigned w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool in_i = live && pixel_of(o, i) < left;
        w[i] = in_i ? ldcs2(row + pixel_of(o, i)) : 0u;
      }
      raw[u] = make_uint4(w[0] | w[1] << 16, w[2] | w[3] << 16, w[4] | w[5] << 16, w[6] | w[7] << 16);
    }
  }
}

// The online softmax of an octet in the log2 domain (NEG: of -v).
template <bool NEG>
struct Octet {
  float m[8], sum[8], wsum[8];
  __device__ __forceinline__ Octet() {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      m[i] = -INFINITY;
      sum[i] = 0.f;
      wsum[i] = 0.f;
    }
  }

  // Adds candidates d0 .. d0 + UNROLL - 1 from raw; TAIL: only the first n
  // (>= 1).
  template <bool TAIL>
  __device__ __forceinline__ void add(const uint4 (&raw)[UNROLL], int d0, int n) {
    constexpr float L = NEG ? -1.4426950408889634f : 1.4426950408889634f;  // s * log2(e)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float ext = NEG ? INFINITY : -INFINITY;  // the chunk's min (NEG) or max of v
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!TAIL || u < n) ext = NEG ? fminf(ext, bf16_at(raw[u], i)) : fmaxf(ext, bf16_at(raw[u], i));
      }
      const float mx = fmaxf(m[i], ext * L);
      const float r = ex2(m[i] - mx);  // 0 on the first chunk
      float s = 0.f, w = 0.f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float e = ex2(fmaf(bf16_at(raw[u], i), L, -mx));
        if (TAIL) e = u < n ? e : 0.f;
        s += e;
        w = fmaf(e, static_cast<float>(d0 + u), w);
      }
      sum[i] = fmaf(sum[i], r, s);
      wsum[i] = fmaf(wsum[i], r, w);
      m[i] = mx;
    }
  }

  // This slice's triples into its slots (slot: [slices][3][BF16_TILE]).
  __device__ __forceinline__ void publish(float* slot, int s, int o, bool vec) const {
    auto put = [&](int f, const float (&x)[8]) {
      float* dst = slot + (s * 3 + f) * BF16_TILE;
      if (vec) {
        reinterpret_cast<float4*>(dst + 8 * o)[0] = make_float4(x[0], x[1], x[2], x[3]);
        reinterpret_cast<float4*>(dst + 8 * o)[1] = make_float4(x[4], x[5], x[6], x[7]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) dst[pixel_of(o, i)] = x[i];
      }
    };
    put(0, m);
    put(1, sum);
    put(2, wsum);
  }

  // One slice: the octet's disparities (0 where the sum is empty, D = 0)
  // stored straight from the thread.
  __device__ __forceinline__ void store(float* out, long long left, int o, bool vec) const {
    float r[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = sum[i] > 0.f ? wsum[i] / sum[i] : 0.f;
    if (vec) {
      if (8 * o < left) {
        reinterpret_cast<float4*>(out + 8 * o)[0] = make_float4(r[0], r[1], r[2], r[3]);
        reinterpret_cast<float4*>(out + 8 * o)[1] = make_float4(r[4], r[5], r[6], r[7]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (pixel_of(o, i) < left) out[pixel_of(o, i)] = r[i];
      }
    }
  }
};

// The merge of S slices: warp s takes pixels s * BF16_TILE / S .. of the
// tile, PL = 8 / S neighbours a lane; the largest of the slices' maxima,
// then each slice's sums rescaled to it (an empty slice's to 0) and added
// in slice order; the disparities stored (`left`: pixels of the plane from
// the tile's first on).
template <int S>
__device__ __forceinline__ void merge_store(const float* slot, float* out, long long left, int s,
                                            int lane, bool vec) {
  constexpr int PL = 8 / S;
  const int p = s * (BF16_TILE / S) + lane * PL;
  float r[PL];
#pragma unroll
  for (int k = 0; k < PL; ++k) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < S; ++j) mx = fmaxf(mx, slot[j * 3 * BF16_TILE + p + k]);
    float sum = 0.f, wsum = 0.f;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const float* x = slot + j * 3 * BF16_TILE + p + k;
      const float f = x[0] == -INFINITY ? 0.f : ex2(x[0] - mx);
      sum = fmaf(x[BF16_TILE], f, sum);
      wsum = fmaf(x[2 * BF16_TILE], f, wsum);
    }
    r[k] = sum > 0.f ? wsum / sum : 0.f;
  }
  if (vec && p + PL <= left) {
    if constexpr (PL == 4) {
      *reinterpret_cast<float4*>(out + p) = make_float4(r[0], r[1], r[2], r[3]);
    } else if constexpr (PL == 2) {
      *reinterpret_cast<float2*>(out + p) = make_float2(r[0], r[1]);
    } else {
      out[p] = r[0];
    }
  } else {
#pragma unroll
    for (int k = 0; k < PL; ++k) {
      if (p + k < left) out[p + k] = r[k];
    }
  }
}

template <bool VEC, bool NEG>
__global__ void __launch_bounds__(BF16_MAX_THREADS, VEC ? BF16_MIN_BLOCKS : BF16_ODD_MIN_BLOCKS)
softargmin_fwd_bf16_kernel(const bf16* __restrict__ cost, float* __restrict__ out, int depth,
                           long long plane, int slices) {
  extern __shared__ float sa_part[];  // [slices][3][BF16_TILE]: the merge slots
  const int lane = threadIdx.x % 32, s = threadIdx.x / 32;
  const long long p0 = static_cast<long long>(blockIdx.x) * BF16_TILE, left = plane - p0;
  const long long b = blockIdx.y;
  const bf16* c = cost + b * depth * plane + p0;
  int begin, end;
  slice_range(depth, slices, s, begin, end);
  Octet<NEG> st;
  for (int d0 = begin; d0 < end; d0 += UNROLL) {
    uint4 raw[UNROLL];
    load_rows<VEC>(raw, c, plane, left, lane, d0, end);
    if (d0 + UNROLL <= end) {
      st.template add<false>(raw, d0, UNROLL);
    } else {
      st.template add<true>(raw, d0, end - d0);
    }
  }
  float* o = out + b * plane + p0;
  if (slices > 1) {
    st.publish(sa_part, s, lane, VEC);
    __syncthreads();
    if (slices == 2) {
      merge_store<2>(sa_part, o, left, s, lane, VEC);
    } else if (slices == 4) {
      merge_store<4>(sa_part, o, left, s, lane, VEC);
    } else {
      merge_store<8>(sa_part, o, left, s, lane, VEC);
    }
  } else {
    st.store(o, left, lane, VEC);
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

// The checks and the launch of the float32 forward's entry point.
int launch_fwd(const float* cost, float* out, int batch, int depth, long long plane, int negate,
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
  auto kernel = vec ? softargmin_fwd_kernel<true> : softargmin_fwd_kernel<false>;
  dim3 grid(static_cast<unsigned int>(tiles), batch);
  kernel<<<grid, (FWD_TILE / 4) * slices, smem_bytes, stream>>>(cost, out, depth, plane, slices,
                                                                 negate ? -1.f : 1.f);
  return static_cast<int>(cudaGetLastError());
}

// The checks and the launch of the bf16 forward's entry point.
int launch_fwd_bf16(const bf16* cost, float* out, int batch, int depth, long long plane,
                    int negate, int tile, int slices, int smem_bytes, cudaStream_t stream) {
  if (batch == 0 || plane == 0) return 0;
  const long long tiles = (plane + BF16_TILE - 1) / BF16_TILE;
  if (tile != BF16_TILE || (slices != 1 && slices != 2 && slices != 4 && slices != 8) ||
      depth < 0 || batch > 65535 || tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (fwd_bf16_smem_bytes(slices) != smem_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);  // the wrapper's plan has another layout
  }
  const bool vec = plane % 8 == 0 && aligned16(cost) && aligned16(out);
  auto kernel = vec ? (negate ? softargmin_fwd_bf16_kernel<true, true>
                              : softargmin_fwd_bf16_kernel<true, false>)
                    : (negate ? softargmin_fwd_bf16_kernel<false, true>
                              : softargmin_fwd_bf16_kernel<false, false>);
  dim3 grid(static_cast<unsigned int>(tiles), batch);
  kernel<<<grid, 32 * slices, smem_bytes, stream>>>(cost, out, depth, plane, slices);
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

// The bf16 form: cost bfloat16, out float32, the arguments as
// aanet_softargmin_f32's; a kernel and a plan of its own (ops/softargmin.py
// forward_plan_bf16): tile (BF16_TILE pixels a block), slices (1, 2, 4 or 8
// warps a block) and smem_bytes, which must be this layout's. Anything else
// is cudaErrorInvalidValue.
extern "C" int aanet_softargmin_bf16(const bf16* cost, float* out, int batch, int depth,
                                     long long plane, int negate, int tile, int slices,
                                     int smem_bytes, int device, void* stream) {
  cudaSetDevice(device);
  return launch_fwd_bf16(cost, out, batch, depth, plane, negate, tile, slices, smem_bytes,
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
