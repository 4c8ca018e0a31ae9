// Shared by every kernel library of aanet_torch (each .cu is its own .so,
// loaded with ctypes by aanet_torch/_build.py).
//
// Every C entry point makes the caller's device current, launches on the
// caller's stream (PyTorch's current stream, passed as a void*), never
// synchronises, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a launch that CUDA refused.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

extern "C" const char* aanet_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Blocks needed to give each of n items one thread.
static inline unsigned int aanet_blocks(long long n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

static __host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

// Asynchronous copies from device to shared memory (cp.async), waited for
// by commit group.
static __device__ __forceinline__ void cp_async_f32(float* dst, const float* src, bool valid) {
  // 4 bytes from src, or zeros without reading it when !valid
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

static __device__ __forceinline__ void cp_async_f32x4(float* dst, const float* src) {
  // 16 bytes, both ends 16-byte aligned
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

static __device__ __forceinline__ void cp_async_f32x4(float* dst, const float* src, bool valid) {
  // 16 bytes, both ends 16-byte aligned, or zeros without reading src when !valid
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for all committed groups but the newest N.
template <int N>
static __device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

static __device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4, 8 and 16 bytes from src into shared memory, of which the first `bytes`
// are read and the rest zero (bytes = 0: nothing is read; src must still be
// a valid address); both ends aligned to the copy's size. The raw bf16
// copies of the bf16 forms.
static __device__ __forceinline__ void cp_async_4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

static __device__ __forceinline__ void cp_async_8(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

static __device__ __forceinline__ void cp_async_16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes));
}

// The tensor cores: mma.sync.aligned.m16n8k16 bf16 x bf16 with float32
// accumulators (d += a . b: a the 16 x 16 A fragment, b0 and b1 the 16 x 8
// B fragment's, as PTX lays them out), and ldmatrix of 8 x 8 bf16 matrices
// from shared memory: lanes 8 i .. 8 i + 7 give the rows of matrix i, each
// 16 bytes at a 16-byte aligned address (.x2: lanes 0 .. 15); .trans gives
// each lane the transposed matrix's elements.
static __device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                                unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

static __device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

static __device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

static __device__ __forceinline__ void ldmatrix_x2(unsigned& r0, unsigned& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p))
               : "memory");
}

static __device__ __forceinline__ void ldmatrix_x2_trans(unsigned& r0, unsigned& r1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p))
               : "memory");
}

// The kernels' two forms: float32 values, and bfloat16 values that are
// widened to float32 where they are loaded (exactly), computed on in
// float32 and rounded to bfloat16 once, where they are stored (to nearest,
// ties to even), as the JAX ops compute under a bf16 compute dtype.
using bf16 = __nv_bfloat16;

template <typename T>
constexpr bool is_bf16 = std::is_same<T, bf16>::value;

static __device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }

static __device__ __forceinline__ float load_f32(const bf16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// Four neighbouring values: one 16-byte load of float32 (16-byte aligned),
// one 8-byte load of bfloat16 (8-byte aligned).
static __device__ __forceinline__ float4 load4_f32(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Four bfloat16 values in 8 bytes (the first in the low half of u.x) widened.
static __device__ __forceinline__ float4 widen4(uint2 u) {
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

static __device__ __forceinline__ float4 load4_f32(const bf16* p) {
  return widen4(__ldg(reinterpret_cast<const uint2*>(p)));
}

// One value into shared memory as float32, zero when !valid (src is then
// not read but must be a valid address): float32 with cp.async, bfloat16
// widened by a load and a store (cp.async copies bytes, it cannot widen
// them, so a bf16 form's copies are not in flight behind other work); and
// four neighbouring values (16-byte aligned float32, 8-byte aligned
// bfloat16; dst 16-byte aligned).
static __device__ __forceinline__ void stage1(float* dst, const float* src, bool valid) {
  cp_async_f32(dst, src, valid);
}

static __device__ __forceinline__ void stage1(float* dst, const bf16* src, bool valid) {
  *dst = valid ? load_f32(src) : 0.f;
}

static __device__ __forceinline__ void stage4(float* dst, const float* src, bool valid) {
  cp_async_f32x4(dst, src, valid);
}

static __device__ __forceinline__ void stage4(float* dst, const bf16* src, bool valid) {
  *reinterpret_cast<float4*>(dst) = valid ? load4_f32(src) : make_float4(0.f, 0.f, 0.f, 0.f);
}

static __device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }

static __device__ __forceinline__ void store_f32(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// Four neighbouring values, aligned as load4_f32's.
static __device__ __forceinline__ void store4_f32(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

static __device__ __forceinline__ void store4_f32(bf16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned int*>(&lo);
  u.y = *reinterpret_cast<const unsigned int*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
