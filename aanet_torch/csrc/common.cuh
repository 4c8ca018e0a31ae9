// Shared by every kernel library of aanet_torch (each .cu is its own .so,
// loaded with ctypes by aanet_torch/_build.py).
//
// Every C entry point makes the caller's device current, launches on the
// caller's stream (PyTorch's current stream, passed as a void*), never
// synchronises, allocates nothing, and returns cudaGetLastError() so the
// Python wrapper can raise on a launch that CUDA refused.
#pragma once

#include <cuda_runtime.h>

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
