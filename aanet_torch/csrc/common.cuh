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
