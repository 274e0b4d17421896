// Shared pieces of the port's Hopper kernels: the lex compares that define
// the record order, and the C export macro the ctypes binding loads.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define RT_API extern "C" __attribute__((visibility("default")))

// Return the launch error (if any) to the Python wrapper, which raises.
#define RT_CHECK()                                   \
  do {                                               \
    cudaError_t err_ = cudaGetLastError();           \
    if (err_ != cudaSuccess) return (int)err_;       \
  } while (0)

// (k0, v0) > (k1, v1) lexicographically, unsigned.
__device__ __forceinline__ bool kv_greater(uint32_t k0, uint32_t v0,
                                           uint32_t k1, uint32_t v1) {
  return k0 > k1 || (k0 == k1 && v0 > v1);
}

// (k0, v0, i0) > (k1, v1, i1) lexicographically; the ordinal is signed.
__device__ __forceinline__ bool kvi_greater(uint32_t k0, uint32_t v0,
                                            int32_t i0, uint32_t k1,
                                            uint32_t v1, int32_t i1) {
  return k0 > k1 || (k0 == k1 && (v0 > v1 || (v0 == v1 && i0 > i1)));
}
