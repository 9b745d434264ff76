// Shared device helpers of the pangea_tpu_torch kernels.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// MurmurHash3 fmix32 finalizer (SEMANTICS.md §4).
__device__ __forceinline__ uint32_t mix32(uint32_t v) {
  v ^= v >> 16;
  v *= 0x85EBCA6Bu;
  v ^= v >> 13;
  v *= 0xC2B2AE35u;
  v ^= v >> 16;
  return v;
}

// hash32 of a canonical k-mer split as (hi, lo) 32-bit halves.
__device__ __forceinline__ uint32_t hash32(uint32_t hi, uint32_t lo) {
  return mix32(mix32(lo ^ 0x9E3779B9u) ^ hi);
}

// Blocks needed to cover n items at `per` items a block.
inline unsigned int blocks_for(long long n, long long per) {
  return static_cast<unsigned int>((n + per - 1) / per);
}
