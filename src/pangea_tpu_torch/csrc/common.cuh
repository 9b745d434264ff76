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

// Pairwise LCA by binary lifting, 0 the identity (the reference's
// lca_pairs_jnp, src/pangea_tpu/kernels/score.py:127): u == v == 0 -> 0,
// u == 0 -> v, v == 0 -> u; otherwise lift the deeper of (u, v) by the depth
// difference bit by bit from the top level, and if they differ move both
// while up[l] differs; the LCA is the common node, or the parent of the last
// pair. parent/depth int32 [T1], up int32 [levels, T1]. Shared by K5
// (lca_lift.cu) and K7 (merge_multik.cu).
__device__ __forceinline__ int lca_lift_pair(
    int u, int v, const int32_t* __restrict__ parent,
    const int32_t* __restrict__ depth, const int32_t* __restrict__ up,
    int levels, int T1) {
  const bool zu = u == 0, zv = v == 0;
  const int uu = zu ? 1 : u, vv = zv ? 1 : v;
  const int du = depth[uu], dv = depth[vv];
  int a = dv > du ? vv : uu;               // a is the deeper node
  int c = dv > du ? uu : vv;
  const int diff = du > dv ? du - dv : dv - du;
  for (int l = levels - 1; l >= 0; --l) {
    if ((diff >> l) & 1) a = up[static_cast<size_t>(l) * T1 + a];
  }
  const bool equal = a == c;
  if (!equal) {
    for (int l = levels - 1; l >= 0; --l) {
      const int ua = up[static_cast<size_t>(l) * T1 + a];
      const int uc = up[static_cast<size_t>(l) * T1 + c];
      if (ua != uc) {
        a = ua;
        c = uc;
      }
    }
  }
  const int res = equal ? a : parent[a];
  return (zu && zv) ? 0 : zu ? v : zv ? u : res;
}

// Blocks needed to cover n items at `per` items a block.
inline unsigned int blocks_for(long long n, long long per) {
  return static_cast<unsigned int>((n + per - 1) / per);
}
