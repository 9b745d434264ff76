// Shared device helpers of the pangea_tpu_torch kernels.
#pragma once

#include <climits>
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

// log2 of NB, or -1 when NB is not a power of two (NB up to 2^62).
inline int log2_exact(long long NB) {
  int log2nb = 0;
  while (log2nb < 62 && (1ll << log2nb) < NB) ++log2nb;
  return (1ll << log2nb) == NB ? log2nb : -1;
}

// The table probes (K2, K4): a group of kProbeLanes lanes owns one probe, so
// a warp serves 32 / kProbeLanes probes at once, and the group's partial
// sums reduce in log2(kProbeLanes) shuffles.
constexpr int kProbeLanes = 8;
constexpr int kProbesPerBlock = 32;   // 8 warps of 4 probes

__device__ __forceinline__ uint32_t group_sum(uint32_t v) {
  for (int off = kProbeLanes / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  }
  return v;
}

// One probe as K9 (bucket_sort.cu) leaves it in sorted order: its index in
// the unsorted arrays (where its outputs go), its lanes and its valid flag.
struct __align__(16) SortedProbe {
  int32_t index;
  uint32_t hi, lo, valid;
};

// Row of a table of NB rows that index i names, as NumPy-style indexing
// under XLA takes it: below 0 it counts from the end, then it is clamped
// into [0, NB) (K11-K13).
__device__ __forceinline__ long long row_in(int32_t i, long long NB) {
  const long long r = i < 0 ? i + NB : i;
  return r < 0 ? 0 : r >= NB ? NB - 1 : r;
}

// Blocks needed to cover n items at `per` items a block.
inline unsigned int blocks_for(long long n, long long per) {
  return static_cast<unsigned int>((n + per - 1) / per);
}

// The per-read state of a scoring block (K3, K8), in shared memory.
struct ScoreState {
  int best, nvalid, tin_u, tin_v, u, v;
  unsigned long long lca;
};

// One probe position as the score's tail sees it: its lane (hit count or
// hit taxon, 0 for a miss), its t_in and its pscore (0 for a miss).
struct ScorePos {
  int lane, tin, ps;
};

__device__ __forceinline__ void score_state_init(ScoreState* s) {
  if (threadIdx.x == 0) {
    s->best = 0;
    s->nvalid = 0;
    s->tin_u = INT_MAX;
    s->tin_v = -2;
    s->u = 0;
    s->v = 0;
    s->lca = 0ull;
  }
}

// The score after the pscore (SEMANTICS.md §7; the rules are stated in
// score_tin.cu), shared by K3 and K8: one block owns read b, whose R
// positions at(i) returns, and s->best and s->nvalid are complete and
// visible to every thread. Finds the tied winners' min and max t_in (and,
// kTaxon, their taxa), then either the direct LCA scan over the T1 taxa
// and the threshold (kDirect: o0..o2 = taxon, best, nvalid) or the winners
// form (o0..o5 = u, v, tin_u, tin_v, best, nvalid) that K5 lifts.
template <bool kTaxon, bool kDirect, class At>
__device__ void score_finish(ScoreState* s, int b, int R, At at,
                             const int32_t* __restrict__ tin,
                             const int32_t* __restrict__ tout,
                             const int32_t* __restrict__ depth, int T1,
                             float thr, int32_t* __restrict__ o0,
                             int32_t* __restrict__ o1,
                             int32_t* __restrict__ o2,
                             int32_t* __restrict__ o3,
                             int32_t* __restrict__ o4,
                             int32_t* __restrict__ o5) {
  const int best = s->best;
  if (best > 0) {
    int u = INT_MAX, v = -2;
    for (int i = threadIdx.x; i < R; i += blockDim.x) {
      const ScorePos p = at(i);
      if (p.lane != 0 && p.ps == best) {
        u = min(u, p.tin);
        v = max(v, p.tin);
      }
    }
    if (v != -2) {
      atomicMin(&s->tin_u, u);
      atomicMax(&s->tin_v, v);
    }
  }
  __syncthreads();
  const int tu = s->tin_u, tv = s->tin_v;
  if (kTaxon && best > 0) {
    // Node ids: the largest taxon lane among the winners at each end
    // (every winner at one tin carries the same taxon in a sound table).
    int mu = 0, mv = 0;
    for (int i = threadIdx.x; i < R; i += blockDim.x) {
      const ScorePos p = at(i);
      if (p.lane != 0 && p.ps == best) {
        if (p.tin == tu) mu = max(mu, p.lane);
        if (p.tin == tv) mv = max(mv, p.lane);
      }
    }
    if (mu) atomicMax(&s->u, mu);
    if (mv) atomicMax(&s->v, mv);
  }
  if (kDirect && best > 0) {
    // Key orders by depth, then by the smaller taxon index: the maximum
    // key is the first-index argmax of the masked depth.
    unsigned long long key = 0ull;
    for (int t = threadIdx.x; t < T1; t += blockDim.x) {
      const bool ca = tin[t] <= tu && tu < tout[t] && tin[t] <= tv &&
                      tv < tout[t];
      const long long d = ca ? depth[t] : -1;
      const unsigned long long kt =
          (static_cast<unsigned long long>(d + 1) << 32) |
          static_cast<unsigned int>(0xFFFFFFFFu - static_cast<unsigned>(t));
      key = kt > key ? kt : key;
    }
    atomicMax(&s->lca, key);
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    const int nvalid = s->nvalid;
    const int has = best > 0 ? 1 : 0;
    const int u = kTaxon ? s->u : has;
    const int v = kTaxon ? s->v : has;
    if (kDirect) {
      const int res = best > 0 ? static_cast<int>(
          0xFFFFFFFFu - static_cast<unsigned>(s->lca & 0xFFFFFFFFull)) : 0;
      const int assigned = (u == 0 && v == 0) ? 0
                           : (u == 0)         ? v
                           : (v == 0)         ? u
                                              : res;
      const bool below = static_cast<float>(best) <
                         __fmul_rn(thr, static_cast<float>(nvalid));
      o0[b] = (below || nvalid == 0) ? 0 : assigned;
      o1[b] = best;
      o2[b] = nvalid;
    } else {
      o0[b] = u;
      o1[b] = v;
      o2[b] = tu;
      o3[b] = tv;
      o4[b] = best;
      o5[b] = nvalid;
    }
  }
}
