// K3: per-read consensus score and LCA of the tied winners (q8 path).
//
// Replaces the XLA-compiled reference function
//   src/pangea_tpu/kernels/score.py:237  score_reads_tin_jnp (B5)
// through _score_impl :176, _pscore_quadratic :62 and _lca_by_tin_direct
// :158. The reference builds a [B, R, R] containment tensor and a
// [B, T+1] interval-test tensor in device memory; here one block owns one
// read, keeps its R probes in shared memory and reduces with shared
// atomics, so only the [B, R] hits are read and three [B] ints written.
//
// What bounds it on an H100: R^2 compares plus a (T+1)-taxon scan a read,
// from shared memory and L1 (the taxonomy arrays are a few KB). At the
// bench shape (R = 32, T + 1 = 68) the work a block does is small, so
// block scheduling and the barriers bound it, not memory bandwidth.
//
// Rules (SEMANTICS.md §7): pscore_i = hit_i ? #{j : hit_j && t_in_j <=
// t_in_i < t_out_j} : 0; best = max pscore; winners are hits with pscore
// == best > 0; tin_u / tin_v = min / max winner t_in; the LCA is the
// first-index argmax over t of (tin[t] <= tin_u < tout[t] && tin[t] <=
// tin_v < tout[t]) ? depth[t] : -1, and 0 when best == 0; nvalid = sum
// valid; taxon = 0 if (float)best < thr * (float)nvalid (one rounded
// float32 multiply) or nvalid == 0.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxR = 2048;          // 4 int arrays of R in shared memory
constexpr int kMaxTaxa = 4096;       // direct LCA scan (B12 lifts beyond)

__global__ void score_tin_kernel(const int32_t* __restrict__ hit,
                                 const int32_t* __restrict__ t_in,
                                 const int32_t* __restrict__ t_out,
                                 const uint8_t* __restrict__ valid, int R,
                                 const int32_t* __restrict__ tin,
                                 const int32_t* __restrict__ tout,
                                 const int32_t* __restrict__ depth, int T1,
                                 float thr, int32_t* __restrict__ taxon,
                                 int32_t* __restrict__ best_out,
                                 int32_t* __restrict__ nvalid_out) {
  extern __shared__ int32_t smem[];
  int32_t* s_hit = smem;
  int32_t* s_in = smem + R;
  int32_t* s_out = smem + 2 * R;
  int32_t* s_ps = smem + 3 * R;
  __shared__ int s_best, s_nvalid, s_tin_u, s_tin_v;
  __shared__ unsigned long long s_lca;

  const int b = blockIdx.x;
  const size_t base = static_cast<size_t>(b) * R;
  if (threadIdx.x == 0) {
    s_best = 0;
    s_nvalid = 0;
    s_tin_u = INT_MAX;
    s_tin_v = -2;
    s_lca = 0ull;
  }
  int nv = 0;
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    s_hit[i] = hit[base + i] != 0;
    s_in[i] = t_in[base + i];
    s_out[i] = t_out[base + i];
    nv += valid[base + i] != 0;
  }
  __syncthreads();
  if (nv) atomicAdd(&s_nvalid, nv);

  int my_best = 0;
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    int ps = 0;
    if (s_hit[i]) {
      const int ti = s_in[i];
      for (int j = 0; j < R; ++j) {
        ps += s_hit[j] && s_in[j] <= ti && ti < s_out[j];
      }
    }
    s_ps[i] = ps;
    my_best = max(my_best, ps);
  }
  if (my_best) atomicMax(&s_best, my_best);
  __syncthreads();

  const int best = s_best;
  if (best > 0) {
    int u = INT_MAX, v = -2;
    for (int i = threadIdx.x; i < R; i += blockDim.x) {
      if (s_hit[i] && s_ps[i] == best) {
        u = min(u, s_in[i]);
        v = max(v, s_in[i]);
      }
    }
    if (v != -2) {
      atomicMin(&s_tin_u, u);
      atomicMax(&s_tin_v, v);
    }
    __syncthreads();
    const int tu = s_tin_u, tv = s_tin_v;
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
    atomicMax(&s_lca, key);
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    const int nvalid = s_nvalid;
    int assigned = 0;
    if (best > 0) {
      assigned = static_cast<int>(0xFFFFFFFFu -
                                  static_cast<unsigned>(s_lca & 0xFFFFFFFFull));
    }
    const bool below = static_cast<float>(best) <
                       __fmul_rn(thr, static_cast<float>(nvalid));
    taxon[b] = (below || nvalid == 0) ? 0 : assigned;
    best_out[b] = best;
    nvalid_out[b] = nvalid;
  }
}

}  // namespace

// hit/t_in/t_out int32 and valid bytes [B, R]; tin/tout/depth int32 [T1];
// taxon/best/nvalid int32 [B].
extern "C" int pangea_score_tin(const void* hit, const void* t_in,
                                const void* t_out, const void* valid, int B,
                                int R, const void* tin, const void* tout,
                                const void* depth, int T1, float thr,
                                void* taxon, void* best, void* nvalid,
                                void* stream) {
  if (R < 1 || R > kMaxR || T1 < 1 || T1 > kMaxTaxa) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const size_t smem = 4 * static_cast<size_t>(R) * sizeof(int32_t);
  score_tin_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(hit), static_cast<const int32_t*>(t_in),
      static_cast<const int32_t*>(t_out), static_cast<const uint8_t*>(valid),
      R, static_cast<const int32_t*>(tin), static_cast<const int32_t*>(tout),
      static_cast<const int32_t*>(depth), T1, thr,
      static_cast<int32_t*>(taxon), static_cast<int32_t*>(best),
      static_cast<int32_t*>(nvalid));
  return static_cast<int>(cudaGetLastError());
}
