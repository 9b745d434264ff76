// K5: pairwise LCA by binary lifting, then the confidence threshold.
//
// Replaces the XLA-compiled reference function
//   src/pangea_tpu/kernels/score.py:127  lca_pairs_jnp (B12)
// as _score_impl uses it past _DIRECT_LCA_MAX_TAXA (score.py:206-217),
// with the q8 path's node-id recovery through tin2node (:207-212). It runs
// as its own [B]-wide launch after K3's winners form: one thread a read.
//
// What bounds it on an H100: 2 x levels dependent reads of the lifting
// table a read (levels = bit length of the tree's depth), random but from
// an up table of levels x (T+1) x 4 B (0.5 MB at 66,563 taxa and 2
// levels), which L2 holds; the [B] inputs and output are a few hundred KB.
// So it is bound by the latency of the dependent reads, which the B
// threads in flight hide.
//
// Rules: q8 (tin2node given): has = u != 0; u = has ? tin2node[clamp(
// tin_u, 0, M-1)] : 0, v likewise from tin_v. Then the LCA by
// lca_lift_pair (common.cuh, shared with K7). taxon = 0 if (float)best <
// thr * (float)nvalid (one rounded float32 multiply) or nvalid == 0.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void lca_lift_kernel(const int32_t* __restrict__ u_in,
                                const int32_t* __restrict__ v_in,
                                const int32_t* __restrict__ tin_u,
                                const int32_t* __restrict__ tin_v,
                                const int32_t* __restrict__ best,
                                const int32_t* __restrict__ nvalid, int B,
                                const int32_t* __restrict__ tin2node, int M,
                                const int32_t* __restrict__ parent,
                                const int32_t* __restrict__ depth,
                                const int32_t* __restrict__ up, int levels,
                                int T1, float thr,
                                int32_t* __restrict__ taxon) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int u = u_in[b], v = v_in[b];
  if (tin2node != nullptr) {
    const bool has = u != 0;
    u = has ? tin2node[min(max(tin_u[b], 0), M - 1)] : 0;
    v = has ? tin2node[min(max(tin_v[b], 0), M - 1)] : 0;
  }
  const int assigned = lca_lift_pair(u, v, parent, depth, up, levels, T1);
  const int n = nvalid[b];
  const bool below = static_cast<float>(best[b]) <
                     __fmul_rn(thr, static_cast<float>(n));
  taxon[b] = (below || n == 0) ? 0 : assigned;
}

}  // namespace

// u/v/tin_u/tin_v/best/nvalid int32 [B] (K3's winners form); tin2node
// int32 [M] or null (taxon lanes: u and v are node ids already);
// parent/depth int32 [T1]; up int32 [levels, T1]; taxon int32 [B].
extern "C" int pangea_lca_lift(const void* u, const void* v,
                               const void* tin_u, const void* tin_v,
                               const void* best, const void* nvalid, int B,
                               const void* tin2node, int M,
                               const void* parent, const void* depth,
                               const void* up, int levels, int T1, float thr,
                               void* taxon, void* stream) {
  if (levels < 1 || T1 < 2 || (tin2node != nullptr && M < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  lca_lift_kernel<<<blocks_for(B, kThreads), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(u), static_cast<const int32_t*>(v),
      static_cast<const int32_t*>(tin_u), static_cast<const int32_t*>(tin_v),
      static_cast<const int32_t*>(best), static_cast<const int32_t*>(nvalid),
      B, static_cast<const int32_t*>(tin2node), M,
      static_cast<const int32_t*>(parent), static_cast<const int32_t*>(depth),
      static_cast<const int32_t*>(up), levels, T1, thr,
      static_cast<int32_t*>(taxon));
  return static_cast<int>(cudaGetLastError());
}
