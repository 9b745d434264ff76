// K3: per-read consensus score and the LCA of the tied winners.
//
// Replaces the XLA-compiled reference functions
//   src/pangea_tpu/kernels/score.py:237  score_reads_tin_jnp (B5, q8 form)
//   src/pangea_tpu/kernels/score.py:221  score_reads_jnp     (B9, taxon form)
// through _score_impl :176, _pscore_quadratic :62 and _lca_by_tin_direct
// :158. The reference builds a [B, R, R] containment tensor and a
// [B, T+1] interval-test tensor in device memory; here one block owns one
// read, keeps its R probes in shared memory and reduces with shared
// atomics, so only the [B, R] lanes are read and a few [B] ints written.
//
// Two template switches, one kernel:
//  - kTaxon: the lanes are hit taxa (std lookup) and the winners' node ids
//    u / v are the taxa of the min-tin and max-tin winners (score.py:192-
//    195); otherwise the lanes are hit counts (q8) and u = v = has-winner.
//  - kDirect: the LCA is the direct scan over the T+1 taxa (T+1 <= 4096,
//    score.py:204) and the block writes (taxon, best, nvalid). Otherwise
//    the block writes (u, v, tin_u, tin_v, best, nvalid) and K5
//    (csrc/lca_lift.cu) lifts the LCA in a second, [B]-wide launch.
//
// What bounds it on an H100: R^2 compares a read (plus the (T+1)-taxon
// scan in the direct form), from shared memory and L1; device-memory
// traffic is the [B, R] lanes once. At R = 260 (w = 1, paired 150 bp) the
// R^2 compares are the work, so it is bound by integer issue.
//
// The part after the pscore, score_finish in common.cuh, is shared with K8
// (score_ranked.cu), which computes the same pscore by ranks for R > 2048.
//
// Rules (SEMANTICS.md §7): hit_i = lane_i != 0; pscore_i = hit_i ? #{j :
// hit_j && t_in_j <= t_in_i < t_out_j} : 0; best = max pscore; winners are
// hits with pscore == best > 0; tin_u / tin_v = min / max winner t_in
// (INT_MAX / -2 without one); u / v = max lane over winners with t_in ==
// tin_u / tin_v (0 without one); the direct LCA is the first-index argmax
// over t of (tin[t] <= tin_u < tout[t] && tin[t] <= tin_v < tout[t]) ?
// depth[t] : -1, then 0 if u == v == 0, v if u == 0, u if v == 0; nvalid =
// sum valid; taxon = 0 if (float)best < thr * (float)nvalid (one rounded
// float32 multiply) or nvalid == 0.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxR = 2048;          // 4 int arrays of R in shared memory
constexpr int kMaxTaxa = 4096;       // direct LCA scan; K5 lifts beyond

template <bool kTaxon, bool kDirect>
__global__ void score_kernel(const int32_t* __restrict__ lanes,
                             const int32_t* __restrict__ t_in,
                             const int32_t* __restrict__ t_out,
                             const uint8_t* __restrict__ valid, int R,
                             const int32_t* __restrict__ tin,
                             const int32_t* __restrict__ tout,
                             const int32_t* __restrict__ depth, int T1,
                             float thr, int32_t* __restrict__ o0,
                             int32_t* __restrict__ o1,
                             int32_t* __restrict__ o2,
                             int32_t* __restrict__ o3,
                             int32_t* __restrict__ o4,
                             int32_t* __restrict__ o5) {
  extern __shared__ int32_t smem[];
  int32_t* s_lane = smem;
  int32_t* s_in = smem + R;
  int32_t* s_out = smem + 2 * R;
  int32_t* s_ps = smem + 3 * R;
  __shared__ ScoreState st;

  const int b = blockIdx.x;
  const size_t base = static_cast<size_t>(b) * R;
  score_state_init(&st);
  int nv = 0;
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    s_lane[i] = lanes[base + i];
    s_in[i] = t_in[base + i];
    s_out[i] = t_out[base + i];
    nv += valid[base + i] != 0;
  }
  __syncthreads();
  if (nv) atomicAdd(&st.nvalid, nv);

  int my_best = 0;
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    int ps = 0;
    if (s_lane[i] != 0) {
      const int ti = s_in[i];
      for (int j = 0; j < R; ++j) {
        ps += s_lane[j] != 0 && s_in[j] <= ti && ti < s_out[j];
      }
    }
    s_ps[i] = ps;
    my_best = max(my_best, ps);
  }
  if (my_best) atomicMax(&st.best, my_best);
  __syncthreads();

  score_finish<kTaxon, kDirect>(
      &st, b, R,
      [&](int i) { return ScorePos{s_lane[i], s_in[i], s_ps[i]}; }, tin,
      tout, depth, T1, thr, o0, o1, o2, o3, o4, o5);
}

template <bool kTaxon, bool kDirect>
void launch(int B, int R, size_t smem, cudaStream_t stream,
            const void* lanes, const void* t_in, const void* t_out,
            const void* valid, const void* tin, const void* tout,
            const void* depth, int T1, float thr, void* o0, void* o1,
            void* o2, void* o3, void* o4, void* o5) {
  score_kernel<kTaxon, kDirect><<<B, kThreads, smem, stream>>>(
      static_cast<const int32_t*>(lanes), static_cast<const int32_t*>(t_in),
      static_cast<const int32_t*>(t_out), static_cast<const uint8_t*>(valid),
      R, static_cast<const int32_t*>(tin), static_cast<const int32_t*>(tout),
      static_cast<const int32_t*>(depth), T1, thr,
      static_cast<int32_t*>(o0), static_cast<int32_t*>(o1),
      static_cast<int32_t*>(o2), static_cast<int32_t*>(o3),
      static_cast<int32_t*>(o4), static_cast<int32_t*>(o5));
}

}  // namespace

// lanes/t_in/t_out int32 and valid bytes [B, R]; taxon_lanes selects the
// taxon form. T1 > 0: the direct form, tin/tout/depth int32 [T1] and
// o0..o2 = taxon, best, nvalid int32 [B] (o3..o5 unused). T1 == 0: the
// winners form, o0..o5 = u, v, tin_u, tin_v, best, nvalid int32 [B].
extern "C" int pangea_score(const void* lanes, const void* t_in,
                            const void* t_out, const void* valid, int B,
                            int R, int taxon_lanes, const void* tin,
                            const void* tout, const void* depth, int T1,
                            float thr, void* o0, void* o1, void* o2,
                            void* o3, void* o4, void* o5, void* stream) {
  if (R < 1 || R > kMaxR || T1 < 0 || T1 > kMaxTaxa) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const size_t smem = 4 * static_cast<size_t>(R) * sizeof(int32_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (taxon_lanes && T1 > 0) {
    launch<true, true>(B, R, smem, s, lanes, t_in, t_out, valid, tin, tout,
                       depth, T1, thr, o0, o1, o2, o3, o4, o5);
  } else if (taxon_lanes) {
    launch<true, false>(B, R, smem, s, lanes, t_in, t_out, valid, tin, tout,
                        depth, T1, thr, o0, o1, o2, o3, o4, o5);
  } else if (T1 > 0) {
    launch<false, true>(B, R, smem, s, lanes, t_in, t_out, valid, tin,
                        tout, depth, T1, thr, o0, o1, o2, o3, o4, o5);
  } else {
    launch<false, false>(B, R, smem, s, lanes, t_in, t_out, valid, tin,
                         tout, depth, T1, thr, o0, o1, o2, o3, o4, o5);
  }
  return static_cast<int>(cudaGetLastError());
}
