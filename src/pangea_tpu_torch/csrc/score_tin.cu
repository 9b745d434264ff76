// K3: per-read consensus score and the LCA of the tied winners, R <= 2048.
//
// Replaces the XLA-compiled reference functions
//   src/pangea_tpu/kernels/score.py:237  score_reads_tin_jnp (B5, q8 form)
//   src/pangea_tpu/kernels/score.py:221  score_reads_jnp     (B9, taxon form)
// through _score_impl :176, _pscore_quadratic :62 and _lca_by_tin_direct
// :158. The reference builds a [B, R, R] containment tensor and a
// [B, T+1] interval-test tensor in device memory; here a read's probes are
// read once, folded into a shared-memory table of the distinct (t_in,
// t_out) intervals among its hits, and scored from that table
// (score_kernel in common.cuh, shared with K8): U^2 compares over the U
// distinct intervals, not R^2 over the probes.
//
// Two template switches, one kernel:
//  - kTaxon: the lanes are hit taxa (std lookup) and the winners' node ids
//    u / v are the taxa of the min-tin and max-tin winners (score.py:192-
//    195); otherwise the lanes are hit counts (q8) and u = v = has-winner.
//  - kTail: the direct LCA, a scan over the T+1 taxa (T+1 <= 4096,
//    score.py:204); past that the LCA by binary lifting (K5, B12, in
//    common.cuh); either writes (taxon, best, nvalid), merged with an
//    earlier call where one is given (K7, B13, in common.cuh). Or the
//    winners form, (u, v, tin_u, tin_v, best, nvalid), which the scorer's
//    sweeps and timings read.
//
// The general branch (Quadratic), for a read with more distinct intervals
// than the plan's cap: the read's probes go to shared memory as one 8-byte
// (t_in, t_out) word each, a miss as (0, INT_MIN), which contains nothing,
// and each thread counts kBatch of its probes against every word, so that
// one broadcast load serves kBatch compares.
//
// What bounds it on an H100: at the bench worlds' U ~ 1, the bytes of the
// [B, R] lanes, read once (13 B a probe); at U = R the general branch's R^2
// compares a read, from shared memory.
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

constexpr int kMaxR = 2048;          // K8 scores longer reads
constexpr int kBatch = 4;            // probes a thread counts at once

struct Quadratic {
  static constexpr bool kRanked = false;

  // Shared bytes a read's general branch takes: (t_in, t_out), lane and
  // pscore a probe; none where no table can overflow.
  static size_t general_bytes(int R, int cap, int, bool) {
    return R > cap ? 16 * static_cast<size_t>(R) : 0;
  }

  template <bool kTaxon>
  __device__ static void general(const ScoreGroup& g, ReadState* st,
                                 const ScoreArgs& a, int b,
                                 unsigned char* mine) {
    const int R = a.R;
    const size_t base = static_cast<size_t>(b) * R;
    int2* s_iv = reinterpret_cast<int2*>(mine);
    int* s_lane = reinterpret_cast<int*>(s_iv + R);
    int* s_ps = s_lane + R;
    for (int i = g.rank; i < R; i += g.size) {
      const int ln = a.lanes[base + i];
      s_lane[i] = ln;
      s_iv[i] = ln != 0 ? make_int2(a.t_in[base + i], a.t_out[base + i])
                        : make_int2(0, INT_MIN);
    }
    g.sync();
    int my_best = 0;
    for (int i0 = g.rank; i0 < R; i0 += kBatch * g.size) {
      int ti[kBatch], c[kBatch];
#pragma unroll
      for (int p = 0; p < kBatch; ++p) {
        const int i = i0 + p * g.size;
        ti[p] = i < R ? s_iv[i].x : 0;
        c[p] = 0;
      }
      for (int j = 0; j < R; ++j) {
        const int2 iv = s_iv[j];
#pragma unroll
        for (int p = 0; p < kBatch; ++p) {
          c[p] += iv.x <= ti[p] && ti[p] < iv.y;
        }
      }
#pragma unroll
      for (int p = 0; p < kBatch; ++p) {
        const int i = i0 + p * g.size;
        if (i < R) {
          const int ps = s_lane[i] != 0 ? c[p] : 0;
          s_ps[i] = ps;
          my_best = max(my_best, ps);
        }
      }
    }
    if (my_best) atomicMax(&st->best, my_best);
    g.sync();
    group_winners<kTaxon>(g, st, R, [&](int i) {
      return ScorePos{s_lane[i], s_iv[i].x, s_ps[i]};
    });
  }
};

}  // namespace

// See score_args (common.cuh) for the arguments; rpad 0 and scratch null.
extern "C" int pangea_score(
    const void* lanes, const void* t_in, const void* t_out, const void* valid,
    int B, int R, int taxon_lanes, const void* tin, const void* tout,
    const void* depth, int T1, const void* parent, const void* up,
    int levels, const void* tin2node, int M, float thr, void* o0, void* o1,
    void* o2, void* o3, void* o4, void* o5, void* general,
    const void* prior, const void* p_best, const void* p_nvalid,
    const void* m_parent, const void* m_depth, const void* m_up,
    int m_levels, int m_T1, int wpr, int rpb, int cap, int per_read,
    int rpad, void* scratch, void* stream) {
  if (R < 1 || R > kMaxR || rpad != 0 || scratch != nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ScoreArgs a =
      score_args(lanes, t_in, t_out, valid, B, R, tin, tout, depth, T1, parent, up,
                 levels, tin2node, M, thr, o0, o1, o2, o3, o4, o5, general,
                 prior, p_best, p_nvalid, m_parent, m_depth, m_up, m_levels,
                 m_T1, wpr, cap, per_read,
                 0, nullptr);
  return score_launch<Quadratic>(a, taxon_lanes, rpb,
                              static_cast<cudaStream_t>(stream));
}
