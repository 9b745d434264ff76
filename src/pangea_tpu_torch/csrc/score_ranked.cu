// K8: the per-read score of long reads (R > 2048 probes), by ranks.
//
// Replaces the XLA-compiled reference function
//   src/pangea_tpu/kernels/score.py:71  _pscore_ranked (B11)
// as _score_impl :176 runs it for the long-read buckets (chosen at
// :105-124), in both of K3's forms. The reference sorts [B, R] tin and tout
// arrays with lax.sort and ranks every probe with two searchsorted calls:
// pscore_i = #{j hit : tin_j <= tin_i} - #{j hit : tout_j <= tin_i}, which
// is K3's #{j hit : tin_j <= tin_i < tout_j} wherever every hit's tin_j <
// tout_j. Here the read's probes fold into the table of distinct (t_in,
// t_out) intervals that K3 uses (score_kernel in common.cuh), each entry
// counting both ranks' terms times its multiplicity, so K8 computes
// exactly the reference's ranks and writes K3's outputs in K3's tails:
// (taxon, best, nvalid) by the direct or lifted LCA (K5), merged with an
// earlier call where given (K7), or the six winners arrays. A read gets a
// block of 32 warps (kernels/score.py score_plan), each warp folding its
// share of the read's chunks.
//
// The general branch (Ranked), for a read with more distinct intervals than
// the plan's cap: the block sorts the read's tins and touts (misses, and the
// pad up to the next power of two Rpad, as INT_MAX after every real tin)
// with a bitonic sort, ranks each probe once with two upper-bound searches
// and keeps its pscore beside the sorted arrays, so the winners' passes
// read it back and search nothing. The three [Rpad] arrays live in shared
// memory when they fit the plan's limit (Rpad <= 16,384: R up to the
// single-end 16,384-base bucket), beyond it in a device scratch [B, 3,
// Rpad] that the wrapper allocates.
//
// What bounds it on an H100: at small U, the bytes of the [B, R] lanes
// read once; at U = R, the general branch's sort, R log^2 R
// compare-exchanges a read from shared memory (or L2).
#include "common.cuh"

namespace {

constexpr int kMinR = 2049;          // K3 scores R <= 2048

// Ascending bitonic sort of a[0, n) and c[0, n) together (n a power of
// two), by the group; ends with the group's barrier.
__device__ void bitonic_sort2(const ScoreGroup& g, int32_t* a, int32_t* c,
                              int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = g.rank; i < n / 2; i += g.size) {
        const int lo = ((i & ~(j - 1)) << 1) | (i & (j - 1));
        const int hi = lo + j;
        const bool up = (lo & k) == 0;
        const int32_t a0 = a[lo], a1 = a[hi];
        if ((a0 > a1) == up) {
          a[lo] = a1;
          a[hi] = a0;
        }
        const int32_t c0 = c[lo], c1 = c[hi];
        if ((c0 > c1) == up) {
          c[lo] = c1;
          c[hi] = c0;
        }
      }
      g.sync();
    }
  }
}

// Number of entries of the ascending s[0, n) that are <= x.
__device__ __forceinline__ int upper_bound(const int32_t* s, int n, int x) {
  int lo = 0, len = n;
  while (len > 0) {
    const int half = len >> 1;
    if (s[lo + half] <= x) {
      lo += half + 1;
      len -= half + 1;
    } else {
      len = half;
    }
  }
  return lo;
}

struct Ranked {
  static constexpr bool kRanked = true;

  // Shared bytes a read's general branch takes: sorted tins and touts and
  // the pscores, [Rpad] each; none when they go to the device scratch.
  static size_t general_bytes(int, int, int rpad, bool scratch) {
    return scratch ? 0 : 12 * static_cast<size_t>(rpad);
  }

  template <bool kTaxon>
  __device__ static void general(const ScoreGroup& g, ReadState* st,
                                 const ScoreArgs& a, int b,
                                 unsigned char* mine) {
    const int R = a.R, Rpad = a.rpad;
    const size_t base = static_cast<size_t>(b) * R;
    int32_t* s_in = a.scratch ? a.scratch + static_cast<size_t>(b) * 3 * Rpad
                              : reinterpret_cast<int32_t*>(mine);
    int32_t* s_out = s_in + Rpad;
    int32_t* s_ps = s_out + Rpad;
    for (int i = g.rank; i < Rpad; i += g.size) {
      const bool hit = i < R && a.lanes[base + i] != 0;
      s_in[i] = hit ? a.t_in[base + i] : INT_MAX;
      s_out[i] = hit ? a.t_out[base + i] : INT_MAX;
    }
    g.sync();
    bitonic_sort2(g, s_in, s_out, Rpad);
    int my_best = 0;
    for (int i = g.rank; i < R; i += g.size) {
      const int ti = a.t_in[base + i];
      const int ps = a.lanes[base + i] != 0
                         ? upper_bound(s_in, Rpad, ti) -
                               upper_bound(s_out, Rpad, ti)
                         : 0;
      s_ps[i] = ps;
      my_best = max(my_best, ps);
    }
    if (my_best) atomicMax(&st->best, my_best);
    g.sync();
    group_winners<kTaxon>(g, st, R, [&](int i) {
      return ScorePos{a.lanes[base + i], a.t_in[base + i], s_ps[i]};
    });
  }
};

}  // namespace

// K3's contract (pangea_score in score_tin.cu) for R > 2048, with rpad (a
// power of two >= R) and scratch: null to sort in 12 * rpad bytes of shared
// memory a read, else int32 [B, 3, rpad] in device memory.
extern "C" int pangea_score_ranked(
    const void* lanes, const void* t_in, const void* t_out, const void* valid,
    int B, int R, int taxon_lanes, const void* tin, const void* tout,
    const void* depth, int T1, const void* parent, const void* up,
    int levels, const void* tin2node, int M, float thr, void* o0, void* o1,
    void* o2, void* o3, void* o4, void* o5, void* general,
    const void* prior, const void* p_best, const void* p_nvalid,
    const void* m_parent, const void* m_depth, const void* m_up,
    int m_levels, int m_T1, int wpr, int rpb, int cap, int per_read,
    int rpad, void* scratch, void* stream) {
  if (R < kMinR || rpad < R || (rpad & (rpad - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const ScoreArgs a =
      score_args(lanes, t_in, t_out, valid, B, R, tin, tout, depth, T1, parent, up,
                 levels, tin2node, M, thr, o0, o1, o2, o3, o4, o5, general,
                 prior, p_best, p_nvalid, m_parent, m_depth, m_up, m_levels,
                 m_T1, wpr, cap, per_read,
                 rpad, scratch);
  return score_launch<Ranked>(a, taxon_lanes, rpb,
                              static_cast<cudaStream_t>(stream));
}
