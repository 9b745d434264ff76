// K8: the per-read score of long reads (R > 2048 probes), by ranks.
//
// Replaces the XLA-compiled reference function
//   src/pangea_tpu/kernels/score.py:71  _pscore_ranked (B11)
// as _score_impl :176 runs it for the long-read buckets (chosen at
// :105-124), in both of K3's forms. The reference sorts [B, R] tin and tout
// arrays with lax.sort and ranks every probe with two searchsorted calls;
// here one block owns one read: it sorts the read's two arrays with a
// hand-written bitonic sort, ranks each probe with two upper-bound binary
// searches, and then runs K3's tail (score_finish in common.cuh), so K8
// computes exactly what K3 computes (the rules in score_tin.cu) and writes
// the same outputs: (taxon, best, nvalid), or the six winners arrays K5
// lifts.
//
// pscore_i = #{j hit : tin_j <= tin_i} - #{j hit : tout_j <= tin_i}, which
// is K3's #{j hit : tin_j <= tin_i < tout_j} because every hit's tin_j <
// tout_j. Misses, and the pad up to the next power of two Rpad, enter both
// sorted arrays as INT_MAX, after every real tin. The sorted arrays live in
// shared memory when 2 * Rpad * 4 bytes fit the opt-in limit (Rpad <=
// 16,384: R up to the single-end 16,384-base bucket); beyond that, in a
// global scratch [B, 2, Rpad] that the wrapper allocates.
//
// What bounds it on an H100: the sort, R log^2 R compare-exchanges a read
// from shared memory (or L2), and 3 x 2 binary searches a hit; device
// memory traffic is the [B, R] lanes about four times. The long-read
// buckets hold few rows (64-75 at the 16,384 bucket), so only that many of
// the 132 SMs work; each block sorts with 512 threads.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMinR = 2049;          // K3 scores R <= 2048
constexpr int kMaxTaxa = 4096;       // direct LCA scan; K5 lifts beyond

// Ascending bitonic sort of a[0, n) and c[0, n) together (n a power of
// two), by the whole block; ends with a barrier.
__device__ void bitonic_sort2(int32_t* a, int32_t* c, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n / 2; i += blockDim.x) {
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
      __syncthreads();
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

template <bool kTaxon, bool kDirect>
__global__ void __launch_bounds__(kThreads) score_ranked_kernel(
    const int32_t* __restrict__ lanes, const int32_t* __restrict__ t_in,
    const int32_t* __restrict__ t_out, const uint8_t* __restrict__ valid,
    int R, int Rpad, int32_t* __restrict__ scratch,
    const int32_t* __restrict__ tin, const int32_t* __restrict__ tout,
    const int32_t* __restrict__ depth, int T1, float thr,
    int32_t* __restrict__ o0, int32_t* __restrict__ o1,
    int32_t* __restrict__ o2, int32_t* __restrict__ o3,
    int32_t* __restrict__ o4, int32_t* __restrict__ o5) {
  extern __shared__ int32_t smem[];
  __shared__ ScoreState st;
  const int b = blockIdx.x;
  const size_t base = static_cast<size_t>(b) * R;
  int32_t* s_in = scratch ? scratch + static_cast<size_t>(b) * 2 * Rpad
                          : smem;
  int32_t* s_out = s_in + Rpad;

  score_state_init(&st);
  int nv = 0;
  for (int i = threadIdx.x; i < Rpad; i += blockDim.x) {
    const bool hit = i < R && lanes[base + i] != 0;
    s_in[i] = hit ? t_in[base + i] : INT_MAX;
    s_out[i] = hit ? t_out[base + i] : INT_MAX;
    if (i < R) nv += valid[base + i] != 0;
  }
  __syncthreads();
  if (nv) atomicAdd(&st.nvalid, nv);
  bitonic_sort2(s_in, s_out, Rpad);

  auto at = [&](int i) {
    const int lane = lanes[base + i];
    const int ti = t_in[base + i];
    const int ps = lane != 0 ? upper_bound(s_in, Rpad, ti) -
                                   upper_bound(s_out, Rpad, ti)
                             : 0;
    return ScorePos{lane, ti, ps};
  };
  int my_best = 0;
  for (int i = threadIdx.x; i < R; i += blockDim.x) {
    my_best = max(my_best, at(i).ps);
  }
  if (my_best) atomicMax(&st.best, my_best);
  __syncthreads();

  score_finish<kTaxon, kDirect>(&st, b, R, at, tin, tout, depth, T1, thr,
                                o0, o1, o2, o3, o4, o5);
}

template <bool kTaxon, bool kDirect>
cudaError_t launch(int B, int R, int Rpad, void* scratch, cudaStream_t s,
                   const void* lanes, const void* t_in, const void* t_out,
                   const void* valid, const void* tin, const void* tout,
                   const void* depth, int T1, float thr, void* o0, void* o1,
                   void* o2, void* o3, void* o4, void* o5) {
  const size_t smem =
      scratch ? 0 : 2 * static_cast<size_t>(Rpad) * sizeof(int32_t);
  auto kernel = score_ranked_kernel<kTaxon, kDirect>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, smem, s>>>(
      static_cast<const int32_t*>(lanes), static_cast<const int32_t*>(t_in),
      static_cast<const int32_t*>(t_out), static_cast<const uint8_t*>(valid),
      R, Rpad, static_cast<int32_t*>(scratch),
      static_cast<const int32_t*>(tin), static_cast<const int32_t*>(tout),
      static_cast<const int32_t*>(depth), T1, thr, static_cast<int32_t*>(o0),
      static_cast<int32_t*>(o1), static_cast<int32_t*>(o2),
      static_cast<int32_t*>(o3), static_cast<int32_t*>(o4),
      static_cast<int32_t*>(o5));
  return cudaGetLastError();
}

}  // namespace

// K3's contract (pangea_score in score_tin.cu) for R > 2048, plus Rpad (a
// power of two >= R) and scratch: null to sort in 2 * Rpad * 4 bytes of
// shared memory, else int32 [B, 2, Rpad] in device memory.
extern "C" int pangea_score_ranked(const void* lanes, const void* t_in,
                                   const void* t_out, const void* valid,
                                   int B, int R, int Rpad, void* scratch,
                                   int taxon_lanes, const void* tin,
                                   const void* tout, const void* depth,
                                   int T1, float thr, void* o0, void* o1,
                                   void* o2, void* o3, void* o4, void* o5,
                                   void* stream) {
  if (R < kMinR || Rpad < R || (Rpad & (Rpad - 1)) != 0 || T1 < 0 ||
      T1 > kMaxTaxa) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (taxon_lanes && T1 > 0) {
    err = launch<true, true>(B, R, Rpad, scratch, s, lanes, t_in, t_out,
                             valid, tin, tout, depth, T1, thr, o0, o1, o2,
                             o3, o4, o5);
  } else if (taxon_lanes) {
    err = launch<true, false>(B, R, Rpad, scratch, s, lanes, t_in, t_out,
                              valid, tin, tout, depth, T1, thr, o0, o1, o2,
                              o3, o4, o5);
  } else if (T1 > 0) {
    err = launch<false, true>(B, R, Rpad, scratch, s, lanes, t_in, t_out,
                              valid, tin, tout, depth, T1, thr, o0, o1, o2,
                              o3, o4, o5);
  } else {
    err = launch<false, false>(B, R, Rpad, scratch, s, lanes, t_in, t_out,
                               valid, tin, tout, depth, T1, thr, o0, o1, o2,
                               o3, o4, o5);
  }
  return static_cast<int>(err);
}
