// K2: q8 and q12 bucket-row probes plus the full-key stash scan.
//
// Replaces the XLA-compiled reference functions
//   src/pangea_tpu/kernels/lookup.py:710  lookup_q8_jnp (B4)
// (with _umulh32_jnp :694 and the stash scan :775-782) and
//   src/pangea_tpu/kernels/lookup.py:629  lookup_q12_jnp (B10)
// (its three remainder branches :650-662 and the stash scan :683-690). The
// reference gathers whole rows into device memory and compares them in a
// second pass; here a group of kProbeLanes (8) lanes owns one probe, reads
// its row once (lane g reads the rem lanes j = g, g + 8, ... and, only on a
// match, the payload lane) and reduces with shuffles, so no row copy
// reaches device memory.
//
// The sorted form (kSorted; B15, the reference's _sorted_pk at
// lookup.py:354 through _sorted_apply :300) takes K9's output
// (bucket_sort.cu): the probes in bucket order. Group w probes the w-th
// sorted probe and writes its outputs as the w-th 16-byte record of
// sorted_out, which K9's restore puts back in the probes' order (the
// reference's restoring sort, :349-350). The groups walk the table in
// bucket order, so the probes of one row run close together in time and the
// row comes from HBM about once; unsorted, a probe past the 50 MB L2 pays
// one random HBM row read. A probe addresses the whole table, so no span
// can overflow, and there is no fallback branch.
//
// What bounds it on an H100: one random 512 B row read a probe, and the
// instructions around it. With one warp a probe it was bound by issue and
// latency (about as slow on a table that stays in L2 as on one five times
// the L2); a group of 8 lanes does the same work with a quarter of the
// warps and 3-step reductions. The q8 bench table (8.4
// MB) stays in the 50 MB L2; the config-4 q12 table (67.1 MB) and the deep
// tables do not. The TPU needed 32-bit limb arithmetic for the 62-bit mix;
// Hopper multiplies in 64 bits natively, so all three of the reference's
// q12 remainder branches are the one split below.
//
// Rules: K = hi << 32 | lo, m = 2k, h = K * 0x9E3779B1 mod 2^m, r = m -
// log2 NB (q8: [0, 31]; q12: [0, 62]), bucket = h >> r, rem = h & (2^r -
// 1). q8 rows are [rem | payload] x W: a slot matches when row[j] == rem.
// q12 rows are [rem_lo | rem_hi | payload] x W then pad: a slot matches when
// row[j] == rem & 0xFFFFFFFF and row[W + j] == rem >> 32 (empty slots hold
// rem_hi 0xFFFFFFFF, which no remainder reaches, so they never match, even
// when r < 32 makes every real rem_hi 0). pk = wrapping uint32 sum of the
// matching payload lanes, for valid probes only; t_in = pk >> 16, t_out =
// pk & 0xFFFF, hit = pk != 0. Then every stash column s with valid && hi ==
// stash[0][s] && lo == stash[1][s] adds stash rows 3 and 4 to t_in / t_out
// and 1 to hit.
#include "common.cuh"

namespace {

template <bool kQ12, bool kSorted>
__global__ void lookup_quot_kernel(const uint32_t* __restrict__ hi,
                                   const uint32_t* __restrict__ lo,
                                   const uint8_t* __restrict__ valid,
                                   long long N,
                                   const uint32_t* __restrict__ fused, int W,
                                   int row_lanes,
                                   const uint32_t* __restrict__ stash, int S,
                                   int m, int r,
                                   const SortedProbe* __restrict__ order,
                                   int4* __restrict__ sorted_out,
                                   int32_t* __restrict__ hit,
                                   int32_t* __restrict__ t_in,
                                   int32_t* __restrict__ t_out) {
  const int g = threadIdx.x % kProbeLanes;
  const long long w = blockIdx.x * static_cast<long long>(kProbesPerBlock) +
                      threadIdx.x / kProbeLanes;
  const bool in = w < N;    // the warp stays whole for its shuffles
  bool ok = false;
  uint32_t qhi = 0, qlo = 0;
  if (in) {
    if (kSorted) {
      const SortedProbe p = order[w];
      ok = p.valid != 0;
      qhi = p.hi;
      qlo = p.lo;
    } else {
      ok = valid[w] != 0;
      qhi = hi[w];
      qlo = lo[w];
    }
  }
  uint32_t pk = 0, s_in = 0, s_out = 0, s_hit = 0;   // wrapping sums
  if (ok) {
    const uint64_t K = (static_cast<uint64_t>(qhi) << 32) | qlo;
    const uint64_t h = (K * 0x9E3779B1ull) & ((1ull << m) - 1);
    const uint64_t bucket = h >> r;
    const uint64_t rem = h & ((1ull << r) - 1);
    const uint32_t rem_lo = static_cast<uint32_t>(rem);
    const uint32_t rem_hi = static_cast<uint32_t>(rem >> 32);
    const uint32_t* row = fused + bucket * static_cast<uint64_t>(row_lanes);
    const uint32_t* payload = row + (kQ12 ? 2 * W : W);
    for (int j = g; j < W; j += kProbeLanes) {
      if (row[j] == rem_lo && (!kQ12 || row[W + j] == rem_hi)) {
        pk += payload[j];
      }
    }
    for (int s = g; s < S; s += kProbeLanes) {
      if (stash[s] == qhi && stash[S + s] == qlo) {
        s_in += stash[3 * S + s];
        s_out += stash[4 * S + s];
        s_hit += 1;
      }
    }
  }
  pk = group_sum(pk);
  if (S > 0) {
    s_in = group_sum(s_in);
    s_out = group_sum(s_out);
    s_hit = group_sum(s_hit);
  }
  if (in && g == 0) {
    const int32_t o0 = (pk != 0 ? 1 : 0) + static_cast<int32_t>(s_hit);
    const auto o1 = static_cast<int32_t>((pk >> 16) + s_in);
    const auto o2 = static_cast<int32_t>((pk & 0xFFFFu) + s_out);
    if (kSorted) {
      sorted_out[w] = make_int4(o0, o1, o2, 0);
    } else {
      hit[w] = o0;
      t_in[w] = o1;
      t_out[w] = o2;
    }
  }
}

template <bool kQ12>
int launch(const void* hi, const void* lo, const void* valid, long long N,
           const void* fused, int W, int row_lanes, const void* stash, int S,
           int m, int r, const void* order, void* sorted_out, void* hit,
           void* t_in, void* t_out, void* stream) {
  if (N == 0) return 0;
  const auto kernel = order != nullptr ? lookup_quot_kernel<kQ12, true>
                                       : lookup_quot_kernel<kQ12, false>;
  kernel<<<blocks_for(N, kProbesPerBlock), kProbesPerBlock * kProbeLanes, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
      static_cast<const uint8_t*>(valid), N,
      static_cast<const uint32_t*>(fused), W, row_lanes,
      static_cast<const uint32_t*>(stash), S, m, r,
      static_cast<const SortedProbe*>(order), static_cast<int4*>(sorted_out),
      static_cast<int32_t*>(hit), static_cast<int32_t*>(t_in),
      static_cast<int32_t*>(t_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hi/lo int32 bit patterns and valid bytes [N]; fused [NB, 2W] and stash
// [5, S] int32 bit patterns; order: NULL, or K9's int32 [N, 4] sorted
// probes (index, hi, lo, valid), which the sorted form takes in place of
// hi/lo/valid, writing (hit, t_in, t_out, 0) a probe in sorted order to
// sorted_out, int32 [N, 4], in place of hit/t_in/t_out, int32 [N].
extern "C" int pangea_lookup_q8(const void* hi, const void* lo,
                                const void* valid, long long N,
                                const void* fused, long long NB, int W,
                                const void* stash, int S, int k,
                                const void* order, void* sorted_out,
                                void* hit, void* t_in, void* t_out,
                                void* stream) {
  const int log2nb = log2_exact(NB);
  const int r = 2 * k - log2nb;
  if (log2nb < 0 || k < 1 || k > 31 || r < 0 || r > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<false>(hi, lo, valid, N, fused, W, 2 * W, stash, S, 2 * k, r,
                       order, sorted_out, hit, t_in, t_out, stream);
}

// The q12 form: fused [NB, row_lanes] with row_lanes >= 3W.
extern "C" int pangea_lookup_q12(const void* hi, const void* lo,
                                 const void* valid, long long N,
                                 const void* fused, long long NB, int W,
                                 int row_lanes, const void* stash, int S,
                                 int k, const void* order, void* sorted_out,
                                 void* hit, void* t_in, void* t_out,
                                 void* stream) {
  const int log2nb = log2_exact(NB);
  const int r = 2 * k - log2nb;
  if (log2nb < 0 || k < 1 || k > 31 || r < 0 || r > 62 ||
      row_lanes < 3 * W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<true>(hi, lo, valid, N, fused, W, row_lanes, stash, S, 2 * k,
                      r, order, sorted_out, hit, t_in, t_out, stream);
}
