// K4: std bucket-row probe plus full-key stash scan, one table shard.
//
// Replaces the XLA-compiled reference function
//   src/pangea_tpu/kernels/lookup.py:94  lookup_jnp (B8)
// (its _std_lanes :125-147 and the stash scan :165-172), with its owner
// mask for a table of S > 1 shards (:117-120; B14's std branch): a probe
// whose owner, the top log2 S bits of hash32, is not this shard gives zeros
// (owner_shift = 32 - log2 S; 0 turns the mask off). The reference
// gathers whole [N, 4W | 6W] rows into device memory and compares them in
// a second pass; here a group of kProbeLanes (8) lanes owns one probe and
// reads its row's hi lanes once, and the lo, val and Euler lanes only where
// they match, so no row copy reaches device memory.
//
// The sorted form (kSorted; B15, the reference's _sorted_std at
// lookup.py:389 through _sorted_apply :300) takes K9's output
// (bucket_sort.cu): the probes in bucket order. Group w probes the w-th
// sorted probe and writes its outputs as the w-th 16-byte record of
// sorted_out, which K9's restore puts back in the probes' order (the
// reference's restoring sort, :349-350). Invalid probes write
// zeros, as here unsorted, where the reference folds them into its
// _NEVER_HI sentinel (:386). The groups walk the table in bucket order, so
// a row read from HBM serves the probes that share it; the probe addresses
// the whole table, so there is no span guard and no fallback branch.
//
// What bounds it on an H100: one random row a probe, of which the W hi
// lanes (128 B at W = 32, 64 B at W = 16) are read, then one 32 B sector
// each of the lo, val and Euler lanes where hi matches. The wide bench
// table (131,072 rows x 768 B = 100.7 MB) is twice the 50 MB L2 and the
// deep std table (4,194,304 rows x 256 B) twenty times it, so most row
// reads go to HBM unsorted; each group makes two dependent random reads and
// little else, so the latency of those reads, not the HBM rate, is the
// likely limit. The packed k=31 table (16.8 MB) stays in L2.
//
// Rules (SEMANTICS.md §4-5): bucket = hash32(hi, lo) & (NB - 1); for a
// valid probe, every lane j < W with row[j] == hi && row[W + j] == lo adds
// val = row[2W + j] to taxon and, packed, pk = row[3W + j] (a wrapping
// uint32 sum, then t_in = pk >> 16 and t_out = pk & 0xFFFF) or, wide,
// row[3W + j] / row[4W + j] to t_in / t_out. Then every stash column s
// with hi == stash[0][s] && lo == stash[1][s] adds stash rows 2, 3 and 4
// to taxon, t_in and t_out. All sums wrap in 32 bits, as the reference's
// int32 sums do.
#include "common.cuh"

namespace {

template <bool kSorted>
__global__ void lookup_std_kernel(const uint32_t* __restrict__ hi,
                                  const uint32_t* __restrict__ lo,
                                  const uint8_t* __restrict__ valid,
                                  long long N,
                                  const uint32_t* __restrict__ fused,
                                  uint32_t nb_mask, int W, int lanes,
                                  bool packed,
                                  const uint32_t* __restrict__ stash, int S,
                                  int owner_shift, uint32_t shard_id,
                                  const SortedProbe* __restrict__ order,
                                  int4* __restrict__ sorted_out,
                                  int32_t* __restrict__ taxon,
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
  // a: pk (packed) or tin (wide); c: tout (wide only).
  uint32_t tax = 0, a = 0, c = 0, s_tax = 0, s_in = 0, s_out = 0;
  const uint32_t h = hash32(qhi, qlo);
  if (owner_shift > 0 && (h >> owner_shift) != shard_id) ok = false;
  if (ok) {
    const uint32_t bucket = h & nb_mask;
    const uint32_t* row = fused + static_cast<size_t>(bucket) * lanes;
    for (int j = g; j < W; j += kProbeLanes) {
      if (row[j] == qhi && row[W + j] == qlo) {
        tax += row[2 * W + j];
        a += row[3 * W + j];
        if (!packed) c += row[4 * W + j];
      }
    }
    for (int s = g; s < S; s += kProbeLanes) {
      if (stash[s] == qhi && stash[S + s] == qlo) {
        s_tax += stash[2 * S + s];
        s_in += stash[3 * S + s];
        s_out += stash[4 * S + s];
      }
    }
  }
  tax = group_sum(tax);
  a = group_sum(a);
  if (!packed) c = group_sum(c);
  if (S > 0) {
    s_tax = group_sum(s_tax);
    s_in = group_sum(s_in);
    s_out = group_sum(s_out);
  }
  if (in && g == 0) {
    const uint32_t r_in = packed ? a >> 16 : a;
    const uint32_t r_out = packed ? a & 0xFFFFu : c;
    const auto o0 = static_cast<int32_t>(tax + s_tax);
    const auto o1 = static_cast<int32_t>(r_in + s_in);
    const auto o2 = static_cast<int32_t>(r_out + s_out);
    if (kSorted) {
      sorted_out[w] = make_int4(o0, o1, o2, 0);
    } else {
      taxon[w] = o0;
      t_in[w] = o1;
      t_out[w] = o2;
    }
  }
}

}  // namespace

// hi/lo int32 bit patterns and valid bytes [N]; fused [NB, 4W] (packed) or
// [NB, 6W] (wide) and stash [5, S] int32 bit patterns; owner_shift: 0, or
// 32 - log2 of the table's shard count, with shard_id the table's shard (the
// owner mask); order: NULL, or K9's int32 [N, 4] sorted probes (index, hi,
// lo, valid), which the sorted form takes in place of hi/lo/valid, writing
// (taxon, t_in, t_out, 0) a probe in sorted order to sorted_out, int32
// [N, 4], in place of taxon/t_in/t_out, int32 [N].
extern "C" int pangea_lookup_std(const void* hi, const void* lo,
                                 const void* valid, long long N,
                                 const void* fused, long long NB, int W,
                                 int packed, const void* stash, int S,
                                 int owner_shift, int shard_id,
                                 const void* order, void* sorted_out,
                                 void* taxon, void* t_in, void* t_out,
                                 void* stream) {
  if (NB < 1 || NB > (1ll << 32) || (NB & (NB - 1)) != 0 || W < 1 ||
      S < 0 || owner_shift < 0 || owner_shift > 31 || shard_id < 0 ||
      (owner_shift > 0 && (shard_id >> (32 - owner_shift)) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  const int lanes = (packed ? 4 : 6) * W;
  const auto kernel = order != nullptr ? lookup_std_kernel<true>
                                       : lookup_std_kernel<false>;
  kernel<<<blocks_for(N, kProbesPerBlock), kProbesPerBlock * kProbeLanes, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
      static_cast<const uint8_t*>(valid), N,
      static_cast<const uint32_t*>(fused),
      static_cast<uint32_t>(NB - 1), W, lanes, packed != 0,
      static_cast<const uint32_t*>(stash), S, owner_shift,
      static_cast<uint32_t>(shard_id), static_cast<const SortedProbe*>(order),
      static_cast<int4*>(sorted_out),
      static_cast<int32_t*>(taxon), static_cast<int32_t*>(t_in),
      static_cast<int32_t*>(t_out));
  return static_cast<int>(cudaGetLastError());
}
