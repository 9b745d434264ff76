// K9: the table probes sorted by bucket, for the deep-table lookups.
//
// Replaces the two sorts of the XLA-compiled reference function
//   src/pangea_tpu/kernels/lookup.py:300  _sorted_apply (B15)
// the sort by bucket at :321 (pangea_bucket_sort) and the restoring sort at
// :349-350 (pangea_bucket_restore). The reference sorts (bucket, probe
// lanes..., index) tuples with a comparison sort, and sorts the outputs
// back by the carried index. Here the keys are small integers, so a
// counting sort does the first, a block a tile of kTile probes:
//   1. count: the block counts its tile's keys in shared memory, then adds
//      each nonzero count to the global counts (one atomic a key a tile);
//   2. scan: one block turns the counts into each key's first place;
//   3. scatter: the block counts its tile again in shared memory, each
//      probe taking its rank among the tile's probes of its key; claims a
//      run of places for each key with one atomic; and each probe writes
//      one 16-byte record, its index, hi, lo and valid (SortedProbe), at
//      its run's place plus its rank, and that place at its own index
//      (inv).
// A tile's probes of one key land side by side (about 8 records, 128 B, at
// 1,024 keys), so the record writes fill whole sectors. Stability is not
// needed: each probe's outputs depend on that probe alone. The sorted
// lookups (lookup_q8.cu, lookup_std.cu) read the records in order and write
// their outputs in sorted order, one 16-byte record a probe, and the
// restore gathers them back: out[i] = record[inv[i]], one random 16-byte
// read and contiguous writes a probe, where scattering three 4-byte
// outputs a probe would make three partial-sector writes.
//
// Rules: the bucket is h >> r of the q8/q12 mix (k > 0: K = hi << 32 | lo,
// m = 2k, h = K * 0x9E3779B1 mod 2^m, r = m - log2 NB) or hash32(hi, lo) &
// (NB - 1) (k = 0: the std bucket); key = bucket >> shift. An invalid probe
// i (its outputs are zeros, its row is never read) takes key i mod (NB >>
// shift), which spreads the invalid probes over all the keys. order holds
// the probes' records in ascending key order. The wrapper picks shift so
// that there are at most 2^10 keys: a key is 256 KB-1 MB of adjacent rows
// on the deep tables, and the lookup's warps, taking the probes in this
// order, walk the table from end to end with a few keys in flight.
//
// What bounds it on an H100: bytes. Two passes read each probe's 9 bytes,
// and the second writes its 16-byte record and its place; the restore
// reads 20 bytes and writes 12 a probe. Shared-memory atomics do the
// counting; a tile makes one global atomic a key in each pass.
//
// K10 (pangea_route_bin): the routing bin of the routed sharded step,
// replacing the lax.sort, searchsorted and four scatters of the
// XLA-compiled reference function
//   src/pangea_tpu/dist/mesh.py:371  _local_classify_routed (B14), :410-430
// with the third key rule: key = the probe's owner shard, the top log2 S
// bits of hash32 (:410). An invalid probe stays home (no slot, no count,
// inv = -1: its answer is zeros), where the reference sends it to owner 0
// as padding (:412), which fills owner 0's bin. One scatter pass of the
// same tile code, with no scan: a key's run of places starts at its owner's
// first slot owner * C, so each probe lands at owner * C + its rank among
// its owner's probes when that rank is below C, and counts an overflow
// otherwise (inv = -1, no record). The grid is zeroed first, so unused slots
// carry valid 0, and the counts end as each owner's total: the caller's
// overflow flag is max(counts) > C. The way back is the restore below, on
// the records the owners answered: out[i] = answer[inv[i]]. Bytes bound it:
// 9 bytes read and 20 written a probe, plus the S * C * 16-byte grid zeroed.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 8;                  // probes a thread in a tile
constexpr long long kTile = kThreads * kItems;
constexpr int kRestoreThreads = 256;

enum KeyKind { kQuotBucket, kStdBucket, kOwner };
constexpr uint32_t kHome = 0xFFFFFFFFu;   // kOwner: an invalid probe's key

struct KeyRule {
  KeyKind kind;        // the q8/q12 bucket, the std bucket or the owner
  int m, r;            // quotient mix width and remainder bits
  uint32_t nb_mask;    // NB - 1
  int shift;           // kOwner: 32 - log2 S (0: one shard)
  uint32_t key_mask;   // (NB >> shift) - 1
};

__device__ __forceinline__ uint32_t probe_key(const KeyRule& rule,
                                              uint32_t hi, uint32_t lo,
                                              bool ok, long long i) {
  if (rule.kind == kOwner) {
    if (!ok) return kHome;
    return rule.shift > 0 ? hash32(hi, lo) >> rule.shift : 0u;
  }
  if (!ok) return static_cast<uint32_t>(i) & rule.key_mask;
  uint64_t bucket;
  if (rule.kind == kQuotBucket) {
    const uint64_t K = (static_cast<uint64_t>(hi) << 32) | lo;
    bucket = ((K * 0x9E3779B1ull) & ((1ull << rule.m) - 1)) >> rule.r;
  } else {
    bucket = hash32(hi, lo) & rule.nb_mask;
  }
  return static_cast<uint32_t>(bucket >> rule.shift);
}

// One tile of kTile probes a block, counted by key in shared memory
// (tile_count, n_keys ints). kScatter = false adds the tile's counts to
// counter; kScatter = true claims a run of counter's places for each key
// and writes each probe's record at its run's place plus its rank: place
// pos itself (cap = 0, the sort), or key * cap + pos while pos < cap (the
// routing bin; a probe past cap, or with key kHome, writes no record and
// gets inv = -1).
template <bool kScatter>
__global__ void count_or_scatter(const uint32_t* __restrict__ hi,
                                 const uint32_t* __restrict__ lo,
                                 const uint8_t* __restrict__ valid,
                                 long long N, KeyRule rule, int n_keys,
                                 int cap, int* __restrict__ counter,
                                 SortedProbe* __restrict__ order,
                                 int32_t* __restrict__ inv) {
  extern __shared__ int tile_count[];
  for (int k = threadIdx.x; k < n_keys; k += kThreads) tile_count[k] = 0;
  __syncthreads();
  const long long base = blockIdx.x * kTile + threadIdx.x;
  uint32_t key[kItems];
  int rank[kItems];
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j * static_cast<long long>(kThreads);
    if (i < N) {
      key[j] = probe_key(rule, hi[i], lo[i], valid[i] != 0, i);
      rank[j] = key[j] != kHome ? atomicAdd(&tile_count[key[j]], 1) : 0;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_keys; k += kThreads) {
    const int c = tile_count[k];
    if (c == 0) continue;
    if (kScatter) {
      tile_count[k] = atomicAdd(&counter[k], c);   // the run's first place
    } else {
      atomicAdd(&counter[k], c);
    }
  }
  if (!kScatter) return;
  __syncthreads();
  for (int j = 0; j < kItems; ++j) {
    const long long i = base + j * static_cast<long long>(kThreads);
    if (i < N && key[j] == kHome) {
      inv[i] = -1;
    } else if (i < N) {
      int pos = tile_count[key[j]] + rank[j];
      if (cap > 0) {
        pos = pos < cap ? static_cast<int>(key[j]) * cap + pos : -1;
      }
      if (pos >= 0) {
        order[pos] = SortedProbe{static_cast<int32_t>(i), hi[i], lo[i],
                                 valid[i] != 0 ? 1u : 0u};
      }
      inv[i] = pos;
    }
  }
}

// Exclusive scan of counts[0, n) in place, by one block: each thread sums
// a run of ceil(n / blockDim) counts, the block scans the sums, and each
// thread writes its run's prefixes.
__global__ void scan_counts(int* __restrict__ counts, int n) {
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (n + kThreads - 1) / kThreads;
  const int begin = min(static_cast<int>(threadIdx.x) * per, n);
  const int end = min(begin + per, n);
  int sum = 0;
  for (int j = begin; j < end; ++j) sum += counts[j];
  int x = sum;                         // inclusive scan within the warp
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, s, off);
      if (lane >= off) s += y;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  int run = x - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int j = begin; j < end; ++j) {
    const int c = counts[j];
    counts[j] = run;
    run += c;
  }
}

__global__ void restore(const int32_t* __restrict__ inv,
                        const int4* __restrict__ sorted_out, long long N,
                        int32_t* __restrict__ o0, int32_t* __restrict__ o1,
                        int32_t* __restrict__ o2) {
  const long long i = blockIdx.x * static_cast<long long>(kRestoreThreads) +
                      threadIdx.x;
  if (i >= N) return;
  const int p = inv[i];
  const int4 v = p >= 0 ? sorted_out[p] : make_int4(0, 0, 0, 0);
  o0[i] = v.x;
  o1[i] = v.y;
  o2[i] = v.z;
}

}  // namespace

// hi/lo int32 bit patterns and valid bytes [N]; k: the q8/q12 rule at k, or
// 0 for the std rule; counts: int32 scratch of NB >> shift entries;
// order: int32 [N, 4], written with the probes' records (index, hi, lo,
// valid) in ascending key order; inv: int32 [N], each probe's place there.
extern "C" int pangea_bucket_sort(const void* hi, const void* lo,
                                  const void* valid, long long N,
                                  long long NB, int k, int shift,
                                  void* counts, void* order, void* inv,
                                  void* stream) {
  const int log2nb = log2_exact(NB);
  const int r = 2 * k - log2nb;
  if (log2nb < 0 || log2nb > 32 || N < 0 || N > INT_MAX || k < 0 ||
      k > 31 || shift < 0 || shift > log2nb || log2nb - shift > 12 ||
      (k > 0 && (r < 0 || r > 62))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  KeyRule rule;
  rule.kind = k > 0 ? kQuotBucket : kStdBucket;
  rule.m = 2 * k;
  rule.r = r;
  rule.nb_mask = static_cast<uint32_t>(NB - 1);
  rule.shift = shift;
  rule.key_mask = static_cast<uint32_t>((NB >> shift) - 1);
  const int n_keys = static_cast<int>(NB >> shift);
  const size_t smem = sizeof(int) * n_keys;      // at most 16 KB
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * n_keys, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = blocks_for(N, kTile);
  const auto h = static_cast<const uint32_t*>(hi);
  const auto l = static_cast<const uint32_t*>(lo);
  const auto v = static_cast<const uint8_t*>(valid);
  const auto c = static_cast<int*>(counts);
  count_or_scatter<false><<<blocks, kThreads, smem, s>>>(
      h, l, v, N, rule, n_keys, 0, c, nullptr, nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  scan_counts<<<1, kThreads, 0, s>>>(c, n_keys);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  count_or_scatter<true><<<blocks, kThreads, smem, s>>>(
      h, l, v, N, rule, n_keys, 0, c, static_cast<SortedProbe*>(order),
      static_cast<int32_t*>(inv));
  return static_cast<int>(cudaGetLastError());
}

// K10. hi/lo int32 bit patterns and valid bytes [N]; S = 2^log2S owners
// (log2S <= 12) of C slots each; counts: int32 [S], written with each
// owner's valid probes; records: int32 [S * C, 4], the slot grid, written with
// the records (index, hi, lo, valid) of the probes that fit and zeros
// elsewhere; inv: int32 [N], each probe's slot, or -1 for an invalid probe
// and past its owner's C.
extern "C" int pangea_route_bin(const void* hi, const void* lo,
                                const void* valid, long long N, int log2S,
                                int C, void* counts, void* records,
                                void* inv, void* stream) {
  if (N < 0 || N > INT_MAX || log2S < 0 || log2S > 12 || C < 1 ||
      (static_cast<long long>(C) << log2S) > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_keys = 1 << log2S;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * n_keys, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(records, 0,
                        sizeof(SortedProbe) * (static_cast<size_t>(C) << log2S),
                        s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N == 0) return 0;
  KeyRule rule{};
  rule.kind = kOwner;
  rule.shift = log2S > 0 ? 32 - log2S : 0;
  count_or_scatter<true><<<blocks_for(N, kTile), kThreads,
                           sizeof(int) * n_keys, s>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
      static_cast<const uint8_t*>(valid), N, rule, n_keys, C,
      static_cast<int*>(counts), static_cast<SortedProbe*>(records),
      static_cast<int32_t*>(inv));
  return static_cast<int>(cudaGetLastError());
}

// inv int32 [N] (pangea_bucket_sort's or pangea_route_bin's); sorted_out
// int32 [M, 4], a sorted lookup's outputs in sorted order or the owners'
// answers in slot order; o0/o1/o2 int32 [N]: the first three lanes of each
// probe's record, in the probes' own order (zeros where inv is -1).
extern "C" int pangea_bucket_restore(const void* inv, const void* sorted_out,
                                     long long N, void* o0, void* o1,
                                     void* o2, void* stream) {
  if (N < 0 || N > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  restore<<<blocks_for(N, kRestoreThreads), kRestoreThreads, 0,
            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(inv), static_cast<const int4*>(sorted_out),
      N, static_cast<int32_t*>(o0), static_cast<int32_t*>(o1),
      static_cast<int32_t*>(o2));
  return static_cast<int>(cudaGetLastError());
}
