// K9 and K10: the probes binned by a small integer key, one tile body for
// both.
//
// K9 (pangea_bucket_sort) replaces the two sorts of the XLA-compiled
// reference function
//   src/pangea_tpu/kernels/lookup.py:300  _sorted_apply (B15)
// the sort by bucket at :321 and the restoring sort at :349-350
// (pangea_bucket_restore, below). The reference sorts (bucket, probe
// lanes..., index) tuples with a comparison sort, and sorts the outputs
// back by the carried index. Here the keys are small integers, so K9 is a
// counting sort over tiles of kTile probes, a block of kThreads threads a
// tile, in three launches and no global atomics:
//   1. tile_counts: the block counts its tile's keys in shared memory and
//      writes the counts as one coalesced row of a [tiles, keys] scratch;
//   2. scan_columns: a block a group of 32 keys, a lane a key and its warps
//      over the tiles, turns each key's column into exclusive prefixes (the
//      key's probes in earlier tiles) and writes each key's total after the
//      last row;
//   3. scatter_tiles: the block keeps its tile's lanes in shared memory,
//      ranks its probes among the tile's probes of their key (one shared
//      atomic a probe), scans the tile's counts into each key's first slot
//      in the tile and the totals into each key's first place in the
//      output, stages a 4-byte slot a probe in key order (its key, its
//      place in the tile, its valid flag), writes each probe's place at its
//      own index (inv, coalesced), then writes the records (index, hi, lo,
//      valid: SortedProbe) out in slot order: consecutive lanes store
//      consecutive records of a key's run, 16 bytes each.
// Stability is not needed: each probe's outputs depend on that probe alone.
// The sorted lookups (lookup_q8.cu, lookup_std.cu) read the records in
// order and write their outputs in sorted order, one 16-byte record a
// probe, and the restore gathers them back: out[i] = record[inv[i]], one
// random 16-byte read and contiguous writes a probe, where scattering three
// 4-byte outputs a probe would make three partial-sector writes.
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
// What bounds it on an H100: bytes, 9 read and 20 written a probe. The
// design reads each probe's 9 bytes twice (the count pass and the scatter)
// and moves (tiles + 1) * keys * 4 bytes of counts four times (about 1 MB
// on deep q8's 2,129,920 probes). A tile is 8,192 probes, so a key's run
// from a tile averages 8 records (128 B) at 1,024 keys; a block of 512
// threads holds its tile in 96 KB of shared memory, so two tiles share an
// SM and one's barriers overlap the other's traffic. Warp-aggregated ranks
// (__match_any_sync) cost K9 more than they save: a warp's 32 lanes rarely
// share one of 1,024 keys.
//
// K10 (pangea_route_bin): the routing bin of the routed sharded step,
// replacing the lax.sort, searchsorted and four scatters of the
// XLA-compiled reference function
//   src/pangea_tpu/dist/mesh.py:371  _local_classify_routed (B14), :410-430
// with the third key rule: key = the probe's owner shard, the top log2 S
// bits of hash32 (:410). An invalid probe stays home (no slot, no count,
// inv = -1: its answer is zeros), where the reference sends it to owner 0
// as padding (:412), which fills owner 0's bin. The same scatter body,
// with no scan: a tile claims the run of each owner's places it needs with
// one global atomic on that owner's count, and each probe lands at owner *
// C + its place when the place is below C, and counts an overflow otherwise
// (inv = -1, no record). K10 ranks by warp-aggregated atomics (one shared
// atomic a distinct owner a warp), so that a warp's probes of one owner do
// not queue on one of S shared counters: against one atomic a probe, its
// scatter runs 17 % faster at one owner and 6 % at two on an H100, the
// same at four and 10 % slower at eight (PERF.md §6). The counts end
// as each owner's total: the caller's overflow flag is max(counts) > C. A
// tail launch then zeroes each owner's slots from min(count, C) to C, so
// every slot of the [S, C] grid is written once and unused slots carry
// valid 0. The way back is the restore below, on the records the owners
// answered: out[i] = answer[inv[i]]. Bytes bound it: 9 read and 20
// written a probe, plus the unused slots' zeros.
//
// The row probes' routing pass (pangea_rowprobe_route, for K11 and K12 of
// rowprobe_smem.cu and rowprobe_onehot.cu; it replaces no TPU kernel: the
// Pallas kernels it serves hold the whole table on chip, which no H100
// block can): K9's three launches with the fourth key rule, key =
// row_in(b, NB) >> shift, over tiles of kRouteTile queries. The records
// are (query index, row, rem, 1) in ascending key order, no inverse is
// written, and each query's output depends on it alone, so the order
// within a key is free. shift is 5 (a key is K12's 32-row k-tile, so any
// run of keys is a run of whole k-tiles), coarsened only past 2^
// kRouteKeyBits k-tiles (65,536 rows), where more keys than a tile has
// queries would cost the scatter's scans more than its queries and
// overflow the slots that hold a tile's row of places
// (kernels/rowprobe.py rowprobe_plan). The tile is a quarter of K9's: at
// mb_pallas's 524,288 queries K9's tile would give 64 blocks on 132 SMs,
// kRouteTile gives 256. Bytes bound it: 8 read and 16 written a query.
#include <mutex>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;              // a tile's block
constexpr int kItems = 16;                 // probes a thread in a tile
constexpr int kTile = kThreads * kItems;   // probes a tile
constexpr int kRouteItems = 4;             // the row probes' routing pass
constexpr int kRouteTile = kThreads * kRouteItems;
constexpr int kRouteKeyBits = 11;          // the routing pass's most keys
static_assert(1 << kRouteKeyBits <= kRouteTile,
              "a tile's row of places fits its slots");
constexpr int kWarps = kThreads / 32;
constexpr int kCountThreads = 1024;        // K9's count pass
constexpr int kScanKeys = 32;              // keys a scan block, a lane a key
constexpr int kScanWarps = 32;
constexpr int kZeroThreads = 256;
constexpr int kZeroSlots = kZeroThreads * 16;   // K10's slots a tail block
constexpr int kRestoreThreads = 256;
constexpr int kMaxKeyBits = 12;           // K9's and K10's most keys

enum KeyKind { kQuotBucket, kStdBucket, kOwner };
constexpr uint32_t kNone = 0xFFFFFFFFu;   // past N, or K10's invalid probe

struct KeyRule {
  KeyKind kind;        // the q8/q12 bucket, the std bucket or the owner
  int m, r;            // quotient mix width and remainder bits
  uint32_t nb_mask;    // NB - 1
  int shift;           // kOwner: 32 - log2 S (0: one shard)
  uint32_t key_mask;   // (NB >> shift) - 1
  long long nb;        // the routing pass: NB
};

// The routing pass: the row a row number names (row_in), which its record
// keeps; its key is row >> shift.
__device__ __forceinline__ uint32_t row_of(const KeyRule& rule,
                                           uint32_t b) {
  return static_cast<uint32_t>(row_in(static_cast<int32_t>(b), rule.nb));
}

__device__ __forceinline__ uint32_t probe_key(const KeyRule& rule,
                                              uint32_t hi, uint32_t lo,
                                              bool ok, long long i) {
  if (rule.kind == kOwner) {
    if (!ok) return kNone;
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

// Item j of thread x is probe tile * kT + j * kThreads + x, so each load
// and inv's stores are coalesced; the probe's place in its tile is
// j * kThreads + x.
template <int kT>
__device__ __forceinline__ long long tile_probe(int j) {
  return blockIdx.x * static_cast<long long>(kT) +
         j * static_cast<long long>(kThreads) + threadIdx.x;
}

// The rank of this lane's key among the earlier adds to count[key] and, in
// the warp, the lower lanes of its key. kAggregate: the warp's lanes of one
// key add their number with one shared atomic, made by the lowest of them
// (__match_any_sync; for K10's few keys); otherwise each lane adds 1 (K9's
// 1,024 keys, which a warp's lanes rarely share). kNone adds nothing. Every
// lane of the warp calls it.
template <bool kAggregate>
__device__ __forceinline__ int warp_rank(int* count, uint32_t key) {
  if (!kAggregate) return key != kNone ? atomicAdd(&count[key], 1) : 0;
  const unsigned peers = __match_any_sync(0xFFFFFFFFu, key);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  int first = 0;
  if (lane == leader && key != kNone) {
    first = atomicAdd(&count[key], __popc(peers));
  }
  first = __shfl_sync(0xFFFFFFFFu, first, leader);
  return first + __popc(peers & ((1u << lane) - 1u));
}

// Exclusive scan of v[0, n) in place by the block, each thread a run of
// ceil(n / kThreads) entries; f(key, count, first) sees each entry's value
// and its prefix. Returns the total. Ends with a barrier.
template <class F>
__device__ __forceinline__ int block_scan(int* v, int n, int* sums, F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (n + kThreads - 1) / kThreads;
  const int begin = min(static_cast<int>(threadIdx.x) * per, n);
  const int end = min(begin + per, n);
  int sum = 0;
  for (int k = begin; k < end; ++k) sum += v[k];
  int x = sum;                         // inclusive scan within the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kWarps ? sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, s, off);
      if (lane >= off) s += y;
    }
    if (lane < kWarps) sums[lane] = s;
  }
  __syncthreads();
  int run = x - sum + (warp > 0 ? sums[warp - 1] : 0);
  for (int k = begin; k < end; ++k) {
    const int c = v[k];
    v[k] = run;
    f(k, c, run);
    run += c;
  }
  const int total = sums[kWarps - 1];
  __syncthreads();
  return total;
}

// K9, pass 1: the tile's key counts, a row of counts [tiles, n_keys]. A
// block of kCountThreads threads, each loading its kT / kCountThreads
// probes before it hashes any. kRows: the routing pass (hi the row
// numbers, every probe valid, key = row >> shift).
template <int kT, bool kRows>
__global__ void __launch_bounds__(kCountThreads)
    tile_counts(const uint32_t* __restrict__ hi,
                const uint32_t* __restrict__ lo,
                const uint8_t* __restrict__ valid, long long N, KeyRule rule,
                int n_keys, int* __restrict__ counts) {
  constexpr int kCountItems = kT / kCountThreads;
  static_assert(kT % kCountThreads == 0, "a count pass thread's items");
  extern __shared__ int hist[];
  for (int k = threadIdx.x; k < n_keys; k += kCountThreads) hist[k] = 0;
  const long long base = blockIdx.x * static_cast<long long>(kT) +
                         threadIdx.x;
  uint32_t h[kCountItems], l[kCountItems];
  uint32_t ok = 0;
#pragma unroll
  for (int j = 0; j < kCountItems; ++j) {
    const long long i = base + j * static_cast<long long>(kCountThreads);
    const bool on = i < N;
    h[j] = on ? hi[i] : 0u;
    l[j] = on ? lo[i] : 0u;
    if (on && (kRows || valid[i] != 0)) ok |= 1u << j;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kCountItems; ++j) {
    const long long i = base + j * static_cast<long long>(kCountThreads);
    if (i < N) {
      atomicAdd(&hist[kRows ? row_of(rule, h[j]) >> rule.shift
                            : probe_key(rule, h[j], l[j], (ok >> j) & 1, i)],
                1);
    }
  }
  __syncthreads();
  int* row = counts + blockIdx.x * static_cast<long long>(n_keys);
  for (int k = threadIdx.x; k < n_keys; k += kCountThreads) row[k] = hist[k];
}

// K9, pass 2: each key's column of counts [tiles, n_keys] becomes its
// exclusive prefixes, and counts[tiles, key] its total.
__global__ void __launch_bounds__(kScanWarps * 32)
    scan_columns(int* __restrict__ counts, int tiles, int n_keys) {
  __shared__ int part[kScanWarps][kScanKeys + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int key = blockIdx.x * kScanKeys + lane;
  const bool on = key < n_keys;
  const int per = (tiles + kScanWarps - 1) / kScanWarps;
  const int t0 = min(warp * per, tiles), t1 = min(t0 + per, tiles);
  int* col = counts + key;
  int sum = 0;
  if (on) {
#pragma unroll 8
    for (int t = t0; t < t1; ++t) {
      sum += col[t * static_cast<long long>(n_keys)];
    }
  }
  part[warp][lane] = sum;
  __syncthreads();
  int run = 0, total = 0;
  for (int w = 0; w < kScanWarps; ++w) {
    const int v = part[w][lane];
    run += w < warp ? v : 0;
    total += v;
  }
  if (!on) return;
  for (int t = t0; t < t1; ++t) {
    const long long at = t * static_cast<long long>(n_keys);
    const int c = col[at];
    col[at] = run;
    run += c;
  }
  if (warp == 0) col[tiles * static_cast<long long>(n_keys)] = total;
}

// The scatter's arguments. K9: place = the scanned counts [tiles + 1,
// n_keys]; the routing pass: the same, valid and inv unused (every probe
// valid, no inverse). K10: cap = C, counts = the owners' counts
// [n_keys] (zeroed).
struct BinArgs {
  const uint32_t* hi;
  const uint32_t* lo;
  const uint8_t* valid;
  long long N;
  KeyRule rule;
  int n_keys;
  int cap;
  const int* place;
  int tiles;
  int* counts;
  int4* out;
  int32_t* inv;
};

// A staged slot: its key, its probe's place in the tile and valid flag.
constexpr int kLocalBits = 13;
static_assert(kTile <= 1 << kLocalBits, "a tile's places fit kLocalBits");

// Shared bytes of a scatter block of kT probes: the tile's hi and lo lanes
// in probe order and its slots in key order, then two ints a key.
template <int kT>
__host__ __device__ constexpr size_t scatter_smem(int n_keys) {
  return 3 * sizeof(uint32_t) * kT +
         2 * sizeof(int) * static_cast<size_t>(n_keys);
}

// K9 and the routing pass (kRoute false; kRows: the routing pass, valid
// and inv unused) and K10 (kRoute true), pass 3: one tile of kT probes a
// block.
template <int kT, bool kRoute, bool kRows>
__global__ void __launch_bounds__(kThreads, 2) scatter_tiles(const BinArgs a) {
  constexpr int kPer = kT / kThreads;
  static_assert(kT % kThreads == 0 && kT <= 1 << kLocalBits,
                "a tile's places fit kLocalBits");
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* shi = reinterpret_cast<uint32_t*>(smem);
  uint32_t* slo = shi + kT;
  uint32_t* slot = slo + kT;     // key << 14 | place in tile << 1 | valid
  int* off = reinterpret_cast<int*>(slot + kT);   // tile counts, then slots
  int* delta = off + a.n_keys;                       // a slot's place - slot
  // K9: the tile's row of place (its keys' probes in earlier tiles) waits
  // in the slots until the scans have read it.
  int* row = reinterpret_cast<int*>(slot);
  __shared__ int sums[kWarps];
  const int n_keys = a.n_keys;
  uint32_t key[kPer];
  uint32_t ok = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long i = tile_probe<kT>(j);
    const bool on = i < a.N;
    const uint32_t h = on ? (kRows ? row_of(a.rule, a.hi[i]) : a.hi[i]) : 0u;
    const uint32_t l = on ? a.lo[i] : 0u;
    const bool v = on && (kRows || a.valid[i] != 0);
    shi[j * kThreads + threadIdx.x] = h;
    slo[j * kThreads + threadIdx.x] = l;
    ok |= static_cast<uint32_t>(v) << j;
    key[j] = !on    ? kNone
             : kRows ? h >> a.rule.shift
                     : probe_key(a.rule, h, l, v, i);
  }
  const int* place =
      kRoute ? nullptr : a.place + blockIdx.x * static_cast<long long>(n_keys);
  const int* totals =
      kRoute ? nullptr : a.place + a.tiles * static_cast<long long>(n_keys);
  for (int k = threadIdx.x; k < n_keys; k += kThreads) {
    off[k] = 0;
    if (!kRoute) {
      delta[k] = totals[k];
      row[k] = place[k];
    }
  }
  __syncthreads();
  int rank[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) rank[j] = warp_rank<kRoute>(off, key[j]);
  if (!kRoute) {
    // The keys' totals become each key's first place in the output.
    block_scan(delta, n_keys, sums, [](int, int, int) {});
  } else {
    __syncthreads();
  }
  const int staged = block_scan(off, n_keys, sums, [&](int k, int c, int s) {
    if (kRoute) {
      delta[k] = (c > 0 ? atomicAdd(&a.counts[k], c) : 0) - s;
    } else {
      delta[k] += row[k] - s;
    }
  });
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const long long i = tile_probe<kT>(j);
    if (key[j] == kNone) {
      if (kRoute && i < a.N) a.inv[i] = -1;
      continue;
    }
    const int s = off[key[j]] + rank[j];
    const int pos = delta[key[j]] + s;
    slot[s] = key[j] << (kLocalBits + 1) |
              static_cast<uint32_t>(j * kThreads + threadIdx.x) << 1 |
              ((ok >> j) & 1);
    if (kRoute) {
      a.inv[i] = pos < a.cap ? static_cast<int>(key[j]) * a.cap + pos : -1;
    } else if (!kRows) {
      a.inv[i] = pos;
    }
  }
  __syncthreads();
  const long long first = blockIdx.x * static_cast<long long>(kT);
  for (int s = threadIdx.x; s < staged; s += kThreads) {
    const uint32_t e = slot[s];
    const int k = static_cast<int>(e >> (kLocalBits + 1));
    const int t = static_cast<int>(e >> 1) & ((1 << kLocalBits) - 1);
    const int pos = delta[k] + s;
    const int4 rec = make_int4(static_cast<int>(first + t),
                               static_cast<int>(shi[t]),
                               static_cast<int>(slo[t]),
                               static_cast<int>(e & 1));
    if (!kRoute) {
      a.out[pos] = rec;
    } else if (pos < a.cap) {
      a.out[static_cast<long long>(k) * a.cap + pos] = rec;
    }
  }
}

// K10's tail: zeros in owner blockIdx.y's slots from min(count, cap) on.
__global__ void __launch_bounds__(kZeroThreads)
    zero_unused(const int* __restrict__ counts, int cap,
                int4* __restrict__ records) {
  const long long used = min(counts[blockIdx.y], cap);
  const long long first = blockIdx.x * static_cast<long long>(kZeroSlots);
  const long long last = min(first + kZeroSlots, static_cast<long long>(cap));
  if (last <= used) return;
  int4* slots = records + blockIdx.y * static_cast<long long>(cap);
  for (long long r = max(first, used) + threadIdx.x; r < last;
       r += kZeroThreads) {
    slots[r] = make_int4(0, 0, 0, 0);
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

// The scatter launch. Its shared memory is opted in past 48 KB once a
// device, up to the most the launchers' 2^12 keys take.
template <int kT, bool kRoute, bool kRows = false>
cudaError_t launch_scatter(const BinArgs& a, unsigned tiles, cudaStream_t s) {
  constexpr int kDevices = 64;
  static std::mutex lock;
  static bool allowed[kDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> hold(lock);
    if (!allowed[dev]) {
      err = cudaFuncSetAttribute(
          scatter_tiles<kT, kRoute, kRows>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(scatter_smem<kT>(1 << kMaxKeyBits)));
      if (err != cudaSuccess) return err;
      allowed[dev] = true;
    }
  }
  scatter_tiles<kT, kRoute, kRows>
      <<<tiles, kThreads, scatter_smem<kT>(a.n_keys), s>>>(a);
  return cudaGetLastError();
}

// K9's three launches (kRows: the routing pass's) on tiles of kT probes:
// counts, column scan, scatter. counts: (ceil(N / kT) + 1) * n_keys ints.
template <int kT, bool kRows>
cudaError_t sort_tiles(const uint32_t* h, const uint32_t* l, const uint8_t* v,
                       long long N, const KeyRule& rule, int n_keys,
                       int* counts, int4* order, int32_t* inv,
                       cudaStream_t s) {
  const unsigned tiles = blocks_for(N, kT);
  tile_counts<kT, kRows><<<tiles, kCountThreads, sizeof(int) * n_keys, s>>>(
      h, l, v, N, rule, n_keys, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_columns<<<blocks_for(n_keys, kScanKeys), kScanWarps * 32, 0, s>>>(
      counts, static_cast<int>(tiles), n_keys);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const BinArgs a{h, l, v, N, rule, n_keys, 0, counts,
                  static_cast<int>(tiles), nullptr, order, inv};
  return launch_scatter<kT, false, kRows>(a, tiles, s);
}

}  // namespace

// hi/lo int32 bit patterns and valid bytes [N]; k: the q8/q12 rule at k, or
// 0 for the std rule; counts: int32 scratch of (ceil(N / kTile) + 1) *
// (NB >> shift) entries (kernels/lookup.py bin_plan); order: int32 [N, 4],
// written with the probes' records (index, hi, lo, valid) in ascending key
// order; inv: int32 [N], each probe's place there.
extern "C" int pangea_bucket_sort(const void* hi, const void* lo,
                                  const void* valid, long long N,
                                  long long NB, int k, int shift,
                                  void* counts, void* order, void* inv,
                                  void* stream) {
  const int log2nb = log2_exact(NB);
  const int r = 2 * k - log2nb;
  if (log2nb < 0 || log2nb > 32 || N < 0 || N > INT_MAX || k < 0 ||
      k > 31 || shift < 0 || shift > log2nb ||
      log2nb - shift > kMaxKeyBits || (k > 0 && (r < 0 || r > 62))) {
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
  return static_cast<int>(sort_tiles<kTile, false>(
      static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
      static_cast<const uint8_t*>(valid), N, rule,
      static_cast<int>(NB >> shift), static_cast<int*>(counts),
      static_cast<int4*>(order), static_cast<int32_t*>(inv),
      static_cast<cudaStream_t>(stream)));
}

// The row probes' routing pass. b int32 [N] row numbers, rem int32 [N]
// (uint32 bit patterns); key = row_in(b, NB) >> shift, 5 <= shift, at most
// 2^kRouteKeyBits keys; counts: int32 scratch of (ceil(N / kRouteTile) + 1)
// * ceil(NB / 2^shift) entries (kernels/rowprobe.py route_scratch), its
// last row each key's total; records: int32 [N, 4], written with (query
// index, row, rem, 1) in ascending key order.
extern "C" int pangea_rowprobe_route(const void* b, const void* rem,
                                     long long N, long long NB, int shift,
                                     void* counts, void* records,
                                     void* stream) {
  if (N < 0 || N > INT_MAX || NB < 1 || NB > INT_MAX || shift < 5 ||
      shift > 30 || ((NB - 1) >> shift) >= (1ll << kRouteKeyBits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  KeyRule rule{};
  rule.shift = shift;
  rule.nb = NB;
  return static_cast<int>(sort_tiles<kRouteTile, true>(
      static_cast<const uint32_t*>(b), static_cast<const uint32_t*>(rem),
      nullptr, N, rule, static_cast<int>(((NB - 1) >> shift) + 1),
      static_cast<int*>(counts), static_cast<int4*>(records), nullptr,
      static_cast<cudaStream_t>(stream)));
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
  if (N < 0 || N > INT_MAX || log2S < 0 || log2S > kMaxKeyBits || C < 1 ||
      (static_cast<long long>(C) << log2S) > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_keys = 1 << log2S;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto c = static_cast<int*>(counts);
  const auto grid = static_cast<int4*>(records);
  cudaError_t err = cudaMemsetAsync(c, 0, sizeof(int) * n_keys, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (N > 0) {
    KeyRule rule{};
    rule.kind = kOwner;
    rule.shift = log2S > 0 ? 32 - log2S : 0;
    const BinArgs a{static_cast<const uint32_t*>(hi),
                    static_cast<const uint32_t*>(lo),
                    static_cast<const uint8_t*>(valid), N, rule, n_keys, C,
                    nullptr, 0, c, grid, static_cast<int32_t*>(inv)};
    if ((err = launch_scatter<kTile, true>(a, blocks_for(N, kTile), s)) !=
        cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  zero_unused<<<dim3(blocks_for(C, kZeroSlots), n_keys), kZeroThreads, 0,
                s>>>(c, C, grid);
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
