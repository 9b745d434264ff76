// K4: std bucket-row probe plus full-key stash scan, one table shard.
//
// Replaces the XLA-compiled reference function
//   src/pangea_tpu/kernels/lookup.py:94  lookup_jnp (B8)
// (its _std_lanes :125-147 and the stash scan :165-172), with its owner
// mask for a table of S > 1 shards (:117-120; B14's std branch): a probe
// whose owner, the top log2 S bits of hash32, is not this shard gives zeros
// (owner_shift = 32 - log2 S; 0 turns the mask off). The reference
// gathers whole [N, 4W | 6W] rows into device memory and compares them in
// a second pass; here a group of kProbeLanes (8) lanes owns a probe and
// reads its row's key lanes, and the val and Euler lanes only where a key
// matches, so no row copy reaches device memory.
//
// The sorted form (kSorted; B15, the reference's _sorted_std at
// lookup.py:389 through _sorted_apply :300) takes K9's output
// (bucket_sort.cu): the probes in bucket order. The w-th sorted probe's
// outputs go to the w-th 16-byte record of sorted_out, which K9's restore
// puts back in the probes' order (the reference's restoring sort,
// :349-350). Invalid probes write zeros, as here unsorted, where the
// reference folds them into its _NEVER_HI sentinel (:386). The probes walk
// the table in bucket order, so a row read from HBM serves the probes that
// share it; the probe addresses the whole table, so there is no span guard
// and no fallback branch.
//
// What bounds it on an H100: a probe's random row. Its W hi and W lo lanes
// (256 B at W = 32) decide the hit; the val and Euler lanes (one 32 B
// sector each) are read for the slot that hits. The wide bench table
// (131,072 rows x 768 B = 100.7 MB) is twice the 50 MB L2, its key lanes
// (33.5 MB) are not; the deep std table (1.07 GB) is twenty times it. The
// first form gave each probe a group of 8 lanes that read its inputs,
// hashed it and wrote its outputs 8 times over, read its hi lanes in a
// loop over a runtime W with lo after hi and the payload after lo, and
// summed three values in three 3-step shuffle reductions a probe. The
// design:
//  - Each lane owns one of its warp's 32 consecutive probes a step: one
//    coalesced load of the inputs and one coalesced store of the outputs
//    a warp, one hash a probe, and each lane scans the stash (staged in
//    shared memory once a block) for its own probe.
//  - A group of 8 lanes probes the rows of its lanes' probes, `batch` of
//    them at a time, their key loads issued together: with W = 16 or 32
//    (what index/build.py auto_ways picks) and the row form as template
//    parameters, a lane reads its 2 or 4 hi lanes in one 8- or 16-byte
//    load and its lo lanes in a second (any other W: a generic body, both
//    keys a slot, no short-circuit); a matching slot's payload lanes
//    follow.
//  - A reduce-scatter over the group (7 shuffles a value for 8 probes)
//    hands each lane the row sums of its own probe.
//  - A persistent grid (kernels/lookup.py std_plan) walks the probes, the
//    next step's inputs loaded before the current step is probed.
//  - L2 policies (`l2`): the key lanes can be read evict-last, so that the
//    wide world's 33.5 MB of keys stay in L2, the payload lanes and the
//    streams (inputs and outputs) evict-first or evict-normal.
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

struct StdArgs {
  const uint32_t* hi;
  const uint32_t* lo;
  const uint8_t* valid;
  const SortedProbe* order;             // the sorted form's input
  long long N;
  const uint32_t* fused;
  uint32_t nb_mask;
  int W, lanes;                         // the generic body's geometry
  const uint32_t* stash;
  int S;
  bool staged;                          // the stash in shared memory
  int l2;                               // the L2 policy mode (Policies)
  int owner_shift;
  uint32_t shard_id;
  int4* sorted_out;
  int32_t* taxon;
  int32_t* t_in;
  int32_t* t_out;
};

// The probe's bucket, or kNoRow for an invalid probe or one the owner mask
// drops.
__device__ __forceinline__ uint32_t bucket_of(const StdArgs& a,
                                              const TableProbe& p) {
  const uint32_t h = hash32(p.hi, p.lo);
  const bool mine = a.owner_shift == 0 || (h >> a.owner_shift) == a.shard_id;
  return p.ok && mine ? h & a.nb_mask : kNoRow;
}

// Slot j's val and Euler lanes into the sums of probe r.
template <bool kPacked>
__device__ __forceinline__ void add_payload(const uint32_t* row, int W,
                                            int j, uint64_t pol,
                                            uint32_t& tax, uint32_t& x,
                                            uint32_t& y) {
  tax += ld(row + 2 * W + j, pol);
  x += ld(row + 3 * W + j, pol);
  if (!kPacked) y += ld(row + 4 * W + j, pol);
}

// Each lane owns one probe of the warp's 32 consecutive probes a step: it
// loads the probe's inputs (one coalesced load a warp), hashes it, scans
// the stash for it and writes its outputs (one coalesced store a warp).
// The rows are probed by groups of kProbeLanes (8) lanes: group q takes
// the probes of its own 8 lanes in turn, kR at a time, each lane
// comparing its slots of the row (kW 16 or 32: its 2 or 4 hi and lo lanes
// in one 8- or 16-byte load each, the kR probes' loads issued together;
// kW = 0, any W: slot by slot, both keys, no short-circuit) and reading a
// matching slot's payload lanes. A reduce-scatter then hands each lane the
// row sums of its own probe. The next step's inputs load before the
// current step is probed. The launch bounds hold a thread to 64 registers,
// so that the plan's 4 blocks of 8 warps fit an SM.
template <int kW, bool kPacked, bool kSorted, int kR>
__global__ void __launch_bounds__(kLookupWarps * 32, kLookupBlocks)
    lookup_std_kernel(const StdArgs a) {
  extern __shared__ uint32_t staged[];  // the stash, [5, S], when a.staged
  const uint32_t* stash = a.stash;
  if (a.staged) {
    for (int i = threadIdx.x; i < kStashRows * a.S; i += blockDim.x) {
      staged[i] = a.stash[i];
    }
    __syncthreads();
    stash = staged;
  }
  const Policies pol(a.l2);
  const int W = kW ? kW : a.W;
  const int lanes = kW ? (kPacked ? 4 : 6) * kW : a.lanes;
  const int S = a.S;
  const int lane = threadIdx.x % 32;
  const int g = lane % kProbeLanes;
  const long long warps = static_cast<long long>(gridDim.x) * blockDim.x /
                          32;
  const long long step = warps * 32;
  const long long first = (static_cast<long long>(blockIdx.x) *
                           blockDim.x / 32 + threadIdx.x / 32) * 32;

  TableProbe me = load_probe<kSorted>(a.hi, a.lo, a.valid, a.order, a.N,
                                      first + lane, pol.streams);
  for (long long base = first; base < a.N; base += step) {
    const TableProbe next = load_probe<kSorted>(
        a.hi, a.lo, a.valid, a.order, a.N, base + step + lane, pol.streams);
    const uint32_t my_bucket = bucket_of(a, me);
    uint32_t tax[8], x[8], y[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) tax[r] = x[r] = y[r] = 0u;
#pragma unroll
    for (int r0 = 0; r0 < 8; r0 += kR) {
      uint32_t qhi[kR], qlo[kR], qb[kR];
#pragma unroll
      for (int q = 0; q < kR; ++q) {
        qhi[q] = __shfl_sync(0xFFFFFFFFu, me.hi, r0 + q, kProbeLanes);
        qlo[q] = __shfl_sync(0xFFFFFFFFu, me.lo, r0 + q, kProbeLanes);
        qb[q] = __shfl_sync(0xFFFFFFFFu, my_bucket, r0 + q, kProbeLanes);
      }
      if constexpr (kW != 0) {
        constexpr int K = kW / kProbeLanes;
        uint32_t kh[kR][K], kl[kR][K];
#pragma unroll
        for (int q = 0; q < kR; ++q) {
          if (qb[q] != kNoRow) {
            const uint32_t* row =
                a.fused + static_cast<size_t>(qb[q]) * lanes;
            ld_vec<K>(row + g * K, pol.keys, kh[q]);
            ld_vec<K>(row + kW + g * K, pol.keys, kl[q]);
          }
        }
#pragma unroll
        for (int q = 0; q < kR; ++q) {
          if (qb[q] == kNoRow) continue;
          const uint32_t* row = a.fused + static_cast<size_t>(qb[q]) * lanes;
#pragma unroll
          for (int i = 0; i < K; ++i) {
            if (kh[q][i] == qhi[q] && kl[q][i] == qlo[q]) {
              add_payload<kPacked>(row, kW, g * K + i, pol.payload,
                                   tax[r0 + q], x[r0 + q], y[r0 + q]);
            }
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < kR; ++q) {
          if (qb[q] == kNoRow) continue;
          const uint32_t* row = a.fused + static_cast<size_t>(qb[q]) * lanes;
#pragma unroll 4
          for (int j = g; j < W; j += kProbeLanes) {
            const uint32_t h = ld(row + j, pol.keys);
            const uint32_t l = ld(row + W + j, pol.keys);
            if (h == qhi[q] && l == qlo[q]) {
              add_payload<kPacked>(row, W, j, pol.payload, tax[r0 + q],
                                   x[r0 + q], y[r0 + q]);
            }
          }
        }
      }
    }
    // This lane's probe: its row sums, then its stash matches.
    uint32_t o0 = reduce_scatter(tax, g);
    const uint32_t pk = reduce_scatter(x, g);
    uint32_t o1 = kPacked ? pk >> 16 : pk;
    uint32_t o2 = kPacked ? pk & 0xFFFFu : reduce_scatter(y, g);
    if (my_bucket != kNoRow) {
      for (int s = 0; s < S; ++s) {
        if (stash[s] == me.hi && stash[S + s] == me.lo) {
          o0 += stash[2 * S + s];
          o1 += stash[3 * S + s];
          o2 += stash[4 * S + s];
        }
      }
    }
    const long long w = base + lane;
    if (w < a.N) {
      if (kSorted) {
        st_v4(a.sorted_out + w, o0, o1, o2, pol.streams);
      } else {
        st(a.taxon + w, o0, pol.streams);
        st(a.t_in + w, o1, pol.streams);
        st(a.t_out + w, o2, pol.streams);
      }
    }
    me = next;
  }
}

using Kernel = void (*)(StdArgs);

template <int kW, bool kPacked, bool kSorted>
Kernel pick_r(int batch) {
  switch (batch) {
    case 2: return lookup_std_kernel<kW, kPacked, kSorted, 2>;
    case 4: return lookup_std_kernel<kW, kPacked, kSorted, 4>;
    default: return nullptr;
  }
}

template <bool kPacked, bool kSorted>
Kernel pick_w(int spec, int batch) {
  switch (spec) {
    case 0: return pick_r<0, kPacked, kSorted>(batch);
    case 16: return pick_r<16, kPacked, kSorted>(batch);
    case 32: return pick_r<32, kPacked, kSorted>(batch);
    default: return nullptr;
  }
}

Kernel pick(int spec, bool packed, bool sorted, int batch) {
  if (packed) {
    return sorted ? pick_w<true, true>(spec, batch)
                  : pick_w<true, false>(spec, batch);
  }
  return sorted ? pick_w<false, true>(spec, batch)
                : pick_w<false, false>(spec, batch);
}

}  // namespace

// hi/lo int32 bit patterns and valid bytes [N]; fused [NB, 4W] (packed) or
// [NB, 6W] (wide) and stash [5, S] int32 bit patterns; owner_shift: 0, or
// 32 - log2 of the table's shard count, with shard_id the table's shard (the
// owner mask); order: NULL, or K9's int32 [N, 4] sorted probes (index, hi,
// lo, valid), which the sorted form takes in place of hi/lo/valid, writing
// (taxon, t_in, t_out, 0) a probe in sorted order to sorted_out, int32
// [N, 4], in place of taxon/t_in/t_out, int32 [N]. The plan (std_plan of
// kernels/lookup.py): grid blocks of `warps` warps; batch probes (2 or 4)
// whose key loads a group issues together; spec the W of the specialised
// body (16 or 32, equal to W, fused 16-byte aligned) or 0 for the generic
// one; l2 the L2 policy mode (0-2); smem 20 S bytes to stage the stash in
// shared memory, or 0.
extern "C" int pangea_lookup_std(const void* hi, const void* lo,
                                 const void* valid, long long N,
                                 const void* fused, long long NB, int W,
                                 int packed, const void* stash, int S,
                                 int owner_shift, int shard_id,
                                 const void* order, void* sorted_out,
                                 void* taxon, void* t_in, void* t_out,
                                 int grid, int warps, int batch, int spec,
                                 int l2, int smem, void* stream) {
  // NB <= 2^31 leaves kNoRow out of every table (2^31 rows are 512 GB).
  if (NB < 1 || NB > (1ll << 31) || (NB & (NB - 1)) != 0 || W < 1 ||
      S < 0 || owner_shift < 0 || owner_shift > 31 || shard_id < 0 ||
      (owner_shift > 0 && (shard_id >> (32 - owner_shift)) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  if (grid < 1 || warps < 1 || warps > kLookupWarps || l2 < 0 || l2 > 2 ||
      (spec != 0 && (spec != W ||
                     reinterpret_cast<uintptr_t>(fused) % 16 != 0)) ||
      (smem != 0 && (smem != 4 * kStashRows * S || smem > kStashSmemMax))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel kernel = pick(spec, packed != 0, order != nullptr, batch);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  StdArgs a;
  a.hi = static_cast<const uint32_t*>(hi);
  a.lo = static_cast<const uint32_t*>(lo);
  a.valid = static_cast<const uint8_t*>(valid);
  a.order = static_cast<const SortedProbe*>(order);
  a.N = N;
  a.fused = static_cast<const uint32_t*>(fused);
  a.nb_mask = static_cast<uint32_t>(NB - 1);
  a.W = W;
  a.lanes = (packed ? 4 : 6) * W;
  a.stash = static_cast<const uint32_t*>(stash);
  a.S = S;
  a.staged = smem != 0;
  a.l2 = l2;
  a.owner_shift = owner_shift;
  a.shard_id = static_cast<uint32_t>(shard_id);
  a.sorted_out = static_cast<int4*>(sorted_out);
  a.taxon = static_cast<int32_t*>(taxon);
  a.t_in = static_cast<int32_t*>(t_in);
  a.t_out = static_cast<int32_t*>(t_out);
  kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
