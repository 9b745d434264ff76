// K2: q8 and q12 bucket-row probes plus the full-key stash scan.
//
// Replaces the XLA-compiled reference functions
//   src/pangea_tpu/kernels/lookup.py:710  lookup_q8_jnp (B4)
// (with _umulh32_jnp :694 and the stash scan :775-782) and
//   src/pangea_tpu/kernels/lookup.py:629  lookup_q12_jnp (B10)
// (its three remainder branches :650-662 and the stash scan :683-690). The
// reference gathers whole rows into device memory and compares them in a
// second pass; here a group of kProbeLanes (8) lanes reads a probe's row
// once (its key lanes, and a matching slot's rem_hi and payload lanes), so
// no row copy reaches device memory.
//
// The sorted form (kSorted; B15, the reference's _sorted_pk at
// lookup.py:354 through _sorted_apply :300) takes K9's output
// (bucket_sort.cu): the probes in bucket order. The w-th sorted probe's
// outputs go to the w-th 16-byte record of sorted_out, which K9's restore
// puts back in the probes' order (the reference's restoring sort,
// :349-350). The probes walk the table in bucket order, so a row read from
// HBM serves the probes that share it; a probe addresses the whole table,
// so there is no span guard and no fallback branch.
//
// What bounds it on an H100: a probe's random row. Its key lanes decide the
// hit: q8's W rem lanes (256 B at W = 64) or q12's W rem_lo lanes (168 B at
// W = 42, six 32 B sectors); a matching slot's rem_hi and payload lanes
// (a sector each) follow. The q8 bench table (8.4 MB) stays in the 50 MB
// L2; config 4's q12 table (131,072 rows x 512 B = 67.1 MB) does not, but
// its rem_lo region (131,072 x 192 B = 25.2 MB) can. The first form gave
// each probe a group of 8 lanes that loaded its inputs and stored its
// outputs 8 times over, walked a runtime W in 4-byte loads, and read
// rem_hi only after rem_lo matched and the payload only after rem_hi did.
// The design (K4's, csrc/lookup_std.cu):
//  - Each lane owns one of its warp's 32 consecutive probes a step: one
//    coalesced load of the inputs (or of K9's 16-byte records) and one
//    coalesced store of the outputs (one 16-byte record a sorted probe) a
//    warp, one mix a probe, and each lane scans the stash (staged in
//    shared memory once a block) for its own probe.
//  - A group of 8 lanes probes the rows of its lanes' probes, kBatch (2)
//    at a time, every key load of the batch issued before any compare (4
//    at a time spilled and ran slower everywhere). With W a template
//    parameter (64 for q8, 42 for q12: index/quot.py Q8_WAYS and
//    Q12_WAYS) a row's key lanes are read as 16-byte words, word i by
//    lane i % 8 (KeyWords): q8's 16 words two a lane; q12's 10.5 words,
//    lanes 0-7 words 0-7 and lanes 0-2 words 8-10, where word 10's last
//    two lanes are rem_hi[0..1] and are never compared as keys. Any
//    other W: a generic body, slot by slot.
//  - A hit costs one more round trip, which the group's 8 rows share:
//    once the key lanes of all 8 rows are compared, each lane issues the
//    loads of the rem_hi lane (q12) and the payload lane of its first
//    matching slot in every row together, then decides. A lane's further
//    matches in one row (at r >= 32 rem_lo alone can match several slots;
//    a probe whose rem_lo is 0 matches every empty slot) follow one by
//    one, so every slot that matches both halves is summed, as the
//    reference sums it.
//  - A reduce-scatter over the group (7 shuffles for 8 probes) hands each
//    lane its own probe's payload sum.
//  - A persistent grid (kernels/lookup.py quot_plan) walks the probes, the
//    next step's inputs loaded before the current step is probed.
//  - L2 policies (`l2`, common.cuh Policies): the key lanes can be read
//    evict-last, so that q12's rem_lo region stays in L2, with the rem_hi
//    and payload lanes and the streams evict-first or evict-normal.
// Hopper multiplies in 64 bits natively, so all three of the reference's
// q12 remainder branches (the TPU's 32-bit limb arithmetic) are one split.
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

constexpr int kQ8Spec = 64;    // index/quot.py Q8_WAYS
constexpr int kQ12Spec = 42;   // index/quot.py Q12_WAYS
constexpr int kBatch = 2;      // rows whose key loads a group issues together

struct QuotArgs {
  const uint32_t* hi;
  const uint32_t* lo;
  const uint8_t* valid;
  const SortedProbe* order;             // the sorted form's input
  long long N;
  const uint32_t* fused;
  int W, row_lanes;
  int m, r;                             // mix bits (2k), remainder bits
  const uint32_t* stash;
  int S;
  bool staged;                          // the stash in shared memory
  int l2;                               // the L2 policy mode (Policies)
  int4* sorted_out;
  int32_t* hit;
  int32_t* t_in;
  int32_t* t_out;
};

// A probe's row and the two 32-bit halves of its remainder; row kNoRow for
// an invalid probe.
struct Quot {
  uint32_t row, rem_lo, rem_hi;
};

__device__ __forceinline__ Quot quot_of(const QuotArgs& a,
                                        const TableProbe& p) {
  const uint64_t K = (static_cast<uint64_t>(p.hi) << 32) | p.lo;
  const uint64_t h = (K * 0x9E3779B1ull) & ((1ull << a.m) - 1);
  const uint64_t rem = h & ((1ull << a.r) - 1);
  return {p.ok ? static_cast<uint32_t>(h >> a.r) : kNoRow,
          static_cast<uint32_t>(rem), static_cast<uint32_t>(rem >> 32)};
}

// The key lanes of a row of the specialised body as 16-byte words: word i
// (key lanes 4i to 4i + 3) is lane i % 8's load i / 8; a lane of a word
// past kW - 1 is not a key. Bit 4t + e of a lane's match mask of a row is
// element e of its load t: key slot 4(g + 8t) + e of lane g. The masks of
// the group's 8 rows share one 64-bit word, a byte a row.
template <int kW>
struct KeyWords {
  static constexpr int kWords = (kW + 3) / 4;
  static constexpr int kLoads = (kWords + kProbeLanes - 1) / kProbeLanes;
  static_assert(kLoads * 4 <= 8, "a lane's matches in a row fit a byte");

  __device__ static int slot(int g, int bit) {
    return 4 * (g + kProbeLanes * (bit >> 2)) + (bit & 3);
  }
};

// Lane g's further matching slots of a row (every bit of `match` but its
// lowest, KeyWords' bits): each adds its payload lane to pk where its
// rem_hi lane (q12) is rem_hi too, one slot a round trip.
template <int kW, bool kQ12>
__device__ __forceinline__ void add_rest(const uint32_t* row, int g,
                                         uint32_t match, uint32_t rem_hi,
                                         uint64_t pol, uint32_t& pk) {
  for (uint32_t rest = match & (match - 1); rest != 0; rest &= rest - 1) {
    const int j = KeyWords<kW>::slot(g, __ffs(rest) - 1);
    const uint32_t h = kQ12 ? ld(row + kW + j, pol) : 0u;
    const uint32_t p = ld(row + (kQ12 ? 2 : 1) * kW + j, pol);
    if (!kQ12 || h == rem_hi) pk += p;
  }
}

// Each lane owns one probe of the warp's 32 consecutive probes a step: it
// loads the probe's inputs (one coalesced load a warp), mixes it, scans
// the stash for it and writes its outputs (one coalesced store a warp).
// The rows are probed by groups of kProbeLanes (8) lanes: the group takes
// the rows of its own 8 lanes' probes, each lane comparing its key slots
// of each row (kW 64 or 42: its 16-byte words, the loads of kBatch rows
// issued together, then the rem_hi and payload loads of its first match in
// all 8 rows together; kW = 0, any W: kBatch rows at a time, slot by
// slot). A reduce-scatter then hands each lane its own probe's payload
// sum. The next step's inputs load before the current step is probed.
template <int kW, bool kQ12, bool kSorted>
__global__ void __launch_bounds__(kLookupWarps * 32, kLookupBlocks)
    lookup_quot_kernel(const QuotArgs a) {
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
  const int pay = (kQ12 ? 2 : 1) * W;   // the payload lanes' offset
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
    const Quot mine = quot_of(a, me);
    uint32_t pk[8];                     // the lane's part of each row's sum
    if constexpr (kW != 0) {
      using KW = KeyWords<kW>;
      // 1. The key words of the group's 8 rows, kBatch rows' loads
      // issued together, compared into each row's match byte.
      uint64_t matches = 0u;
#pragma unroll
      for (int r0 = 0; r0 < 8; r0 += kBatch) {
        uint32_t qrow[kBatch], qlo[kBatch], key[kBatch][KW::kLoads][4];
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          qrow[q] = __shfl_sync(0xFFFFFFFFu, mine.row, r0 + q, kProbeLanes);
          qlo[q] = __shfl_sync(0xFFFFFFFFu, mine.rem_lo, r0 + q,
                               kProbeLanes);
          if (qrow[q] == kNoRow) continue;
          const uint32_t* row =
              a.fused + static_cast<size_t>(qrow[q]) * a.row_lanes;
#pragma unroll
          for (int t = 0; t < KW::kLoads; ++t) {
            const int word = g + kProbeLanes * t;
            if (word < KW::kWords) {
              ld_vec<4>(row + 4 * word, pol.keys, key[q][t]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          uint32_t m = 0u;
#pragma unroll
          for (int t = 0; t < KW::kLoads; ++t) {
            const int word = g + kProbeLanes * t;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (qrow[q] != kNoRow && word < KW::kWords &&
                  4 * word + e < kW && key[q][t][e] == qlo[q]) {
                m |= 1u << (4 * t + e);
              }
            }
          }
          matches |= static_cast<uint64_t>(m) << (8 * (r0 + q));
        }
      }
      // 2. The first matching slot of each of the 8 rows: its rem_hi
      // (q12) and payload loads, all issued before any is used.
      uint32_t mh[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const uint32_t qrow = __shfl_sync(0xFFFFFFFFu, mine.row, r,
                                          kProbeLanes);
        const uint32_t m = static_cast<uint32_t>(matches >> (8 * r)) & 0xFFu;
        pk[r] = 0u;
        if (m == 0u) continue;
        const uint32_t* row = a.fused + static_cast<size_t>(qrow) *
                                            a.row_lanes;
        const int j = KW::slot(g, __ffs(m) - 1);
        mh[r] = kQ12 ? ld(row + W + j, pol.payload) : 0u;
        pk[r] = ld(row + pay + j, pol.payload);
      }
      // 3. Kept where rem_hi matches too; a row's further matches (rare)
      // one by one.
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const uint32_t qrow = __shfl_sync(0xFFFFFFFFu, mine.row, r,
                                          kProbeLanes);
        const uint32_t qhi = kQ12 ? __shfl_sync(0xFFFFFFFFu, mine.rem_hi, r,
                                                kProbeLanes)
                                  : 0u;
        const uint32_t m = static_cast<uint32_t>(matches >> (8 * r)) & 0xFFu;
        if (m == 0u) continue;
        if (kQ12 && mh[r] != qhi) pk[r] = 0u;
        add_rest<kW, kQ12>(a.fused + static_cast<size_t>(qrow) *
                                         a.row_lanes,
                           g, m, qhi, pol.payload, pk[r]);
      }
    } else {
      // Any W: the group's 8 rows kBatch at a time, slot by slot.
#pragma unroll
      for (int q = 0; q < 8; ++q) pk[q] = 0u;
#pragma unroll
      for (int r0 = 0; r0 < 8; r0 += kBatch) {
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const uint32_t qrow = __shfl_sync(0xFFFFFFFFu, mine.row, r0 + q,
                                            kProbeLanes);
          const uint32_t qlo = __shfl_sync(0xFFFFFFFFu, mine.rem_lo, r0 + q,
                                           kProbeLanes);
          const uint32_t qhi = kQ12 ? __shfl_sync(0xFFFFFFFFu, mine.rem_hi,
                                                  r0 + q, kProbeLanes)
                                    : 0u;
          if (qrow == kNoRow) continue;
          const uint32_t* row =
              a.fused + static_cast<size_t>(qrow) * a.row_lanes;
#pragma unroll 4
          for (int j = g; j < W; j += kProbeLanes) {
            if (ld(row + j, pol.keys) == qlo) {
              const uint32_t h = kQ12 ? ld(row + W + j, pol.payload) : 0u;
              const uint32_t p = ld(row + pay + j, pol.payload);
              if (!kQ12 || h == qhi) pk[r0 + q] += p;
            }
          }
        }
      }
    }
    // This lane's probe: its payload sum, then its stash matches.
    const uint32_t sum = reduce_scatter(pk, g);
    uint32_t o0 = sum != 0u ? 1u : 0u;
    uint32_t o1 = sum >> 16;
    uint32_t o2 = sum & 0xFFFFu;
    if (mine.row != kNoRow) {
      for (int s = 0; s < S; ++s) {
        if (stash[s] == me.hi && stash[S + s] == me.lo) {
          o0 += 1u;
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
        st(a.hit + w, o0, pol.streams);
        st(a.t_in + w, o1, pol.streams);
        st(a.t_out + w, o2, pol.streams);
      }
    }
    me = next;
  }
}

using Kernel = void (*)(QuotArgs);

template <bool kQ12, bool kSorted>
Kernel pick_w(int spec) {
  constexpr int kSpec = kQ12 ? kQ12Spec : kQ8Spec;
  if (spec == 0) return lookup_quot_kernel<0, kQ12, kSorted>;
  if (spec == kSpec) return lookup_quot_kernel<kSpec, kQ12, kSorted>;
  return nullptr;
}

Kernel pick(bool q12, bool sorted, int spec) {
  if (q12) {
    return sorted ? pick_w<true, true>(spec) : pick_w<true, false>(spec);
  }
  return sorted ? pick_w<false, true>(spec) : pick_w<false, false>(spec);
}

int launch(bool q12, const void* hi, const void* lo, const void* valid,
           long long N, const void* fused, long long NB, int W,
           int row_lanes, const void* stash, int S, int k,
           const void* order, void* sorted_out, void* hit, void* t_in,
           void* t_out, int grid, int warps, int batch, int spec, int l2,
           int smem, void* stream) {
  const int log2nb = log2_exact(NB);
  const int r = 2 * k - log2nb;
  // NB <= 2^31 leaves kNoRow out of every table.
  if (log2nb < 0 || log2nb > 31 || k < 1 || k > 31 || r < 0 ||
      r > (q12 ? 62 : 31) || W < 1 || row_lanes < (q12 ? 3 : 2) * W ||
      S < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  if (grid < 1 || warps < 1 || warps > kLookupWarps || batch != kBatch ||
      l2 < 0 || l2 > 2 ||
      (spec != 0 && (spec != W || row_lanes % 4 != 0 ||
                     reinterpret_cast<uintptr_t>(fused) % 16 != 0)) ||
      (smem != 0 && (smem != 4 * kStashRows * S || smem > kStashSmemMax))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel kernel = pick(q12, order != nullptr, spec);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  QuotArgs a;
  a.hi = static_cast<const uint32_t*>(hi);
  a.lo = static_cast<const uint32_t*>(lo);
  a.valid = static_cast<const uint8_t*>(valid);
  a.order = static_cast<const SortedProbe*>(order);
  a.N = N;
  a.fused = static_cast<const uint32_t*>(fused);
  a.W = W;
  a.row_lanes = row_lanes;
  a.m = 2 * k;
  a.r = r;
  a.stash = static_cast<const uint32_t*>(stash);
  a.S = S;
  a.staged = smem != 0;
  a.l2 = l2;
  a.sorted_out = static_cast<int4*>(sorted_out);
  a.hit = static_cast<int32_t*>(hit);
  a.t_in = static_cast<int32_t*>(t_in);
  a.t_out = static_cast<int32_t*>(t_out);
  kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hi/lo int32 bit patterns and valid bytes [N]; fused [NB, 2W] and stash
// [5, S] int32 bit patterns; order: NULL, or K9's int32 [N, 4] sorted
// probes (index, hi, lo, valid), which the sorted form takes in place of
// hi/lo/valid, writing (hit, t_in, t_out, 0) a probe in sorted order to
// sorted_out, int32 [N, 4], in place of hit/t_in/t_out, int32 [N]. The plan
// (quot_plan of kernels/lookup.py): grid blocks of `warps` warps; batch
// the rows whose key loads a group issues together (kBatch); spec the W of
// the specialised body (64 here, 42 for q12; equal to W, fused 16-byte
// aligned) or 0 for the generic one; l2 the L2 policy mode (0-2); smem 20 S
// bytes to stage the stash in shared memory, or 0.
extern "C" int pangea_lookup_q8(const void* hi, const void* lo,
                                const void* valid, long long N,
                                const void* fused, long long NB, int W,
                                const void* stash, int S, int k,
                                const void* order, void* sorted_out,
                                void* hit, void* t_in, void* t_out, int grid,
                                int warps, int batch, int spec, int l2,
                                int smem, void* stream) {
  return launch(false, hi, lo, valid, N, fused, NB, W, 2 * W, stash, S, k,
                order, sorted_out, hit, t_in, t_out, grid, warps, batch,
                spec, l2, smem, stream);
}

// The q12 form: fused [NB, row_lanes] with row_lanes >= 3W (a multiple of
// 4 for the specialised body).
extern "C" int pangea_lookup_q12(const void* hi, const void* lo,
                                 const void* valid, long long N,
                                 const void* fused, long long NB, int W,
                                 int row_lanes, const void* stash, int S,
                                 int k, const void* order, void* sorted_out,
                                 void* hit, void* t_in, void* t_out,
                                 int grid, int warps, int batch, int spec,
                                 int l2, int smem, void* stream) {
  return launch(true, hi, lo, valid, N, fused, NB, W, row_lanes, stash, S,
                k, order, sorted_out, hit, t_in, t_out, grid, warps, batch,
                spec, l2, smem, stream);
}
