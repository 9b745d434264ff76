// Shared device helpers of the pangea_tpu_torch kernels.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

// MurmurHash3 fmix32 finalizer (SEMANTICS.md §4).
__device__ __forceinline__ uint32_t mix32(uint32_t v) {
  v ^= v >> 16;
  v *= 0x85EBCA6Bu;
  v ^= v >> 13;
  v *= 0xC2B2AE35u;
  v ^= v >> 16;
  return v;
}

// hash32 of a canonical k-mer split as (hi, lo) 32-bit halves.
__device__ __forceinline__ uint32_t hash32(uint32_t hi, uint32_t lo) {
  return mix32(mix32(lo ^ 0x9E3779B9u) ^ hi);
}

// Pairwise LCA by binary lifting, 0 the identity (the reference's
// lca_pairs_jnp, src/pangea_tpu/kernels/score.py:127): u == v == 0 -> 0,
// u == 0 -> v, v == 0 -> u; otherwise lift the deeper of (u, v) by the depth
// difference bit by bit from the top level, and if they differ move both
// while up[l] differs; the LCA is the common node, or the parent of the last
// pair. parent/depth int32 [T1], up int32 [levels, T1]. The scorer's lifted
// and merged tails (score_tail below: K5 and K7) call it.
__device__ __forceinline__ int lca_lift_pair(
    int u, int v, const int32_t* __restrict__ parent,
    const int32_t* __restrict__ depth, const int32_t* __restrict__ up,
    int levels, int T1) {
  const bool zu = u == 0, zv = v == 0;
  const int uu = zu ? 1 : u, vv = zv ? 1 : v;
  const int du = depth[uu], dv = depth[vv];
  int a = dv > du ? vv : uu;               // a is the deeper node
  int c = dv > du ? uu : vv;
  const int diff = du > dv ? du - dv : dv - du;
  for (int l = levels - 1; l >= 0; --l) {
    if ((diff >> l) & 1) a = up[static_cast<size_t>(l) * T1 + a];
  }
  const bool equal = a == c;
  if (!equal) {
    for (int l = levels - 1; l >= 0; --l) {
      const int ua = up[static_cast<size_t>(l) * T1 + a];
      const int uc = up[static_cast<size_t>(l) * T1 + c];
      if (ua != uc) {
        a = ua;
        c = uc;
      }
    }
  }
  const int res = equal ? a : parent[a];
  return (zu && zv) ? 0 : zu ? v : zv ? u : res;
}

// log2 of NB, or -1 when NB is not a power of two (NB up to 2^62).
inline int log2_exact(long long NB) {
  int log2nb = 0;
  while (log2nb < 62 && (1ll << log2nb) < NB) ++log2nb;
  return (1ll << log2nb) == NB ? log2nb : -1;
}

// The row probes (K2, K4, K12): a group of kProbeLanes lanes reads one row
// together, and the group's partial sums reduce in log2(kProbeLanes)
// shuffles.
constexpr int kProbeLanes = 8;

__device__ __forceinline__ uint32_t group_sum(uint32_t v) {
  for (int off = kProbeLanes / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  }
  return v;
}

// One probe as K9 (bucket_sort.cu) leaves it in sorted order: its index in
// the unsorted arrays (where its outputs go), its lanes and its valid flag.
struct __align__(16) SortedProbe {
  int32_t index;
  uint32_t hi, lo, valid;
};

// ---------------------------------------------------------------------------
// The table lookups, K2 (lookup_q8.cu) and K4 (lookup_std.cu): a persistent
// grid of blocks of at most kLookupWarps warps, kLookupBlocks of them an SM
// (the launch bounds hold a thread to 64 registers), a lane a probe; the
// stash [kStashRows, S] staged in shared memory up to kStashSmemMax bytes;
// kNoRow the row of a probe that reads none.
constexpr int kLookupWarps = 8;
constexpr int kLookupBlocks = 4;
constexpr int kStashRows = 5;
constexpr int kStashSmemMax = 48 * 1024;
constexpr uint32_t kNoRow = 0xFFFFFFFFu;

enum L2Priority { kNormal, kLast, kFirst };

__device__ __forceinline__ uint64_t l2_policy(int priority) {
  uint64_t p;
  if (priority == kLast) {
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  } else if (priority == kFirst) {
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  } else {
    asm("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;" : "=l"(p));
  }
  return p;
}

// The L2 policies of the key lanes, the payload lanes and the streams (the
// probes' inputs and the outputs) by mode: 0 all evict-normal; 1 keys
// evict-last, the rest evict-first; 2 keys evict-last, payload
// evict-normal, streams evict-first.
struct Policies {
  uint64_t keys, payload, streams;

  __device__ explicit Policies(int mode)
      : keys(l2_policy(mode == 0 ? kNormal : kLast)),
        payload(l2_policy(mode == 1 ? kFirst : kNormal)),
        streams(l2_policy(mode == 0 ? kNormal : kFirst)) {}
};

__device__ __forceinline__ uint32_t ld(const uint32_t* p, uint64_t pol) {
  uint32_t v;
  asm volatile("ld.global.L2::cache_hint.u32 %0, [%1], %2;"
               : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

__device__ __forceinline__ uint32_t ld_u8(const uint8_t* p, uint64_t pol) {
  uint32_t v;
  asm volatile("ld.global.L2::cache_hint.u8 %0, [%1], %2;"
               : "=r"(v) : "l"(p), "l"(pol));
  return v;
}

// K = 2 or 4 consecutive words from an address aligned to 4K bytes.
template <int K>
__device__ __forceinline__ void ld_vec(const uint32_t* p, uint64_t pol,
                                       uint32_t (&v)[K]) {
  static_assert(K == 2 || K == 4, "2 or 4 words a load");
  if constexpr (K == 4) {
    asm volatile(
        "ld.global.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
        : "=r"(v[0]), "=r"(v[1]), "=r"(v[2]), "=r"(v[3])
        : "l"(p), "l"(pol));
  } else {
    asm volatile("ld.global.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
                 : "=r"(v[0]), "=r"(v[1]) : "l"(p), "l"(pol));
  }
}

__device__ __forceinline__ void st(int32_t* p, uint32_t v, uint64_t pol) {
  asm volatile("st.global.L2::cache_hint.u32 [%0], %1, %2;"
               :: "l"(p), "r"(v), "l"(pol) : "memory");
}

__device__ __forceinline__ void st_v4(int4* p, uint32_t a, uint32_t b,
                                      uint32_t c, uint64_t pol) {
  asm volatile(
      "st.global.L2::cache_hint.v4.u32 [%0], {%1, %2, %3, %4}, %5;"
      :: "l"(p), "r"(a), "r"(b), "r"(c), "r"(0u), "l"(pol) : "memory");
}

// A lane's probe: its lanes and valid flag, from hi/lo/valid or, sorted,
// from K9's record w; invalid past N.
struct TableProbe {
  uint32_t hi, lo;
  bool ok;
};

template <bool kSorted>
__device__ __forceinline__ TableProbe load_probe(
    const uint32_t* hi, const uint32_t* lo, const uint8_t* valid,
    const SortedProbe* order, long long N, long long w, uint64_t pol) {
  TableProbe p{0u, 0u, false};
  if (w < N) {
    if (kSorted) {
      uint32_t r[4];
      ld_vec<4>(reinterpret_cast<const uint32_t*>(order + w), pol, r);
      p.hi = r[1];
      p.lo = r[2];
      p.ok = r[3] != 0;
    } else {
      p.hi = ld(hi + w, pol);
      p.lo = ld(lo + w, pol);
      p.ok = ld_u8(valid + w, pol) != 0;
    }
  }
  return p;
}

// Reduce-scatter over a group of 8 lanes: lane g of the group gets the sum
// over the group's lanes of v[g] (7 shuffles for 8 probes, where a sum a
// probe takes 3).
__device__ __forceinline__ uint32_t reduce_scatter(const uint32_t (&v)[8],
                                                   int g) {
  uint32_t h[4], q[2];
  const bool b4 = g & 4, b2 = g & 2, b1 = g & 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t keep = b4 ? v[4 + i] : v[i];
    const uint32_t send = b4 ? v[i] : v[4 + i];
    h[i] = keep + __shfl_xor_sync(0xFFFFFFFFu, send, 4);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t keep = b2 ? h[2 + i] : h[i];
    const uint32_t send = b2 ? h[i] : h[2 + i];
    q[i] = keep + __shfl_xor_sync(0xFFFFFFFFu, send, 2);
  }
  const uint32_t keep = b1 ? q[1] : q[0];
  const uint32_t send = b1 ? q[0] : q[1];
  return keep + __shfl_xor_sync(0xFFFFFFFFu, send, 1);
}

// Row of a table of NB rows that index i names, as NumPy-style indexing
// under XLA takes it: below 0 it counts from the end, then it is clamped
// into [0, NB) (K11-K13).
__device__ __forceinline__ long long row_in(int32_t i, long long NB) {
  const long long r = i < 0 ? i + NB : i;
  return r < 0 ? 0 : r >= NB ? NB - 1 : r;
}

// Blocks needed to cover n items at `per` items a block.
inline unsigned int blocks_for(long long n, long long per) {
  return static_cast<unsigned int>((n + per - 1) / per);
}

// ---------------------------------------------------------------------------
// The routed row probes, K11 (rowprobe_smem.cu) and K12 (rowprobe_onehot.cu).
// The routing pass (bucket_sort.cu pangea_rowprobe_route) leaves the
// queries as records (query index, row, rem, 1) in ascending key order,
// key = row >> shift. Block b takes the run of records [b * kRun, (b + 1)
// * kRun): its rows are a run of keys, and over the grid the runs read the
// table about once. The block stages its run's records, then walks the run
// in passes: a pass is the records whose keys lie within window_keys keys
// of its first record's key, and the block stages the rows of the keys from
// its first to its last record into shared memory, then probes the pass
// from there. A key that holds no record opens no pass, so a run that
// jumps over empty keys stages none of their rows; a run whose keys span
// more than one window takes a pass a window.
constexpr int kRun = 2048;

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Starts copying words [0, n) of src into dst (shared memory, 16-byte
// aligned), the block's threads in turn: 16 bytes a copy by cp.async where
// src is 16-byte aligned, else 4 bytes a load. stage_wait ends every copy
// started.
__device__ __forceinline__ void stage_words(uint32_t* dst,
                                            const uint32_t* src,
                                            long long n) {
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const long long n4 = n >> 2;
    for (long long c = threadIdx.x; c < n4; c += blockDim.x) {
      cp_async16(shared_addr(dst + 4 * c), src + 4 * c);
    }
    done = n4 << 2;
  }
  for (long long c = done + threadIdx.x; c < n; c += blockDim.x) {
    dst[c] = src[c];
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// A pass of a run: its records end at `end`; the rows [row0, row0 + rows)
// of its keys are staged.
struct RowPass {
  long long end;
  long long row0;
  int rows;
};

__device__ __forceinline__ int record_key(const int4* rec, long long i,
                                          int shift) {
  return __ldg(&rec[i].y) >> shift;
}

// The pass that opens at record i of a run that ends at r1: the records
// before the first whose key is window_keys or more past record i's
// (found by bisection where the run's last record is that far), and the
// rows of the keys from record i's to the last such record's, cut at NB.
__device__ __forceinline__ RowPass row_pass(const int4* rec, long long i,
                                            long long r1, int shift,
                                            int window_keys, long long NB) {
  const int k0 = record_key(rec, i, shift);
  const int kend = k0 + window_keys;
  long long end = r1;
  if (record_key(rec, r1 - 1, shift) >= kend) {
    long long lo = i + 1, hi = r1 - 1;         // hi's key is kend or more
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (record_key(rec, mid, shift) < kend) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    end = lo;
  }
  RowPass p;
  p.end = end;
  p.row0 = static_cast<long long>(k0) << shift;
  const long long last = record_key(rec, end - 1, shift);
  p.rows = static_cast<int>(min(NB, (last + 1) << shift) - p.row0);
  return p;
}

// Shared memory a routed probe block may take, or a CUDA error: the most a
// block of the current device may opt in to (cudaErrorInvalidValue when
// smem is past it), opted in for kernel.
template <class K>
cudaError_t allow_smem(K kernel, long long smem) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  if (smem > optin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The group's part of one row probe: lane g of the group compares the rem
// lanes of row (in shared memory) with rem and adds the payload lanes of
// those equal; group_sum of the parts is the probe. kVec (W a multiple of
// 4, row 16-byte aligned): lane g reads the rem words 4g + 32t as 16-byte
// loads, and reads a payload word only where one of its 4 equals rem;
// else lanes g, g + 8, ... one word a load.
template <bool kVec>
__device__ __forceinline__ uint32_t probe_part(const uint32_t* row, int W,
                                               uint32_t rem, int g) {
  uint32_t pk = 0;
  if (kVec) {
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    for (int j4 = g; j4 < W / 4; j4 += kProbeLanes) {
      const uint4 v = r4[j4];
      if (v.x == rem || v.y == rem || v.z == rem || v.w == rem) {
        const uint4 p = r4[W / 4 + j4];
        pk += (v.x == rem ? p.x : 0u) + (v.y == rem ? p.y : 0u) +
              (v.z == rem ? p.z : 0u) + (v.w == rem ? p.w : 0u);
      }
    }
  } else {
    for (int j = g; j < W; j += kProbeLanes) {
      if (row[j] == rem) pk += row[W + j];
    }
  }
  return pk;
}


// ---------------------------------------------------------------------------
// The scorer: K3 (score_tin.cu, R <= 2048) and K8 (score_ranked.cu), one
// body (score_kernel) with the form's exact general branch as its Form.
//
// A probe's pscore depends on its t_in alone, so a read is scored from the
// distinct (t_in, t_out) intervals among its hits, each entry with its
// multiplicity and the largest lane that carries it:
//   K3  ps(d) = sum_e mult_e * [tin_e <= tin_d < tout_e]
//   K8  ps(d) = sum_e mult_e * ([tin_e <= tin_d] - [tout_e <= tin_d])
// (K8's two ranks, term by term). Every hit's pscore is its entry's; best =
// max(0, max_d ps(d)); the winners' min and max t_in are those of the
// entries with ps == best > 0, and u / v the largest lane of the entries at
// those t_in, which is the largest lane of the winning probes there. The
// table is keyed on the pair, not on t_in, so the result is exact on any
// input. Misses (lane 0) enter no table.
//
// Layout (kernels/score.py score_plan): a read gets `wpr` warps and a block
// holds `rpb` reads (rpb > 1 only with one warp a read, which then never
// waits on another warp). The read's warps read its chunks of 32 probes and
// add their hits to one open-addressed hash table of score_slots(cap)
// slots in shared memory (atomicCAS claims a slot, shared atomics add the
// multiplicity and the largest lane). A chunk whose hits all carry one key,
// as nearly always on real reads, is folded by two warp reductions into a
// warp's running entry, which reaches the table only when the key changes.
// The read's first warp then packs the table's entries and scores them. A
// read with more than `cap` distinct intervals (or a key equal to the empty
// slot's) takes the form's exact general branch (Form::general: K3's
// quadratic count, K8's sort) in the same launch, and the launch adds one
// to *general for each such read.
//
// The tail (score_tail) turns the winners into the read's outputs in the
// same launch, in one of three forms (ScoreTail): the winners themselves
// (six [B] arrays); the direct LCA, a scan over T1 <= 4096 taxa; or the
// lifted LCA, K5 (below). Every form that writes a taxon may merge it with
// an earlier call, K7 (below).
//
// K5, the lifted tail: replaces the XLA-compiled reference function
//   src/pangea_tpu/kernels/score.py:127  lca_pairs_jnp (B12)
// as _score_impl uses it past _DIRECT_LCA_MAX_TAXA (score.py:204-217), with
// the q8 path's node recovery through tin2node (:207-212). Rank 0 of the
// read's group recovers u and v (q8: has ? tin2node[clamp(tin, 0, M-1)] :
// 0), lifts their LCA (lca_lift_pair) and applies the threshold. Its bound
// is 2 x levels dependent reads of the up table (levels x T1 x 4 B, 0.5 MB
// at 66,563 taxa, held by L2) a read; in the scorer's launch they overlap
// the other reads' scoring on every SM, where a launch of their own ran
// B / 256 blocks of them alone, after a round trip of six [B] arrays
// through HBM.
//
// K7, the merged tail: replaces the XLA-compiled reference function
//   src/pangea_tpu/classify/merge.py:39  merge_multik_jnp (B13)
// (with _mul_u64 :16 and _ge_u64 :35), the rules of docs/SEMANTICS.md §9,
// with an earlier call (prior, the reference's res1) over the first
// index's taxonomy (m_parent, m_depth, m_up): x1 = b1 * n2 and x2 = b2 * n1
// exactly, in int64 (the TPU compared 16-bit limb products). Both
// unclassified: (0, 0, n1 + n2), the sum wrapping in 32 bits. Agreement:
// the taxon, with (best, nvalid) of the prior if x1 >= x2. Conflict: the
// LCA, with (best, nvalid) of the prior if x1 <= x2 (a tie goes to the
// prior). One-sided: the classified call's triple. It reads three [B]
// arrays more and walks the lifting table on a conflict, in place of a
// launch that read six [B] arrays and wrote three.

constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kScoreMaxCap = 128;    // a lane keeps cap / 32 entries' pscores
constexpr int kScoreMaxReads = 8;    // reads a block (one warp each)
constexpr int kScoreDirectMaxTaxa = 4096;   // the direct tail's T1; lifted
                                            // beyond
// An empty slot: the key of (t_in, t_out) = (INT_MIN, INT_MIN), which a read
// that carries it sends to the general branch.
constexpr unsigned long long kEmptyKey = 0x8000000080000000ull;

// Slots of a read's hash table: a power of two with room for the cap
// entries and one chunk's 32 more.
__host__ __device__ __forceinline__ int score_slots(int cap) {
  int s = 32;
  while (s < cap + 32) s <<= 1;
  return s;
}

// The scorer's tails (score_tail).
enum ScoreTail { kWinnersTail, kDirectTail, kLiftedTail };

struct ScoreArgs {
  const int32_t* lanes;
  const int32_t* t_in;
  const int32_t* t_out;
  const uint8_t* valid;
  int B, R;
  int wpr, cap, per_read;            // score_plan; per_read: shared bytes
  int rpad;                          // K8's sort width (0 for K3)
  int32_t* scratch;                  // K8's sort in device memory, or null
  const int32_t* tin;                // the direct tail's scan
  const int32_t* tout;
  const int32_t* depth;              // [T1]: the direct and lifted tails
  int T1;
  const int32_t* parent;             // the lifted tail: [T1]
  const int32_t* up;                 // [levels, T1]
  int levels;                        // > 0 selects the lifted tail
  const int32_t* tin2node;           // [M]: q8 winners' nodes
  int M;
  float thr;
  int32_t* o[6];
  int* general;                      // += reads that took the general branch
  const int32_t* prior[3];           // the merge: taxon, best, nvalid [B]
  const int32_t* m_parent;           // the merge's taxonomy: [m_T1]
  const int32_t* m_depth;
  const int32_t* m_up;               // [m_levels, m_T1]
  int m_levels, m_T1;
};

inline int score_tail_of(const ScoreArgs& a) {
  return a.levels > 0 ? kLiftedTail : a.T1 > 0 ? kDirectTail : kWinnersTail;
}

// The per-read state, in shared memory.
struct ReadState {
  int best, nvalid, tin_u, tin_v, u, v;
  int count;                         // distinct keys in the table
  int general;                       // the read takes the general branch
  unsigned long long lca;
};

// One probe position as the general branch's tail sees it: its lane (hit
// count or hit taxon, 0 for a miss), its t_in and its pscore (0 for a miss).
struct ScorePos {
  int lane, tin, ps;
};

// The threads that own one read: one warp, or the whole block.
struct ScoreGroup {
  int rank, size;
  bool warp;
  __device__ __forceinline__ void sync() const {
    if (warp) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  }
};

// A table of n slots or entries: 16 * n bytes from base.
struct IvTable {
  unsigned long long* key;           // (t_in << 32) | (uint32) t_out
  int* mult;
  int* maxl;
};

__device__ __forceinline__ IvTable iv_table(unsigned char* base, int n) {
  IvTable r;
  r.key = reinterpret_cast<unsigned long long*>(base);
  r.mult = reinterpret_cast<int*>(base + 8 * static_cast<size_t>(n));
  r.maxl = r.mult + n;
  return r;
}

__device__ __forceinline__ unsigned long long iv_key(int tin, int tout) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(tin))
          << 32) | static_cast<uint32_t>(tout);
}

__device__ __forceinline__ int key_tin(unsigned long long k) {
  return static_cast<int>(static_cast<uint32_t>(k >> 32));
}

__device__ __forceinline__ int key_tout(unsigned long long k) {
  return static_cast<int>(static_cast<uint32_t>(k));
}

// Adds weight w and lane l to key's slot of the hash table (S slots),
// claiming an empty one for a new key (and counting it). False where the
// key is the empty slot's or no slot is left.
__device__ __forceinline__ bool slot_add(const IvTable& t, int S,
                                         unsigned long long key, int w, int l,
                                         int* count) {
  if (key == kEmptyKey) return false;
  unsigned h = (static_cast<uint32_t>(key ^ (key >> 32)) * 0x9E3779B1u) &
               (S - 1);
  volatile unsigned long long* keys = t.key;
  for (int p = 0; p < S; ++p) {
    unsigned long long cur = keys[h];
    if (cur == kEmptyKey) {
      cur = atomicCAS(&t.key[h], kEmptyKey, key);
      if (cur == kEmptyKey) {
        atomicAdd(count, 1);
        cur = key;
      }
    }
    if (cur == key) {
      atomicAdd(&t.mult[h], w);
      atomicMax(&t.maxl[h], l);
      return true;
    }
    h = (h + 1) & (S - 1);
  }
  return false;
}

// A warp's running entry: the key of its last chunks whose hits all carried
// one key, and their summed weight and largest lane (the same in every
// lane).
struct RunEntry {
  unsigned long long key;
  int w, l;
  bool live;
};

// Empties the S slots of a read's table (one warp).
__device__ __forceinline__ void table_clear(const IvTable& t, int S) {
  for (int s = threadIdx.x & 31; s < S; s += 32) {
    t.key[s] = kEmptyKey;
    t.mult[s] = 0;
    t.maxl[s] = INT_MIN;
  }
  __syncwarp();
}

// Adds a warp's chunk (each lane with `has` brings one key of weight 1 and
// lane l) to the table through the warp's running entry: hits of the
// running key fold into it; a chunk of one other key replaces it (the old
// one goes to the table); other hits go to the table one a lane. `ready`
// says the table is cleared: a warp that owns its read alone clears it at
// its first use. False, the warp together, where a slot_add failed.
__device__ __forceinline__ bool chunk_add(const IvTable& t, int S,
                                          RunEntry& run, bool& ready,
                                          bool has, unsigned long long key,
                                          int l, int* count) {
  const unsigned hm = __ballot_sync(kFullMask, has);
  if (hm == 0) return true;
  const int lane = threadIdx.x & 31;
  const unsigned long long k0 = __shfl_sync(kFullMask, key, __ffs(hm) - 1);
  bool ok = true;
  if (__all_sync(kFullMask, !has || key == k0)) {
    const int w = __popc(hm);
    const int gl = __reduce_max_sync(kFullMask, has ? l : INT_MIN);
    if (run.live && run.key == k0) {
      run.w += w;
      run.l = max(run.l, gl);
      return true;
    }
    if (run.live) {
      if (!ready) {
        table_clear(t, S);
        ready = true;
      }
      if (lane == 0) ok = slot_add(t, S, run.key, run.w, run.l, count);
    }
    run = RunEntry{k0, w, gl, true};
  } else {
    if (!ready) {
      table_clear(t, S);
      ready = true;
    }
    const bool folds = has && run.live && key == run.key;
    const unsigned fm = __ballot_sync(kFullMask, folds);
    if (fm) {
      run.w += __popc(fm);
      run.l = max(run.l, __reduce_max_sync(kFullMask, folds ? l : INT_MIN));
    }
    if (has && !folds) ok = slot_add(t, S, key, 1, l, count);
  }
  return __all_sync(kFullMask, ok);
}

// One warp scores the read from its n packed entries and writes best,
// tin_u, tin_v, u and v into st.
template <bool kRanked, bool kTaxon>
__device__ void table_score(const IvTable& t, int n, ReadState* st) {
  constexpr int K = kScoreMaxCap / 32;
  const int lane = threadIdx.x & 31;
  const int kk = (n + 31) >> 5;
  int ti[K], ps[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = lane + 32 * k;
    ti[k] = e < n ? key_tin(t.key[e]) : 0;
    ps[k] = 0;
  }
  for (int f = 0; f < n; ++f) {
    const unsigned long long kf = t.key[f];
    const int fi = key_tin(kf), fo = key_tout(kf), m = t.mult[f];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k < kk) {
        if (kRanked) {
          ps[k] += (fi <= ti[k] ? m : 0) - (fo <= ti[k] ? m : 0);
        } else {
          ps[k] += fi <= ti[k] && ti[k] < fo ? m : 0;
        }
      }
    }
  }
  int best = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (lane + 32 * k < n) best = max(best, ps[k]);
  }
  best = __reduce_max_sync(kFullMask, best);
  int tu = INT_MAX, tv = -2;
  if (best > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (lane + 32 * k < n && ps[k] == best) {
        tu = min(tu, ti[k]);
        tv = max(tv, ti[k]);
      }
    }
  }
  tu = __reduce_min_sync(kFullMask, tu);
  tv = __reduce_max_sync(kFullMask, tv);
  int mu = 0, mv = 0;
  if (kTaxon && best > 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = lane + 32 * k;
      if (e < n) {
        if (ti[k] == tu) mu = max(mu, t.maxl[e]);
        if (ti[k] == tv) mv = max(mv, t.maxl[e]);
      }
    }
    mu = __reduce_max_sync(kFullMask, mu);
    mv = __reduce_max_sync(kFullMask, mv);
  }
  if (lane == 0) {
    st->best = best;
    st->tin_u = tu;
    st->tin_v = tv;
    st->u = mu;
    st->v = mv;
  }
}

// The general branch's winners: st->best and st->nvalid are complete; at(i)
// gives position i. Finds the tied winners' min and max t_in and (kTaxon)
// the largest lane at each, into st.
template <bool kTaxon, class At>
__device__ void group_winners(const ScoreGroup& g, ReadState* st, int R,
                              At at) {
  const int best = st->best;
  if (best > 0) {
    int u = INT_MAX, v = -2;
    for (int i = g.rank; i < R; i += g.size) {
      const ScorePos p = at(i);
      if (p.lane != 0 && p.ps == best) {
        u = min(u, p.tin);
        v = max(v, p.tin);
      }
    }
    if (v != -2) {
      atomicMin(&st->tin_u, u);
      atomicMax(&st->tin_v, v);
    }
  }
  g.sync();
  if (kTaxon && best > 0) {
    const int tu = st->tin_u, tv = st->tin_v;
    int mu = 0, mv = 0;
    for (int i = g.rank; i < R; i += g.size) {
      const ScorePos p = at(i);
      if (p.lane != 0 && p.ps == best) {
        if (p.tin == tu) mu = max(mu, p.lane);
        if (p.tin == tv) mv = max(mv, p.lane);
      }
    }
    if (mu) atomicMax(&st->u, mu);
    if (mv) atomicMax(&st->v, mv);
  }
  g.sync();
}

// K7: merges an earlier call (t1, b1, n1) into the read's (t2, b2, n2), in
// place (see above).
__device__ __forceinline__ void merge_call(int t1, int b1, int n1, int& t2,
                                           int& b2, int& n2,
                                           const ScoreArgs& a) {
  const long long x1 = static_cast<long long>(b1) * n2;
  const long long x2 = static_cast<long long>(b2) * n1;
  const bool both0 = t1 == 0 && t2 == 0;
  const bool agree = t1 != 0 && t1 == t2;
  const bool conflict = t1 != 0 && t2 != 0 && t1 != t2;
  const bool keep1 = agree ? x1 >= x2 : conflict ? x1 <= x2 : t1 != 0;
  const int t = conflict ? lca_lift_pair(t1, t2, a.m_parent, a.m_depth,
                                         a.m_up, a.m_levels, a.m_T1)
                         : (t1 != 0 ? t1 : t2);
  const int n = both0 ? static_cast<int>(static_cast<uint32_t>(n1) +
                                         static_cast<uint32_t>(n2))
                      : keep1 ? n1 : n2;
  b2 = both0 ? 0 : keep1 ? b1 : b2;
  n2 = n;
  t2 = t;
}

// After the winners, by kTail: the winners form (o0..o5 = u, v, tin_u,
// tin_v, best, nvalid); or the direct LCA scan over the T1 taxa, or the
// lifted LCA (K5), then the threshold and, given a prior, the merge (K7):
// o0..o2 = taxon, best, nvalid.
template <bool kTaxon, int kTail>
__device__ void score_tail(const ScoreGroup& g, ReadState* st,
                           const ScoreArgs& a, int b) {
  const int best = st->best;
  const int tu = st->tin_u, tv = st->tin_v;
  if (kTail == kDirectTail && best > 0) {
    // Key orders by depth, then by the smaller taxon index: the maximum
    // key is the first-index argmax of the masked depth.
    unsigned long long key = 0ull;
    for (int t = g.rank; t < a.T1; t += g.size) {
      const int lo = a.tin[t], hi = a.tout[t];
      const bool ca = lo <= tu && tu < hi && lo <= tv && tv < hi;
      const long long d = ca ? a.depth[t] : -1;
      const unsigned long long kt =
          (static_cast<unsigned long long>(d + 1) << 32) |
          static_cast<unsigned int>(0xFFFFFFFFu - static_cast<unsigned>(t));
      key = kt > key ? kt : key;
    }
    atomicMax(&st->lca, key);
  }
  g.sync();
  if (g.rank == 0) {
    int nvalid = st->nvalid;
    const int has = best > 0 ? 1 : 0;
    int u = kTaxon ? st->u : has;
    int v = kTaxon ? st->v : has;
    if (kTail == kWinnersTail) {
      a.o[0][b] = u;
      a.o[1][b] = v;
      a.o[2][b] = tu;
      a.o[3][b] = tv;
      a.o[4][b] = best;
      a.o[5][b] = nvalid;
      return;
    }
    int assigned;
    if (kTail == kDirectTail) {
      const int res = best > 0 ? static_cast<int>(
          0xFFFFFFFFu - static_cast<unsigned>(st->lca & 0xFFFFFFFFull)) : 0;
      assigned = (u == 0 && v == 0) ? 0
                 : (u == 0)         ? v
                 : (v == 0)         ? u
                                    : res;
    } else {
      if (!kTaxon) {
        u = has ? a.tin2node[min(max(tu, 0), a.M - 1)] : 0;
        v = has ? a.tin2node[min(max(tv, 0), a.M - 1)] : 0;
      }
      assigned = lca_lift_pair(u, v, a.parent, a.depth, a.up, a.levels,
                               a.T1);
    }
    const bool below = static_cast<float>(best) <
                       __fmul_rn(a.thr, static_cast<float>(nvalid));
    int taxon = (below || nvalid == 0) ? 0 : assigned;
    int bst = best;
    if (a.prior[0] != nullptr) {
      merge_call(a.prior[0][b], a.prior[1][b], a.prior[2][b], taxon, bst,
                 nvalid, a);
    }
    a.o[0][b] = taxon;
    a.o[1][b] = bst;
    a.o[2][b] = nvalid;
  }
}

// The scorer (see above). Form: kRanked, general<kTaxon>(group, state,
// args, read, its shared bytes), general_bytes(R, cap, rpad, scratch). A
// read's shared bytes hold its hash table (score_slots(cap) slots), then
// its packed entries (cap); the general branch reuses them from the start.
template <bool kTaxon, int kTail, class Form>
__global__ void __launch_bounds__(1024) score_kernel(const ScoreArgs a) {
  extern __shared__ __align__(16) unsigned char score_smem[];
  __shared__ ReadState states[kScoreMaxReads];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp / a.wpr, wir = warp - slot * a.wpr;
  const int b = blockIdx.x * (blockDim.x / (32 * a.wpr)) + slot;
  if (b >= a.B) return;              // a whole read's warps: rpb > 1 only
                                     // with one warp a read
  const ScoreGroup g{static_cast<int>(threadIdx.x) - slot * 32 * a.wpr,
                     32 * a.wpr, a.wpr == 1};
  ReadState* st = &states[slot];
  unsigned char* mine = score_smem + static_cast<size_t>(slot) * a.per_read;
  const size_t base = static_cast<size_t>(b) * a.R;
  const int S = score_slots(a.cap);
  const IvTable table = iv_table(mine, S);
  if (g.rank == 0) {
    st->best = 0;
    st->nvalid = 0;
    st->tin_u = INT_MAX;
    st->tin_v = -2;
    st->u = 0;
    st->v = 0;
    st->count = 0;
    st->general = 0;
    st->lca = 0ull;
  }
  // Several warps share the read's table: it is cleared before they add.
  bool ready = a.wpr > 1;
  if (ready) {
    for (int s = g.rank; s < S; s += g.size) {
      table.key[s] = kEmptyKey;
      table.mult[s] = 0;
      table.maxl[s] = INT_MIN;
    }
  }
  g.sync();

  // 1. The read's hits into the table (two chunks ahead in flight), and
  // the valid count; a warp stops adding once the read overflows.
  const int chunks = (a.R + 31) >> 5;
  volatile int* general = &st->general;
  volatile int* count = &st->count;
  int nv = 0;
  bool ok = true;
  RunEntry run{0ull, 0, 0, false};
  // A lane's probe of chunk c: lane (0 past R), t_in, t_out, valid.
  struct Probe {
    int l, x, y;
    bool v;
  };
  auto load = [&](int c) {
    const int i = c * 32 + lane;
    Probe p{0, 0, 0, false};
    if (c < chunks && i < a.R) {
      p = Probe{a.lanes[base + i], a.t_in[base + i], a.t_out[base + i],
                a.valid[base + i] != 0};
    }
    return p;
  };
  Probe cur = load(wir), next = load(wir + a.wpr);
  for (int c = wir; c < chunks; c += a.wpr) {
    const Probe after = load(c + 2 * a.wpr);
    nv += cur.v;
    if (ok) {
      const bool fine = chunk_add(table, S, run, ready, cur.l != 0,
                                  iv_key(cur.x, cur.y), cur.l, &st->count);
      // Only the table's count and the other warps can end the read's
      // table; before its first use neither has moved.
      ok = ready ? __all_sync(kFullMask,
                              fine && *count <= a.cap && !*general)
                 : fine;
    }
    cur = next;
    next = after;
  }
  // The running entry goes to the table, unless it is the read's only
  // entry and no table was needed (one warp a read).
  if (ok && run.live && ready && lane == 0) {
    ok = slot_add(table, S, run.key, run.w, run.l, &st->count);
  }
  nv = __reduce_add_sync(kFullMask, nv);
  ok = __all_sync(kFullMask, ok);
  if (lane == 0) {
    if (nv) atomicAdd(&st->nvalid, nv);
    if (!ok) *general = 1;
  }
  g.sync();

  // 2. The read's packed entries and their score (the first warp).
  if (wir == 0 && !st->general && st->count <= a.cap) {
    const IvTable dense = iv_table(mine + 16 * static_cast<size_t>(S),
                                   a.cap);
    int n = 0;
    if (!ready && run.live && lane == 0) {
      dense.key[0] = run.key;
      dense.mult[0] = run.w;
      dense.maxl[0] = run.l;
    }
    if (!ready) n = run.live ? 1 : 0;
    for (int s0 = 0; ready && s0 < S; s0 += 32) {
      const int s = s0 + lane;
      const bool occ = table.key[s] != kEmptyKey;   // S is a multiple of 32
      const unsigned bm = __ballot_sync(kFullMask, occ);
      if (occ) {
        const int d = n + __popc(bm & ((1u << lane) - 1u));
        dense.key[d] = table.key[s];
        dense.mult[d] = table.mult[s];
        dense.maxl[d] = table.maxl[s];
      }
      n += __popc(bm);
    }
    __syncwarp();
    table_score<Form::kRanked, kTaxon>(dense, n, st);
  } else if (wir == 0 && lane == 0) {
    st->general = 1;
  }
  g.sync();

  // 3. The exact general branch, over the table's bytes.
  if (st->general) {
    Form::template general<kTaxon>(g, st, a, b, mine);
    if (g.rank == 0) atomicAdd(a.general, 1);
  }
  score_tail<kTaxon, kTail>(g, st, a, b);
}

using ScoreKernel = void (*)(const ScoreArgs);

template <int kTail, class Form>
ScoreKernel score_kernel_for(int taxon_lanes) {
  return taxon_lanes ? score_kernel<true, kTail, Form>
                     : score_kernel<false, kTail, Form>;
}

// Checks a plan and the tail's arrays against the form's needs and
// launches score_kernel in the form the lanes, T1 and levels select. rpb
// reads a block of wpr warps each.
template <class Form>
int score_launch(const ScoreArgs& a, int taxon_lanes, int rpb,
                 cudaStream_t s) {
  const int wpr = a.wpr;
  const bool pow2 = wpr >= 1 && wpr <= 32 && (wpr & (wpr - 1)) == 0;
  const int tail = score_tail_of(a);
  const bool lift_ok =
      a.T1 >= 2 && a.parent != nullptr && a.depth != nullptr &&
      a.up != nullptr && (taxon_lanes || (a.tin2node != nullptr && a.M >= 1));
  const bool merge_ok =
      tail != kWinnersTail && a.prior[1] != nullptr &&
      a.prior[2] != nullptr && a.m_parent != nullptr &&
      a.m_depth != nullptr && a.m_up != nullptr && a.m_levels >= 1 &&
      a.m_T1 >= 2;
  if (!pow2 || rpb < 1 || rpb > kScoreMaxReads || (rpb > 1 && wpr > 1) ||
      a.cap < 1 || a.cap > kScoreMaxCap || a.T1 < 0 || a.levels < 0 ||
      a.general == nullptr || (tail == kLiftedTail && !lift_ok) ||
      (tail == kDirectTail && a.T1 > kScoreDirectMaxTaxa) ||
      (a.prior[0] != nullptr && !merge_ok)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t tables = 16 * static_cast<size_t>(score_slots(a.cap) + a.cap);
  const size_t general =
      Form::general_bytes(a.R, a.cap, a.rpad, a.scratch != nullptr);
  const size_t need = tables > general ? tables : general;
  if (a.per_read % 16 != 0 || static_cast<size_t>(a.per_read) < need) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.B == 0) return 0;
  const size_t smem = static_cast<size_t>(rpb) * a.per_read;
  const unsigned grid = blocks_for(a.B, rpb);
  const unsigned threads = 32u * wpr * rpb;
  const ScoreKernel kernel =
      tail == kLiftedTail   ? score_kernel_for<kLiftedTail, Form>(taxon_lanes)
      : tail == kDirectTail ? score_kernel_for<kDirectTail, Form>(taxon_lanes)
                            : score_kernel_for<kWinnersTail, Form>(
                                  taxon_lanes);
  // Past 48 KB a block (with its static per-read states) the kernel must
  // opt in.
  if (smem + sizeof(ReadState) * kScoreMaxReads > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The score launchers' arguments (pangea_score, pangea_score_ranked):
// lanes/t_in/t_out int32 and valid bytes [B, R]; taxon_lanes selects the
// taxon form. The tail (o0..o2 = taxon, best, nvalid int32 [B], o3..o5
// unused, unless the winners form): levels > 0, the lifted LCA (K5) over
// depth/parent int32 [T1] and up int32 [levels, T1], the q8 form's winners
// recovered through tin2node int32 [M] (null for taxon lanes); else T1 > 0,
// the direct LCA over tin/tout/depth int32 [T1]; else T1 == 0, the winners
// form, o0..o5 = u, v, tin_u, tin_v, best, nvalid int32 [B]. prior: null,
// or an earlier call's taxon/best/nvalid int32 [B] (p_best, p_nvalid) that
// the read's taxon merges with (K7) over m_parent/m_depth int32 [m_T1] and
// m_up int32 [m_levels, m_T1], in the direct and lifted tails. general: an
// int32 the launch adds its general-branch reads to. wpr, rpb, cap,
// per_read, rpad, scratch: kernels/score.py score_plan.
inline ScoreArgs score_args(
    const void* lanes, const void* t_in, const void* t_out,
    const void* valid, int B, int R, const void* tin, const void* tout,
    const void* depth, int T1, const void* parent, const void* up,
    int levels, const void* tin2node, int M, float thr, void* o0, void* o1,
    void* o2, void* o3, void* o4, void* o5, void* general,
    const void* prior, const void* p_best, const void* p_nvalid,
    const void* m_parent, const void* m_depth, const void* m_up,
    int m_levels, int m_T1, int wpr, int cap, int per_read, int rpad,
    void* scratch) {
  ScoreArgs a;
  a.lanes = static_cast<const int32_t*>(lanes);
  a.t_in = static_cast<const int32_t*>(t_in);
  a.t_out = static_cast<const int32_t*>(t_out);
  a.valid = static_cast<const uint8_t*>(valid);
  a.B = B;
  a.R = R;
  a.wpr = wpr;
  a.cap = cap;
  a.per_read = per_read;
  a.rpad = rpad;
  a.scratch = static_cast<int32_t*>(scratch);
  a.tin = static_cast<const int32_t*>(tin);
  a.tout = static_cast<const int32_t*>(tout);
  a.depth = static_cast<const int32_t*>(depth);
  a.T1 = T1;
  a.parent = static_cast<const int32_t*>(parent);
  a.up = static_cast<const int32_t*>(up);
  a.levels = levels;
  a.tin2node = static_cast<const int32_t*>(tin2node);
  a.M = M;
  a.thr = thr;
  void* o[6] = {o0, o1, o2, o3, o4, o5};
  for (int i = 0; i < 6; ++i) a.o[i] = static_cast<int32_t*>(o[i]);
  a.general = static_cast<int*>(general);
  a.prior[0] = static_cast<const int32_t*>(prior);
  a.prior[1] = static_cast<const int32_t*>(p_best);
  a.prior[2] = static_cast<const int32_t*>(p_nvalid);
  a.m_parent = static_cast<const int32_t*>(m_parent);
  a.m_depth = static_cast<const int32_t*>(m_depth);
  a.m_up = static_cast<const int32_t*>(m_up);
  a.m_levels = m_levels;
  a.m_T1 = m_T1;
  return a;
}
