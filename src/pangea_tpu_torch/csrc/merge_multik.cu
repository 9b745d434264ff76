// K7: the multi-k merge of two classifiers' per-read calls.
//
// Replaces the XLA-compiled reference function
//   src/pangea_tpu/classify/merge.py:39  merge_multik_jnp (B13)
// (with _mul_u64 :16 and _ge_u64 :35), the rules of docs/SEMANTICS.md §9.
// One thread a read over the [B] triples (taxon, best, nvalid) of the two
// calls.
//
// What bounds it on an H100: it reads six and writes three int32 [B]
// arrays, a few hundred KB a batch, and on a conflict walks the binary
// lifting table (lca_lift_pair, common.cuh, shared with K5): dependent
// reads of a table that L2 holds, hidden by the B threads in flight. The
// TPU had no 64-bit integers under jit, so the reference compares the
// confidences through 16-bit limb products; Hopper multiplies int32 by
// int32 into int64 natively.
//
// Rules: x1 = b1 * n2 and x2 = b2 * n1 exactly (int64; best and nvalid are
// counts, so never negative). Both unclassified (t1 == t2 == 0): (0, 0,
// n1 + n2), the sum wrapping in 32 bits as the reference's does. Agreement
// (t1 == t2 != 0): t1, with (best, nvalid) of r1 if x1 >= x2, else of r2.
// Conflict (both != 0, t1 != t2): LCA(t1, t2), with (best, nvalid) of r1
// if x1 <= x2 (the lower confidence; a tie goes to r1), else of r2.
// One-sided: the classified call's triple.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void merge_multik_kernel(const int32_t* __restrict__ t1,
                                    const int32_t* __restrict__ b1,
                                    const int32_t* __restrict__ n1,
                                    const int32_t* __restrict__ t2,
                                    const int32_t* __restrict__ b2,
                                    const int32_t* __restrict__ n2, int B,
                                    const int32_t* __restrict__ parent,
                                    const int32_t* __restrict__ depth,
                                    const int32_t* __restrict__ up,
                                    int levels, int T1,
                                    int32_t* __restrict__ taxon,
                                    int32_t* __restrict__ best,
                                    int32_t* __restrict__ nvalid) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B) return;
  const int a1 = t1[i], a2 = t2[i];
  const int32_t bb1 = b1[i], nn1 = n1[i], bb2 = b2[i], nn2 = n2[i];
  const long long x1 = static_cast<long long>(bb1) * nn2;
  const long long x2 = static_cast<long long>(bb2) * nn1;
  const bool both0 = a1 == 0 && a2 == 0;
  const bool agree = a1 != 0 && a1 == a2;
  const bool conflict = a1 != 0 && a2 != 0 && a1 != a2;
  const bool keep1 = agree ? x1 >= x2 : conflict ? x1 <= x2 : a1 != 0;
  taxon[i] = conflict ? lca_lift_pair(a1, a2, parent, depth, up, levels, T1)
                      : (a1 != 0 ? a1 : a2);
  best[i] = both0 ? 0 : keep1 ? bb1 : bb2;
  nvalid[i] = both0 ? static_cast<int32_t>(static_cast<uint32_t>(nn1) +
                                           static_cast<uint32_t>(nn2))
                    : keep1 ? nn1 : nn2;
}

}  // namespace

// t1/b1/n1/t2/b2/n2 int32 [B]: the two calls; parent/depth int32 [T1]; up
// int32 [levels, T1]; taxon/best/nvalid int32 [B]: the merged call.
extern "C" int pangea_merge_multik(const void* t1, const void* b1,
                                   const void* n1, const void* t2,
                                   const void* b2, const void* n2, int B,
                                   const void* parent, const void* depth,
                                   const void* up, int levels, int T1,
                                   void* taxon, void* best, void* nvalid,
                                   void* stream) {
  if (levels < 1 || T1 < 2) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  merge_multik_kernel<<<blocks_for(B, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(t1), static_cast<const int32_t*>(b1),
      static_cast<const int32_t*>(n1), static_cast<const int32_t*>(t2),
      static_cast<const int32_t*>(b2), static_cast<const int32_t*>(n2), B,
      static_cast<const int32_t*>(parent), static_cast<const int32_t*>(depth),
      static_cast<const int32_t*>(up), levels, T1,
      static_cast<int32_t*>(taxon), static_cast<int32_t*>(best),
      static_cast<int32_t*>(nvalid));
  return static_cast<int>(cudaGetLastError());
}
