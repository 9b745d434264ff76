// K4: std bucket-row probe plus full-key stash scan, one table shard.
//
// Replaces the XLA-compiled reference function
//   src/pangea_tpu/kernels/lookup.py:94  lookup_jnp (B8), n_shards = 1
// (its _std_lanes :125-147 and the stash scan :165-172). The reference
// gathers whole [N, 4W | 6W] rows into device memory and compares them in
// a second pass; here one warp owns one probe and reads its row's hi and lo
// lanes once, and the val / Euler lanes only where they match, so no row
// copy reaches device memory.
//
// What bounds it on an H100: one random row a probe, of which the W hi
// lanes (128 B at W = 32) are read, then one 32 B sector each of the lo,
// val and Euler lanes where hi matches. The wide bench table (131,072 rows
// x 768 B = 100.7 MB) is twice the 50 MB L2, so most row reads go to HBM;
// each warp makes two dependent random reads and little else, so the
// latency of those reads, not the HBM rate, is the likely limit. The
// packed k=31 table (16.8 MB) stays in L2.
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

constexpr int kWarpsPerBlock = 8;

__global__ void lookup_std_kernel(const uint32_t* __restrict__ hi,
                                  const uint32_t* __restrict__ lo,
                                  const uint8_t* __restrict__ valid,
                                  long long N,
                                  const uint32_t* __restrict__ fused,
                                  uint32_t nb_mask, int W, int lanes,
                                  bool packed,
                                  const uint32_t* __restrict__ stash, int S,
                                  int32_t* __restrict__ taxon,
                                  int32_t* __restrict__ t_in,
                                  int32_t* __restrict__ t_out) {
  const int lane = threadIdx.x & 31;
  long long q = blockIdx.x * static_cast<long long>(kWarpsPerBlock) +
                (threadIdx.x >> 5);
  if (q >= N) return;                 // whole warp leaves together
  const bool ok = valid[q] != 0;
  const uint32_t qhi = hi[q], qlo = lo[q];
  // a: pk (packed) or tin (wide); c: tout (wide only).
  uint32_t tax = 0, a = 0, c = 0, s_tax = 0, s_in = 0, s_out = 0;
  if (ok) {
    const uint32_t bucket = hash32(qhi, qlo) & nb_mask;
    const uint32_t* row = fused + static_cast<size_t>(bucket) * lanes;
    for (int j = lane; j < W; j += 32) {
      if (row[j] == qhi && row[W + j] == qlo) {
        tax += row[2 * W + j];
        a += row[3 * W + j];
        if (!packed) c += row[4 * W + j];
      }
    }
    for (int s = lane; s < S; s += 32) {
      if (stash[s] == qhi && stash[S + s] == qlo) {
        s_tax += stash[2 * S + s];
        s_in += stash[3 * S + s];
        s_out += stash[4 * S + s];
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    tax += __shfl_xor_sync(0xFFFFFFFFu, tax, off);
    a += __shfl_xor_sync(0xFFFFFFFFu, a, off);
    c += __shfl_xor_sync(0xFFFFFFFFu, c, off);
    s_tax += __shfl_xor_sync(0xFFFFFFFFu, s_tax, off);
    s_in += __shfl_xor_sync(0xFFFFFFFFu, s_in, off);
    s_out += __shfl_xor_sync(0xFFFFFFFFu, s_out, off);
  }
  if (lane == 0) {
    const uint32_t r_in = packed ? a >> 16 : a;
    const uint32_t r_out = packed ? a & 0xFFFFu : c;
    taxon[q] = static_cast<int32_t>(tax + s_tax);
    t_in[q] = static_cast<int32_t>(r_in + s_in);
    t_out[q] = static_cast<int32_t>(r_out + s_out);
  }
}

}  // namespace

// hi/lo int32 bit patterns and valid bytes [N]; fused [NB, 4W] (packed) or
// [NB, 6W] (wide) and stash [5, S] int32 bit patterns; taxon/t_in/t_out
// int32 [N].
extern "C" int pangea_lookup_std(const void* hi, const void* lo,
                                 const void* valid, long long N,
                                 const void* fused, long long NB, int W,
                                 int packed, const void* stash, int S,
                                 void* taxon, void* t_in, void* t_out,
                                 void* stream) {
  if (NB < 1 || NB > (1ll << 32) || (NB & (NB - 1)) != 0 || W < 1 ||
      S < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  const int lanes = (packed ? 4 : 6) * W;
  lookup_std_kernel<<<blocks_for(N, kWarpsPerBlock), 32 * kWarpsPerBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
      static_cast<const uint8_t*>(valid), N,
      static_cast<const uint32_t*>(fused),
      static_cast<uint32_t>(NB - 1), W, lanes, packed != 0,
      static_cast<const uint32_t*>(stash), S, static_cast<int32_t*>(taxon),
      static_cast<int32_t*>(t_in), static_cast<int32_t*>(t_out));
  return static_cast<int>(cudaGetLastError());
}
