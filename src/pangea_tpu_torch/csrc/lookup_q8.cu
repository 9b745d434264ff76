// K2: q8 and q12 bucket-row probes plus the full-key stash scan.
//
// Replaces the XLA-compiled reference functions
//   src/pangea_tpu/kernels/lookup.py:710  lookup_q8_jnp (B4)
// (with _umulh32_jnp :694 and the stash scan :775-782) and
//   src/pangea_tpu/kernels/lookup.py:629  lookup_q12_jnp (B10)
// (its three remainder branches :650-662 and the stash scan :683-690). The
// reference gathers whole rows into device memory and compares them in a
// second pass; here one warp owns one probe, reads its row once (each lane
// reads the rem lanes j = lane, lane + 32, ... and, only on a match, the
// payload lane) and reduces with shuffles, so no row copy reaches device
// memory.
//
// What bounds it on an H100: one random 512 B row read a probe. The q8
// bench table (8.4 MB) stays in the 50 MB L2, so q8 is bound by L2 row
// fetches and warp issue; the config-4 q12 table (67.1 MB) does not, so
// q12 pays an HBM sector read for its rem_lo lanes on most probes. The TPU
// needed 32-bit limb arithmetic for the 62-bit mix; Hopper multiplies in 64
// bits natively, so all three of the reference's q12 remainder branches are
// the one split below.
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

constexpr int kWarpsPerBlock = 8;

template <bool kQ12>
__global__ void lookup_quot_kernel(const uint32_t* __restrict__ hi,
                                   const uint32_t* __restrict__ lo,
                                   const uint8_t* __restrict__ valid,
                                   long long N,
                                   const uint32_t* __restrict__ fused, int W,
                                   int row_lanes,
                                   const uint32_t* __restrict__ stash, int S,
                                   int m, int r, int32_t* __restrict__ hit,
                                   int32_t* __restrict__ t_in,
                                   int32_t* __restrict__ t_out) {
  const int lane = threadIdx.x & 31;
  long long q = blockIdx.x * static_cast<long long>(kWarpsPerBlock) +
                (threadIdx.x >> 5);
  if (q >= N) return;                 // whole warp leaves together
  const bool ok = valid[q] != 0;
  const uint32_t qhi = hi[q], qlo = lo[q];
  uint32_t pk = 0, s_in = 0, s_out = 0;   // wrapping, as the reference
  int s_hit = 0;
  if (ok) {
    const uint64_t K = (static_cast<uint64_t>(qhi) << 32) | qlo;
    const uint64_t h = (K * 0x9E3779B1ull) & ((1ull << m) - 1);
    const uint64_t bucket = h >> r;
    const uint64_t rem = h & ((1ull << r) - 1);
    const uint32_t rem_lo = static_cast<uint32_t>(rem);
    const uint32_t rem_hi = static_cast<uint32_t>(rem >> 32);
    const uint32_t* row = fused + bucket * static_cast<uint64_t>(row_lanes);
    const uint32_t* payload = row + (kQ12 ? 2 * W : W);
    for (int j = lane; j < W; j += 32) {
      if (row[j] == rem_lo && (!kQ12 || row[W + j] == rem_hi)) {
        pk += payload[j];
      }
    }
    for (int s = lane; s < S; s += 32) {
      if (stash[s] == qhi && stash[S + s] == qlo) {
        s_in += stash[3 * S + s];
        s_out += stash[4 * S + s];
        s_hit += 1;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    pk += __shfl_xor_sync(0xFFFFFFFFu, pk, off);
    s_in += __shfl_xor_sync(0xFFFFFFFFu, s_in, off);
    s_out += __shfl_xor_sync(0xFFFFFFFFu, s_out, off);
    s_hit += __shfl_xor_sync(0xFFFFFFFFu, s_hit, off);
  }
  if (lane == 0) {
    hit[q] = (pk != 0 ? 1 : 0) + s_hit;
    t_in[q] = static_cast<int32_t>((pk >> 16) + s_in);
    t_out[q] = static_cast<int32_t>((pk & 0xFFFFu) + s_out);
  }
}

// log2 of NB, or -1 when NB is not a power of two.
int log2_exact(long long NB) {
  int log2nb = 0;
  while ((1ll << log2nb) < NB) ++log2nb;
  return (1ll << log2nb) == NB ? log2nb : -1;
}

template <bool kQ12>
int launch(const void* hi, const void* lo, const void* valid, long long N,
           const void* fused, int W, int row_lanes, const void* stash, int S,
           int m, int r, void* hit, void* t_in, void* t_out, void* stream) {
  if (N == 0) return 0;
  lookup_quot_kernel<kQ12>
      <<<blocks_for(N, kWarpsPerBlock), 32 * kWarpsPerBlock, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
          static_cast<const uint8_t*>(valid), N,
          static_cast<const uint32_t*>(fused), W, row_lanes,
          static_cast<const uint32_t*>(stash), S, m, r,
          static_cast<int32_t*>(hit), static_cast<int32_t*>(t_in),
          static_cast<int32_t*>(t_out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hi/lo int32 bit patterns and valid bytes [N]; fused [NB, 2W] and stash
// [5, S] int32 bit patterns; hit/t_in/t_out int32 [N].
extern "C" int pangea_lookup_q8(const void* hi, const void* lo,
                                const void* valid, long long N,
                                const void* fused, long long NB, int W,
                                const void* stash, int S, int k, void* hit,
                                void* t_in, void* t_out, void* stream) {
  const int log2nb = log2_exact(NB);
  const int r = 2 * k - log2nb;
  if (log2nb < 0 || k < 1 || k > 31 || r < 0 || r > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<false>(hi, lo, valid, N, fused, W, 2 * W, stash, S, 2 * k, r,
                       hit, t_in, t_out, stream);
}

// The q12 form: fused [NB, row_lanes] with row_lanes >= 3W.
extern "C" int pangea_lookup_q12(const void* hi, const void* lo,
                                 const void* valid, long long N,
                                 const void* fused, long long NB, int W,
                                 int row_lanes, const void* stash, int S,
                                 int k, void* hit, void* t_in, void* t_out,
                                 void* stream) {
  const int log2nb = log2_exact(NB);
  const int r = 2 * k - log2nb;
  if (log2nb < 0 || k < 1 || k > 31 || r < 0 || r > 62 ||
      row_lanes < 3 * W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch<true>(hi, lo, valid, N, fused, W, row_lanes, stash, S, 2 * k,
                      r, hit, t_in, t_out, stream);
}
