// K1: fused k-mer extraction + disjoint-window minimizer selection.
//
// Replaces the XLA-compiled reference functions
//   src/pangea_tpu/kernels/encode.py:100   extract_kmers_jnp (B1)
//   src/pangea_tpu/kernels/minimize.py:20  select_minimizers_jnp (B2)
//   src/pangea_tpu/kernels/lookup.py:41    hash32_jnp (B3)
// The reference materialises canonical k-mers for all P positions as
// [B, P] arrays and then reduces them to [B, NW] windows; here one thread
// owns one (read, window) and keeps everything in registers: only the
// [B, L] codes are read and only the [B, NW] probes are written.
//
// What bounds it on an H100: device-memory traffic is tiny (L bytes in,
// 9 bytes a window out), so the kernel is bound by integer instructions:
// (w + k - 1) rolling 64-bit updates and w double fmix32 hashes per
// window. The reference builds k-mers by log-doubling merges because a
// TPU has no 64-bit integers; Hopper has them, so the k-mer is a rolling
// 2k-bit register (forward and reverse complement) per thread.
//
// The packed form (kPacked) reads the native reader's wire rows in place of
// codes, fusing the reference's unpack_wire / extract_kmers_packed_jnp
// (src/pangea_tpu/kernels/encode.py:113, :129; B7) into the same pass:
// base t is bits [2(t%16), +2) of word t/16 of the row and its bad flag is
// bit t%32 of word W16 + t/32 (W16 = ceil(L/16)). A row pitch in words
// lets the two mates be column slices of one [B, 2 * (W16 + W32)] batch.
// Rows are 60 B a 150 bp read, so the form reads 2.5x fewer bytes.
//
// Rules (SEMANTICS.md §1-3): codes > 3 (N, padding; int8 read as uint8,
// so negatives count too), and bad flags, make every k-mer that covers them
// invalid.
// canonical = min(fwd, rc); invalid positions carry canonical 0 and are
// hashed as (0, 0). The window keeps the strict-< leftmost hash argmin and
// is valid iff all its w positions are. w = 1 is plain extraction.
#include "common.cuh"

namespace {

template <bool kPacked>
__global__ void extract_probes_kernel(const void* __restrict__ codes,
                                      long long pitch, int B, int L, int k,
                                      int w, int NW,
                                      uint32_t* __restrict__ hi,
                                      uint32_t* __restrict__ lo,
                                      uint8_t* __restrict__ valid, int R,
                                      int col0) {
  long long gid = blockIdx.x * static_cast<long long>(blockDim.x) +
                  threadIdx.x;
  if (gid >= static_cast<long long>(B) * NW) return;
  int b = static_cast<int>(gid / NW);
  int win = static_cast<int>(gid % NW);
  const uint8_t* row = static_cast<const uint8_t*>(codes) + b * pitch;
  const uint32_t* words = static_cast<const uint32_t*>(codes) + b * pitch;
  const int w16 = (L + 15) / 16;
  const uint64_t mask = (1ull << (2 * k)) - 1;   // k <= 31
  const int rc_shift = 2 * (k - 1);
  const int p0 = win * w;
  uint64_t fwd = 0, rc = 0;
  int last_bad = -1;
  uint32_t best_h = 0, best_hi = 0, best_lo = 0;
  bool all_ok = true;
  for (int t = p0; t < p0 + w + k - 1; ++t) {
    uint32_t c2;
    if (kPacked) {
      c2 = (words[t >> 4] >> (2 * (t & 15))) & 3u;
      if ((words[w16 + (t >> 5)] >> (t & 31)) & 1u) last_bad = t;
    } else {
      const uint32_t c = row[t];
      if (c > 3) last_bad = t;
      c2 = c & 3u;
    }
    fwd = ((fwd << 2) | c2) & mask;
    rc = (rc >> 2) | (static_cast<uint64_t>(3u - c2) << rc_shift);
    int p = t - k + 1;               // the k-mer [p, p+k) is complete
    if (p < p0) continue;
    bool ok = last_bad < p;
    uint64_t canon = ok ? (fwd < rc ? fwd : rc) : 0ull;
    uint32_t chi = static_cast<uint32_t>(canon >> 32);
    uint32_t clo = static_cast<uint32_t>(canon);
    uint32_t h = hash32(chi, clo);
    if (p == p0 || h < best_h) {
      best_h = h;
      best_hi = chi;
      best_lo = clo;
    }
    all_ok = all_ok && ok;
  }
  size_t o = static_cast<size_t>(b) * R + col0 + win;
  hi[o] = best_hi;
  lo[o] = best_lo;
  valid[o] = all_ok ? 1 : 0;
}

}  // namespace

// codes int8 [B, L] rows `pitch` bytes apart, or (packed) wire rows of
// uint32 words `pitch` words apart; hi/lo int32 bit patterns and valid
// bytes [B, R], written at columns [col0, col0 + NW) with NW = (L - k + 1)
// / w.
extern "C" int pangea_extract_probes(const void* codes, int B, int L, int k,
                                     int w, void* hi, void* lo, void* valid,
                                     int R, int col0, int packed,
                                     long long pitch, void* stream) {
  int NW = (L - k + 1) / w;
  long long n = static_cast<long long>(B) * NW;
  if (n == 0) return 0;
  const int threads = 256;
  const unsigned int blocks = blocks_for(n, threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed) {
    extract_probes_kernel<true><<<blocks, threads, 0, s>>>(
        codes, pitch, B, L, k, w, NW, static_cast<uint32_t*>(hi),
        static_cast<uint32_t*>(lo), static_cast<uint8_t*>(valid), R, col0);
  } else {
    extract_probes_kernel<false><<<blocks, threads, 0, s>>>(
        codes, pitch, B, L, k, w, NW, static_cast<uint32_t*>(hi),
        static_cast<uint32_t*>(lo), static_cast<uint8_t*>(valid), R, col0);
  }
  return static_cast<int>(cudaGetLastError());
}
