// K1: fused k-mer extraction + disjoint-window minimizer selection.
//
// Replaces the XLA-compiled reference functions
//   src/pangea_tpu/kernels/encode.py:100   extract_kmers_jnp (B1)
//   src/pangea_tpu/kernels/minimize.py:20  select_minimizers_jnp (B2)
//   src/pangea_tpu/kernels/lookup.py:41    hash32_jnp (B3)
// and, in its packed form, unpack_wire / extract_kmers_packed_jnp
// (src/pangea_tpu/kernels/encode.py:113, :129; B7). The reference
// materialises canonical k-mers for all P positions as [B, P] arrays and
// reduces them to [B, NW] windows; here only the [B, L] codes (or wire
// rows) are read and only the [B, NW] probes are written.
//
// What bounds it on an H100: L bytes in (the packed form L / 2.5) and 9
// bytes a window out, and about 30 integer operations a position (48 with
// the hash), which the card issues at half its 32-bit rate. A warp
// owns a tile of consecutive windows of one read (kernels/minimize.py
// k1_plan sizes the tiles so that the grid fills the card) and walks it in
// passes of 32 positions, a lane a position. The read comes in as a 2-bit
// stream the warp shares: a pass needs bases [p, p + 64) (k <= 31), four
// 32-bit words of codes, base j at bits [2j, 2j + 2), and 64 bad flags,
// ingested a block of 32 bases a pass and loaded a pass ahead.
//   codes form: lane i loads base t + i (one coalesced 32-byte read); a
//     ballot gives the bad flags (code > 3 as uint8, so negatives too),
//     two OR-reductions the codes of lanes 0-15 and 16-31;
//   packed form: the wire row is that stream already (base t at bits
//     [2(t%16), +2) of word t/16, its bad flag at bit t%32 of word
//     W16 + t/32, W16 = ceil(L/16)): three uniform word loads a block. A
//     row pitch in words lets the two mates be column slices of one batch.
// Each lane builds its k-mer once: x = the 2k stream bits at 2p (a funnel
// shift of two 32-bit words a half), the reverse complement is x ^ mask
// (base p in the low bits, as a rolling rc register holds it), the forward
// k-mer x with its 2-bit pairs reversed (__brev of each half, one swap of
// adjacent bits, the halves exchanged) shifted down by 64 - 2k; valid iff
// no bad flag in [p, p + k). One hash32 a position where w > 1.
//
// Rules (SEMANTICS.md §1-3): codes > 3 (N, padding; int8 read as uint8,
// so negatives count too), and bad flags, make every k-mer that covers them
// invalid.
// canonical = min(fwd, rc); invalid positions carry canonical 0 and are
// hashed as (0, 0). The window keeps the strict-< leftmost hash argmin and
// is valid iff all its w positions are. w = 1 is plain extraction.
//
// Windows. Where w is a power of two up to 32 a window is an aligned group
// of w lanes of one pass: log2(w) xor-shuffles give the group its least
// hash, a ballot its leftmost lane, which stores the window (w = 1: every
// lane stores its own position, coalesced). Any other w: lane j owns
// window j of each round of 32 windows (32w positions, w passes); a pass
// reduces each run of lanes of one window to its leftmost minimum
// (shuffles down by 1, 2, 4, ... < min(w, 32)), each owner takes its
// window's run from the lane where the run starts, strict-< over earlier
// passes, and stores it at the round's end, coalesced; the window's
// validity is the AND of its lanes' ballot bits. Any w >= 1 and 1 <= k <=
// 31 take this one body.
#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxWarps = 8;   // kernels/minimize.py K1_WARPS

// A block of 32 bases as the warp shares it: base j's 2-bit code at bits
// [2j, 2j + 2) of (hi:lo), its bad flag at bit j of `bad`.
struct Block {
  uint32_t lo, hi, bad;
};

// int8 codes, rows `pitch` bytes apart; each lane reads its own column.
// load() reads the next block, from base t0 on.
struct CodesFront {
  using Raw = uint32_t;
  const uint8_t* at;   // this lane's base of the next block
  int left;            // bases of the read from there on
  __device__ CodesFront(const void* src, long long pitch, int b, int len,
                        int lane, int t0)
      : at(static_cast<const uint8_t*>(src) + b * pitch + lane + t0),
        left(len - lane - t0) {}
  // Lane i's base of the block; bases past the read read as 0.
  __device__ Raw load() {
    const Raw c = left > 0 ? static_cast<Raw>(*at) : 0u;
    at += 32;
    left -= 32;
    return c;
  }
  __device__ Block ingest(Raw c, int lane) const {
    const uint32_t v = (c & 3u) << (2 * (lane & 15));
    return {__reduce_or_sync(kFull, lane < 16 ? v : 0u),
            __reduce_or_sync(kFull, lane < 16 ? 0u : v),
            __ballot_sync(kFull, c > 3u)};
  }
};

// Packed wire rows of uint32 words, `pitch` words apart; t0 a multiple of
// 32. Words past the row read as 0.
struct PackedFront {
  using Raw = Block;
  const uint32_t* code;   // the next block's two code words
  const uint32_t* bad;    // its bad-flag word
  int codes_left, bad_left;
  __device__ PackedFront(const void* src, long long pitch, int b, int len,
                         int, int t0)
      : code(static_cast<const uint32_t*>(src) + b * pitch + t0 / 16),
        bad(static_cast<const uint32_t*>(src) + b * pitch + (len + 15) / 16 +
            t0 / 32),
        codes_left((len + 15) / 16 - t0 / 16),
        bad_left((len + 31) / 32 - t0 / 32) {}
  __device__ Raw load() {
    const Raw r = {codes_left > 0 ? code[0] : 0u,
                   codes_left > 1 ? code[1] : 0u,
                   bad_left > 0 ? bad[0] : 0u};
    code += 2;
    bad += 1;
    codes_left -= 2;
    bad_left -= 1;
    return r;
  }
  __device__ Block ingest(Raw r, int) const { return r; }
};

// The 2-bit pairs of v in reverse order: __brev, then adjacent bits
// swapped back, (r >> 1) & 0x55555555 | (r << 1) & 0xAAAAAAAA as one LOP3
// (table 0xE4: a & c | b & ~c).
__device__ __forceinline__ uint32_t reverse_pairs(uint32_t v) {
  const uint32_t r = __brev(v);
  uint32_t out;
  asm("lop3.b32 %0, %1, %2, %3, 0xE4;"
      : "=r"(out)
      : "r"(r >> 1), "r"(r << 1), "r"(0x55555555u));
  return out;
}

// What a lane needs of k, fixed for the launch: the k-mer's mask as two
// words, the shift that brings the reversed k-mer down, k bad-flag bits.
struct KmerShape {
  uint32_t mlo, mhi, kbits;
  int down;   // 64 - 2k
  __device__ explicit KmerShape(int k)
      : mlo(k >= 16 ? kFull : (1u << (2 * k)) - 1u),
        mhi(k > 16 ? (1u << (2 * k - 32)) - 1u : 0u),
        kbits((1u << k) - 1u), down(64 - 2 * k) {}
};

// The canonical k-mer (hi, lo) at the lane's position p0 + lane of a pass
// whose blocks are b0 (bases [p0, p0 + 32)) and b1, canonical 0 unless
// valid. The lane's 2k stream bits start at bit 2 * lane: words (a, m, c)
// are (b0.lo, b0.hi, b1.lo) for lanes 0-15 and (b0.hi, b1.lo, b1.hi) for
// 16-31, shifted by r = 2 * (lane % 16).
__device__ __forceinline__ bool kmer_at(const Block& b0, const Block& b1,
                                        int lane, const KmerShape& ks,
                                        uint32_t& chi, uint32_t& clo) {
  const bool upper = lane >= 16;
  const int r = 2 * (lane & 15);
  const uint32_t a = upper ? b0.hi : b0.lo;
  const uint32_t m = upper ? b1.lo : b0.hi;
  const uint32_t c = upper ? b1.hi : b1.lo;
  const uint32_t xlo = __funnelshift_r(a, m, r) & ks.mlo;
  const uint32_t xhi = __funnelshift_r(m, c, r) & ks.mhi;
  const uint32_t rlo = xlo ^ ks.mlo, rhi = xhi ^ ks.mhi;  // reverse compl.
  const uint64_t fwd = (static_cast<uint64_t>(reverse_pairs(xlo)) << 32 |
                        reverse_pairs(xhi)) >> ks.down;
  const uint64_t rc = static_cast<uint64_t>(rhi) << 32 | rlo;
  const bool ok = (__funnelshift_r(b0.bad, b1.bad, lane) & ks.kbits) == 0;
  const uint64_t canon = ok ? (fwd < rc ? fwd : rc) : 0ull;
  chi = static_cast<uint32_t>(canon >> 32);
  clo = static_cast<uint32_t>(canon);
  return ok;
}

__host__ __device__ constexpr int log2_of(int v) {
  return v > 1 ? 1 + log2_of(v / 2) : 0;
}

// kW: w, where w is a power of two up to 32 (a window is an aligned group
// of kW lanes of one pass); 0 for any other w.
template <class Front, int kW>
__global__ void __launch_bounds__(kMaxWarps * 32)
    extract_probes_kernel(const void* __restrict__ src, long long pitch,
                          int B, int L, int k, int w, int NW, int tiles,
                          int tile_windows, uint32_t* __restrict__ hi,
                          uint32_t* __restrict__ lo,
                          uint8_t* __restrict__ valid, int R, int col0) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (item >= B * tiles) return;                 // a whole warp
  const int b = tiles == 1 ? item : item / tiles;
  const int win0 = (item - b * tiles) * tile_windows;
  const int win_end = min(win0 + tile_windows, NW);
  // tile_windows is a multiple of 32, so the tile's first position is.
  int p = win0 * w;
  Front front(src, pitch, b, L, lane, p);
  const KmerShape ks(k);
  uint32_t* const hi_row = hi + static_cast<size_t>(b) * R + col0;
  uint32_t* const lo_row = lo + static_cast<size_t>(b) * R + col0;
  uint8_t* const valid_row = valid + static_cast<size_t>(b) * R + col0;
  // The stream: the blocks at p and p + 32 ingested, p + 64's loading.
  Block b0 = front.ingest(front.load(), lane);
  Block b1 = front.ingest(front.load(), lane);
  typename Front::Raw next = front.load();
  if constexpr (kW > 0) {
    // The group's leftmost hash minimum stores its window.
    constexpr int kLog2 = log2_of(kW);
    const uint32_t group =
        kW == 32 ? kFull : ((1u << kW) - 1u) << (lane & ~(kW - 1));
    const int end = win_end * kW;
    int win = (p + lane) >> kLog2;
    uint32_t* hp = hi_row + win;
    uint32_t* lp = lo_row + win;
    uint8_t* vp = valid_row + win;
    // Four passes unrolled where w > 1 (about 6 % off the q8 headline's
    // launch on an H100); two at w = 1, as the compiler unrolls it.
#pragma unroll(kW == 1 ? 2 : 4)
    for (; p < end; p += 32, win += 32 / kW, hp += 32 / kW, lp += 32 / kW,
                    vp += 32 / kW) {
      uint32_t chi, clo;
      const bool ok = kmer_at(b0, b1, lane, ks, chi, clo);
      bool store = win < win_end, wok = ok;
      if constexpr (kW > 1) {
        const uint32_t h = hash32(chi, clo);
        uint32_t g = h;
#pragma unroll
        for (int d = 1; d < kW; d <<= 1) {
          g = min(g, __shfl_xor_sync(kFull, g, d));
        }
        const uint32_t eq = __ballot_sync(kFull, h == g) & group;
        wok = (__ballot_sync(kFull, ok) & group) == group;
        store = store && lane == __ffs(eq) - 1;
      }
      if (store) {
        *hp = chi;
        *lp = clo;
        *vp = wok ? 1 : 0;
      }
      b0 = b1;
      b1 = front.ingest(next, lane);
      next = front.load();
    }
  } else {
    // Lane j owns window j of each round of 32 windows. Each run of lanes
    // of one window goes down to its leftmost minimum; its owner takes it
    // from the lane where the run starts.
    const int span = min(w, 32);
    const int step_rem = 32 % w;
    int rem = lane % w;         // this lane's place in its window
    for (int r0 = win0; r0 < win_end; r0 += 32) {
      const int nwin = min(32, win_end - r0);
      const int end = (r0 + nwin) * w;
      int head = lane * w;      // window r0 + lane's start, from p
      uint32_t best_h = 0, best_hi = 0, best_lo = 0;
      bool best_ok = true;
      for (; p < end; p += 32) {
        uint32_t chi, clo;
        const bool ok = kmer_at(b0, b1, lane, ks, chi, clo);
        uint32_t h = hash32(chi, clo);
        const uint32_t okm = __ballot_sync(kFull, ok);
        for (int d = 1; d < span; d <<= 1) {
          const uint32_t oh = __shfl_down_sync(kFull, h, d);
          const uint32_t ohi = __shfl_down_sync(kFull, chi, d);
          const uint32_t olo = __shfl_down_sync(kFull, clo, d);
          if (lane + d < 32 && rem + d < w && oh < h) {
            h = oh;
            chi = ohi;
            clo = olo;
          }
        }
        const bool mine = head < 32 && head + w > 0;
        const int from = mine ? max(head, 0) : lane;
        const uint32_t oh = __shfl_sync(kFull, h, from);
        const uint32_t ohi = __shfl_sync(kFull, chi, from);
        const uint32_t olo = __shfl_sync(kFull, clo, from);
        if (mine) {
          const int n = min(head + w, 32) - from;
          const uint32_t m = (n == 32 ? kFull : (1u << n) - 1u) << from;
          if (head >= 0 || oh < best_h) {
            best_h = oh;
            best_hi = ohi;
            best_lo = olo;
          }
          best_ok = best_ok && (okm & m) == m;
        }
        head -= 32;
        rem += step_rem;
        if (rem >= w) rem -= w;
        b0 = b1;
        b1 = front.ingest(next, lane);
        next = front.load();
      }
      if (lane < nwin) {
        hi_row[r0 + lane] = best_hi;
        lo_row[r0 + lane] = best_lo;
        valid_row[r0 + lane] = best_ok ? 1 : 0;
      }
    }
  }
}

template <class Front, int kW>
void launch(const void* codes, long long pitch, int B, int L, int k, int w,
            int NW, int grid, int warps, int tiles, int tile_windows,
            void* hi, void* lo, void* valid, int R, int col0,
            cudaStream_t s) {
  extract_probes_kernel<Front, kW><<<grid, warps * 32, 0, s>>>(
      codes, pitch, B, L, k, w, NW, tiles, tile_windows,
      static_cast<uint32_t*>(hi), static_cast<uint32_t*>(lo),
      static_cast<uint8_t*>(valid), R, col0);
}

template <class Front>
void launch_w(const void* codes, long long pitch, int B, int L, int k,
              int w, int NW, int grid, int warps, int tiles,
              int tile_windows, void* hi, void* lo, void* valid, int R,
              int col0, cudaStream_t s) {
  switch (w) {
#define K1_CASE(W)                                                        \
  case W:                                                                 \
    launch<Front, W>(codes, pitch, B, L, k, w, NW, grid, warps, tiles,    \
                     tile_windows, hi, lo, valid, R, col0, s);            \
    break;
    K1_CASE(1)
    K1_CASE(2)
    K1_CASE(4)
    K1_CASE(8)
    K1_CASE(16)
    K1_CASE(32)
#undef K1_CASE
    default:
      launch<Front, 0>(codes, pitch, B, L, k, w, NW, grid, warps, tiles,
                       tile_windows, hi, lo, valid, R, col0, s);
  }
}

}  // namespace

// codes int8 [B, L] rows `pitch` bytes apart, or (packed) wire rows of
// uint32 words `pitch` words apart; hi/lo int32 bit patterns and valid
// bytes [B, R], written at columns [col0, col0 + NW) with NW = (L - k + 1)
// / w. grid, warps, tiles (a read's) and tile_windows (a multiple of 32)
// are kernels/minimize.py k1_plan's.
extern "C" int pangea_extract_probes(const void* codes, int B, int L, int k,
                                     int w, void* hi, void* lo, void* valid,
                                     int R, int col0, int packed,
                                     long long pitch, int grid, int warps,
                                     int tiles, int tile_windows,
                                     void* stream) {
  if (k < 1 || k > 31 || w < 1 || warps < 1 || warps > kMaxWarps ||
      tile_windows < 32 || tile_windows % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int NW = (L - k + 1) / w;
  if (NW <= 0 || B <= 0 || grid == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (packed) {
    launch_w<PackedFront>(codes, pitch, B, L, k, w, NW, grid, warps, tiles,
                          tile_windows, hi, lo, valid, R, col0, s);
  } else {
    launch_w<CodesFront>(codes, pitch, B, L, k, w, NW, grid, warps, tiles,
                         tile_windows, hi, lo, valid, R, col0, s);
  }
  return static_cast<int>(cudaGetLastError());
}
