// K12: the row probe as a one-hot product on the tensor cores.
//
// Replaces the Pallas kernel
//   experiments/mb_pallas.py:118  oneh_lookup (kernel _oneh_kernel :100)
// which fetches the rows of a query tile with a one-hot [qt, NB] x table
// [NB, 2W] product on the MXU (float32, the table split into 16-bit
// halves), then compares the W rem lanes with rem and sums the W payload
// lanes where they match (uint32, wrapping): the function of xla_lookup
// (:68) and of K11.
//
// Form chosen: mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32, the
// table split into its four byte planes. Each output of the product is one
// byte times 1 (a row of the one-hot has a single 1), so the s32
// accumulator holds it exactly, and u8 runs at the card's int8 rate, twice
// the fp16/bf16 rate that an m16n8k16 form with 16-bit halves would get.
//   - A (16 x 32 u8, row) is the one-hot, built in registers from b: the
//     register holding A[row][4t .. 4t+3] is 1 << 8 (b - k) when b lies in
//     that span, else 0. It is never stored.
//   - B (32 x 8 u8, col) is 32 table rows of 8 word lanes in one byte
//     plane: the column operand wants 4 consecutive rows of one lane in a
//     register, which four __byte_perm's cut out of the 4 words that the
//     tile holds in its natural [row][lane] layout, for all four planes
//     at once. The tiles stream through a double buffer of 32 rows
//     (cp.async, 16 bytes a thread), each row padded by 4 words.
//   - A block takes 64 queries (4 m-tiles); warp w owns word lanes
//     [8w, 8w + 8) in all four planes, so a block has 2W / 8 warps, and
//     each k-step runs 16 mma's a warp.
// The four byte planes are then joined into words, the rows written to
// shared memory, and a group of kProbeLanes lanes a query compares and sums
// them as K11 does.
//
// What bounds it on an H100: the product is 2 M NB 4 (2W) operations, a
// dense form of a gather; at mb_pallas's NB = 16,384, 2W = 128 and M =
// 524,288 queries that is 8.8e12, 4.4 ms at the 1,979 T/s int8 peak, while
// the function's own bytes (the table once, 12 B a query) take 0.0044 ms at
// 3.35 TB/s. Every block also reads the whole table from L2 (8.4 MB a block
// of 64 queries). mma.sync, not wgmma, keeps the kernel simple; a wgmma form
// is later work. Row numbers are taken as K11 takes them (row_in).
#include "common.cuh"

namespace {

constexpr int kK = 32;              // table rows a k-step (the mma's k)
constexpr int kMTiles = 4;          // 16-row m-tiles a block
constexpr int kQueries = 16 * kMTiles;
constexpr int kMaxThreads = 512;    // 2W <= 128: 16 warps at most
constexpr int kPad = 4;             // words of padding a tile row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four consecutive one-hot bytes A[row][k .. k+3] of a query whose table
// row is qrow (-1: none).
__device__ __forceinline__ uint32_t onehot4(int qrow, int k) {
  const unsigned d = static_cast<unsigned>(qrow - k);
  return d < 4u ? 1u << (8 * d) : 0u;
}

// Byte plane p of four words w[0..3]: byte c is byte p of w[c].
__device__ __forceinline__ void byte_planes(const uint32_t* w,
                                            uint32_t (&plane)[4]) {
  const uint32_t lo01 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t lo23 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t hi01 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t hi23 = __byte_perm(w[2], w[3], 0x7362);
  plane[0] = __byte_perm(lo01, lo23, 0x5410);
  plane[1] = __byte_perm(lo01, lo23, 0x7632);
  plane[2] = __byte_perm(hi01, hi23, 0x5410);
  plane[3] = __byte_perm(hi01, hi23, 0x7632);
}

__global__ void __launch_bounds__(kMaxThreads)
rowprobe_onehot_kernel(const uint32_t* __restrict__ table, int NB, int W,
                       const int32_t* __restrict__ b,
                       const uint32_t* __restrict__ rem, long long M,
                       uint32_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  const int lanes = 2 * W;
  const int ls = lanes + kPad;
  uint32_t* tiles = reinterpret_cast<uint32_t*>(smem4);   // [2][kK][ls]
  uint32_t* rows = tiles + 2 * kK * ls;                    // [kQueries][lanes]
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const long long q0 = blockIdx.x * static_cast<long long>(kQueries);

  // The table rows of this thread's A rows: m-tile mt, rows gid, gid + 8.
  int qrow[kMTiles][2];
  for (int mt = 0; mt < kMTiles; ++mt) {
    for (int h = 0; h < 2; ++h) {
      const long long q = q0 + mt * 16 + gid + 8 * h;
      qrow[mt][h] = q < M ? static_cast<int>(row_in(b[q], NB)) : -1;
    }
  }

  const int nk = (NB + kK - 1) / kK;
  const int row_chunks = lanes / 4;                 // 16-byte chunks a row
  auto load = [&](int kt, int buf) {
    for (int c = threadIdx.x; c < kK * row_chunks; c += blockDim.x) {
      const int r = c / row_chunks, col = (c % row_chunks) * 4;
      const long long k = static_cast<long long>(kt) * kK + r;
      if (k < NB) {
        cp_async16(smem_addr(tiles + (buf * kK + r) * ls + col),
                   table + k * lanes + col);
      }
    }
  };

  int acc[kMTiles][4][4];
  for (int mt = 0; mt < kMTiles; ++mt)
    for (int p = 0; p < 4; ++p)
      for (int c = 0; c < 4; ++c) acc[mt][p][c] = 0;

  load(0, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const int l = warp * 8 + gid;                     // this thread's B lane
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load(kt + 1, (kt + 1) & 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    // Rows past NB in the last tile hold stale words; their one-hot
    // bytes are 0, so they add nothing.
    const uint32_t* t = tiles + (kt & 1) * kK * ls;
    uint32_t w[8];
    for (int i = 0; i < 4; ++i) {
      w[i] = t[(4 * tig + i) * ls + l];
      w[4 + i] = t[(16 + 4 * tig + i) * ls + l];
    }
    uint32_t b0[4], b1[4];
    byte_planes(w, b0);
    byte_planes(w + 4, b1);
    const int k0 = kt * kK + 4 * tig;
    for (int mt = 0; mt < kMTiles; ++mt) {
      const uint32_t a[4] = {onehot4(qrow[mt][0], k0),
                             onehot4(qrow[mt][1], k0),
                             onehot4(qrow[mt][0], k0 + 16),
                             onehot4(qrow[mt][1], k0 + 16)};
      for (int p = 0; p < 4; ++p) mma_u8(acc[mt][p], a, b0[p], b1[p]);
    }
    __syncthreads();
  }

  // Join the planes: c0, c1 are row gid, lanes 2 tig and 2 tig + 1 of the
  // warp's 8; c2, c3 the same lanes of row gid + 8.
  for (int mt = 0; mt < kMTiles; ++mt) {
    for (int c = 0; c < 4; ++c) {
      const int row = mt * 16 + gid + (c >= 2 ? 8 : 0);
      const int col = warp * 8 + 2 * tig + (c & 1);
      rows[row * lanes + col] =
          static_cast<uint32_t>(acc[mt][0][c]) |
          (static_cast<uint32_t>(acc[mt][1][c]) << 8) |
          (static_cast<uint32_t>(acc[mt][2][c]) << 16) |
          (static_cast<uint32_t>(acc[mt][3][c]) << 24);
    }
  }
  __syncthreads();

  const int g = lane % kProbeLanes;
  constexpr int kGroups = 32 / kProbeLanes;
  for (int qb = warp * kGroups; qb < kQueries; qb += warps * kGroups) {
    const int qi = qb + lane / kProbeLanes;
    const long long q = q0 + qi;
    uint32_t pk = 0;
    if (q < M) {
      const uint32_t rr = rem[q];
      const uint32_t* row = rows + qi * lanes;
      for (int j = g; j < W; j += kProbeLanes) {
        if (row[j] == rr) pk += row[W + j];
      }
    }
    pk = group_sum(pk);
    if (q < M && g == 0) out[q] = pk;
  }
}

}  // namespace

// table int32 [NB, 2W] (uint32 bit patterns; 2W a multiple of 8, at most
// 128; the table 16-byte aligned), b int32 [M], rem int32 [M] (uint32 bit
// patterns), out int32 [M].
extern "C" int pangea_rowprobe_onehot(const void* table, long long NB, int W,
                                      const void* b, const void* rem,
                                      long long M, void* out, void* stream) {
  const int lanes = 2 * W;
  if (NB < 1 || NB > INT_MAX || W < 1 || lanes % 8 || lanes > 128 ||
      reinterpret_cast<uintptr_t>(table) & 15) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  const int smem = (2 * kK * (lanes + kPad) + kQueries * lanes) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      rowprobe_onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rowprobe_onehot_kernel<<<blocks_for(M, kQueries), lanes / 8 * 32, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), static_cast<int>(NB), W,
      static_cast<const int32_t*>(b), static_cast<const uint32_t*>(rem), M,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
