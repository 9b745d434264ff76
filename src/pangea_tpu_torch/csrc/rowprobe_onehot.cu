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
//   - A (16 x 32 u8, row) is the one-hot, built in registers from the
//     records' rows: the register holding A[row][4t .. 4t+3] is 1 << 8 (r -
//     k) when the row r lies in that span, else 0. It is never stored.
//   - B (32 x 8 u8, col) is a k-tile's 32 table rows of 8 word lanes in
//     one byte plane: the column operand wants 4 consecutive rows of one
//     lane in a register, which four __byte_perm's cut out of the 4 words
//     that the staged rows hold in their natural [row][lane] layout, for all
//     four planes at once.
//   - Warp w owns word lanes [8w, 8w + 8) in all four planes, so a block
//     has 2W / 8 warps; a step takes 64 records (4 m-tiles).
//
// The queries come routed, as K11 takes them (common.cuh): the routing
// pass leaves records in ascending order of their row's 32-row k-tile, a
// block takes a run of kRun records and stages, a pass at a time, the rows
// of the pass's k-tiles and its records. An m-tile of 16 consecutive
// records then spans one k-tile, or a few, and its k-loop visits only
// those: the warp takes the least k-tile that one of the m-tile's rows
// still lies in (__reduce_min_sync), runs the mma's for it, and marks those
// rows done. Every k-tile it skips holds none of the m-tile's rows, so that
// tile's block of the one-hot is all zero and adds nothing: the product is
// the same product. A warp keeps the B planes of the last k-tile it loaded,
// and consecutive m-tiles mostly share one. Rows past NB are never staged;
// their B words are 0 and their one-hot bytes are 0. The four byte planes
// are then joined into words, the rows written to shared memory, and a
// group of kProbeLanes lanes a record compares and sums them as K11 does.
//
// What bounds it on an H100: the function's bytes (the table once, 12 B a
// query: 0.0044 ms at 3.35 TB/s at mb_pallas's shapes). The product the
// TPU experiment calibrated, dense over all NB rows, is 2 M NB 4 (2W)
// operations (8.8e12 there, 4.4 ms at the 1,979 T/s int8 peak); over the
// visited k-tiles alone it is 2 x 16 x 32 x 4 (2W) a visit, about 1.7e10
// (under 0.01 ms). Before the routing, every block of 64 queries walked
// all NB / 32 k-tiles and read the whole table from L2. Row numbers are
// taken as K11 takes them (row_in, in the routing pass).
#include "common.cuh"

namespace {

constexpr int kK = 32;              // table rows a k-tile (the mma's k)
constexpr int kMTiles = 4;          // 16-row m-tiles a step
constexpr int kQueries = 16 * kMTiles;
constexpr int kMaxThreads = 512;    // 2W <= 128: 16 warps at most
constexpr uint32_t kDone = 0xFFFFFFFFu;   // no row, or its k-tile visited

__device__ __forceinline__ void mma_u8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four consecutive one-hot bytes A[row][k .. k+3] of a record whose staged
// row is qrow (kDone: none).
__device__ __forceinline__ uint32_t onehot4(uint32_t qrow, int k) {
  const uint32_t d = qrow - static_cast<uint32_t>(k);
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

// Words a row of the joined rows: lanes padded to 8 mod 32, so that a
// warp's 8-byte stores of rows gid (0-7) at lanes 2 tig fall in distinct
// banks, and each row stays 16-byte aligned.
__host__ __device__ constexpr int joined_stride(int lanes) {
  return lanes + ((8 - lanes) % 32 + 32) % 32;
}

__global__ void __launch_bounds__(kMaxThreads)
rowprobe_onehot_kernel(const uint32_t* __restrict__ table, long long NB,
                       int W, int shift, int window_keys,
                       const int4* __restrict__ rec, long long M,
                       uint32_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  const int lanes = 2 * W;
  const int ls = joined_stride(lanes);
  int4* srec = smem4;                                         // [kRun]
  uint32_t* rows = reinterpret_cast<uint32_t*>(smem4 + kRun);  // [64][ls]
  uint32_t* win = rows + kQueries * ls;             // staged [rows][lanes]
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int l = warp * 8 + gid;                     // this thread's B lane
  const int g = lane % kProbeLanes, grp = lane / kProbeLanes;
  constexpr int kGroups = 32 / kProbeLanes;
  const long long r0 = blockIdx.x * static_cast<long long>(kRun);
  const long long r1 = min(M, r0 + kRun);
  stage_words(reinterpret_cast<uint32_t*>(srec),
              reinterpret_cast<const uint32_t*>(rec + r0), 4 * (r1 - r0));

  for (long long i = r0; i < r1;) {
    const RowPass p = row_pass(rec, i, r1, shift, window_keys, NB);
    stage_words(win, table + p.row0 * lanes,
                static_cast<long long>(p.rows) * lanes);
    stage_wait();
    uint32_t cached = kDone;             // the k-tile that b0, b1 hold
    uint32_t b0[4], b1[4];
    for (long long base = i; base < p.end; base += kQueries) {
      // This thread's A rows: m-tile mt, rows gid and gid + 8, as rows of
      // the staged window.
      uint32_t qrow[kMTiles][2];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long r = base + mt * 16 + gid + 8 * h;
          qrow[mt][h] = r < p.end
                            ? static_cast<uint32_t>(srec[r - r0].y - p.row0)
                            : kDone;
        }
      }
      int acc[kMTiles][4][4];
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[mt][q][c] = 0;

#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        uint32_t t0 = qrow[mt][0] == kDone ? kDone : qrow[mt][0] / kK;
        uint32_t t1 = qrow[mt][1] == kDone ? kDone : qrow[mt][1] / kK;
        for (;;) {                                  // warp-uniform
          const uint32_t kt = __reduce_min_sync(0xFFFFFFFFu, min(t0, t1));
          if (kt == kDone) break;
          if (kt != cached) {
            uint32_t w[8];
            const int rb = static_cast<int>(kt) * kK + 4 * tig;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              w[u] = rb + u < p.rows ? win[(rb + u) * lanes + l] : 0u;
              w[4 + u] =
                  rb + 16 + u < p.rows ? win[(rb + 16 + u) * lanes + l] : 0u;
            }
            byte_planes(w, b0);
            byte_planes(w + 4, b1);
            cached = kt;
          }
          const int k0 = static_cast<int>(kt) * kK + 4 * tig;
          const uint32_t a[4] = {onehot4(qrow[mt][0], k0),
                                 onehot4(qrow[mt][1], k0),
                                 onehot4(qrow[mt][0], k0 + 16),
                                 onehot4(qrow[mt][1], k0 + 16)};
#pragma unroll
          for (int q = 0; q < 4; ++q) mma_u8(acc[mt][q], a, b0[q], b1[q]);
          if (t0 == kt) t0 = kDone;
          if (t1 == kt) t1 = kDone;
        }
      }

      // Join the planes: c0, c1 are row gid, lanes 2 tig and 2 tig + 1 of
      // the warp's 8; c2, c3 the same lanes of row gid + 8.
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int k = 2 * h + c;
            v[c] = static_cast<uint32_t>(acc[mt][0][k]) |
                   (static_cast<uint32_t>(acc[mt][1][k]) << 8) |
                   (static_cast<uint32_t>(acc[mt][2][k]) << 16) |
                   (static_cast<uint32_t>(acc[mt][3][k]) << 24);
          }
          const int row = mt * 16 + gid + 8 * h;
          *reinterpret_cast<uint2*>(rows + row * ls + warp * 8 + 2 * tig) =
              make_uint2(v[0], v[1]);
        }
      }
      __syncthreads();

      // A group a record; the loop's bound is the warp's, so that
      // group_sum's shuffles see every lane.
      for (int q0 = warp * kGroups; q0 < kQueries; q0 += warps * kGroups) {
        const int qi = q0 + grp;
        const long long r = base + qi;
        const bool has = qi < kQueries && r < p.end;
        uint32_t pk = 0;
        int4 e = make_int4(0, 0, 0, 0);
        if (has) {
          e = srec[r - r0];
          pk = probe_part<true>(rows + qi * ls, W,
                                static_cast<uint32_t>(e.z), g);
        }
        pk = group_sum(pk);
        if (has && g == 0) out[e.x] = pk;
      }
      __syncthreads();                  // before the next step's rows
    }
    i = p.end;
  }
}

}  // namespace

// table int32 [NB, 2W] (uint32 bit patterns; 2W a multiple of 8, at most
// 128); shift and window_keys as K11's (kernels/rowprobe.py rowprobe_plan);
// records int32 [M, 4], the routing pass's (query index, row, rem, 1) in
// ascending row >> shift; out int32 [M], written at each record's query
// index.
extern "C" int pangea_rowprobe_onehot(const void* table, long long NB, int W,
                                      int shift, int window_keys,
                                      const void* records, long long M,
                                      void* out, void* stream) {
  const int lanes = 2 * W;
  if (NB < 1 || NB > INT_MAX || W < 1 || lanes % 8 || lanes > 128 ||
      shift < 5 || shift > 30 || window_keys < 1 || M < 0 ||
      reinterpret_cast<uintptr_t>(records) & 15) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M == 0) return 0;
  const long long smem =
      kRun * sizeof(int4) + kQueries * joined_stride(lanes) * 4ll +
      (static_cast<long long>(window_keys) << shift) * lanes * 4ll;
  cudaError_t err = allow_smem(rowprobe_onehot_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rowprobe_onehot_kernel<<<blocks_for(M, kRun), lanes / 8 * 32, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), NB, W, shift, window_keys,
      static_cast<const int4*>(records), M, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
