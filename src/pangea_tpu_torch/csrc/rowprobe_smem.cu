// K11: the q8-style row probe with the table held in shared memory.
//
// Replaces the Pallas kernel
//   experiments/mb_pallas.py:83  take_lookup (kernel _take_kernel :75)
// whose function is xla_lookup (:68): for each query, take row b of a
// [NB, 2W] uint32 table, compare its W rem lanes with rem, and sum the W
// payload lanes where they match (uint32, wrapping). The TPU kernel keeps
// the whole table resident in VMEM and tiles the queries over its grid.
//
// No H100 block can hold the 8.4 MB table (227 KB of shared memory at
// most), but the card's 132 SMs hold about 30 MB together. So the table is
// cut into slices of a power-of-two row count that fits one block's
// dynamic shared memory (kSliceBytes: 256 rows of 512 B), and block (s, p)
// loads slice s once, with 16-byte loads, then streams the queries of
// partition p and probes from shared memory exactly those whose row lies in
// slice s: a warp reads the row numbers of kUnroll windows of 32 queries
// at once (then the remainders of the ones it owns), ballots a window's
// owned queries, and a group of kProbeLanes lanes probes each (lane g
// reads rem lanes j = g, g + 8, ... and, only on a match, the payload lane),
// reducing with shuffles. Each query has one owner, which writes its output
// once. A table past one wave of blocks just takes more blocks; when the
// slices are few, the queries split into partitions (gridDim.y) so that
// every SM gets a block.
//
// What bounds it on an H100: bytes are the table read once plus 8 B in and
// 4 B out a query (14.7 MB at mb_pallas's shapes, 0.0044 ms at 3.35 TB/s),
// but every block scans every query's row number of its partition, so the
// blocks read the row numbers S / P times from L2 in all (S slices, P
// partitions). A counting pass that routes each query to its slice first
// would remove that scan; it is later work.
//
// A row number below 0 counts from the end, as in NumPy, and the result is
// clamped into [0, NB), as XLA clamps the reference's gather (row_in).
#include "common.cuh"

namespace {

constexpr int kSliceBytes = 128 * 1024;
constexpr int kThreads = 512;                  // 16 warps
constexpr int kUnroll = 8;                     // 32-query windows a step

__global__ void __launch_bounds__(kThreads)
rowprobe_smem_kernel(const uint32_t* __restrict__ table, long long NB,
                     int W, int log2_slice,
                     const int32_t* __restrict__ b,
                     const uint32_t* __restrict__ rem, long long N,
                     uint32_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  uint32_t* srow = reinterpret_cast<uint32_t*>(smem4);
  const int lanes = 2 * W;
  const long long s = blockIdx.x;
  const long long row0 = s << log2_slice;
  const long long rows = min(NB - row0, 1ll << log2_slice);

  // The slice, once: 16-byte loads where the slice is 16-byte aligned.
  const uint32_t* src = table + row0 * lanes;
  const long long words = rows * lanes;
  long long done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const long long n4 = words / 4;
    const int4* src4 = reinterpret_cast<const int4*>(src);
    for (long long i = threadIdx.x; i < n4; i += blockDim.x) {
      smem4[i] = src4[i];
    }
    done = n4 * 4;
  }
  for (long long i = done + threadIdx.x; i < words; i += blockDim.x) {
    srow[i] = src[i];
  }
  __syncthreads();

  // Partition p of the queries.
  const long long per = (N + gridDim.y - 1) / gridDim.y;
  const long long q0 = blockIdx.y * per;
  const long long q1 = min(N, q0 + per);
  const int lane = threadIdx.x % 32;
  const int g = lane % kProbeLanes;            // lane in its group
  const int grp = lane / kProbeLanes;          // group in the warp
  constexpr int kGroups = 32 / kProbeLanes;
  const int warps = blockDim.x / 32;
  constexpr long long kSpan = 32ll * kUnroll;  // queries a warp a step
  for (long long base = q0 + (threadIdx.x / 32) * kSpan; base < q1;
       base += warps * kSpan) {
    // The step's row numbers first, then the remainders of the owned
    // queries, each batch of loads in flight together.
    int local[kUnroll];                        // row in the slice, or -1
    uint32_t r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = base + u * 32 + lane;
      local[u] = -1;
      if (q < q1) {
        const long long bb = row_in(b[q], NB);
        if ((bb >> log2_slice) == s) local[u] = static_cast<int>(bb - row0);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      r[u] = local[u] >= 0 ? rem[base + u * 32 + lane] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      unsigned mask = __ballot_sync(0xFFFFFFFFu, local[u] >= 0);
      while (mask) {                            // warp-uniform
        unsigned m = mask;
        for (int k = 0; k < grp; ++k) m &= m - 1;  // the grp-th owned query
        const bool has = m != 0;
        const int src_lane = has ? __ffs(m) - 1 : 0;
        const int lr = __shfl_sync(0xFFFFFFFFu, local[u], src_lane);
        const uint32_t rr = __shfl_sync(0xFFFFFFFFu, r[u], src_lane);
        uint32_t pk = 0;
        if (has) {
          const uint32_t* row = srow + static_cast<long long>(lr) * lanes;
          for (int j = g; j < W; j += kProbeLanes) {
            if (row[j] == rr) pk += row[W + j];
          }
        }
        pk = group_sum(pk);
        if (has && g == 0) out[base + u * 32 + src_lane] = pk;
        for (int k = 0; k < kGroups && mask; ++k) mask &= mask - 1;
      }
    }
  }
}

}  // namespace

// table int32 [NB, 2W] (uint32 bit patterns), b int32 [N], rem int32 [N]
// (uint32 bit patterns), out int32 [N]. A block holds the most rows, a
// power of two, that fit kSliceBytes (one row when a row is larger).
extern "C" int pangea_rowprobe_smem(const void* table, long long NB, int W,
                                    const void* b, const void* rem,
                                    long long N, void* out, void* stream) {
  if (NB < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const long long row_bytes = 8ll * W;
  int log2_slice = 0;
  while ((row_bytes << (log2_slice + 1)) <= kSliceBytes &&
         (1ll << log2_slice) < NB) {
    ++log2_slice;
  }
  const long long slice = min(1ll << log2_slice, NB);
  const long long smem = slice * row_bytes;
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(rowprobe_smem_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long S = (NB + slice - 1) / slice;
  // Split the queries when the slices alone leave SMs idle, keeping at
  // least a warp's worth of queries a partition per warp of the block.
  long long P = S < sms ? sms / S : 1;
  P = max(1ll, min(P, N / kThreads));
  const dim3 grid(static_cast<unsigned>(S), static_cast<unsigned>(P));
  rowprobe_smem_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(table), NB, W, log2_slice,
      static_cast<const int32_t*>(b), static_cast<const uint32_t*>(rem), N,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
