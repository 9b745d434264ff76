// K11: the q8-style row probe, the table rows a block needs held in shared
// memory.
//
// Replaces the Pallas kernel
//   experiments/mb_pallas.py:83  take_lookup (kernel _take_kernel :75)
// whose function is xla_lookup (:68): for each query, take row b of a
// [NB, 2W] uint32 table, compare its W rem lanes with rem, and sum the W
// payload lanes where they match (uint32, wrapping). The TPU kernel keeps
// the whole table resident in VMEM and tiles the queries over its grid.
//
// No H100 block can hold the 8.4 MB table (227 KB of shared memory at
// most). So the queries come routed: the routing pass (bucket_sort.cu
// pangea_rowprobe_route) leaves them as records in ascending order of their
// row's 32-row tile, and block b takes the run of records [b * kRun, (b +
// 1) * kRun) (common.cuh). On mb_pallas's world a run of 2,048 records
// touches 2-4 tiles (32-64 KB), so the grid reads the table about once, as
// take_lookup does. The block stages its run's records and, a pass at a
// time, the rows of its keys (cp.async, 16 bytes a copy, at most
// window_keys keys: about 64 KB), then probes each record from shared
// memory: a group of kProbeLanes lanes probes kBatch records at a time,
// lane g reading the rem lanes 4g + 32t as 16-byte words where W is a
// multiple of 4 (one word a load otherwise) and a payload word only on a
// match, and one reduce-scatter leaves each lane one record's sum to
// write. Each query has one record, which writes its output once.
//
// What bounds it on an H100: bytes, the table read once plus 8 B in and 4
// B out a query (14.7 MB at mb_pallas's shapes, 0.0044 ms at 3.35 TB/s).
// Routed, the call moves about twice that: the routing pass reads the 8 B
// and writes a 16-byte record a query, and the probe reads the records
// back; the rows staged per pass add about half a table (a tile at each
// run's edge is staged by both runs). Before the routing pass, each block
// held a 128 KB slice and scanned the row number of every query, reading
// the row numbers 64 times over.
//
// A row number below 0 counts from the end, as in NumPy, and the result is
// clamped into [0, NB), as XLA clamps the reference's gather (row_in, in
// the routing pass).
#include "common.cuh"

namespace {

constexpr int kThreads = 512;                  // 16 warps
constexpr int kGroups = 32 / kProbeLanes;      // groups a warp
constexpr int kBatch = kProbeLanes;            // records a group a step

// kW: W when the launch fixes it (32 or 64, mb_pallas's widths, so that a
// lane's loop over its 16-byte rem words unrolls), else 0; kVec: the
// 16-byte probe (W a multiple of 4).
template <int kW, bool kVec>
__global__ void __launch_bounds__(kThreads)
rowprobe_smem_kernel(const uint32_t* __restrict__ table, long long NB,
                     int w, int shift, int window_keys,
                     const int4* __restrict__ rec, long long N,
                     uint32_t* __restrict__ out) {
  extern __shared__ int4 smem4[];
  int4* srec = smem4;                               // [kRun] the run
  uint32_t* srow = reinterpret_cast<uint32_t*>(smem4 + kRun);  // the rows
  const int W = kW ? kW : w;
  const int lanes = 2 * W;
  const long long r0 = blockIdx.x * static_cast<long long>(kRun);
  const long long r1 = min(N, r0 + kRun);
  stage_words(reinterpret_cast<uint32_t*>(srec),
              reinterpret_cast<const uint32_t*>(rec + r0), 4 * (r1 - r0));
  const int lane = threadIdx.x % 32;
  const int g = lane % kProbeLanes, grp = lane / kProbeLanes;
  for (long long i = r0; i < r1;) {
    const RowPass p = row_pass(rec, i, r1, shift, window_keys, NB);
    stage_words(srow, table + p.row0 * lanes,
                static_cast<long long>(p.rows) * lanes);
    stage_wait();
    // A warp takes 32 consecutive records a step: group grp probes records
    // grp + kGroups k (k < kBatch; the groups' k-th records are adjacent in
    // shared memory), each lane of the group its part of each, and
    // reduce_scatter leaves lane g the sum of record grp + kGroups g, which
    // it writes. The loop's bound is the warp's, so that every lane shuffles.
    for (long long base = i + threadIdx.x / 32 * 32; base < p.end;
         base += kThreads) {
      uint32_t v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const long long r = base + grp + kGroups * k;
        v[k] = 0;
        if (r < p.end) {
          const int4 e = srec[r - r0];
          v[k] = probe_part<kVec>(srow + (e.y - p.row0) * lanes, W,
                                  static_cast<uint32_t>(e.z), g);
        }
      }
      const uint32_t pk = reduce_scatter(v, g);
      const long long mine = base + grp + kGroups * g;
      if (mine < p.end) out[srec[mine - r0].x] = pk;
    }
    __syncthreads();                    // before the next pass's rows land
    i = p.end;
  }
}

template <int kW, bool kVec>
cudaError_t launch(const uint32_t* table, long long NB, int W, int shift,
                   int window_keys, const int4* rec, long long N,
                   uint32_t* out, cudaStream_t s) {
  const long long smem =
      kRun * sizeof(int4) +
      (static_cast<long long>(window_keys) << shift) * 8ll * W;
  cudaError_t err = allow_smem(rowprobe_smem_kernel<kW, kVec>, smem);
  if (err != cudaSuccess) return err;
  rowprobe_smem_kernel<kW, kVec><<<blocks_for(N, kRun), kThreads, smem, s>>>(
      table, NB, W, shift, window_keys, rec, N, out);
  return cudaGetLastError();
}

}  // namespace

// table int32 [NB, 2W] (uint32 bit patterns); shift and window_keys: the
// routing pass's key shift and the keys a block stages at once
// (kernels/rowprobe.py rowprobe_plan); records int32 [N, 4], the routing
// pass's (query index, row, rem, 1) in ascending row >> shift; out int32
// [N], written at each record's query index.
extern "C" int pangea_rowprobe_smem(const void* table, long long NB, int W,
                                    int shift, int window_keys,
                                    const void* records, long long N,
                                    void* out, void* stream) {
  if (NB < 1 || NB > INT_MAX || W < 1 || shift < 5 || shift > 30 ||
      window_keys < 1 || N < 0 ||
      reinterpret_cast<uintptr_t>(records) & 15) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (N == 0) return 0;
  const auto t = static_cast<const uint32_t*>(table);
  const auto rec = static_cast<const int4*>(records);
  const auto o = static_cast<uint32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto go = W == 64  ? launch<64, true>
                 : W == 32  ? launch<32, true>
                 : W % 4 == 0 ? launch<0, true>
                              : launch<0, false>;
  return static_cast<int>(go(t, NB, W, shift, window_keys, rec, N, o, s));
}
