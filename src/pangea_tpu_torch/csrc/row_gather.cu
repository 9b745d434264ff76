// K13: the row gather, a persistent grid of warps whose every lane starts
// its own row copies.
//
// Replaces the Pallas kernels
//   experiments/mb_gather2.py:119  pallas_gather (kernel gather_kernel :93)
//   experiments/mb_gather3.py:93   make_pallas_gather (call :131)
//   experiments/mb_gather4.py:86, :106  kernel / kernel2 (calls :92, :121)
//   experiments/mb_gather5.py:36, :88   variant_hbm2hbm, variant_vmem_out
// all of which compute out[i] = table[idx[i]] with per-row DMAs: a grid
// step takes `chunk` indices (scalar-prefetched or an SMEM block) and keeps
// `depth` row DMAs in flight behind `depth` semaphores, into VMEM scratch,
// straight into the VMEM output block, or HBM to HBM. mb_gather4's probes
// copy one block of 8 rows from a start read from memory: here that is one
// index and rows = 8. A copy moves rows * row_bytes contiguous bytes from
// row idx[i], any dtype whose row is a multiple of 16 B.
//
// What bounds it on an H100: bytes. Each row is read once and written
// once, plus 4 B an index: 2 n rows row_bytes + 4 n bytes over 3.35 TB/s,
// at 2^20 rows of 256 B 541 MB, 0.1615 ms.
//
// What held the first design back: one lane a block started every copy,
// in series (a shuffle, a barrier wait, an expect_tx and a bulk copy a
// row), and the grid was n / chunk blocks, 64-256 at the experiments'
// chunks of 4,096 and 8,192 on 132 SMs. Its time followed the blocks, not
// the depth (chip_smoke.py phase 30 on an NVIDIA H100 80GB HBM3 at
// 700.00 W: 0.96-2.74 ms against bounds of 0.08-0.16 ms, 1.6-8.6 times
// torch.index_select). Little's law says what the card needs: 3.35 TB/s
// times about 0.7 us of latency is about 2.3 MB, some 9,000 rows of 256 B,
// in flight; at 6.5 G rows/s, with about 300 ns of serial work a row for
// each lane that issues, some 2,000 lanes issuing at once.
//
// Design. The card sets the grid, not `chunk`: SMs times the blocks an SM
// holds at the plan's shared memory, capped by the work (gather_plan in
// kernels/gather.py, which the launcher checks against the device).
//   - Block b owns a contiguous share of the indices, a whole number of
//     runs, and walks it `chunk` indices at a time (the Pallas grid step's
//     index block); its warps take the runs of `lanes` indices of each
//     chunk in turn. A lane loads its own index (a warp's run is one
//     coalesced load) and starts the bulk copy of its row (cp.async.bulk,
//     completing on its slot's mbarrier with expect_tx) into one of the
//     slots it owns: `slots / lanes` of its warp's ring. There is no
//     shuffle and no single-lane loop. A slot's barrier is used by its lane
//     alone, so its parity is the lane's use count of the slot: run i of
//     the warp takes slot round i % (slots / lanes), use i / (slots /
//     lanes). A lane with no index in a ragged run arrives on its barrier
//     instead, so every barrier completes once a run.
//   - Staged (the VMEM-output counterpart): each lane waits on its own
//     slot, the warp meets at __syncwarp, and the whole warp drains the
//     run, which lies in consecutive slots, to consecutive output rows: a
//     16-byte load and store a lane, coalesced. The warp that drains a
//     slot refills it; the drain's reads are in registers before the
//     second __syncwarp, so the slot needs no empty barrier.
//   - Direct (the HBM -> HBM counterpart): Hopper has no global-to-global
//     bulk copy, so a lane sends its slot out by
//     cp.async.bulk.global.shared::cta, never through registers, and
//     refills the slot of run i - lag after cp.async.bulk.wait_group.read
//     shows its store has read it (bulk groups are per thread; lag is half
//     the lane's slots, rounded down to a power of two by the wait's
//     constant). Only the async proxy writes and reads the slot, so no
//     proxy fence stands between the barrier wait and the store.
// The plan gives an SM 8 warps of 32 issuing lanes, at depths up to 32 256
// slots (64 KB of 256-B rows; 33,792 rows on 132 SMs): the knee of
// kernels/gather_sweep.py on an NVIDIA H100 80GB HBM3 at 700.00 W, where 4
// warps an SM were 19-22 % slower, and 16-26 warps 3-7 % slower staged and
// within 4 % direct. The scripts' (depth, chunk) set only a lane's slots
// and the block's step. Phase 30 of chip_smoke.py on that card: staged
// 0.195-0.202 ms on 2^20 rows and 0.103 ms on 2^19, direct 0.113-0.118 ms
// on 2^19, 69-83 % of the byte bound and 0.31-0.37 times
// torch.index_select.
//
// An index below 0 counts from the end, as in NumPy, and the result is
// clamped into [0, NB - rows], as XLA clamps the reference's gather, so no
// copy leaves the table.
#include <mutex>

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Global -> shared bulk copy completing `bytes` on the barrier.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared -> global bulk copy, committed as its own bulk group.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
      "cp.async.bulk.commit_group;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
}

// An empty bulk group: a lane with no row in a run keeps its count of
// groups in step with the runs.
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most n bulk groups still read shared memory; n rounds down
// to a power of two (the instruction takes a constant), which waits for
// more, never for less.
__device__ __forceinline__ void bulk_wait_read(int n) {
  if (n >= 32) {
    asm volatile("cp.async.bulk.wait_group.read 32;\n" ::: "memory");
  } else if (n >= 16) {
    asm volatile("cp.async.bulk.wait_group.read 16;\n" ::: "memory");
  } else if (n >= 8) {
    asm volatile("cp.async.bulk.wait_group.read 8;\n" ::: "memory");
  } else if (n >= 4) {
    asm volatile("cp.async.bulk.wait_group.read 4;\n" ::: "memory");
  } else if (n >= 2) {
    asm volatile("cp.async.bulk.wait_group.read 2;\n" ::: "memory");
  } else if (n >= 1) {
    asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// Row start of index i (row_in, then at most NB - rows).
__device__ __forceinline__ long long row_of(const int32_t* idx, long long i,
                                            long long NB, long long last) {
  return min(row_in(idx[i], NB), last);
}

// The runs of this block: its share [lo, hi) of the n indices, a whole
// number of runs of `lanes` (the grid splits ceil(n / lanes) runs evenly),
// walked `chunk` indices at a time, each chunk cut into runs of `lanes`.
struct Runs {
  long long lo, hi, chunk, per_chunk, count;
  int lanes;

  __device__ Runs(long long n, long long chunk_, int lanes_)
      : chunk(chunk_), lanes(lanes_) {
    const long long total = (n + lanes - 1) / lanes;
    const long long per_block = (total + gridDim.x - 1) / gridDim.x;
    lo = min(static_cast<long long>(blockIdx.x) * per_block * lanes, n);
    hi = min(lo + per_block * lanes, n);
    per_chunk = (chunk + lanes - 1) / lanes;
    const long long full = (hi - lo) / chunk, rest = (hi - lo) - full * chunk;
    count = full * per_chunk + (rest + lanes - 1) / lanes;
  }

  // First index and length of run t of the share.
  __device__ __forceinline__ void run(long long t, long long& start,
                                      int& len) const {
    const long long c = t / per_chunk;
    start = lo + c * chunk + (t - c * per_chunk) * lanes;
    len = static_cast<int>(min(static_cast<long long>(lanes),
                               min(lo + (c + 1) * chunk, hi) - start));
  }
};

// blockDim.x / 32 warps, each with `slots` ring slots of rows * row_bytes
// bytes owned by its first `lanes` lanes, slots / lanes a lane.
template <bool kDirect>
__global__ void row_gather_kernel(const unsigned char* __restrict__ table,
                                  long long NB, int rows, int row_bytes,
                                  const int32_t* __restrict__ idx,
                                  long long n, long long chunk, int lanes,
                                  int slots,
                                  unsigned char* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const long long slot_bytes = static_cast<long long>(rows) * row_bytes;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32, per_lane = slots / lanes;
  unsigned char* const ring =
      smem + static_cast<size_t>(warp) * slots * slot_bytes;
  uint64_t* const full = reinterpret_cast<uint64_t*>(
      smem + static_cast<size_t>(warps) * slots * slot_bytes) +
      warp * slots;
  const bool issuer = lane < lanes;
  if (issuer) {
    for (int u = 0; u < per_lane; ++u) {
      mbar_init(smem_addr(full + u * lanes + lane), 1);
    }
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  const Runs runs(n, chunk, lanes);
  const long long mine =
      runs.count > warp ? (runs.count - warp + warps - 1) / warps : 0;
  const long long last = NB - rows;
  // This lane's slot for the warp's run i, and its address.
  auto slot = [&](long long i) {
    return static_cast<int>(i % per_lane) * lanes + lane;
  };
  auto slot_addr = [&](int s) {
    return smem_addr(ring + static_cast<size_t>(s) * slot_bytes);
  };
  // Start this lane's copy of the warp's run i (issuing lanes only).
  auto issue = [&](long long i) {
    long long start;
    int len;
    runs.run(warp + i * warps, start, len);
    const int s = slot(i);
    const uint32_t bar = smem_addr(full + s);
    if (lane < len) {
      const long long r = row_of(idx, start + lane, NB, last);
      mbar_expect_tx(bar, static_cast<uint32_t>(slot_bytes));
      bulk_load(slot_addr(s), table + r * row_bytes,
                static_cast<uint32_t>(slot_bytes), bar);
    } else {
      mbar_arrive(bar);                   // no row: the phase completes
    }
  };
  const long long ahead = min(static_cast<long long>(per_lane), mine);

  if constexpr (kDirect) {
    if (!issuer) return;
    const int lag = per_lane / 2;         // stores left in flight at a refill
    for (long long i = 0; i < ahead; ++i) issue(i);
    for (long long i = 0; i < mine; ++i) {
      long long start;
      int len;
      runs.run(warp + i * warps, start, len);
      const int s = slot(i);
      mbar_wait(smem_addr(full + s), static_cast<uint32_t>(i / per_lane) & 1);
      if (lane < len) {
        bulk_store(out + (start + lane) * slot_bytes, slot_addr(s),
                   static_cast<uint32_t>(slot_bytes));
      } else {
        bulk_commit();
      }
      const long long refill = i - lag;   // its slot now takes run + per_lane
      if (refill >= 0 && refill + per_lane < mine) {
        bulk_wait_read(lag);              // the store of run `refill` read
        issue(refill + per_lane);
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    return;
  }

  if (issuer) {
    for (long long i = 0; i < ahead; ++i) issue(i);
  }
  const int vecs_per_slot = static_cast<int>(slot_bytes / 16);
  for (long long i = 0; i < mine; ++i) {
    long long start;
    int len;
    runs.run(warp + i * warps, start, len);
    if (issuer) {
      mbar_wait(smem_addr(full + slot(i)),
                static_cast<uint32_t>(i / per_lane) & 1);
    }
    __syncwarp();
    // The run's rows lie in slots (i % per_lane) * lanes + [0, len).
    const int4* src = reinterpret_cast<const int4*>(
        ring + static_cast<size_t>(i % per_lane) * lanes * slot_bytes);
    int4* dst = reinterpret_cast<int4*>(out + start * slot_bytes);
    const int vecs = len * vecs_per_slot;
    for (int v = lane; v < vecs; v += 32) dst[v] = src[v];
    __syncwarp();
    if (issuer && i + per_lane < mine) issue(i + per_lane);
  }
}

// The device's opt-in shared memory a block, read once a device, and the
// dynamic shared memory each form may already use there.
constexpr int kDevices = 64;
std::mutex g_lock;
int g_optin[kDevices];
int g_allowed[2][kDevices];

// Let `kernel` (form 0 staged, 1 direct) use smem bytes on the current
// device; cudaErrorInvalidValue past the device's opt-in limit.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int form, long long smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> hold(g_lock);
  if (g_optin[dev] == 0) {
    err = cudaDeviceGetAttribute(&g_optin[dev],
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  if (smem > g_optin[dev]) return cudaErrorInvalidValue;
  if (smem > g_allowed[form][dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    g_allowed[form][dev] = static_cast<int>(smem);
  }
  return cudaSuccess;
}

}  // namespace

// table [NB, row_bytes] bytes of any dtype (row_bytes a multiple of 16;
// the table and out 16-byte aligned), idx int32 [n]; copies rows rows from
// each index into out [n * rows, row_bytes]. chunk: indices a block takes
// at a step; direct: 0 staged, 1 direct. The plan (gather_plan of
// kernels/gather.py): grid blocks of `warps` warps, each with `slots` ring
// slots owned by its first `lanes` lanes (slots a multiple of lanes).
extern "C" int pangea_row_gather(const void* table, long long NB,
                                 int row_bytes, int rows, const void* idx,
                                 long long n, int chunk, int direct,
                                 int grid, int warps, int lanes, int slots,
                                 void* out, void* stream) {
  if (NB < rows || rows < 1 || row_bytes < 16 || row_bytes % 16 ||
      chunk < 1 ||
      (reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out)) &
          15) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const long long slot_bytes = static_cast<long long>(rows) * row_bytes;
  // One bulk copy completes at most 2^20 - 1 bytes on its barrier.
  if (slot_bytes >= (1 << 20) || grid < 1 || warps < 1 || warps > 32 ||
      lanes < 1 || lanes > 32 || slots < lanes || slots % lanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long smem = static_cast<long long>(warps) * slots *
                         (slot_bytes + sizeof(uint64_t));
  const auto kernel =
      direct ? &row_gather_kernel<true> : &row_gather_kernel<false>;
  cudaError_t err = allow_smem(kernel, direct ? 1 : 0, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(table), NB, rows, row_bytes,
      static_cast<const int32_t*>(idx), n, chunk, lanes, slots,
      static_cast<unsigned char*>(out));
  return static_cast<int>(cudaGetLastError());
}
