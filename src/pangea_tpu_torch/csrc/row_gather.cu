// K13: the row gather, a ring of row copies in flight.
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
// Design. Block c owns indices [c chunk, (c + 1) chunk) and loads them
// itself (Hopper has no scalar prefetch): a warp reads 32 at once and
// shuffles them to the lane that starts the copies. Rows move by
// cp.async.bulk (the TMA without a tensor map) into a ring of `depth`
// shared-memory slots, each completing on its own mbarrier with expect_tx;
// the slot is reused `depth` rows later.
//   - Staged (the VMEM-output counterpart): one producer warp starts the
//     loads; C consumer warps (C = gcd(depth, 4)) each own the slots
//     s = w (mod C), wait on a slot's full barrier, store the row with
//     coalesced 16-byte stores and arrive on its empty barrier, which the
//     producer waits on before it refills the slot.
//   - Direct (the HBM -> HBM counterpart): Hopper has no global-to-global
//     bulk copy, so the row bounces through its slot without passing
//     through registers: one thread waits on the slot's full barrier and
//     sends the slot out by cp.async.bulk.global.shared::cta; depth / 2 rows
//     later it waits (cp.async.bulk.wait_group.read) until that store has
//     read the slot and refills it.
// The TPU's whole [chunk, D] VMEM output block is not carried over: a row
// leaves shared memory as soon as it arrives.
//
// What bounds it on an H100: bytes. Each row is read once and written
// once, plus 4 B an index: at 2^20 rows of 256 B that is 541 MB, 0.1615 ms
// at 3.35 TB/s. Latency bounds it below that when few copies are in flight:
// the scripts' (depth, chunk) give a block depth rows in flight, and the
// card holds at most 32 blocks an SM.
//
// An index below 0 counts from the end, as in NumPy, and the result is
// clamped into [0, NB - rows], as XLA clamps the reference's gather, so no
// copy leaves the table.
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

struct Ring {
  unsigned char* slots;     // [depth][slot_bytes]
  uint64_t* full;           // [depth]
  uint64_t* empty;          // [depth]
};

__device__ __forceinline__ Ring ring_init(int depth, int slot_bytes) {
  extern __shared__ __align__(128) unsigned char smem[];
  Ring r;
  r.slots = smem;
  r.full = reinterpret_cast<uint64_t*>(
      smem + static_cast<size_t>(depth) * slot_bytes);
  r.empty = r.full + depth;
  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) {
      mbar_init(smem_addr(r.full + s), 1);
      mbar_init(smem_addr(r.empty + s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return r;
}

// Row start of index i (row_in, then at most NB - rows).
__device__ __forceinline__ long long row_of(const int32_t* idx, long long i,
                                            long long NB, long long last) {
  return min(row_in(idx[i], NB), last);
}

// Staged: warp 0 produces, warps 1..C consume.
__global__ void row_gather_staged(const unsigned char* __restrict__ table,
                                  long long NB, int rows, int row_bytes,
                                  const int32_t* __restrict__ idx,
                                  long long n, int depth, int chunk,
                                  unsigned char* __restrict__ out) {
  const int slot_bytes = rows * row_bytes;
  const Ring ring = ring_init(depth, slot_bytes);
  const long long base = blockIdx.x * static_cast<long long>(chunk);
  const int count = static_cast<int>(min(static_cast<long long>(chunk),
                                         n - base));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int consumers = blockDim.x / 32 - 1;
  const long long last = NB - rows;
  if (warp == 0) {
    for (int j0 = 0; j0 < count; j0 += 32) {
      const long long my =
          j0 + lane < count ? row_of(idx, base + j0 + lane, NB, last) : 0;
      const int m = min(32, count - j0);
      for (int u = 0; u < m; ++u) {
        const long long r = __shfl_sync(0xFFFFFFFFu, my, u);
        if (lane == 0) {
          const int j = j0 + u, s = j % depth;
          if (j >= depth) mbar_wait(smem_addr(ring.empty + s),
                                    ((j / depth) + 1) & 1);
          const uint32_t full = smem_addr(ring.full + s);
          mbar_expect_tx(full, slot_bytes);
          bulk_load(smem_addr(ring.slots + static_cast<size_t>(s) *
                              slot_bytes),
                    table + r * row_bytes, slot_bytes, full);
        }
        __syncwarp();
      }
    }
  } else {
    for (int j = warp - 1; j < count; j += consumers) {
      const int s = j % depth;
      mbar_wait(smem_addr(ring.full + s), (j / depth) & 1);
      const int4* src4 = reinterpret_cast<const int4*>(
          ring.slots + static_cast<size_t>(s) * slot_bytes);
      int4* dst4 = reinterpret_cast<int4*>(
          out + (base + j) * static_cast<long long>(slot_bytes));
      for (int v = lane; v < slot_bytes / 16; v += 32) dst4[v] = src4[v];
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(ring.empty + s));
    }
  }
}

// Direct: one thread bounces each row through its slot.
__global__ void row_gather_direct(const unsigned char* __restrict__ table,
                                  long long NB, int rows, int row_bytes,
                                  const int32_t* __restrict__ idx,
                                  long long n, int depth, int chunk,
                                  unsigned char* __restrict__ out) {
  const int slot_bytes = rows * row_bytes;
  const Ring ring = ring_init(depth, slot_bytes);
  const long long base = blockIdx.x * static_cast<long long>(chunk);
  const int count = static_cast<int>(min(static_cast<long long>(chunk),
                                         n - base));
  const int lane = threadIdx.x % 32;
  const long long last = NB - rows;
  const int lag = depth / 2;     // stores left in flight when a slot refills
  auto slot = [&](int j) {
    return smem_addr(ring.slots + static_cast<size_t>(j % depth) *
                     slot_bytes);
  };
  auto load = [&](int j, long long r) {
    const uint32_t full = smem_addr(ring.full + j % depth);
    mbar_expect_tx(full, slot_bytes);
    bulk_load(slot(j), table + r * row_bytes, slot_bytes, full);
  };
  // The rows, 32 at a time, each lane holding one; lane 0 works.
  long long held = 0;
  int held_at = -64;
  auto row = [&](int j) {
    if ((j & ~31) != held_at) {
      held_at = j & ~31;
      held = held_at + lane < count
                 ? row_of(idx, base + held_at + lane, NB, last) : 0;
    }
    return __shfl_sync(0xFFFFFFFFu, held, j & 31);
  };
  // Every lane runs the loops (for the shuffles); lane 0 starts copies.
  for (int j = 0; j < min(depth, count); ++j) {
    const long long r = row(j);
    if (lane == 0) load(j, r);
  }
  for (int j = 0; j < count; ++j) {
    const int refill = j - lag;           // its slot now takes row + depth
    const bool more = refill >= 0 && refill + depth < count;
    const long long r = more ? row(refill + depth) : 0;
    if (lane == 0) {
      mbar_wait(smem_addr(ring.full + j % depth), (j / depth) & 1);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bulk_store(out + (base + j) * static_cast<long long>(slot_bytes),
                 slot(j), slot_bytes);
      if (more) {
        bulk_wait_read(lag);              // the store of row `refill` read
        load(refill + depth, r);
      }
    }
    __syncwarp();
  }
  if (lane == 0) {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

int gcd_int(int a, int b) { return b == 0 ? a : gcd_int(b, a % b); }

}  // namespace

// table [NB, row_bytes] bytes of any dtype (row_bytes a multiple of 16;
// the table and out 16-byte aligned), idx int32 [n]; copies rows rows from
// each index into out [n * rows, row_bytes]. depth: copies in flight a
// block; chunk: indices a block; direct: 0 staged, 1 direct.
extern "C" int pangea_row_gather(const void* table, long long NB,
                                 int row_bytes, int rows, const void* idx,
                                 long long n, int depth, int chunk,
                                 int direct, void* out, void* stream) {
  if (NB < rows || rows < 1 || row_bytes < 16 || row_bytes % 16 ||
      depth < 1 || chunk < 1 ||
      (reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out)) &
          15) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  const long long slot_bytes = static_cast<long long>(rows) * row_bytes;
  const long long smem = depth * slot_bytes + 16ll * depth;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // One bulk copy completes at most 2^20 - 1 bytes on its barrier.
  if (smem > optin || slot_bytes >= (1 << 20)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = direct ? row_gather_direct : row_gather_staged;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = direct ? 32 : 32 * (1 + gcd_int(depth, 4));
  kernel<<<blocks_for(n, chunk), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(table), NB, rows, row_bytes,
      static_cast<const int32_t*>(idx), n, depth, chunk,
      static_cast<unsigned char*>(out));
  return static_cast<int>(cudaGetLastError());
}
