// Candidate shapes of the p2p_copy kernel (brpc_tpu_torch/csrc/p2p_copy.cu)
// that lost to it on an H100.  Not part of the package: sweeps/
// sweep_p2p_copy.py builds this file in several variants and times each
// shape against the package's kernel and Tensor.copy_, in turns.
//
// Aligned copies only (n a multiple of 16, src and dst 16-byte aligned):
// the shapes differ in how the body of a copy is spread over the card, and
// the package's kernel handles the edges and the source phase.
//
// Shapes (candidate_launch's `shape`):
//   0 wave    one 16-byte chunk per thread, a block per kThreads chunks:
//             the package kernel's shape, here for its cache flavours
//   1 stream  a block per kThreads * kUnroll chunks, kUnroll loads in
//             flight per thread
//   2 span    a persistent grid of kSpanBlocksPerSm blocks per SM, each
//             copying one contiguous span in passes of kUnroll loads per
//             thread
//   3 bulk    a TMA pipeline: a persistent grid of one 32-thread block per
//             SM; one thread streams units of kBulkUnit chunks (0: one
//             contiguous span per block) through a ring of kBulkStages
//             shared-memory stages of kBulkStageBytes: cp.async.bulk loads
//             complete on one mbarrier per stage, cp.async.bulk stores
//             drain each stage in bulk groups, and a stage is refilled once
//             the store that read it has finished reading (wait_group.read)
//
// Variants (-D at build time): P2P_THREADS, P2P_UNROLL, P2P_LD (0
// ld.global, 1 ld.global.nc.L1::no_allocate), P2P_ST_CS (1: st.global.cs),
// P2P_SPAN_BLOCKS_PER_SM, P2P_BULK_STAGES, P2P_BULK_STAGE_BYTES,
// P2P_BULK_UNIT, P2P_BULK_HINT (1: an L2 evict-first policy on the bulk
// copies).
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#ifndef P2P_THREADS
#define P2P_THREADS 256
#endif
#ifndef P2P_UNROLL
#define P2P_UNROLL 4
#endif
#ifndef P2P_LD
#define P2P_LD 0
#endif
#ifndef P2P_ST_CS
#define P2P_ST_CS 0
#endif
#ifndef P2P_SPAN_BLOCKS_PER_SM
#define P2P_SPAN_BLOCKS_PER_SM 2
#endif
#ifndef P2P_BULK_STAGES
#define P2P_BULK_STAGES 6
#endif
#ifndef P2P_BULK_STAGE_BYTES
#define P2P_BULK_STAGE_BYTES (32 * 1024)
#endif
#ifndef P2P_BULK_UNIT
#define P2P_BULK_UNIT 8192
#endif
#ifndef P2P_BULK_HINT
#define P2P_BULK_HINT 1
#endif

namespace {

enum Shape : int { kWave = 0, kStream = 1, kSpan = 2, kBulk = 3 };

constexpr int kThreads = P2P_THREADS;
constexpr int kUnroll = P2P_UNROLL;
constexpr size_t kTile = (size_t)kThreads * kUnroll;
constexpr int kBulkThreads = 32;
constexpr int kBulkStages = P2P_BULK_STAGES;
constexpr uint32_t kBulkStageBytes = P2P_BULK_STAGE_BYTES;
constexpr size_t kBulkUnit = P2P_BULK_UNIT;
constexpr int kBulkSmem = kBulkStages * (int)kBulkStageBytes
                        + kBulkStages * (int)sizeof(uint64_t);

__device__ __forceinline__ uint4 ld_chunk(const uint4* p) {
  uint4 v;
#if P2P_LD == 1
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
#else
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
#endif
  return v;
}

__device__ __forceinline__ void st_chunk(uint4* p, const uint4& v) {
#if P2P_ST_CS
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
#else
  asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
#endif
}

__global__ void __launch_bounds__(kThreads)
wave_kernel(const uint4* __restrict__ s, uint4* __restrict__ d,
            size_t chunks) {
  const size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (i < chunks) st_chunk(d + i, ld_chunk(s + i));
}

// One pass: this thread's kUnroll chunks of [base, end), every load issued
// before the first store.
__device__ __forceinline__ void copy_tile(const uint4* __restrict__ s,
                                          uint4* __restrict__ d,
                                          size_t base, size_t end) {
  const size_t c = base + threadIdx.x;
  uint4 v[kUnroll];
  if (c + (size_t)(kUnroll - 1) * kThreads < end) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = ld_chunk(s + c + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) st_chunk(d + c + u * kThreads, v[u]);
  } else {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (c + u * kThreads < end) v[u] = ld_chunk(s + c + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (c + u * kThreads < end) st_chunk(d + c + u * kThreads, v[u]);
  }
}

__global__ void __launch_bounds__(kThreads)
stream_kernel(const uint4* __restrict__ s, uint4* __restrict__ d,
              size_t chunks) {
  const size_t base = (size_t)blockIdx.x * kTile;
  copy_tile(s, d, base, base + kTile < chunks ? base + kTile : chunks);
}

__global__ void __launch_bounds__(kThreads)
span_kernel(const uint4* __restrict__ s, uint4* __restrict__ d,
            size_t chunks, size_t span) {
  const size_t begin = (size_t)blockIdx.x * span;
  const size_t end = begin + span < chunks ? begin + span : chunks;
  for (size_t base = begin; base < end; base += kTile)
    copy_tile(s, d, base, end);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Wait for the phase of `bar` with this parity to complete.  A wait that
// outlasts kWaitCycles (seconds: a pipeline fault, never a slow copy)
// traps, so the launch fails instead of hanging the card.
constexpr long long kWaitCycles = 1ll << 34;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitCycles) __trap();
  }
}

// The chunks fall into units of `span`; block b copies units b,
// b + gridDim.x, ... as one sequence of tiles of at most kBulkStageBytes
// through the ring.
__global__ void __launch_bounds__(kBulkThreads)
bulk_kernel(const uint8_t* __restrict__ s, uint8_t* __restrict__ d,
            size_t chunks, size_t span) {
  extern __shared__ __align__(128) uint8_t smem[];
  const size_t units = (chunks + span - 1) / span;
  if (threadIdx.x != 0 || blockIdx.x >= units) return;
  const size_t grid = gridDim.x;
  const size_t unit_bytes = span * 16;
  const size_t per_unit = (unit_bytes + kBulkStageBytes - 1) / kBulkStageBytes;
  const size_t mine = (units - blockIdx.x + grid - 1) / grid;
  const size_t last = blockIdx.x + (mine - 1) * grid;
  const size_t last_bytes = chunks * 16 - last * unit_bytes < unit_bytes
                          ? chunks * 16 - last * unit_bytes : unit_bytes;
  const size_t tiles = (mine - 1) * per_unit
                     + (last_bytes + kBulkStageBytes - 1) / kBulkStageBytes;
  // tile t of this block: byte offset into the copy, and its size
  auto tile_at = [&](size_t t) -> size_t {
    return (blockIdx.x + (t / per_unit) * grid) * unit_bytes
         + (t % per_unit) * kBulkStageBytes;
  };
  auto tile_bytes = [&](size_t t) -> uint32_t {
    const size_t at = tile_at(t);
    const size_t unit_end = at - (t % per_unit) * kBulkStageBytes + unit_bytes;
    const size_t end = unit_end < chunks * 16 ? unit_end : chunks * 16;
    return end - at < kBulkStageBytes ? (uint32_t)(end - at) : kBulkStageBytes;
  };
  const uint32_t stage0 = smem_u32(smem);
  const uint32_t bar0 = stage0 + kBulkStages * kBulkStageBytes;
  for (int i = 0; i < kBulkStages; ++i)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                 :: "r"(bar0 + 8 * i) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
#if P2P_BULK_HINT
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
#endif

  auto load = [&](size_t t) {
    const uint32_t stage = (uint32_t)(t % kBulkStages);
    const uint32_t bar = bar0 + 8 * stage;
    const uint32_t size = tile_bytes(t);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(size) : "memory");
#if P2P_BULK_HINT
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".L2::cache_hint [%0], [%1], %2, [%3], %4;"
        :: "r"(stage0 + stage * kBulkStageBytes), "l"(s + tile_at(t)),
           "r"(size), "r"(bar), "l"(policy)
        : "memory");
#else
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(stage0 + stage * kBulkStageBytes), "l"(s + tile_at(t)),
           "r"(size), "r"(bar)
        : "memory");
#endif
  };

  const size_t ahead = tiles < kBulkStages - 1 ? tiles : kBulkStages - 1;
  for (size_t t = 0; t < ahead; ++t) load(t);
  for (size_t t = 0; t < tiles; ++t) {
    const uint32_t stage = (uint32_t)(t % kBulkStages);
    mbar_wait(bar0 + 8 * stage, (uint32_t)(t / kBulkStages) & 1);
#if P2P_BULK_HINT
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
        " [%0], [%1], %2, %3;"
        :: "l"(d + tile_at(t)), "r"(stage0 + stage * kBulkStageBytes),
           "r"(tile_bytes(t)), "l"(policy)
        : "memory");
#else
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
        :: "l"(d + tile_at(t)), "r"(stage0 + stage * kBulkStageBytes),
           "r"(tile_bytes(t))
        : "memory");
#endif
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    // tile t + kBulkStages - 1 refills the stage of tile t - 1, once the
    // store of tile t - 1 has read it (the store of tile t may be pending)
    if (t + kBulkStages - 1 < tiles) {
      asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
      load(t + kBulkStages - 1);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

size_t ceil_div(size_t a, size_t b) { return (a + b - 1) / b; }

}  // namespace

// Grant the bulk kernel its dynamic shared memory on the current device,
// before its first launch there.  Returns the CUDA error code.
extern "C" int candidate_setup(void) {
  return static_cast<int>(cudaFuncSetAttribute(
      bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBulkSmem));
}

// Launch `shape` on `stream` for an aligned copy of n bytes; `sms` is the
// device's SM count.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a copy that is not aligned or an unknown shape.
extern "C" int candidate_launch(const void* src, void* dst,
                                unsigned long long n, int sms, int shape,
                                void* stream_v) {
  if (n == 0) return 0;
  if ((n | reinterpret_cast<uintptr_t>(src)
         | reinterpret_cast<uintptr_t>(dst)) & 15)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  const size_t chunks = n / 16;
  const size_t sm = sms > 0 ? static_cast<size_t>(sms) : 1;
  switch (shape) {
    case kWave:
      wave_kernel<<<(unsigned)ceil_div(chunks, kThreads), kThreads, 0,
                    stream>>>(s, d, chunks);
      break;
    case kStream:
      stream_kernel<<<(unsigned)ceil_div(chunks, kTile), kThreads, 0,
                      stream>>>(s, d, chunks);
      break;
    case kSpan: {
      const size_t grid = sm * P2P_SPAN_BLOCKS_PER_SM;
      const size_t span = ceil_div(ceil_div(chunks, grid), kTile) * kTile;
      span_kernel<<<(unsigned)ceil_div(chunks, span), kThreads, 0, stream>>>(
          s, d, chunks, span);
      break;
    }
    case kBulk: {
      // units of kBulkUnit chunks; 0: one span a block, of whole 128-byte
      // lines
      const size_t even = (ceil_div(chunks, sm) + 7) & ~size_t(7);
      const size_t span = kBulkUnit ? kBulkUnit : (even > 8 ? even : 8);
      size_t blocks = ceil_div(chunks, span);
      if (blocks > sm) blocks = sm;
      bulk_kernel<<<(unsigned)blocks, kBulkThreads, kBulkSmem, stream>>>(
          static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
          chunks, span);
      break;
    }
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
