// p2p_copy: the device plane's one-hop copy, dst[0:n] = src[0:n] on uint8.
//
// Replaces the TPU kernel DevicePlane._pallas_body.kern
// (brpc_tpu/ici/device_plane.py:395-444, pl.pallas_call at :428): one
// remote-DMA hop of a uint8 row between the two members of a (src, dst)
// submesh, staged through a (2, nbytes) VMEM comm buffer, both members
// posting toward each other and DMA semaphores serving as the CQ.
//
// Bound: bytes.  The copy reads n bytes and writes n bytes and does no
// arithmetic, so on one H100 SXM it can take no less than
// 2 * n / 3.35 TB/s.  At 4 KiB the launch cost dominates; at 4 MiB one
// round trip to HBM and the launch's ramp; from tens of MiB up, how well
// the reads and writes of all SMs together keep HBM busy.
//
// Design.  The VMEM staging and the symmetric two-way post exist for the
// TPU's DMA engine; on Hopper the copy goes one way, global memory to
// global memory, through registers, in the simplest shape that measured
// fastest (H100 80GB HBM3, 700 W; chip_smoke.py phase 2, and the
// candidates of sweeps/p2p_copy_candidates.cu):
//   * One 16-byte chunk per thread, a 256-thread block per 4 KiB unit, and
//     a block for every unit: 4 KiB is one block, 64 KiB 16, 256 MiB
//     65,536.  The block scheduler hands units out in address order as
//     blocks retire, so the card streams through one narrow window of the
//     buffer, and its resident blocks (8 per SM) keep ~4 MiB in flight,
//     about what HBM's latency times its rate asks for.
//   * What lost (sweeps/sweep_p2p_copy.py, one call, each candidate in
//     turns with copy_; "single" = one launch at a time with the L2
//     flushed, "b2b" = launches back to back over buffers past the L2):
//     - the TMA pipeline (one block per SM streaming 128 KiB units through
//       6 shared-memory stages of 32 KiB, cp.async.bulk in on an mbarrier
//       per stage, cp.async.bulk out in bulk groups): 192.00 us at 256 MiB
//       single against this kernel's 181.28 (5.9 % behind), 185.69
//       against 179.21 b2b (3.6 %), 9.86 against 8.74 us at 4 MiB; one
//       contiguous span per block instead of 128 KiB units, 195.23 us;
//     - register spans (two blocks per SM, a contiguous span each, 8 loads
//       in flight per thread, ld.global.nc.L1::no_allocate and
//       st.global.cs): 198.72 us single, 191.94 b2b at 256 MiB (9.6 % and
//       7.1 % behind);
//     - a block per 16 KiB unit, 4 chunks per thread: 183.26 us at
//       256 MiB (1.1 % behind), a tie at 4 MiB (8.70 against 8.74).
//     Both the TMA pipeline and the 4-chunk blocks led at 32 MiB single
//     (27.84 and 27.68 against 28.51 us), a size the device plane's
//     transfers (4 KiB-4 MiB) do not reach.
//   * The path to the first load is short: one 64-bit offset per block,
//     32-bit offsets inside the unit, and the rare edge bytes after the
//     stores.
//   * Plain ld.global / st.global.  Against ld.global.nc.L1::no_allocate
//     and st.global.cs (evict-first) they were faster at 256 MiB single
//     (181.54 against 186.14 us, the same shape), slower back to back at
//     4 MiB (5.72 against 5.31 us) and tied at 4 MiB single; they leave
//     the copy's output in L2 for its consumer.
//   * IOBuf slices reach the kernel at any offset and length (65,537
//     bytes, say).  A head of bytes up to dst's 16-byte boundary and a
//     tail past the last whole 16-byte chunk are copied byte by byte by
//     the first and last block.
//   * dst comes 16-byte aligned from the caching allocator, but src may
//     not share its phase.  Then each chunk is assembled from the two
//     aligned 16-byte words of src that cover it with funnel shifts; the
//     phase is a template argument, so the word selection is resolved at
//     compile time and stays in registers.  Both words hold at least one
//     byte of the chunk, so no read leaves the 16-byte-aligned blocks that
//     the source range touches.  These loads go through L1 (__ldg): the
//     neighbouring thread reads the same word.
//   * The kernel allocates nothing and does not synchronize; the caller's
//     stream orders it and the caller's event observes completion.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // one 16-byte chunk a thread: 4 KiB units

// Plain 16-byte loads and stores; asm volatile keeps the load ahead of
// the store.
__device__ __forceinline__ uint4 ld_chunk(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_chunk(uint4* p, const uint4& v) {
  asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

template <int PHASE>
__device__ __forceinline__ uint4 load_chunk(const uint4* __restrict__ a4,
                                            uint32_t c) {
  if constexpr (PHASE == 0) {
    return ld_chunk(a4 + c);
  } else {
    const uint4 w0 = __ldg(a4 + c);
    const uint4 w1 = __ldg(a4 + c + 1);
    const uint32_t a[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    constexpr int q = PHASE / 4;          // first source word of the chunk
    constexpr int r = (PHASE % 4) * 8;    // bit offset inside that word
    uint4 o;
    o.x = __funnelshift_r(a[q + 0], a[q + 1], r);
    o.y = __funnelshift_r(a[q + 1], a[q + 2], r);
    o.z = __funnelshift_r(a[q + 2], a[q + 3], r);
    o.w = __funnelshift_r(a[q + 3], a[q + 4], r);
    return o;
  }
}

// head: bytes before dst reaches a 16-byte boundary; chunks: whole 16-byte
// chunks after the head; src + head lies PHASE bytes past a 16-byte
// boundary.  Block b copies chunks [b * kThreads, (b + 1) * kThreads), one
// a thread.  Block 0 also copies the head bytes and the last block the
// tail bytes (both fewer than 16), after their chunk.
template <int PHASE>
__global__ void __launch_bounds__(kThreads)
copy_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
            size_t n, size_t head, size_t chunks) {
  const size_t begin = (size_t)blockIdx.x * kThreads;
  const uint4* a4 = reinterpret_cast<const uint4*>(src + head - PHASE) + begin;
  uint4* d4 = reinterpret_cast<uint4*>(dst + head) + begin;
  const uint32_t c = threadIdx.x;
  if (begin + c < chunks) st_chunk(d4 + c, load_chunk<PHASE>(a4, c));
  if (blockIdx.x == 0 && c < head) dst[c] = src[c];
  const size_t tail = head + chunks * 16 + c;
  if (blockIdx.x == gridDim.x - 1 && tail < n) dst[tail] = src[tail];
}

template <int PHASE>
void launch_copy(const uint8_t* src, uint8_t* dst, size_t n, size_t head,
                 size_t chunks, cudaStream_t stream) {
  const size_t blocks = chunks ? (chunks + kThreads - 1) / kThreads : 1;
  copy_kernel<PHASE><<<(unsigned)blocks, kThreads, 0, stream>>>(
      src, dst, n, head, chunks);
}

}  // namespace

// Launch the copy on `stream`; returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int p2p_copy_launch(const void* src_v, void* dst_v,
                               unsigned long long n, void* stream_v) {
  if (n == 0) return 0;
  const uint8_t* src = static_cast<const uint8_t*>(src_v);
  uint8_t* dst = static_cast<uint8_t*>(dst_v);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  size_t head = (16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15;
  if (head > n) head = n;
  const size_t chunks = (n - head) / 16;
  const int phase = static_cast<int>(reinterpret_cast<uintptr_t>(src + head) & 15);
  switch (phase) {
#define P2P_CASE(P) \
    case P: launch_copy<P>(src, dst, n, head, chunks, stream); break;
    P2P_CASE(0) P2P_CASE(1) P2P_CASE(2) P2P_CASE(3)
    P2P_CASE(4) P2P_CASE(5) P2P_CASE(6) P2P_CASE(7)
    P2P_CASE(8) P2P_CASE(9) P2P_CASE(10) P2P_CASE(11)
    P2P_CASE(12) P2P_CASE(13) P2P_CASE(14) P2P_CASE(15)
#undef P2P_CASE
  }
  return static_cast<int>(cudaGetLastError());
}
