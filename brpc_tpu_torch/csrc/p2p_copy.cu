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
// 2 * n / 3.35 TB/s.  At 4 KiB the launch cost dominates.
//
// Design.  The VMEM staging and the symmetric two-way post exist for the
// TPU's DMA engine; on Hopper the copy goes one way, global memory to
// global memory, with no shared-memory staging:
//   * 16-byte vector loads and stores in a grid-stride loop over a grid
//     the launcher sizes to the card's SMs (at most 8 blocks of 256
//     threads per SM, the full 2048 resident threads).  The main loop
//     issues kUnroll independent loads before their stores, so each
//     thread keeps several 16-byte reads in flight on large copies.
//   * IOBuf slices reach the kernel at any offset and length (65,537
//     bytes, say).  A head of bytes up to dst's 16-byte boundary and a
//     tail past the last whole 16-byte chunk are copied byte by byte.
//   * dst comes 16-byte aligned from the caching allocator, but src may
//     not share its phase.  Then each chunk is assembled from the two
//     aligned 16-byte words of src that cover it with funnel shifts; the
//     phase is a template argument, so the word selection is resolved at
//     compile time and stays in registers.  Both words hold at least one
//     byte of the chunk, so no read leaves the 16-byte-aligned blocks
//     that the source range touches.
//   * The kernel allocates nothing and does not synchronize; the caller's
//     stream orders it and the caller's event observes its completion.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <int PHASE>
__device__ __forceinline__ uint4 load_chunk(const uint4* __restrict__ a4,
                                            size_t c) {
  if constexpr (PHASE == 0) {
    return a4[c];
  } else {
    const uint4 w0 = a4[c];
    const uint4 w1 = a4[c + 1];
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
// boundary.
template <int PHASE>
__global__ void __launch_bounds__(kThreads)
p2p_copy_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                size_t n, size_t head, size_t chunks) {
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = tid; i < head; i += stride) dst[i] = src[i];
  const uint4* a4 = reinterpret_cast<const uint4*>(src + head - PHASE);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  size_t c = tid;
  for (; c + (kUnroll - 1) * stride < chunks; c += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = load_chunk<PHASE>(a4, c + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) d4[c + u * stride] = v[u];
  }
  for (; c < chunks; c += stride) d4[c] = load_chunk<PHASE>(a4, c);
  for (size_t i = head + chunks * 16 + tid; i < n; i += stride) dst[i] = src[i];
}

template <int PHASE>
void launch(const uint8_t* src, uint8_t* dst, size_t n, size_t head,
            size_t chunks, int blocks, cudaStream_t stream) {
  p2p_copy_kernel<PHASE><<<blocks, kThreads, 0, stream>>>(src, dst, n, head,
                                                          chunks);
}

}  // namespace

// Launch the copy on `stream`; returns cudaGetLastError() after the launch
// (0 = launched).  The grid covers the work with at most `max_blocks`
// blocks (the caller passes 8 per SM).
extern "C" int p2p_copy_launch(const void* src_v, void* dst_v,
                               unsigned long long n, int max_blocks,
                               void* stream_v) {
  if (n == 0) return 0;
  const uint8_t* src = static_cast<const uint8_t*>(src_v);
  uint8_t* dst = static_cast<uint8_t*>(dst_v);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  size_t head = (16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15;
  if (head > n) head = n;
  const size_t chunks = (n - head) / 16;
  const int phase = static_cast<int>(reinterpret_cast<uintptr_t>(src + head) & 15);
  const size_t cap = max_blocks > 0 ? static_cast<size_t>(max_blocks) : 1;
  const size_t want = (chunks + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
  switch (phase) {
#define P2P_CASE(P) \
    case P: launch<P>(src, dst, n, head, chunks, blocks, stream); break;
    P2P_CASE(0) P2P_CASE(1) P2P_CASE(2) P2P_CASE(3)
    P2P_CASE(4) P2P_CASE(5) P2P_CASE(6) P2P_CASE(7)
    P2P_CASE(8) P2P_CASE(9) P2P_CASE(10) P2P_CASE(11)
    P2P_CASE(12) P2P_CASE(13) P2P_CASE(14) P2P_CASE(15)
#undef P2P_CASE
  }
  return static_cast<int>(cudaGetLastError());
}
