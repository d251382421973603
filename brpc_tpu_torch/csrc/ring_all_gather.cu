// ring_all_gather: every rank ends with every rank's chunk, in rank order.
//
// Replaces the TPU kernel _build_all_gather.kernel
// (brpc_tpu/ici/pallas_ring.py:50-73, inside _build_all_gather at :39-93,
// pl.pallas_call at :76).  There each device writes its chunk at row my_id
// of its (n, *chunk) output, then forwards chunks n-1 hops around the ring
// through a double-buffered VMEM comm slot, storing the chunk that arrives
// at step s at row (my_id - s - 1) mod n.  Rank d ends with out[d][r] =
// x[r] for every r.  It is a pure data move: any dtype, exact.
//
// Bound: bytes.  The function reads the n input chunks once (n*C bytes for
// C bytes per rank) and writes n output rows of n*C bytes (n*n*C), so on
// one H100 SXM it takes no less than (n+1)*n*C / 3.35 TB/s: 180.3 us at
// n = 8 and 8 MiB per rank (64 MiB in, 512 MiB out), 2,885 us at 128 MiB
// per rank (1 GiB in, 8 GiB out).
//
// Design.  On one card the ranks share HBM, so there are no hops to make:
// one launch reads each rank's chunk once and writes it into row r of every
// rank's output.
//   * Pointer tables: the n input and n output pointers go by value in a
//     __grid_constant__ kernel-parameter struct (2 x 128 pointers, 2 KiB of
//     the 4 KiB limit).
//   * Byte-generic: the kernel moves units of 16, 8, 4, 2 or 1 bytes -- the
//     widest that divides the chunk's byte length and every pointer -- so a
//     ragged chunk length or a row that is not 16-byte aligned takes
//     narrower units instead of a second code path.  An aligned chunk whose
//     length is a multiple of 16 bytes moves as 16-byte vectors.
//   * blockIdx.y is the source rank r; a grid-stride loop over the chunk's
//     units loads each unit once and stores it n times, at offset r*C of
//     every rank's output.
//   * The kernel allocates nothing and does not synchronize.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRanks = 128;

struct Tables {
  const void* in[kMaxRanks];
  void* out[kMaxRanks];
};

template <typename U>
__global__ void __launch_bounds__(kThreads)
gather(const __grid_constant__ Tables t, int n, size_t units) {
  const int r = blockIdx.y;
  const U* __restrict__ src = static_cast<const U*>(t.in[r]);
  const size_t base = static_cast<size_t>(r) * units;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t k = tid; k < units; k += stride) {
    const U v = src[k];
    for (int d = 0; d < n; ++d) static_cast<U*>(t.out[d])[base + k] = v;
  }
}

template <typename U>
void launch(const Tables& t, int n, size_t units, int max_blocks,
            cudaStream_t stream) {
  const size_t cap = max_blocks / n > 0 ? max_blocks / n : 1;
  const size_t want = (units + kThreads - 1) / kThreads;
  const size_t x = want < 1 ? 1 : (want < cap ? want : cap);
  const dim3 grid(static_cast<unsigned>(x), static_cast<unsigned>(n));
  gather<U><<<grid, kThreads, 0, stream>>>(t, n, units);
}

}  // namespace

// Launch the gather of n chunks of `chunk_bytes` bytes, in[0..n-1], into the
// n outputs out[0..n-1] of n*chunk_bytes bytes each, on `stream`; returns
// cudaGetLastError() after the launch (0 = launched).  The grid uses at most
// `max_blocks` blocks.
extern "C" int ring_all_gather_launch(const void* const* in, void* const* out,
                                      int n, unsigned long long chunk_bytes,
                                      int max_blocks, void* stream_v) {
  if (n < 1 || n > kMaxRanks) return static_cast<int>(cudaErrorInvalidValue);
  if (chunk_bytes == 0) return 0;
  Tables t = {};
  uintptr_t phase = static_cast<uintptr_t>(chunk_bytes);
  for (int r = 0; r < n; ++r) {
    t.in[r] = in[r];
    t.out[r] = out[r];
    phase |= reinterpret_cast<uintptr_t>(in[r]) |
             reinterpret_cast<uintptr_t>(out[r]);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  const size_t b = static_cast<size_t>(chunk_bytes);
  if ((phase & 15) == 0) {
    launch<uint4>(t, n, b / 16, max_blocks, stream);
  } else if ((phase & 7) == 0) {
    launch<uint2>(t, n, b / 8, max_blocks, stream);
  } else if ((phase & 3) == 0) {
    launch<uint32_t>(t, n, b / 4, max_blocks, stream);
  } else if ((phase & 1) == 0) {
    launch<uint16_t>(t, n, b / 2, max_blocks, stream);
  } else {
    launch<uint8_t>(t, n, b, max_blocks, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
