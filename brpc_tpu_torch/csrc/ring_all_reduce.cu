// ring_all_reduce: every rank's row becomes the ring fold of all n rows.
//
// Replaces the TPU kernel _build_all_reduce.kernel
// (brpc_tpu/ici/pallas_ring.py:107-132, inside _build_all_reduce at
// :96-153, pl.pallas_call at :135).  There each device starts a carry as
// its local chunk, sends it one hop around the ring per step through a
// double-buffered VMEM comm slot and a remote DMA, and adds its local chunk
// to what arrives, for n-1 steps.
// Rank d ends with the left fold
//     x[d+1] + x[d+2] + ... + x[d+n-1] + x[d]        (indices mod n)
// rounded to the dtype after every add, so the rows differ from rank to
// rank in their last bits.
//
// Bound: bytes.  The function reads the n input rows once and writes the n
// output rows once, 2*n*C bytes for C bytes per rank, so on one H100 SXM it
// takes no less than 2*n*C / 3.35 TB/s: 40.1 us at n = 8 and 8 MiB per
// rank (64 MiB in all), 641 us at 128 MiB per rank (1 GiB in all).  Its
// n*(n-1) adds per element are a few microseconds of arithmetic there.
//
// Design.  On one card the ranks share HBM, so there are no hops to make:
// one launch reads element i of every row once and writes element i of
// every output row.
//   * Pointer tables: the n input and n output row pointers go by value in
//     a __grid_constant__ kernel-parameter struct (2 x 128 pointers, 2 KiB
//     of the 4 KiB limit), so no table is copied to the device per launch.
//   * n <= 16 and every row 16-byte aligned: n is a template argument.
//     Each thread loads one 16-byte vector of every row into registers
//     (n independent loads in flight), computes each output rank's fold in
//     the ring's order -- start from x[(d+1)%n], add x[(d+2)%n], ..., and
//     x[d] last -- and stores n vectors.  The rank indices are compile-time
//     constants, so the values stay in registers.  Elements past the last
//     whole vector (a ragged tail) are folded one per thread the same way.
//   * More than 16 ranks, or a row that is not 16-byte aligned: a generic
//     kernel folds one element per thread and reads each term of the fold
//     from memory; after the first read of a row the rest hit L1/L2, so
//     device memory still sees each byte once.
//   * Rounding: bfloat16 and float16 add in float and round to nearest
//     even after every add, the TPU kernel's per-hop store.  No float sum
//     is carried across hops.  int32 wraps.
//   * The kernel allocates nothing and does not synchronize; the output
//     rows must not overlap the input rows (the wrapper checks).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRanks = 128;
constexpr int kMaxRegisterRanks = 16;

struct Tables {
  const void* in[kMaxRanks];
  void* out[kMaxRanks];
};

// One add of the ring, rounded to the dtype.  S is the storage type.
struct AddF32 {
  using S = float;
  static __device__ __forceinline__ S add(S a, S b) { return __fadd_rn(a, b); }
};
struct AddI32 {
  using S = int32_t;
  static __device__ __forceinline__ S add(S a, S b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) +
                                static_cast<uint32_t>(b));
  }
};
struct AddBF16 {
  using S = uint16_t;
  static __device__ __forceinline__ S add(S a, S b) {
    const float s = __bfloat162float(__ushort_as_bfloat16(a)) +
                    __bfloat162float(__ushort_as_bfloat16(b));
    return __bfloat16_as_ushort(__float2bfloat16_rn(s));
  }
};
struct AddF16 {
  using S = uint16_t;
  static __device__ __forceinline__ S add(S a, S b) {
    const float s = __half2float(__ushort_as_half(a)) +
                    __half2float(__ushort_as_half(b));
    return __half_as_ushort(__float2half_rn(s));
  }
};

template <typename S>
union Vec {
  uint4 u;
  S e[16 / sizeof(S)];
};

// Output rank d's fold over values v[0..N-1] in the ring's order.
template <typename Op, int N>
__device__ __forceinline__ typename Op::S fold(const typename Op::S (&v)[N],
                                               int d) {
  typename Op::S acc = v[(d + 1) % N];
#pragma unroll
  for (int j = 2; j <= N; ++j) acc = Op::add(acc, v[(d + j) % N]);
  return acc;
}

template <typename Op, int N>
__global__ void __launch_bounds__(kThreads)
fold_registers(const __grid_constant__ Tables t, size_t numel) {
  using S = typename Op::S;
  constexpr int V = 16 / sizeof(S);
  const size_t vecs = numel / V;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = tid; i < vecs; i += stride) {
    Vec<S> x[N];
#pragma unroll
    for (int r = 0; r < N; ++r) x[r].u = static_cast<const uint4*>(t.in[r])[i];
#pragma unroll
    for (int d = 0; d < N; ++d) {
      Vec<S> o;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        S v[N];
#pragma unroll
        for (int r = 0; r < N; ++r) v[r] = x[r].e[e];
        o.e[e] = fold<Op, N>(v, d);
      }
      static_cast<uint4*>(t.out[d])[i] = o.u;
    }
  }
  for (size_t i = vecs * V + tid; i < numel; i += stride) {
    S v[N];
#pragma unroll
    for (int r = 0; r < N; ++r) v[r] = static_cast<const S*>(t.in[r])[i];
#pragma unroll
    for (int d = 0; d < N; ++d)
      static_cast<S*>(t.out[d])[i] = fold<Op, N>(v, d);
  }
}

template <typename Op>
__global__ void __launch_bounds__(kThreads)
fold_generic(const __grid_constant__ Tables t, int n, size_t numel) {
  using S = typename Op::S;
  const size_t tid = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = tid; i < numel; i += stride) {
    for (int d = 0; d < n; ++d) {
      int s = d + 1 == n ? 0 : d + 1;
      S acc = static_cast<const S*>(t.in[s])[i];
      for (int j = 1; j < n; ++j) {
        s = s + 1 == n ? 0 : s + 1;
        acc = Op::add(acc, static_cast<const S*>(t.in[s])[i]);
      }
      static_cast<S*>(t.out[d])[i] = acc;
    }
  }
}

int grid_for(size_t items, int max_blocks) {
  const size_t cap = max_blocks > 0 ? static_cast<size_t>(max_blocks) : 1;
  const size_t want = (items + kThreads - 1) / kThreads;
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

template <typename Op>
void dispatch(const Tables& t, int n, size_t numel, bool aligned,
              int max_blocks, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(typename Op::S);
  if (aligned && n >= 2 && n <= kMaxRegisterRanks) {
    const size_t items = numel / V > 0 ? numel / V : numel;
    const int blocks = grid_for(items, max_blocks);
    switch (n) {
#define RING_CASE(N)                                                     \
      case N:                                                            \
        fold_registers<Op, N><<<blocks, kThreads, 0, stream>>>(t, numel); \
        break;
      RING_CASE(2) RING_CASE(3) RING_CASE(4) RING_CASE(5) RING_CASE(6)
      RING_CASE(7) RING_CASE(8) RING_CASE(9) RING_CASE(10) RING_CASE(11)
      RING_CASE(12) RING_CASE(13) RING_CASE(14) RING_CASE(15) RING_CASE(16)
#undef RING_CASE
    }
    return;
  }
  fold_generic<Op><<<grid_for(numel, max_blocks), kThreads, 0, stream>>>(
      t, n, numel);
}

}  // namespace

// dtype codes, shared with brpc_tpu_torch/ici/pallas_ring.py
enum { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2, kInt32 = 3 };

// Launch the fold of the n rows in[0..n-1] (numel elements each) into
// out[0..n-1] on `stream`; returns cudaGetLastError() after the launch
// (0 = launched).  The grid uses at most `max_blocks` blocks.
extern "C" int ring_all_reduce_launch(const void* const* in, void* const* out,
                                      int n, unsigned long long numel,
                                      int dtype, int max_blocks,
                                      void* stream_v) {
  if (n < 1 || n > kMaxRanks) return static_cast<int>(cudaErrorInvalidValue);
  if (numel == 0) return 0;
  Tables t = {};
  bool aligned = true;
  for (int r = 0; r < n; ++r) {
    t.in[r] = in[r];
    t.out[r] = out[r];
    aligned = aligned && ((reinterpret_cast<uintptr_t>(in[r]) |
                           reinterpret_cast<uintptr_t>(out[r])) & 15) == 0;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_v);
  switch (dtype) {
#define RING_DTYPE(CODE, OP)                                         \
    case CODE:                                                       \
      dispatch<OP>(t, n, numel, aligned, max_blocks, stream);        \
      break;
    RING_DTYPE(kFloat32, AddF32) RING_DTYPE(kBFloat16, AddBF16)
    RING_DTYPE(kFloat16, AddF16) RING_DTYPE(kInt32, AddI32)
#undef RING_DTYPE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
