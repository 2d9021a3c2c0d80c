// Hopper (sm_90a) backward of an embedding lookup, with a plain C interface.
//
// Replaces no Pallas kernel.  The JAX package's lookup is jnp.take of the
// table cast to the compute dtype (src/repro/models/nn.py:94-98), and XLA
// differentiates it: the VJP is a scatter-add into zeros whose combiner adds
// in the compute dtype.  On the CPU that adds each id's rows in ascending
// token position and rounds after every add.  This kernel computes the same:
//   dtable[v] = sum of dy[t] over the positions t with ids[t] == v,
// added in ascending t from zero, each add a float32 add of the two values
// rounded to nearest even in dy's dtype (bf16 or float32); rows that no id
// selects are zero.  There are no float atomics, so the result is the same
// bits on every run and in a CUDA graph.  PyTorch's index_select backward
// would add such rows with float atomics, in an order that changes from run
// to run, and round once.
//
// Bound: bytes.  dy is read once (T x D), every row of dtable written once
// (V x D: at a 151 936-token vocabulary the write is most of the bytes), and
// the sorted ids and their positions (12 bytes a token) are read; there is
// one add an element of dy.
//
// Design.  The wrapper sorts the flat ids with a stable sort (torch.sort:
// an integer permutation, exact), so each id's positions lie together in
// ascending token order.  A first kernel marks where each id's run starts
// (first[v], -1 for an id that does not occur: a memset, then one thread a
// sorted position, each entry written by one thread).  The main kernel gives
// a warp one table row v and a slice of up to slice_cols columns (the
// wrapper's SLICE_COLS), a lane 16 bytes of each 32-lane tile; the grid
// covers V x slices, fixed by the shape, so nothing is read back on the host
// and the kernels can run inside a captured training step.  A row that no id selects reads first[v] and
// writes its zeros.  Otherwise the warp walks the run 32 positions at a
// time, tile by tile: the lanes load 32 sorted ids and token positions at
// once, a ballot gives the run's length within them, the positions are
// broadcast by shuffles, and the loads of kAhead rows are issued before
// the first of their adds, since only the adds depend on each other.  One
// id repeated thousands of times is one serial chain a slice.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kWarps = 8;          // warps of a CTA
constexpr int kAhead = 8;          // rows whose loads a lane issues before their adds
constexpr int kStartThreads = 256; // threads of a CTA of the run-start kernel
constexpr unsigned kFull = 0xffffffffu;

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// acc + x as the reference adds it: a float32 add, rounded to T.
template <typename T>
__device__ __forceinline__ float add_round(float acc, float x);
template <>
__device__ __forceinline__ float add_round<float>(float acc, float x) {
  return __fadd_rn(acc, x);
}
template <>
__device__ __forceinline__ float add_round<__nv_bfloat16>(float acc, float x) {
  return __bfloat162float(__float2bfloat16_rn(__fadd_rn(acc, x)));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// A lane's 16 bytes of a row: kN elements.
template <typename T>
struct Lane {
  static constexpr int kN = 16 / sizeof(T);
};

// The kN columns from col of a row, as floats (zeros past d).  kVec: d a
// multiple of kN and the rows 16-byte aligned, so the lane's share is one
// 16-byte access.
template <typename T, bool kVec>
__device__ __forceinline__ void load_lane(const T* row, int col, int d, uint4& raw) {
  if (kVec) {
    if (col < d) raw = __ldg(reinterpret_cast<const uint4*>(row + col));
    else raw = make_uint4(0u, 0u, 0u, 0u);
  } else {
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < Lane<T>::kN; ++j)
      e[j] = col + j < d ? row[col + j] : from_float<T>(0.f);
  }
}

template <typename T, bool kVec>
__device__ __forceinline__ void store_lane(T* row, int col, int d, const float* acc) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < Lane<T>::kN; ++j) e[j] = from_float<T>(acc[j]);
  if (kVec) {
    if (col < d) *reinterpret_cast<uint4*>(row + col) = raw;
  } else {
#pragma unroll
    for (int j = 0; j < Lane<T>::kN; ++j)
      if (col + j < d) row[col + j] = e[j];
  }
}

// first[v] = the first sorted position holding v; first is -1 beforehand.
__global__ void __launch_bounds__(kStartThreads)
    embedding_run_starts_kernel(const int* __restrict__ sorted, long long n,
                                int* __restrict__ first, long long vocab) {
  const long long i = static_cast<long long>(blockIdx.x) * kStartThreads + threadIdx.x;
  if (i >= n) return;
  const int v = sorted[i];
  if ((i == 0 || sorted[i - 1] != v) && v >= 0 && v < vocab) first[v] = static_cast<int>(i);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(32 * kWarps)
    embedding_bwd_kernel(const T* __restrict__ dy, long long dy_stride,
                         const int* __restrict__ sorted,
                         const long long* __restrict__ order, const int* __restrict__ first,
                         long long n, T* __restrict__ out, long long vocab, int d,
                         int slice_cols, int slices) {
  constexpr int kN = Lane<T>::kN;
  constexpr int kTile = 32 * kN;
  const int lane = threadIdx.x & 31;
  const long long w = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (w >= vocab * slices) return;  // warp-uniform
  const int v = static_cast<int>(w / slices);
  const int c0 = static_cast<int>(w % slices) * slice_cols;
  const int c1 = min(d, c0 + slice_cols);
  const int start = __ldg(first + v);
  T* out_row = out + static_cast<long long>(v) * d;
  for (int tile = c0; tile < c1; tile += kTile) {
    const int col = tile + lane * kN;
    float acc[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) acc[j] = 0.f;
    for (long long i = start; start >= 0 && i < n; i += 32) {
      const long long p = i + lane;
      const bool in_run = p < n && __ldg(sorted + p) == v;
      const int m = __popc(__ballot_sync(kFull, in_run));  // the run's lanes: a prefix
      const long long t_lane = in_run ? __ldg(order + p) : 0;
      for (int k0 = 0; k0 < m; k0 += kAhead) {
        uint4 raw[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const long long t = __shfl_sync(kFull, t_lane, (k0 + u) & 31);
          if (k0 + u < m) load_lane<T, kVec>(dy + t * dy_stride, col, d, raw[u]);
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          if (k0 + u < m) {
            const T* e = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
            for (int j = 0; j < kN; ++j) acc[j] = add_round<T>(acc[j], to_float(e[j]));
          }
        }
      }
      if (m < 32) break;
    }
    store_lane<T, kVec>(out_row, col, d, acc);
  }
}

template <typename T>
cudaError_t launch(const void* dy, long long dy_stride, const void* sorted, const void* order,
                   void* first, long long n, void* out, long long vocab, int d,
                   int slice_cols, cudaStream_t stream) {
  if (slice_cols <= 0 || slice_cols % (32 * Lane<T>::kN)) return cudaErrorInvalidValue;
  const int slices = (d + slice_cols - 1) / slice_cols;
  const long long blocks = (vocab * slices + kWarps - 1) / kWarps;
  const long long start_blocks = (n + kStartThreads - 1) / kStartThreads;
  if (blocks > INT_MAX || start_blocks > INT_MAX || n > INT_MAX || vocab > INT_MAX) {
    return cudaErrorInvalidValue;
  }
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = d % Lane<T>::kN == 0 && dy_stride % Lane<T>::kN == 0 && aligned(dy) &&
                   aligned(out);
  const int* s = static_cast<const int*>(sorted);
  const long long* o = static_cast<const long long*>(order);
  int* f = static_cast<int*>(first);
  cudaError_t err = cudaMemsetAsync(f, 0xff, vocab * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  if (n > 0) {
    embedding_run_starts_kernel<<<static_cast<unsigned>(start_blocks), kStartThreads, 0,
                                  stream>>>(s, n, f, vocab);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>(blocks)), block(32 * kWarps);
  const T* x = static_cast<const T*>(dy);
  T* y = static_cast<T*>(out);
  if (vec)
    embedding_bwd_kernel<T, true><<<grid, block, 0, stream>>>(x, dy_stride, s, o, f, n, y,
                                                                vocab, d, slice_cols, slices);
  else
    embedding_bwd_kernel<T, false><<<grid, block, 0, stream>>>(x, dy_stride, s, o, f, n, y,
                                                                 vocab, d, slice_cols, slices);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dy: [n, d] of dtype (0 float32, 1 bf16) with row stride dy_stride
// (elements) and unit stride along d; sorted: the n ids in ascending order
// (int32), order: their token positions (int64), equal ids in ascending
// position (a stable sort); first: int32 scratch of vocab entries; out:
// [vocab, d] contiguous, of dtype, every row written; slice_cols: the
// columns a warp covers, a multiple of 32 lanes' 16 bytes.
int rt_embedding_bwd(int dtype, const void* dy, long long dy_stride, const void* sorted,
                     const void* order, void* first, long long n, void* out, long long vocab,
                     int d, int slice_cols, void* stream) {
  if (vocab <= 0 || d <= 0) return 0;
  if (n < 0 || (dtype != kFloat32 && dtype != kBFloat16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == kFloat32
          ? launch<float>(dy, dy_stride, sorted, order, first, n, out, vocab, d, slice_cols, s)
          : launch<__nv_bfloat16>(dy, dy_stride, sorted, order, first, n, out, vocab, d,
                                  slice_cols, s);
  return static_cast<int>(err);
}

}  // extern "C"
