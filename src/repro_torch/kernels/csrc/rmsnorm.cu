// Hopper (sm_90a) RMSNorm over the last dimension, with a plain C interface.
//
// Replaces rmsnorm_call (src/repro/kernels/rmsnorm.py:28):
//   y = x * rsqrt(mean(x^2) + eps) * (w + weight_offset)
// with float32 statistics, returned in x's dtype; x is [rows, d] with unit
// stride along d and any row stride, w is [d].
//
// Bound: bytes.  A row is read and written once (plus w, which stays in L1
// and L2): at gemma3-1b's prefill (4096 rows of 1152 bf16) that is 18.9 MB,
// 5.6 us at 3.35 TB/s; the few flops per element are far below the card's
// rate.  Design: ONE WARP PER ROW, eight rows per 256-thread block, so a
// row's sum of squares is a register sum and five shuffles with no shared
// memory or block barrier, and the grid covers any row count without
// padding (the TPU wrapper pads rows to a block multiple; this kernel
// bounds them instead and copies nothing).  A lane reads 16 bytes at a
// time (8 bf16 or 4 float32) when the row start and d allow it, so a warp
// moves 512 contiguous bytes per load; the second pass re-reads the row,
// which a 2-5 KB row keeps in L1.  d is any size (1152 and 2560 are not
// powers of two; the qk-norm's 256 is).
//
// The products are formed in the reference's order, (x * r) * (w + offset),
// each rounded to float32; only the order of the sum of squares differs
// from the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = 32 * kRowsPerBlock;

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

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

// V elements of T, loaded or stored as one 16-byte access when V * sizeof(T)
// is 16.
template <typename T, int V>
struct Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Pack<T, V> load(const T* p) {
  Pack<T, V> out;
  if constexpr (V * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(out.v) = *reinterpret_cast<const uint4*>(p);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) out.v[e] = p[e];
  }
  return out;
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Pack<T, V>& x) {
  if constexpr (V * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(x.v);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) p[e] = x.v[e];
  }
}

// V: elements per lane access (16 bytes, or 1 when the layout does not
// allow it); TW: the weight's type.
template <typename T, typename TW, int V>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const T* __restrict__ x, const TW* __restrict__ w, T* __restrict__ y,
                   int64_t rows, int d, int64_t x_row_stride, float eps, float offset) {
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * x_row_stride;
  T* yr = y + row * static_cast<int64_t>(d);

  float ss = 0.f;
  for (int i = lane * V; i < d; i += 32 * V) {
    const Pack<T, V> a = load<T, V>(xr + i);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float f = to_float(a.v[e]);
      ss += f * f;
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, m);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  for (int i = lane * V; i < d; i += 32 * V) {
    const Pack<T, V> a = load<T, V>(xr + i);
    Pack<T, V> o;
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float wf = to_float(w[i + e]) + offset;
      o.v[e] = from_float<T>((to_float(a.v[e]) * r) * wf);
    }
    store<T, V>(yr + i, o);
  }
}

template <typename T, typename TW>
cudaError_t launch(const void* x, const void* w, void* y, long long rows, int d,
                   long long x_row_stride, float eps, float offset, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 grid(static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock));
  const bool vec = d % kVec == 0 && x_row_stride % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (vec)
    rmsnorm_kernel<T, TW, kVec><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const TW*>(w), static_cast<T*>(y), rows, d,
        x_row_stride, eps, offset);
  else
    rmsnorm_kernel<T, TW, 1><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const TW*>(w), static_cast<T*>(y), rows, d,
        x_row_stride, eps, offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: [rows, d] of x_dtype with row stride x_row_stride (elements) and unit
// stride along d; w: [d] of w_dtype, contiguous; y: [rows, d] contiguous, of
// x_dtype.
int rt_rmsnorm(int x_dtype, int w_dtype, const void* x, const void* w, void* y,
               long long rows, int d, long long x_row_stride, float eps, float offset,
               void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  if ((rows + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == kFloat32 && w_dtype == kFloat32)
    err = launch<float, float>(x, w, y, rows, d, x_row_stride, eps, offset, s);
  else if (x_dtype == kFloat32 && w_dtype == kBFloat16)
    err = launch<float, __nv_bfloat16>(x, w, y, rows, d, x_row_stride, eps, offset, s);
  else if (x_dtype == kBFloat16 && w_dtype == kFloat32)
    err = launch<__nv_bfloat16, float>(x, w, y, rows, d, x_row_stride, eps, offset, s);
  else if (x_dtype == kBFloat16 && w_dtype == kBFloat16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(x, w, y, rows, d, x_row_stride, eps, offset,
                                               s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(err);
}

}  // extern "C"
