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
// rate.  What keeps a norm from that bound is bytes in flight: an SM needs
// tens of KB of loads outstanding to cover the memory latency, and at decode
// (4 rows) the whole launch is a few rows on a few SMs.
//
// The row partition (fixed by d alone).  A row is cut into groups of 8
// elements (16 bytes of bf16), G = ceil(d / 8), and the groups are dealt to
// L = 32 K slots, K = min(32, pow2ceil(ceil(G / 64))): group g goes to slot
// g mod L.  A slot sums the squares of its groups' elements in column order
// (one float32 fma each); lane l of the tree adds the slots l, 32 + l, ...,
// 32 (K - 1) + l in that order, and a five-step xor butterfly adds the 32
// lanes.  Then r = rsqrt(ss / d + eps) and y = (x * r) * (w + offset), each
// product rounded to float32 (the reference's order).  Every step is an
// explicit _rn intrinsic, so no contraction differs between the routes: a
// row's output depends on that row, w, eps, offset and d only -- not on the
// route, the row count, the row stride or the alignment -- and a row of a
// 4-row decode launch equals, bit for bit, the same row of a 4096-row one.
//
// Two routes, chosen by the wrapper from (rows, d, dtype):
// * rows (many rows, d up to 2048 bf16 / 1024 float32): one warp walks
//   rows, lane l holding groups l, l + 32, ... of a row in registers (K
//   slot sums a lane), all of its 16-byte loads issued before the first
//   use; w + offset is loaded once per warp, as 16-byte vectors, and kept in
//   registers across the warp's rows; the grid is a few CTAs per SM, sized
//   to the card by the occupancy calculator, not one warp per row.
// * team (few rows, or wider rows): a CTA of K warps per row, thread t
//   holding groups t, t + L, ... (one or two 16-byte loads a thread at the
//   served widths); the slot sums meet in shared memory.  4 rows fill 4
//   SMs, not 4 warps of one.  With many rows a CTA normalises 2 rows a
//   pass (their loads all in flight together) and holds its w.
// A layout that keeps 16-byte alignment (x, y, w pointers, x's row stride,
// d % 8 == 0) loads and stores whole groups as 16-byte accesses; any other
// takes element accesses into the same registers, with the same arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kGroup = 8;       // elements of a group: 16 bytes of bf16
constexpr int kRowsWarps = 8;   // warps of a CTA of the rows route
constexpr int kMaxTeamGroups = 4;  // groups a thread holds on the team route
// Rows a team CTA normalises at once when there are many, in bf16 (half as
// many in float32): the bytes an SM has in flight.  2 measured best of 1,
// 2 and 4 (scripts/rmsnorm_team_variants.py).
constexpr int kTeamRows = 2;
constexpr long long kTeamManyRows = 1024;  // rows from which a CTA takes kTeamRows

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };
enum Route : int { kRows = 0, kTeam = 1 };

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

// A group of 8 elements in registers (one or two 16-byte vectors).
template <typename T>
struct alignas(16) Group {
  T v[kGroup];
};

// Elements [8 g, 8 g + n) of a row, n <= 8; the rest are zero.  VEC: the
// group is whole and 16-byte aligned.
template <typename T, bool VEC>
__device__ __forceinline__ void load_group(Group<T>& out, const T* __restrict__ p, int n) {
  if constexpr (VEC) {
    constexpr int kVecs = sizeof(Group<T>) / 16;
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
      reinterpret_cast<uint4*>(out.v)[i] = reinterpret_cast<const uint4*>(p)[i];
  } else {
#pragma unroll
    for (int e = 0; e < kGroup; ++e) out.v[e] = e < n ? p[e] : from_float<T>(0.f);
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_group(T* __restrict__ p, const Group<T>& g, int n) {
  if constexpr (VEC) {
    constexpr int kVecs = sizeof(Group<T>) / 16;
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
      reinterpret_cast<uint4*>(p)[i] = reinterpret_cast<const uint4*>(g.v)[i];
  } else {
#pragma unroll
    for (int e = 0; e < kGroup; ++e)
      if (e < n) p[e] = g.v[e];
  }
}

// w + offset of group g, in float32.
template <bool VEC>
__device__ __forceinline__ void load_weight(Group<float>& out, const void* w, bool w_bf16,
                                            int g, int d, float offset) {
  const int n = min(kGroup, d - g * kGroup);
  if (w_bf16) {
    Group<__nv_bfloat16> raw;
    load_group<__nv_bfloat16, VEC>(raw, static_cast<const __nv_bfloat16*>(w) + g * kGroup, n);
#pragma unroll
    for (int e = 0; e < kGroup; ++e) out.v[e] = __fadd_rn(to_float(raw.v[e]), offset);
  } else {
    Group<float> raw;
    load_group<float, VEC>(raw, static_cast<const float*>(w) + g * kGroup, n);
#pragma unroll
    for (int e = 0; e < kGroup; ++e) out.v[e] = __fadd_rn(raw.v[e], offset);
  }
}

// A slot's running sum of squares over one more group, in column order.
template <typename T>
__device__ __forceinline__ float add_squares(float acc, const Group<T>& g) {
#pragma unroll
  for (int e = 0; e < kGroup; ++e) {
    const float f = to_float(g.v[e]);
    acc = __fmaf_rn(f, f, acc);
  }
  return acc;
}

// The lanes' sums added by the fixed butterfly; every lane gets the total.
__device__ __forceinline__ float warp_total(float t) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) t = __fadd_rn(t, __shfl_xor_sync(0xffffffffu, t, m));
  return t;
}

__device__ __forceinline__ float inv_rms(float ss, int d, float eps) {
  return rsqrtf(__fadd_rn(__fdiv_rn(ss, static_cast<float>(d)), eps));
}

template <typename T>
__device__ __forceinline__ Group<T> normed(const Group<T>& x, const Group<float>& w, float r) {
  Group<T> o;
#pragma unroll
  for (int e = 0; e < kGroup; ++e)
    o.v[e] = from_float<T>(__fmul_rn(__fmul_rn(to_float(x.v[e]), r), w.v[e]));
  return o;
}

// The rows route.  NG: groups a lane holds (pow2ceil(ceil(G / 32))); the
// partition's K for these d is NG / 2 (1 for NG = 1): lane l's group i
// (g = l + 32 i) goes to slot l + 32 (i mod K).
template <typename T, bool VEC, int NG>
__global__ void __launch_bounds__(32 * kRowsWarps, 2)
    rmsnorm_rows_kernel(const T* __restrict__ x, const void* __restrict__ w, bool w_bf16,
                        T* __restrict__ y, int64_t rows, int d, int64_t x_row_stride, float eps,
                        float offset) {
  constexpr int K = NG > 1 ? NG / 2 : 1;
  const int lane = threadIdx.x & 31;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kRowsWarps;
  int64_t row = static_cast<int64_t>(blockIdx.x) * kRowsWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int G = (d + kGroup - 1) / kGroup;

  Group<float> wf[NG];
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int g = lane + 32 * i;
    if (g < G) load_weight<VEC>(wf[i], w, w_bf16, g, d, offset);
  }
  for (; row < rows; row += step) {
    const T* xr = x + row * x_row_stride;
    Group<T> xv[NG];
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int g = lane + 32 * i;
      if (g < G) load_group<T, VEC>(xv[i], xr + g * kGroup, d - g * kGroup);
    }
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.f;
#pragma unroll
    for (int i = 0; i < NG; ++i)
      if (lane + 32 * i < G) acc[i % K] = add_squares(acc[i % K], xv[i]);
    float t = acc[0];
#pragma unroll
    for (int k = 1; k < K; ++k) t = __fadd_rn(t, acc[k]);
    const float r = inv_rms(warp_total(t), d, eps);
    T* yr = y + row * static_cast<int64_t>(d);
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int g = lane + 32 * i;
      if (g < G) store_group<T, VEC>(yr + g * kGroup, normed(xv[i], wf[i], r), d - g * kGroup);
    }
  }
}

// The team route: CTAs of 32 K threads (K = blockDim.x / 32) that take R
// rows at a time, gridDim.x * R rows apart (R = 1 and one row a CTA when
// there are few).  NG: groups a thread holds of a row (pow2ceil(ceil(G /
// 32 K))); thread t's groups t, t + L, ... all go to slot t.  They are the
// same columns in every row, so a thread holds its w + offset across rows
// where the registers allow (NG <= 2).
template <typename T, bool VEC, int NG, int R>
__global__ void __launch_bounds__(R == 1 ? 1024 : 512, R == 1 ? 1 : 2)
    rmsnorm_team_kernel(const T* __restrict__ x, const void* __restrict__ w, bool w_bf16,
                        T* __restrict__ y, int64_t rows, int d, int64_t x_row_stride,
                        float eps, float offset) {
  __shared__ float part[2][R][32][32];   // [pass parity][row][warp][lane]: slot sums
  constexpr bool kHoldW = NG <= 2;
  const int tid = threadIdx.x, lane = tid & 31, L = blockDim.x;
  const int G = (d + kGroup - 1) / kGroup;

  Group<float> wf[kHoldW ? NG : 1];
  if constexpr (kHoldW) {
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int g = tid + L * i;
      if (g < G) load_weight<VEC>(wf[i], w, w_bf16, g, d, offset);
    }
  }
  const int64_t step = static_cast<int64_t>(gridDim.x) * R;
  int parity = 0;
  for (int64_t row0 = static_cast<int64_t>(blockIdx.x) * R; row0 < rows;
       row0 += step, parity ^= 1) {
    Group<T> xv[R][NG];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (row0 + j >= rows) break;
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const int g = tid + L * i;
        if (g < G)
          load_group<T, VEC>(xv[j][i], x + (row0 + j) * x_row_stride + g * kGroup,
                             d - g * kGroup);
      }
    }
    // two buffers: a warp writes pass p + 1's sums only after every warp
    // passed pass p + 1's barrier, so pass p - 1's buffer is free by then
#pragma unroll
    for (int j = 0; j < R; ++j) {
      float acc = 0.f;
      if (row0 + j < rows) {
#pragma unroll
        for (int i = 0; i < NG; ++i)
          if (tid + L * i < G) acc = add_squares(acc, xv[j][i]);
      }
      part[parity][j][tid >> 5][lane] = acc;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (row0 + j >= rows) break;
      float t = part[parity][j][0][lane];
      for (int k = 1; k < (L >> 5); ++k) t = __fadd_rn(t, part[parity][j][k][lane]);
      const float r = inv_rms(warp_total(t), d, eps);
      T* yr = y + (row0 + j) * static_cast<int64_t>(d);
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const int g = tid + L * i;
        if (g >= G) continue;
        if constexpr (!kHoldW) load_weight<VEC>(wf[0], w, w_bf16, g, d, offset);
        store_group<T, VEC>(yr + g * kGroup, normed(xv[j][i], wf[kHoldW ? i : 0], r),
                            d - g * kGroup);
      }
    }
  }
}

int pow2ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// CTAs of `threads` threads of `kernel` the card holds at once.
template <typename Kernel>
int capacity(Kernel kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return std::max(sms, 1) * std::max(per_sm, 1);
}

struct Args {
  const void* x;
  const void* w;
  bool w_bf16;
  void* y;
  long long rows;
  int d;
  long long x_row_stride;
  float eps, offset;
  cudaStream_t s;
};

// The grids are a few CTAs per SM at most (the occupancy calculator's,
// cached per instance and team size): CTAs walk the rows beyond that.
template <typename T, bool VEC, int NG>
cudaError_t launch_rows(const Args& a) {
  static const int cap = capacity(rmsnorm_rows_kernel<T, VEC, NG>, 32 * kRowsWarps);
  const long long want = (a.rows + kRowsWarps - 1) / kRowsWarps;
  rmsnorm_rows_kernel<T, VEC, NG><<<static_cast<int>(std::min<long long>(want, cap)),
                                    32 * kRowsWarps, 0, a.s>>>(
      static_cast<const T*>(a.x), a.w, a.w_bf16, static_cast<T*>(a.y), a.rows, a.d,
      a.x_row_stride, a.eps, a.offset);
  return cudaGetLastError();
}

template <typename T, bool VEC, int NG, int R>
cudaError_t launch_team(const Args& a, int warps) {
  static int cap[6] = {};   // by log2(warps)
  int& c = cap[__builtin_ctz(warps)];
  if (c == 0) c = capacity(rmsnorm_team_kernel<T, VEC, NG, R>, 32 * warps);
  rmsnorm_team_kernel<T, VEC, NG, R>
      <<<static_cast<int>(std::min<long long>((a.rows + R - 1) / R, c)), 32 * warps, 0, a.s>>>(
          static_cast<const T*>(a.x), a.w, a.w_bf16, static_cast<T*>(a.y), a.rows, a.d,
          a.x_row_stride, a.eps, a.offset);
  return cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch(const Args& a, int route) {
  const int G = (a.d + kGroup - 1) / kGroup;
  const int warps = std::min(32, pow2ceil((G + 63) / 64));   // the partition's K
  if (route == kRows) {
    // the groups a lane holds; float32 x takes twice the registers
    const int ng = pow2ceil((G + 31) / 32);
    constexpr int kMax = sizeof(T) == 2 ? 8 : 4;
    if (ng > kMax) return cudaErrorInvalidValue;
    switch (ng) {
      case 1: return launch_rows<T, VEC, 1>(a);
      case 2: return launch_rows<T, VEC, 2>(a);
      case 4: return launch_rows<T, VEC, 4>(a);
      default:
        if constexpr (kMax >= 8) return launch_rows<T, VEC, 8>(a);
        return cudaErrorInvalidValue;
    }
  }
  if (route != kTeam) return cudaErrorInvalidValue;
  const int ng = pow2ceil((G + 32 * warps - 1) / (32 * warps));
  // several rows a pass where there are many and a CTA of up to 512
  // threads has the registers (R x NG groups a thread, two CTAs an SM;
  // float32 takes half the rows)
  constexpr int R = sizeof(T) == 2 ? kTeamRows : std::max(1, kTeamRows / 2);
  if (a.rows >= kTeamManyRows && warps <= 16 && ng <= 2)
    return ng == 1 ? launch_team<T, VEC, 1, R>(a, warps) : launch_team<T, VEC, 2, R>(a, warps);
  switch (ng) {
    case 1: return launch_team<T, VEC, 1, 1>(a, warps);
    case 2: return launch_team<T, VEC, 2, 1>(a, warps);
    case kMaxTeamGroups: return launch_team<T, VEC, kMaxTeamGroups, 1>(a, warps);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The backward: rmsnorm_bwd_kernel and rmsnorm_dw_kernel.
//
// No Pallas kernel to replace: the reference's models differentiate the
// plain norm (src/repro/models/nn.py:78) with XLA's autodiff.  With
// r = rsqrt(mean(x^2) + eps), w' = w + offset and g = dy * w' (float32):
//   dx = r * (g - x * (r^2 * mean(g * x)))       in x's dtype
//   dw = sum over rows of dy * (x * r)           in w's dtype
// Bound: bytes (x and dy read, dx written once; the row is read twice, the
// second time from L1).  One CTA of 256 threads takes rows blockIdx.x,
// blockIdx.x + gridDim.x, ...; thread t owns columns t, t + 256, ... of the
// row, so it alone adds into those columns of the CTA's dw partial in
// shared memory.  The two row sums meet in a fixed tree (lanes by the xor
// butterfly, warps in order).  rmsnorm_dw_kernel then adds the CTAs'
// partials column by column in CTA order.  No float atomics: the result is
// the same bits on every run, in a CUDA graph or not, for any row stride;
// the grid (so the order of the partials) is fixed by the row count alone.
// Any d the forward takes (both routes) and any leading dimensions: the
// wrapper flattens them into rows.

constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;

__device__ __forceinline__ float weight_at(const void* w, bool w_bf16, int j, float offset) {
  const float v = w_bf16 ? to_float(static_cast<const __nv_bfloat16*>(w)[j])
                         : static_cast<const float*>(w)[j];
  return __fadd_rn(v, offset);
}

template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
    rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const void* __restrict__ w, bool w_bf16, T* __restrict__ dx,
                       float* __restrict__ partial, long long rows, int d, long long x_rs,
                       float eps, float offset) {
  extern __shared__ float bwd_smem[];
  float* acc = bwd_smem;           // [d]: this CTA's dw partial
  float* red = bwd_smem + d;       // [2 buffers][2 sums][kBwdWarps]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < d; j += kBwdThreads) acc[j] = 0.f;
  int buf = 0;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x, buf ^= 1) {
    const T* xr = x + r * x_rs;
    const T* gr = dy + r * static_cast<long long>(d);
    float ss = 0.f, gx = 0.f;
    for (int j = tid; j < d; j += kBwdThreads) {
      const float xv = to_float(xr[j]);
      const float gv = __fmul_rn(to_float(gr[j]), weight_at(w, w_bf16, j, offset));
      ss = __fmaf_rn(xv, xv, ss);
      gx = __fmaf_rn(gv, xv, gx);
    }
    ss = warp_total(ss);
    gx = warp_total(gx);
    float* rb = red + buf * 2 * kBwdWarps;
    if (lane == 0) {
      rb[warp] = ss;
      rb[kBwdWarps + warp] = gx;
    }
    // one barrier a row: the next row writes the other buffer, and the row
    // after it cannot start before every thread has passed the next barrier
    __syncthreads();
    ss = 0.f;
    gx = 0.f;
#pragma unroll
    for (int k = 0; k < kBwdWarps; ++k) {
      ss = __fadd_rn(ss, rb[k]);
      gx = __fadd_rn(gx, rb[kBwdWarps + k]);
    }
    const float rs = inv_rms(ss, d, eps);
    const float c = __fmul_rn(__fmul_rn(rs, rs), __fdiv_rn(gx, static_cast<float>(d)));
    T* dxr = dx + r * static_cast<long long>(d);
    for (int j = tid; j < d; j += kBwdThreads) {
      const float xv = to_float(xr[j]);
      const float dyv = to_float(gr[j]);
      const float gv = __fmul_rn(dyv, weight_at(w, w_bf16, j, offset));
      dxr[j] = from_float<T>(__fmul_rn(rs, __fsub_rn(gv, __fmul_rn(xv, c))));
      acc[j] = __fmaf_rn(dyv, __fmul_rn(xv, rs), acc[j]);
    }
  }
  float* out = partial + static_cast<long long>(blockIdx.x) * d;
  for (int j = tid; j < d; j += kBwdThreads) out[j] = acc[j];
}

// dw[j] = the CTAs' partials of column j added in CTA order, in w's dtype.
__global__ void rmsnorm_dw_kernel(const float* __restrict__ partial, int ctas, int d, void* dw,
                                  bool w_bf16) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  float s = 0.f;
  for (int b = 0; b < ctas; ++b) s = __fadd_rn(s, partial[static_cast<long long>(b) * d + j]);
  if (w_bf16)
    static_cast<__nv_bfloat16*>(dw)[j] = __float2bfloat16_rn(s);
  else
    static_cast<float*>(dw)[j] = s;
}

size_t bwd_smem_bytes(int d) { return (static_cast<size_t>(d) + 4 * kBwdWarps) * sizeof(float); }

template <typename T>
cudaError_t launch_bwd(const void* x, const void* dy, const void* w, bool w_bf16, void* dx,
                       float* partial, void* dw, long long rows, int d, long long x_rs,
                       float eps, float offset, int ctas, cudaStream_t s) {
  // the largest d the forward takes (32 warps x 4 groups x 8): set once
  static const cudaError_t set = cudaFuncSetAttribute(
      rmsnorm_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bwd_smem_bytes(32 * 32 * kMaxTeamGroups * kGroup)));
  if (set != cudaSuccess) return set;
  rmsnorm_bwd_kernel<T><<<ctas, kBwdThreads, bwd_smem_bytes(d), s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), w, w_bf16, static_cast<T*>(dx),
      partial, rows, d, x_rs, eps, offset);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_dw_kernel<<<(d + 255) / 256, 256, 0, s>>>(partial, ctas, d, dw, w_bf16);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x: [rows, d] of x_dtype with row stride x_row_stride (elements) and unit
// stride along d; w: [d] of w_dtype, contiguous; y: [rows, d] contiguous, of
// x_dtype; route: 0 rows, 1 team (the wrapper's choice; the output is the
// same bits either way).
int rt_rmsnorm(int x_dtype, int w_dtype, const void* x, const void* w, void* y,
               long long rows, int d, long long x_row_stride, float eps, float offset,
               int route, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  if ((x_dtype != kFloat32 && x_dtype != kBFloat16) ||
      (w_dtype != kFloat32 && w_dtype != kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, w, w_dtype == kBFloat16, y, rows, d, x_row_stride, eps, offset,
               static_cast<cudaStream_t>(stream)};
  const long long esize = x_dtype == kFloat32 ? 4 : 2;
  const bool vec = d % kGroup == 0 && (x_row_stride * esize) % 16 == 0 && aligned16(x) &&
                   aligned16(y) && aligned16(w);
  cudaError_t err;
  if (x_dtype == kFloat32)
    err = vec ? launch<float, true>(a, route) : launch<float, false>(a, route);
  else
    err = vec ? launch<__nv_bfloat16, true>(a, route) : launch<__nv_bfloat16, false>(a, route);
  return static_cast<int>(err);
}

// The backward (see launch_bwd): x as rt_rmsnorm's; dy and dx [rows, d]
// contiguous of x_dtype; w [d] of w_dtype; dw [d] of w_dtype; partial
// [ctas, d] float32 scratch, ctas in 1..rows (the wrapper's, from rows alone).
int rt_rmsnorm_bwd(int x_dtype, int w_dtype, const void* x, const void* dy, const void* w,
                   void* dx, void* dw, void* partial, long long rows, int d,
                   long long x_row_stride, float eps, float offset, int ctas, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  if ((x_dtype != kFloat32 && x_dtype != kBFloat16) ||
      (w_dtype != kFloat32 && w_dtype != kBFloat16) || ctas < 1 || ctas > rows ||
      d > 32 * 32 * kMaxTeamGroups * kGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wb = w_dtype == kBFloat16;
  float* part = static_cast<float*>(partial);
  const cudaError_t err =
      x_dtype == kFloat32
          ? launch_bwd<float>(x, dy, w, wb, dx, part, dw, rows, d, x_row_stride, eps, offset,
                              ctas, s)
          : launch_bwd<__nv_bfloat16>(x, dy, w, wb, dx, part, dw, rows, d, x_row_stride, eps,
                                      offset, ctas, s);
  return static_cast<int>(err);
}

}  // extern "C"
