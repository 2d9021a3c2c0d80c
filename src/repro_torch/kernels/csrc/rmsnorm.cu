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
// The backward: a row pass (rmsnorm_bwd_rows_kernel or rmsnorm_bwd_team_kernel)
// and a dw pass (rmsnorm_dw_kernel).
//
// No Pallas kernel to replace: the reference's models differentiate the
// plain norm (src/repro/models/nn.py:78, src/repro/kernels/ref.py:56) with
// XLA's autodiff.  With r = rsqrt(mean(x^2) + eps), w' = w + offset and
// g = dy * w' (float32):
//   dx = r * (g - x * (r^2 * mean(g * x)))       in x's dtype
//   dw = sum over rows of dy * (x * r)           in w's dtype
// Bound: bytes.  x and dy are read and dx written once (w read and dw
// written once besides): at mamba2-2.7b's gated norm (2048 x 5120 bf16)
// 63 MB, 18.8 us at 3.35 TB/s.  The design meets that as the forward does:
// * A row is read once, as 16-byte loads of groups of 8 elements (the
//   forward's test for them; element loads into the same registers
//   otherwise), and stays in registers from the two row sums to the dx
//   write.  Each thread owns the same groups of every row it takes, so it
//   loads w + offset for them once and adds its rows' dy * (x * r) into
//   registers.  Rows stay in flight behind the one being reduced: on the
//   team route's 16-byte path two (one in float32) through a ring in
//   shared memory filled by cp.async, otherwise the next row's loads are
//   issued into registers before this row's sums.
// * rows route (many rows, d up to 1024 bf16 / 512 float32): a warp a row,
//   lane l holding groups l, l + 32, ...; the row sums are the lanes' sums
//   added by the xor butterfly, no barrier.  A CTA of kBwdRowsWarps warps
//   takes rows warp, warp + parts * kBwdRowsWarps, ...; at the end its warps'
//   dw sums meet in shared memory and are added in warp order into the CTA's
//   partial.
// * team route (the rest): a team of W warps in each of C CTAs (a cluster
//   when C > 1, for d above 8192) takes a row; thread u of the team (u =
//   rank * 32 W + tid) holds groups u, u + 32 W C, ... (at most 2).  The
//   row sums: each thread's in order, the lanes' by the butterfly, then the
//   team's warps' in order (through shared memory, across the cluster by
//   distributed shared memory), one barrier a row (two buffers, as the
//   forward's team route).  Team p takes rows p, p + parts, ... and its
//   dw sums are its partial.
// * dw: the partials (`parts` of them, fixed by the wrapper from (rows, d,
//   dtype) alone) are added in a fixed tree by rmsnorm_dw_kernel, a CTA
//   for every 4 column quads (16 columns: 160 CTAs at d 2560, 320 at 5120):
//   64 threads a quad each add every 64th partial in order, then the
//   butterfly and the warps in order.  It is launched as the row pass's
//   programmatic dependent (griddepcontrol), so its launch overlaps the
//   row pass's last rows.
// No float atomics: dx and dw are the same bits on every run, in a CUDA
// graph or not, for any row stride and alignment.  tests/test_torch_backward.py
// (emulate_rmsnorm_bwd) repeats this order of operations on the CPU.

constexpr int kBwdRowsWarps = 4;       // warps of a CTA of the rows route
constexpr int kBwdTeamMaxWarps = 16;   // warps of a team's CTA
constexpr int kBwdMaxCluster = 8;      // CTAs of a team
constexpr int kDwThreads = 256;        // threads of a CTA of the dw pass
constexpr int kDwQuads = 4;            // column quads of a CTA of the dw pass
constexpr int kDwSlices = kDwThreads / kDwQuads;   // its threads a quad

// Elements of the row groups first, first + stride, ... (NG of them, those
// below G) of x and dy.
template <typename T, bool VEC, int NG>
__device__ __forceinline__ void load_row(Group<T> (&xv)[NG], Group<T> (&gv)[NG],
                                         const T* __restrict__ xr, const T* __restrict__ gr,
                                         int first, int stride, int G, int d) {
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int g = first + stride * i;
    if (g < G) {
      load_group<T, VEC>(xv[i], xr + g * kGroup, d - g * kGroup);
      load_group<T, VEC>(gv[i], gr + g * kGroup, d - g * kGroup);
    }
  }
}

// A thread's two row sums over its groups in order: x * x and g * x.
template <typename T, int NG>
__device__ __forceinline__ void thread_sums(const Group<T> (&xv)[NG], const Group<T> (&gv)[NG],
                                            const Group<float> (&wf)[NG], int first, int stride,
                                            int G, float& ss, float& gx) {
  ss = 0.f;
  gx = 0.f;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    if (first + stride * i >= G) continue;
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      const float xf = to_float(xv[i].v[e]);
      ss = __fmaf_rn(xf, xf, ss);
      gx = __fmaf_rn(__fmul_rn(to_float(gv[i].v[e]), wf[i].v[e]), xf, gx);
    }
  }
}

// dx of the thread's groups of a row, and dy * (x * r) added to its dw sums.
template <typename T, bool VEC, int NG>
__device__ __forceinline__ void row_grads(const Group<T> (&xv)[NG], const Group<T> (&gv)[NG],
                                          const Group<float> (&wf)[NG], Group<float> (&acc)[NG],
                                          int first, int stride, int G, int d, float rs, float c,
                                          T* __restrict__ dxr) {
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int g = first + stride * i;
    if (g >= G) continue;
    Group<T> o;
#pragma unroll
    for (int e = 0; e < kGroup; ++e) {
      const float xf = to_float(xv[i].v[e]), dyf = to_float(gv[i].v[e]);
      const float gw = __fmul_rn(dyf, wf[i].v[e]);
      o.v[e] = from_float<T>(__fmul_rn(rs, __fsub_rn(gw, __fmul_rn(xf, c))));
      acc[i].v[e] = __fmaf_rn(dyf, __fmul_rn(xf, rs), acc[i].v[e]);
    }
    store_group<T, VEC>(dxr + g * kGroup, o, d - g * kGroup);
  }
}

__device__ __forceinline__ float grad_scale(float rs, float gx, int d) {
  return __fmul_rn(__fmul_rn(rs, rs), __fdiv_rn(gx, static_cast<float>(d)));
}

template <typename T, bool VEC, int NG>
__device__ __forceinline__ void weights_and_zeros(Group<float> (&wf)[NG], Group<float> (&acc)[NG],
                                                  const void* w, bool w_bf16, int first,
                                                  int stride, int G, int d, float offset) {
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int g = first + stride * i;
    if (g < G) load_weight<VEC>(wf[i], w, w_bf16, g, d, offset);
#pragma unroll
    for (int e = 0; e < kGroup; ++e) acc[i].v[e] = 0.f;
  }
}

// The rows route.  NG: pow2ceil(ceil(G / 32)) groups a lane.  `partial` is
// [gridDim.x, 8 G].
template <typename T, bool VEC, int NG>
__global__ void __launch_bounds__(32 * kBwdRowsWarps, 3)
    rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                            const void* __restrict__ w, bool w_bf16, T* __restrict__ dx,
                            float* __restrict__ partial, long long rows, int d, long long x_rs,
                            float eps, float offset) {
  __shared__ __align__(16) float part[kBwdRowsWarps][32 * NG * kGroup];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = (d + kGroup - 1) / kGroup;
  Group<float> wf[NG], acc[NG];
  weights_and_zeros<T, VEC, NG>(wf, acc, w, w_bf16, lane, 32, G, d, offset);
  const long long step = static_cast<long long>(gridDim.x) * kBwdRowsWarps;
  long long r = static_cast<long long>(blockIdx.x) * kBwdRowsWarps + warp;
  Group<T> xv[NG], gv[NG];
  if (r < rows) load_row<T, VEC, NG>(xv, gv, x + r * x_rs, dy + r * d, lane, 32, G, d);
  for (; r < rows; r += step) {
    const long long next = r + step;
    Group<T> xn[NG], gn[NG];
    if (next < rows) load_row<T, VEC, NG>(xn, gn, x + next * x_rs, dy + next * d, lane, 32, G, d);
    float ss, gx;
    thread_sums<T, NG>(xv, gv, wf, lane, 32, G, ss, gx);
    const float rs = inv_rms(warp_total(ss), d, eps);
    row_grads<T, VEC, NG>(xv, gv, wf, acc, lane, 32, G, d, rs, grad_scale(rs, warp_total(gx), d),
                          dx + r * d);
    if (next < rows) {
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        xv[i] = xn[i];
        gv[i] = gn[i];
      }
    }
  }
  // the dw pass may be scheduled now (it waits for this grid's end)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // the CTA's partial: its warps' sums added in warp order
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int g = lane + 32 * i;
    if (g < G) *reinterpret_cast<Group<float>*>(&part[warp][g * kGroup]) = acc[i];
  }
  __syncthreads();
  float* out = partial + static_cast<long long>(blockIdx.x) * G * kGroup;
  for (int col = threadIdx.x; col < G * kGroup; col += blockDim.x) {
    float s = part[0][col];
#pragma unroll
    for (int k = 1; k < kBwdRowsWarps; ++k) s = __fadd_rn(s, part[k][col]);
    out[col] = s;
  }
}

// Every thread of every CTA of the cluster: writes before it (shared and
// global) are seen by reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of the same shared-memory location in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

// 16 bytes global -> shared, asynchronously (cp.async, not through L1).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's commit groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The team route's ring (16-byte path): kStages rows of each thread's
// groups in shared memory (3 in bf16: 2 to 5 measured alike at 2048 x 5120,
// scripts/norm_bwd_times.py; 2 in float32), laid out
// [stage][group i][x, dy][16-byte vector][thread] so that a warp's accesses
// are consecutive.  A thread reads back only what it copied itself, so no
// barrier guards the ring.
template <typename T>
struct Ring {
  static constexpr int kStages = sizeof(T) == 2 ? 3 : 2;   // rows in flight + 1
  static constexpr int kVecs = sizeof(Group<T>) / 16;
  uint4* base;
  int tid, threads;
  __device__ __forceinline__ uint4* at(int stage, int i, int which, int v, int NG) const {
    return base + (((stage * NG + i) * 2 + which) * kVecs + v) * threads + tid;
  }
};

template <typename T, int NG>
constexpr size_t ring_bytes(int threads) {
  return static_cast<size_t>(Ring<T>::kStages) * NG * 2 * sizeof(Group<T>) * threads;
}

// This thread's groups of x and dy of `row` (none past the last row) into
// ring stage `stage`, as one commit group.
template <typename T, int NG>
__device__ __forceinline__ void fetch_row(const Ring<T>& ring, int stage, const T* x,
                                          const T* dy, long long row, long long rows,
                                          long long x_rs, int d, int first, int stride, int G) {
  if (row < rows) {
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      const int g = first + stride * i;
      if (g >= G) continue;
      const uint4* src[2] = {reinterpret_cast<const uint4*>(x + row * x_rs + g * kGroup),
                             reinterpret_cast<const uint4*>(dy + row * d + g * kGroup)};
#pragma unroll
      for (int which = 0; which < 2; ++which)
#pragma unroll
        for (int v = 0; v < Ring<T>::kVecs; ++v)
          cp_async16(ring.at(stage, i, which, v, NG), src[which] + v);
    }
  }
  cp_async_commit();
}

template <typename T, int NG>
__device__ __forceinline__ void ring_row(Group<T> (&xv)[NG], Group<T> (&gv)[NG],
                                         const Ring<T>& ring, int stage, int first, int stride,
                                         int G) {
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    if (first + stride * i >= G) continue;
#pragma unroll
    for (int v = 0; v < Ring<T>::kVecs; ++v) {
      reinterpret_cast<uint4*>(xv[i].v)[v] = *ring.at(stage, i, 0, v, NG);
      reinterpret_cast<uint4*>(gv[i].v)[v] = *ring.at(stage, i, 1, v, NG);
    }
  }
}

// The team route: grid (C, parts), CTAs of W warps, a cluster of the C CTAs
// of a team when CLUSTER.  NG: groups a thread (1 or 2).  `partial` is
// [parts, 8 G].  VEC: the rows come through the ring (kStages - 1 rows in
// flight behind the one being reduced; ring_bytes of dynamic shared memory),
// otherwise through registers (the next row in flight).  Registers: at most
// 96 a thread in bf16, so that 20 warps of teams fit an SM (the wrapper's
// partial count puts that many there).
template <typename T, bool VEC, int NG, bool CLUSTER>
__global__ void __launch_bounds__(sizeof(T) == 2 ? 640 : 512, 1)
    rmsnorm_bwd_team_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                            const void* __restrict__ w, bool w_bf16, T* __restrict__ dx,
                            float* __restrict__ partial, long long rows, int d, long long x_rs,
                            float eps, float offset) {
  extern __shared__ uint4 ring_smem[];
  __shared__ float red[2][2][kBwdTeamMaxWarps];   // [row parity][ss, gx][warp]
  constexpr int S = Ring<T>::kStages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, W = blockDim.x >> 5;
  const int C = gridDim.x, rank = blockIdx.x;
  const int nt = C * blockDim.x, u = rank * blockDim.x + tid;
  const long long parts = gridDim.y;
  const int G = (d + kGroup - 1) / kGroup;
  const Ring<T> ring{ring_smem, tid, static_cast<int>(blockDim.x)};
  Group<float> wf[NG], acc[NG];
  weights_and_zeros<T, VEC, NG>(wf, acc, w, w_bf16, u, nt, G, d, offset);
  long long r = blockIdx.y;
  Group<T> xv[NG], gv[NG];
  if constexpr (VEC) {
#pragma unroll
    for (int s = 0; s < S - 1; ++s)
      fetch_row<T, NG>(ring, s, x, dy, r + s * parts, rows, x_rs, d, u, nt, G);
  } else if (r < rows) {
    load_row<T, VEC, NG>(xv, gv, x + r * x_rs, dy + r * d, u, nt, G, d);
  }
  for (int k = 0; r < rows; r += parts, ++k) {
    const int par = k & 1;
    const long long next = r + parts;
    Group<T> xn[NG], gn[NG];
    if constexpr (VEC) {
      fetch_row<T, NG>(ring, (k + S - 1) % S, x, dy, r + (S - 1) * parts, rows, x_rs, d, u, nt,
                       G);
      cp_async_wait<S - 1>();
      ring_row<T, NG>(xv, gv, ring, k % S, u, nt, G);
    } else if (next < rows) {
      load_row<T, VEC, NG>(xn, gn, x + next * x_rs, dy + next * d, u, nt, G, d);
    }
    float ss, gx;
    thread_sums<T, NG>(xv, gv, wf, u, nt, G, ss, gx);
    ss = warp_total(ss);
    gx = warp_total(gx);
    if (lane == 0) {
      red[par][0][warp] = ss;
      red[par][1][warp] = gx;
    }
    // a warp writes row k + 2's sums into this buffer only after every
    // warp of the team has passed row k + 1's barrier, so after its reads
    ss = 0.f;
    gx = 0.f;
    if constexpr (CLUSTER) {
      cluster_sync();
      const uint32_t base = smem_u32(&red[par][0][0]);
      for (int c = 0; c < C; ++c) {
        const uint32_t at = map_rank(base, c);
        for (int j = 0; j < W; ++j) {
          ss = __fadd_rn(ss, ld_cluster(at + 4 * j));
          gx = __fadd_rn(gx, ld_cluster(at + 4 * (kBwdTeamMaxWarps + j)));
        }
      }
    } else {
      __syncthreads();
      for (int j = 0; j < W; ++j) {
        ss = __fadd_rn(ss, red[par][0][j]);
        gx = __fadd_rn(gx, red[par][1][j]);
      }
    }
    const float rs = inv_rms(ss, d, eps);
    row_grads<T, VEC, NG>(xv, gv, wf, acc, u, nt, G, d, rs, grad_scale(rs, gx, d), dx + r * d);
    if constexpr (!VEC) {
      if (next < rows) {
#pragma unroll
        for (int i = 0; i < NG; ++i) {
          xv[i] = xn[i];
          gv[i] = gn[i];
        }
      }
    }
  }
  // the dw pass may be scheduled now (it waits for this grid's end)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  // no CTA of the team leaves while another may still read its sums
  if constexpr (CLUSTER) cluster_sync();
  float* out = partial + static_cast<long long>(blockIdx.y) * G * kGroup;
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const int g = u + nt * i;
    if (g < G) *reinterpret_cast<Group<float>*>(out + g * kGroup) = acc[i];
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// dw, column quad by quad (4 columns): a CTA of 256 threads takes
// kDwQuads quads; thread t adds the partials s, s + kDwSlices, ... of quad
// t % kDwQuads in order (slice s = t / kDwQuads); a warp's 8 slices of a
// quad meet by the butterfly (xor 4, 8, 16: the slice's bits), then the
// CTA's 8 warps in order through shared memory; written in w's dtype.
__global__ void __launch_bounds__(kDwThreads)
    rmsnorm_dw_kernel(const float4* __restrict__ partial, int parts, int quads, int d,
                      void* __restrict__ dw, bool w_bf16) {
  __shared__ float4 warp_sums[kDwThreads / 32][kDwQuads];
  // launched as the row pass's programmatic dependent: its partials are
  // complete and visible after this wait
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int t = threadIdx.x, q = blockIdx.x * kDwQuads + t % kDwQuads;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (q < quads) {
    const int first = t / kDwQuads;
#pragma unroll 4
    for (int p = first; p < parts; p += kDwSlices) {
      const float4 v = partial[static_cast<long long>(p) * quads + q];
      s = p == first ? v : add4(s, v);
    }
  }
#pragma unroll
  for (int m = kDwQuads; m < 32; m <<= 1) {
    s.x = __fadd_rn(s.x, __shfl_xor_sync(0xffffffffu, s.x, m));
    s.y = __fadd_rn(s.y, __shfl_xor_sync(0xffffffffu, s.y, m));
    s.z = __fadd_rn(s.z, __shfl_xor_sync(0xffffffffu, s.z, m));
    s.w = __fadd_rn(s.w, __shfl_xor_sync(0xffffffffu, s.w, m));
  }
  if ((t & 31) < kDwQuads) warp_sums[t >> 5][t & 31] = s;
  __syncthreads();
  if (t >= kDwQuads || q >= quads) return;
  s = warp_sums[0][t];
#pragma unroll
  for (int k = 1; k < kDwThreads / 32; ++k) s = add4(s, warp_sums[k][t]);
  const float out[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int col = 4 * q + e;
    if (col >= d) break;
    if (w_bf16)
      static_cast<__nv_bfloat16*>(dw)[col] = __float2bfloat16_rn(out[e]);
    else
      static_cast<float*>(dw)[col] = out[e];
  }
}

struct BwdArgs {
  const void* x;
  const void* dy;
  const void* w;
  bool w_bf16;
  void* dx;
  void* dw;
  float* scratch;   // [parts, 8 G]: the dw partials
  long long rows;
  int d;
  long long x_rs;
  float eps, offset;
  int warps, cluster, parts;
  cudaStream_t s;
};

template <typename T, bool VEC, int NG>
cudaError_t launch_bwd_rows(const BwdArgs& a) {
  rmsnorm_bwd_rows_kernel<T, VEC, NG><<<a.parts, 32 * kBwdRowsWarps, 0, a.s>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.dy), a.w, a.w_bf16,
      static_cast<T*>(a.dx), a.scratch, a.rows, a.d, a.x_rs, a.eps, a.offset);
  return cudaGetLastError();
}

// The team kernel's ring takes up to 128 KB of dynamic shared memory (16
// warps): allowed, with the largest shared-memory carveout, once per instance.
template <typename T, bool VEC, int NG, bool CLUSTER>
cudaError_t allow_ring() {
  if constexpr (VEC) {
    auto kernel = rmsnorm_bwd_team_kernel<T, VEC, NG, CLUSTER>;
    static const cudaError_t set = [&] {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(ring_bytes<T, NG>(32 * kBwdTeamMaxWarps)));
      return e != cudaSuccess ? e
                              : cudaFuncSetAttribute(
                                    kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                    cudaSharedmemCarveoutMaxShared);
    }();
    return set;
  }
  return cudaSuccess;
}

template <typename T, bool VEC, int NG>
cudaError_t launch_bwd_team(const BwdArgs& a) {
  const T* x = static_cast<const T*>(a.x);
  const T* dy = static_cast<const T*>(a.dy);
  T* dx = static_cast<T*>(a.dx);
  const size_t smem = VEC ? ring_bytes<T, NG>(32 * a.warps) : 0;
  if (a.cluster == 1) {
    const cudaError_t set = allow_ring<T, VEC, NG, false>();
    if (set != cudaSuccess) return set;
    rmsnorm_bwd_team_kernel<T, VEC, NG, false><<<dim3(1, a.parts), 32 * a.warps, smem, a.s>>>(
        x, dy, a.w, a.w_bf16, dx, a.scratch, a.rows, a.d, a.x_rs, a.eps, a.offset);
    return cudaGetLastError();
  }
  const cudaError_t set = allow_ring<T, VEC, NG, true>();
  if (set != cudaSuccess) return set;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster, a.parts);
  cfg.blockDim = dim3(32 * a.warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, rmsnorm_bwd_team_kernel<T, VEC, NG, true>, x,
                                             dy, a.w, a.w_bf16, dx, a.scratch, a.rows, a.d,
                                             a.x_rs, a.eps, a.offset);
  return err != cudaSuccess ? err : cudaGetLastError();
}

cudaError_t launch_dw(const BwdArgs& a) {
  const int quads = 2 * ((a.d + kGroup - 1) / kGroup);
  // programmatic dependent launch: the dw pass's CTAs are scheduled as the
  // row pass's finish their rows, not after its grid has drained
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((quads + kDwQuads - 1) / kDwQuads);
  cfg.blockDim = dim3(kDwThreads);
  cfg.stream = a.s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, rmsnorm_dw_kernel, reinterpret_cast<const float4*>(a.scratch),
                         a.parts, quads, a.d, a.dw, a.w_bf16);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, bool VEC>
cudaError_t launch_bwd(const BwdArgs& a, int route) {
  const int G = (a.d + kGroup - 1) / kGroup;
  cudaError_t err = cudaErrorInvalidValue;
  if (route == kRows) {
    // the groups a lane holds; float32 takes twice the registers
    const int ng = pow2ceil((G + 31) / 32);
    constexpr int kMax = sizeof(T) == 2 ? 4 : 2;
    if (a.warps != kBwdRowsWarps || a.cluster != 1 || ng > kMax) return cudaErrorInvalidValue;
    if (ng == 1) err = launch_bwd_rows<T, VEC, 1>(a);
    else if (ng == 2) err = launch_bwd_rows<T, VEC, 2>(a);
    else if constexpr (kMax == 4) err = launch_bwd_rows<T, VEC, 4>(a);
  } else if (route == kTeam) {
    if (a.warps < 1 || a.warps > kBwdTeamMaxWarps || a.cluster < 1 ||
        a.cluster > kBwdMaxCluster)
      return cudaErrorInvalidValue;
    const int threads = 32 * a.warps * a.cluster;
    const int ng = (G + threads - 1) / threads;
    if (ng == 1) err = launch_bwd_team<T, VEC, 1>(a);
    else if (ng == 2) err = launch_bwd_team<T, VEC, 2>(a);
    else return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return launch_dw(a);
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
// contiguous of x_dtype; w [d] of w_dtype; dw [d] of w_dtype; scratch
// float32, parts x 8 ceil(d / 8); route 0 rows, 1 team,
// warps a CTA, cluster CTAs a team (1 on the rows route), parts the dw
// partials, 1..rows (the wrapper's plan, from (rows, d, dtype) alone).
int rt_rmsnorm_bwd(int x_dtype, int w_dtype, const void* x, const void* dy, const void* w,
                   void* dx, void* dw, void* scratch, long long rows, int d,
                   long long x_row_stride, float eps, float offset, int route, int warps,
                   int cluster, int parts, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  if ((x_dtype != kFloat32 && x_dtype != kBFloat16) ||
      (w_dtype != kFloat32 && w_dtype != kBFloat16) || parts < 1 || parts > rows ||
      parts > 65535 || d > 32 * 32 * kMaxTeamGroups * kGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{x, dy, w, w_dtype == kBFloat16, dx, dw, static_cast<float*>(scratch),
                  rows, d, x_row_stride, eps, offset, warps, cluster, parts,
                  static_cast<cudaStream_t>(stream)};
  const long long esize = x_dtype == kFloat32 ? 4 : 2;
  const bool vec = d % kGroup == 0 && (x_row_stride * esize) % 16 == 0 && aligned16(x) &&
                   aligned16(dy) && aligned16(dx) && aligned16(w);
  cudaError_t err;
  if (x_dtype == kFloat32)
    err = vec ? launch_bwd<float, true>(a, route) : launch_bwd<float, false>(a, route);
  else
    err = vec ? launch_bwd<__nv_bfloat16, true>(a, route)
              : launch_bwd<__nv_bfloat16, false>(a, route);
  return static_cast<int>(err);
}

}  // extern "C"
