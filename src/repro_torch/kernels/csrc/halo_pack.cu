// Hopper (sm_90a) kernels of the Faces halo path, with a plain C interface.
//
// They replace the Pallas kernels of src/repro/kernels/halo_pack.py:
//   halo_pack        <- halo_pack_call       (halo_pack.py:67)
//   halo_unpack_add  <- halo_unpack_add_call (halo_pack.py:84)
//   pack_segments    <- pack_segments_call   (halo_pack.py:163)
//   unpack_segments  <- unpack_segments_call (halo_pack.py:202)
//
// One GPU holds every rank: each launch covers all ranks of a buffer laid
// out as (ranks..., px, py, pz) or (ranks, columns).  Each kernel is a
// strided copy (plus one float add for the unpack) at static offsets, so it
// is bound by the bytes it moves -- each element read once and written once
// against 3.35 TB/s on an H100 SXM -- and, at Faces slab sizes (a 128^2 face
// is 64 KiB a rank), by launch latency of a few microseconds.  The design
// answers both simply: one thread per element with the fastest index along
// pz (coalesced), a grid-stride loop, and ONE launch for all ranks and, for
// the segment kernels, all members of a fused transfer, whose offsets and
// sizes travel by value in a small argument table.  Nothing is allocated;
// every kernel runs on the caller's stream, and each entry point returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.
//
// A bfloat16 add is done in float32 and rounded once (round to nearest
// even), as PyTorch's own elementwise add does, so kernel and plain version
// agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegments = 64;  // members of one fused transfer
constexpr int64_t kMaxBlocks = 1 << 16;

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

// A static region [x0, x0+rx) x [y0, y0+ry) x [z0, z0+rz) of a (px, py, pz)
// block; the same region on every rank.
struct Box {
  int px, py, pz;
  int x0, y0, z0;
  int rx, ry, rz;
};

// Element offset in the (ranks, px, py, pz) block of the i-th element of the
// packed (ranks, rx, ry, rz) region.
__device__ __forceinline__ int64_t box_offset(const Box& b, int64_t i) {
  const int64_t slab = static_cast<int64_t>(b.rx) * b.ry * b.rz;
  const int64_t block = static_cast<int64_t>(b.px) * b.py * b.pz;
  const int64_t r = i / slab;
  int64_t e = i - r * slab;
  const int64_t c = e % b.rz;
  e /= b.rz;
  const int64_t y = e % b.ry;
  const int64_t x = e / b.ry;
  return r * block + ((b.x0 + x) * b.py + (b.y0 + y)) * b.pz + (b.z0 + c);
}

template <typename T>
__global__ void halo_pack_kernel(const T* __restrict__ u, T* __restrict__ out,
                                 int64_t n, Box b) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    out[i] = u[box_offset(b, i)];
  }
}

template <typename T>
__global__ void halo_unpack_add_kernel(T* __restrict__ u, const T* __restrict__ msg,
                                       int64_t n, Box b) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t o = box_offset(b, i);
    u[o] = from_float<T>(to_float(u[o]) + to_float(msg[i]));
  }
}

// Member j of a fused transfer: columns [src_col, src_col + size) of every
// row of a (ranks, src_stride) source go to columns [dst_col, dst_col + size)
// of the (ranks, total) staging buffer.
struct PackSeg {
  const void* src;
  int64_t src_stride;
  int64_t src_col;
  int64_t dst_col;
  int64_t size;
};
struct PackTable {
  PackSeg seg[kMaxSegments];
};

// grid: x over a member's columns, y = member, z = rank.
template <typename T>
__global__ void pack_segments_kernel(PackTable tab, T* __restrict__ out, int64_t total) {
  const PackSeg& s = tab.seg[blockIdx.y];
  const int64_t r = blockIdx.z;
  const T* src = static_cast<const T*>(s.src) + r * s.src_stride + s.src_col;
  T* dst = out + r * total + s.dst_col;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < s.size; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    dst[i] = src[i];
  }
}

// Member j of a received buffer: columns [src_col, src_col + size) of every
// row go to the contiguous (ranks, size) slab dst, for the ranks whose mask
// byte is set (all ranks when mask is null).
struct UnpackSeg {
  void* dst;
  int64_t src_col;
  int64_t size;
};
struct UnpackTable {
  UnpackSeg seg[kMaxSegments];
};

template <typename T>
__global__ void unpack_segments_kernel(const T* __restrict__ buf, int64_t total,
                                       UnpackTable tab, const uint8_t* __restrict__ mask,
                                       int64_t n_ranks) {
  const int64_t r = blockIdx.z;
  if (mask != nullptr && !mask[blockIdx.y * n_ranks + r]) return;
  const UnpackSeg& s = tab.seg[blockIdx.y];
  const T* src = buf + r * total + s.src_col;
  T* dst = static_cast<T*>(s.dst) + r * s.size;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < s.size; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    dst[i] = src[i];
  }
}

int blocks_for(int64_t n) {
  return static_cast<int>(std::min(std::max((n + kThreads - 1) / kThreads, int64_t{1}),
                                   kMaxBlocks));
}

bool valid_grid(int nseg, long long n_ranks) {
  return nseg >= 1 && nseg <= kMaxSegments && n_ranks >= 1 && n_ranks <= 65535;
}

}  // namespace

extern "C" {

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int rt_halo_pack(int dtype, const void* u, void* out, long long n_ranks, int px, int py,
                 int pz, int x0, int y0, int z0, int rx, int ry, int rz, void* stream) {
  const Box b{px, py, pz, x0, y0, z0, rx, ry, rz};
  const int64_t n = static_cast<int64_t>(n_ranks) * rx * ry * rz;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      halo_pack_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
          static_cast<const float*>(u), static_cast<float*>(out), n, b);
      break;
    case kBFloat16:
      halo_pack_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(u), static_cast<__nv_bfloat16*>(out), n, b);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int rt_halo_unpack_add(int dtype, void* u, const void* msg, long long n_ranks, int px,
                       int py, int pz, int x0, int y0, int z0, int rx, int ry, int rz,
                       void* stream) {
  const Box b{px, py, pz, x0, y0, z0, rx, ry, rz};
  const int64_t n = static_cast<int64_t>(n_ranks) * rx * ry * rz;
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      halo_unpack_add_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
          static_cast<float*>(u), static_cast<const float*>(msg), n, b);
      break;
    case kBFloat16:
      halo_unpack_add_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
          static_cast<__nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(msg), n, b);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// table: nseg rows of (src pointer, src row stride, src column, dst column,
// size), all in elements.
int rt_pack_segments(int dtype, const long long* table, int nseg, void* out,
                     long long n_ranks, long long total, void* stream) {
  if (!valid_grid(nseg, n_ranks)) return static_cast<int>(cudaErrorInvalidValue);
  PackTable tab{};
  int64_t max_size = 0;
  for (int j = 0; j < nseg; ++j) {
    const long long* row = table + 5 * j;
    tab.seg[j] = PackSeg{reinterpret_cast<const void*>(row[0]), row[1], row[2], row[3], row[4]};
    max_size = std::max<int64_t>(max_size, row[4]);
  }
  if (max_size == 0) return 0;
  const dim3 grid(std::min<int64_t>((max_size + kThreads - 1) / kThreads, 1024), nseg,
                  static_cast<unsigned>(n_ranks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      pack_segments_kernel<float><<<grid, kThreads, 0, s>>>(tab, static_cast<float*>(out), total);
      break;
    case kBFloat16:
      pack_segments_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          tab, static_cast<__nv_bfloat16*>(out), total);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// table: nseg rows of (dst pointer, src column, size); mask: nseg x n_ranks
// bytes on the device, or null.
int rt_unpack_segments(int dtype, const void* buf, long long n_ranks, long long total,
                       const long long* table, int nseg, const void* mask, void* stream) {
  if (!valid_grid(nseg, n_ranks)) return static_cast<int>(cudaErrorInvalidValue);
  UnpackTable tab{};
  int64_t max_size = 0;
  for (int j = 0; j < nseg; ++j) {
    const long long* row = table + 3 * j;
    tab.seg[j] = UnpackSeg{reinterpret_cast<void*>(row[0]), row[1], row[2]};
    max_size = std::max<int64_t>(max_size, row[2]);
  }
  if (max_size == 0) return 0;
  const dim3 grid(std::min<int64_t>((max_size + kThreads - 1) / kThreads, 1024), nseg,
                  static_cast<unsigned>(n_ranks));
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      unpack_segments_kernel<float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(buf), total, tab, m, n_ranks);
      break;
    case kBFloat16:
      unpack_segments_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(buf), total, tab, m, n_ranks);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
