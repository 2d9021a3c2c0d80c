// Hopper (sm_90a) kernels of the Faces halo path, with a plain C interface.
//
// They replace the Pallas kernels of src/repro/kernels/halo_pack.py:
//   halo_pack        <- halo_pack_call       (halo_pack.py:67)
//   halo_unpack_add  <- halo_unpack_add_call (halo_pack.py:84)
//   pack_segments    <- pack_segments_call   (halo_pack.py:163)
//   unpack_segments  <- unpack_segments_call (halo_pack.py:202)
//   pack_boundary        <- pack_boundary_call       (halo_pack.py:112)
//   unpack_boundary_add  <- unpack_boundary_add_call (halo_pack.py:134)
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
// sizes travel by value in a small argument table (pack_segments instead
// launches a flat list of 16-byte-a-thread tiles, below).  Nothing is
// allocated; every kernel runs on the caller's stream, and each entry point
// returns cudaGetLastError() so the Python wrapper raises on a refused launch.
//
// A bfloat16 add is done in float32 and rounded once (round to nearest
// even), as PyTorch's own elementwise add does, so kernel and plain version
// agree bit for bit.
//
// The boundary pair moves all regions of a block (the 26 faces, edges and
// corners, in DIRECTIONS order) to and from ONE buffer at static offsets,
// every rank in one launch: grid x over a region's elements, y = region,
// z = rank, the regions' boxes and offsets by value in a table.  The
// unpack's regions overlap (a face holds its edges and corners), and the
// reference adds them in region order, rounding to the block's dtype after
// each add.  A parallel scatter of the segments would race and reorder
// those adds, so each element of the union is OWNED by the thread of the
// first region that covers it: that thread walks the later regions that
// cover the element, in order, and adds each one's value, rounding after
// each add -- the reference's sequence, bit for bit, with no atomics.  A
// thread whose element an earlier region covers does nothing.  Bound:
// bytes (each region element read once and written once, ~0.8 MB a rank
// for a 128^3 float32 block), so launch latency at these sizes.

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

// pack_segments: member j of a fused transfer, columns [col_j, col_j + n_j)
// of every rank's row of a (ranks, W_j) source, goes to columns [off_j,
// off_j + n_j) of the (ranks, total) staging buffer.  The wrapper cuts each
// member's row into tiles of kTileBytes (one 16-byte access per thread) and
// lists them flat: member j owns CTAs [first_j, first_j + tiles_j * ranks),
// rank-major, and members without columns own none, so the grid is exactly
// sum_j ceil(n_j / tile) * ranks CTAs, none of them idle (a 128^2 float32
// face and eight edges and corners of 8 ranks: 192 CTAs, one wave; the old
// grid of max_size x members x ranks was 4608, 4030 of them empty).  A CTA
// finds its member by a binary search of `first` (uniform, in the parameter
// bank).  A member whose source address, row stride and staging column, and
// the staging row, keep 16-byte alignment copies 16 bytes a thread; any
// other (a corner, a relay at an odd column) copies element by element in
// the same kernel.  The copy moves raw 32- or 16-bit words, so it equals the
// plain version bit for bit whatever the values.
constexpr int kPackThreads = 256;
constexpr int kTileBytes = kPackThreads * 16;

struct PackMember {
  const void* src;  // the member's first column in rank 0's row
  int src_stride;   // elements between two ranks' rows
  int dst_col;      // the member's first column in the staging row
  int size;         // columns
  int tiles;        // tiles a rank
  int vec;          // 1: 16-byte accesses keep alignment
  int pad_;
};
// CAP: the members a launch can take; a transfer of up to 16 members takes
// the 16-member table, 576 bytes of parameters (64 members: 2304).
template <int CAP>
struct PackTable {
  int first[CAP];  // member j's first CTA, increasing
  PackMember m[CAP];
};

// E: a 32- or 16-bit word (float32 or bfloat16 bits).
template <typename E, int CAP>
__global__ void __launch_bounds__(kPackThreads)
    pack_segments_kernel(const __grid_constant__ PackTable<CAP> tab, int nseg,
                         E* __restrict__ out, int total) {
  constexpr int kTile = kTileBytes / sizeof(E);
  constexpr int V = 16 / sizeof(E);
  const int b = blockIdx.x;
  int lo = 0, hi = nseg - 1;  // the last member whose first CTA is <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.first[mid] <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  const PackMember& m = tab.m[lo];
  const int local = b - tab.first[lo];
  const int r = local / m.tiles;
  const int begin = (local - r * m.tiles) * kTile;
  const int end = min(begin + kTile, m.size);
  const E* src = static_cast<const E*>(m.src) + static_cast<int64_t>(r) * m.src_stride;
  E* dst = out + static_cast<int64_t>(r) * total + m.dst_col;
  if (m.vec) {
    const int i = begin + static_cast<int>(threadIdx.x) * V;
    if (i + V <= end) {
      *reinterpret_cast<uint4*>(dst + i) = __ldg(reinterpret_cast<const uint4*>(src + i));
    } else {
      for (int e = i; e < end; ++e) dst[e] = src[e];
    }
  } else {
    for (int i = begin + static_cast<int>(threadIdx.x); i < end; i += kPackThreads)
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

// Region j of a boundary buffer: the box [x0, x0+rx) x [y0, y0+ry) x
// [z0, z0+rz) of a (px, py, pz) block, at element offset `off` of the
// rank's buffer.
struct Region {
  int x0, y0, z0, rx, ry, rz, off, size;
};
struct RegionTable {
  Region r[kMaxSegments];
};

__device__ __forceinline__ bool covers(const Region& g, int x, int y, int z) {
  return x >= g.x0 && x < g.x0 + g.rx && y >= g.y0 && y < g.y0 + g.ry && z >= g.z0 &&
         z < g.z0 + g.rz;
}

// grid: x over region y's elements, y = region, z = rank.
template <typename T>
__global__ void pack_boundary_kernel(const T* __restrict__ u, T* __restrict__ out,
                                     RegionTable tab, int px, int py, int pz, int total) {
  const Region& g = tab.r[blockIdx.y];
  const int64_t rank = blockIdx.z;
  const T* blk = u + rank * static_cast<int64_t>(px) * py * pz;
  T* dst = out + rank * static_cast<int64_t>(total) + g.off;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < g.size; i += gridDim.x * blockDim.x) {
    const int c = i % g.rz;
    const int e = i / g.rz;
    const int y = e % g.ry;
    const int x = e / g.ry;
    dst[i] = blk[(static_cast<int64_t>(g.x0 + x) * py + (g.y0 + y)) * pz + (g.z0 + c)];
  }
}

template <typename T>
__global__ void unpack_boundary_add_kernel(T* __restrict__ u, const T* __restrict__ buf,
                                           RegionTable tab, int nreg, int px, int py, int pz,
                                           int total) {
  const int j0 = blockIdx.y;
  const Region& g = tab.r[j0];
  const int64_t rank = blockIdx.z;
  T* blk = u + rank * static_cast<int64_t>(px) * py * pz;
  const T* src = buf + rank * static_cast<int64_t>(total);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < g.size; i += gridDim.x * blockDim.x) {
    const int z = g.z0 + i % g.rz;
    const int e = i / g.rz;
    const int y = g.y0 + e % g.ry;
    const int x = g.x0 + e / g.ry;
    bool owned = true;
    for (int j = 0; j < j0; ++j) owned = owned && !covers(tab.r[j], x, y, z);
    if (!owned) continue;  // an earlier region's thread adds this element
    const int64_t o = (static_cast<int64_t>(x) * py + y) * pz + z;
    T acc = blk[o];
    for (int j = j0; j < nreg; ++j) {
      const Region& h = tab.r[j];
      if (!covers(h, x, y, z)) continue;
      const int li = ((x - h.x0) * h.ry + (y - h.y0)) * h.rz + (z - h.z0);
      acc = from_float<T>(to_float(acc) + to_float(src[h.off + li]));
    }
    blk[o] = acc;
  }
}

// pack_segments' launch with a table of CAP members (the wrapper's plan; see
// rt_pack_segments).
template <int CAP>
int pack_launch(int dtype, const long long* table, int nseg, void* out, long long n_ctas,
                long long total, void* stream) {
  constexpr long long kMax = 0x7fffffffLL;
  if ((dtype != kFloat32 && dtype != kBFloat16) || nseg < 1 || nseg > CAP || n_ctas < 1 ||
      n_ctas > kMax || total > kMax)
    return static_cast<int>(cudaErrorInvalidValue);
  PackTable<CAP> tab{};
  for (int j = 0; j < nseg; ++j) {
    const long long* row = table + 7 * j;
    for (int f = 1; f < 7; ++f)
      if (row[f] < 0 || row[f] > kMax) return static_cast<int>(cudaErrorInvalidValue);
    if (row[4] < 1 || row[5] >= n_ctas || (j > 0 && row[5] <= tab.first[j - 1]))
      return static_cast<int>(cudaErrorInvalidValue);
    tab.first[j] = static_cast<int>(row[5]);
    tab.m[j] = PackMember{reinterpret_cast<const void*>(row[0]), static_cast<int>(row[1]),
                          static_cast<int>(row[2]), static_cast<int>(row[3]),
                          static_cast<int>(row[4]), row[6] != 0, 0};
  }
  const unsigned grid = static_cast<unsigned>(n_ctas);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    pack_segments_kernel<uint32_t, CAP><<<grid, kPackThreads, 0, s>>>(
        tab, nseg, static_cast<uint32_t*>(out), static_cast<int>(total));
  else
    pack_segments_kernel<uint16_t, CAP><<<grid, kPackThreads, 0, s>>>(
        tab, nseg, static_cast<uint16_t*>(out), static_cast<int>(total));
  return static_cast<int>(cudaGetLastError());
}

int blocks_for(int64_t n) {
  return static_cast<int>(std::min(std::max((n + kThreads - 1) / kThreads, int64_t{1}),
                                   kMaxBlocks));
}

bool valid_grid(int nseg, long long n_ranks) {
  return nseg >= 1 && nseg <= kMaxSegments && n_ranks >= 1 && n_ranks <= 65535;
}

// table: nreg rows of (x0, y0, z0, rx, ry, rz, offset, size); every box
// lies inside the (px, py, pz) block and the offsets are consecutive.
int boundary_launch(bool unpack, int dtype, void* u, void* buf, long long n_ranks, int px,
                    int py, int pz, const int* table, int nreg, int total, void* stream) {
  if (!valid_grid(nreg, n_ranks)) return static_cast<int>(cudaErrorInvalidValue);
  RegionTable tab{};
  int max_size = 0;
  for (int j = 0; j < nreg; ++j) {
    const int* row = table + 8 * j;
    tab.r[j] = Region{row[0], row[1], row[2], row[3], row[4], row[5], row[6], row[7]};
    max_size = std::max(max_size, row[7]);
  }
  if (max_size == 0) return 0;
  const dim3 grid(std::min((max_size + kThreads - 1) / kThreads, 1024), nreg,
                  static_cast<unsigned>(n_ranks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      if (unpack)
        unpack_boundary_add_kernel<float><<<grid, kThreads, 0, s>>>(
            static_cast<float*>(u), static_cast<const float*>(buf), tab, nreg, px, py, pz, total);
      else
        pack_boundary_kernel<float><<<grid, kThreads, 0, s>>>(
            static_cast<const float*>(u), static_cast<float*>(buf), tab, px, py, pz, total);
      break;
    case kBFloat16:
      if (unpack)
        unpack_boundary_add_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
            static_cast<__nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(buf), tab, nreg,
            px, py, pz, total);
      else
        pack_boundary_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(u), static_cast<__nv_bfloat16*>(buf), tab, px,
            py, pz, total);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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

// table: nseg rows of (source address of the member's first column, source
// row stride, staging column, size, tiles a rank, first CTA, vector flag),
// int64 each: the wrapper's plan, every member with columns, first CTAs
// increasing; n_ctas: the CTAs of the flat tile list.
int rt_pack_segments(int dtype, const long long* table, int nseg, void* out,
                     long long n_ctas, long long total, void* stream) {
  if (nseg > 16) return pack_launch<kMaxSegments>(dtype, table, nseg, out, n_ctas, total, stream);
  return pack_launch<16>(dtype, table, nseg, out, n_ctas, total, stream);
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

int rt_pack_boundary(int dtype, const void* u, void* out, long long n_ranks, int px, int py,
                     int pz, const int* table, int nreg, int total, void* stream) {
  return boundary_launch(false, dtype, const_cast<void*>(u), out, n_ranks, px, py, pz, table,
                         nreg, total, stream);
}

int rt_unpack_boundary_add(int dtype, void* u, const void* buf, long long n_ranks, int px,
                           int py, int pz, const int* table, int nreg, int total,
                           void* stream) {
  return boundary_launch(true, dtype, u, const_cast<void*>(buf), n_ranks, px, py, pz, table,
                         nreg, total, stream);
}

}  // extern "C"
