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
// strided copy (plus one float add for the unpacks) at static offsets, so it
// is bound by the bytes it moves -- each element read once and written once
// against 3.35 TB/s on an H100 SXM -- or, where a region is strided in the
// block, by the 32-byte sectors it touches (a z-face touches one sector per
// 4-byte element); and, at Faces slab sizes (a 128^2 face is 64 KiB a rank),
// by launch latency of a few microseconds.  Every kernel makes ONE launch
// for all ranks and, for the segment and boundary kernels, all members or
// regions of a call, whose offsets and sizes travel by value in a small
// argument table.  unpack_segments and unpack_boundary_add take one thread
// per element over a grid-stride loop.  pack_segments launches a flat list of
// 16-byte-a-thread tiles over columns, and halo_pack, halo_unpack_add and
// pack_boundary a flat list of such tiles over boxes (below).  Nothing is
// allocated; every kernel runs on the caller's stream, and each entry point
// returns cudaGetLastError() so the Python wrapper raises on a refused launch.
//
// A bfloat16 add is done in float32 and rounded once (round to nearest
// even), as PyTorch's own elementwise add does, so kernel and plain version
// agree bit for bit.
//
// The boundary pair moves all regions of a block (the 26 faces, edges and
// corners, in DIRECTIONS order) to and from ONE buffer at static offsets,
// every rank in one launch.  The pack is a box launch (below).  The
// unpack's grid is x over a region's elements, y = region, z = rank, the
// regions' boxes and offsets by value in a table.  Its regions overlap (a
// face holds its edges and corners), and the reference adds them in region
// order, rounding to the block's dtype after each add.  A parallel scatter
// of the segments would race and reorder those adds, so each element of the
// union is OWNED by the thread of the first region that covers it: that
// thread walks the later regions that cover the element, in order, and adds
// each one's value, rounding after each add -- the reference's sequence, bit
// for bit, with no atomics.  A thread whose element an earlier region covers
// does nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSegments = 64;  // members of one fused transfer

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

// Box launches (halo_pack, halo_unpack_add, pack_boundary): a region of
// every rank's block and its packed copy (the slab, msg, or the region's
// segment of the boundary buffer), planned by the wrapper (kernels/halo_pack.py: box_plan,
// boundary_plan).  The region's box is in (outer, run) form: element c of
// run b of slab a lies at base + a * slab_stride + b * run_stride + c of a
// rank's block, and at (a * runs + b) * run + c of the rank's packed copy.
// The plan merges dimensions wherever the box is contiguous (an x-face is
// one run of py * pz; a y-face px runs of pz; a z-face, the edges along x
// and y and the corners runs of 1 at a stride).  Each slab is cut into
// tiles of kTileBytes and listed flat: the grid is (CTAs a rank, ranks), and
// CTA k of a row is tile k % tiles of slab k / tiles, so the grid is exactly
// the tile count and no CTA is idle (the old grids gave one thread per
// element, or max region x regions x ranks CTAs: 13 312 for the 26 regions
// of a 128^3 block of 8 ranks, 3 232 of them with elements; now 116 x 8 =
// 928, all with elements).  A CTA decodes its slab and tile once (a division
// only for a box of several slabs, which no Faces region is); an element's
// run comes from the plan's multiplier for `run` (one 64-bit multiply and a
// shift): no division by a runtime value on the path of the Faces regions,
// none per element.  A tile is 256 threads x 16 bytes.  Where both flags
// hold (kPackedVec: the packed side keeps 16-byte alignment; kBoxVec: so
// does the box side, and runs are whole 16-byte words -- x- and y-faces,
// edges along z), a thread moves 16 consecutive bytes with one load and one
// store on each side.  Elsewhere:
//   - halo_unpack_add gives a thread the elements start + threadIdx.x +
//     e * 256 (e < V), coalesced on msg, and issues all of its loads of msg
//     and u before the first add: on a z-face, V independent sector loads
//     of u in flight a thread;
//   - halo_pack and pack_boundary (one gather, gather_tile) give a thread V
//     consecutive packed elements, gather them with V independent loads
//     and store them with one 16-byte store where kPackedVec holds (a
//     z-face, edges along x and y).  halo_pack is pack_boundary with one
//     region, whose slab is the whole packed row: the same tiles, without
//     the table search.
// All take raw 32- or 16-bit words, so a copy is exact whatever the values.
constexpr int kPackedVec = 1;
constexpr int kBoxVec = 2;

struct BoxRow {
  int base;            // the box's first element in a rank's block
  int run;             // contiguous elements of a run
  int runs;            // runs a slab
  int run_stride;      // elements between two runs in the block
  int slabs;           // slabs a rank
  int slab_stride;     // elements between two slabs in the block
  int offset;          // the box's first element in a rank's packed row
  int tiles;           // tiles a slab
  int flags;           // kPackedVec | kBoxVec
  unsigned run_magic;  // p / run == (p * run_magic) >> run_shift, p < 2^31
  int run_shift;
};
constexpr int kBoxFields = 11;

// A CTA's tile: the first element of its slab in the block and in the
// packed buffer, the tile's first packed element in the slab, and the
// slab's packed elements.
struct Tile {
  int64_t box, packed;
  int start, n;
};

template <int V>
__device__ __forceinline__ Tile tile_of(const BoxRow& g, int local, int block,
                                        int packed_stride) {
  const int rank = blockIdx.y;
  int a = 0;
  if (g.slabs > 1) {
    a = local / g.tiles;
    local -= a * g.tiles;
  }
  Tile t;
  t.n = g.runs * g.run;
  t.box = static_cast<int64_t>(rank) * block + g.base + a * g.slab_stride;
  t.packed = static_cast<int64_t>(rank) * packed_stride + g.offset + a * t.n;
  t.start = local * (kTileBytes / 16 * V);
  return t;
}

// Packed element p of a slab, in the block (from the slab's first element):
// its run by the plan's multiplier, then its column.
__device__ __forceinline__ int box_index(const BoxRow& g, int p) {
  const int b = static_cast<int>((static_cast<uint64_t>(p) * g.run_magic) >> g.run_shift);
  return b * g.run_stride + (p - b * g.run);
}

// V raw words (float32 or bfloat16 bits) as one 16-byte access.
template <typename E>
constexpr int kVec = 16 / sizeof(E);
template <typename E>
union Words {
  uint4 v;
  E e[kVec<E>];
};

// a + b on raw words: float32, or bfloat16 added in float32 and rounded once.
__device__ __forceinline__ uint32_t add_words(uint32_t a, uint32_t b) {
  return __float_as_uint(__fadd_rn(__uint_as_float(a), __uint_as_float(b)));
}
__device__ __forceinline__ uint16_t add_words(uint16_t a, uint16_t b) {
  const float x = __fadd_rn(__bfloat162float(__ushort_as_bfloat16(a)),
                            __bfloat162float(__ushort_as_bfloat16(b)));
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

constexpr int kBothVec = kPackedVec | kBoxVec;

// u[region] += msg, msg a (ranks, *region) slab of msg_stride elements a rank.
template <typename E>
__global__ void __launch_bounds__(kPackThreads)
    halo_unpack_add_kernel(E* __restrict__ u, const E* __restrict__ msg, const BoxRow g,
                           int block, int msg_stride) {
  constexpr int V = kVec<E>;
  const Tile t = tile_of<V>(g, blockIdx.x, block, msg_stride);
  if (g.flags == kBothVec) {  // 16 bytes a thread on both sides (n % V == 0)
    const int p = t.start + static_cast<int>(threadIdx.x) * V;
    if (p >= t.n) return;
    uint4* x = reinterpret_cast<uint4*>(u + t.box + box_index(g, p));
    Words<E> a, b;
    b.v = __ldg(reinterpret_cast<const uint4*>(msg + t.packed + p));
    a.v = *x;
#pragma unroll
    for (int e = 0; e < V; ++e) a.e[e] = add_words(a.e[e], b.e[e]);
    *x = a.v;
    return;
  }
  // element by element: element e of a thread is packed element start +
  // threadIdx.x + e * kPackThreads (coalesced on the packed side); every
  // load issued before the first add
  int o[V];
  E x[V] = {}, m[V] = {};
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int p = t.start + static_cast<int>(threadIdx.x) + e * kPackThreads;
    o[e] = p < t.n ? box_index(g, p) : -1;
    if (o[e] >= 0) {
      m[e] = __ldg(msg + t.packed + p);
      x[e] = u[t.box + o[e]];
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e)
    if (o[e] >= 0) u[t.box + o[e]] = add_words(x[e], m[e]);
}

// The gather of a box tile, shared by halo_pack and pack_boundary: a thread
// takes V consecutive packed elements of the tile.  Where both flags hold
// (x- and y-faces, edges along z) it moves them as 16 bytes with one load
// and one store; elsewhere it gathers them with V independent loads and
// stores them with one 16-byte store where the packed row keeps alignment
// (a z-face, the edges along x and y), element by element otherwise.
template <typename E>
__device__ __forceinline__ void gather_tile(const BoxRow& g, const Tile& t,
                                            const E* __restrict__ u, E* __restrict__ out) {
  constexpr int V = kVec<E>;
  const int p = t.start + static_cast<int>(threadIdx.x) * V;
  if (p >= t.n) return;
  if (g.flags == kBothVec) {  // 16 bytes a thread on both sides (n % V == 0)
    *reinterpret_cast<uint4*>(out + t.packed + p) =
        __ldg(reinterpret_cast<const uint4*>(u + t.box + box_index(g, p)));
    return;
  }
  const int count = min(V, t.n - p);
  Words<E> w{};
#pragma unroll
  for (int e = 0; e < V; ++e)
    if (e < count) w.e[e] = __ldg(u + t.box + box_index(g, p + e));
  E* dst = out + t.packed + p;
  if (count == V && (g.flags & kPackedVec)) {
    *reinterpret_cast<uint4*>(dst) = w.v;
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e)
      if (e < count) dst[e] = w.e[e];
  }
}

// out = u[region], out a (ranks, *region) slab of out_stride elements a rank.
template <typename E>
__global__ void __launch_bounds__(kPackThreads)
    halo_pack_kernel(const E* __restrict__ u, E* __restrict__ out, const BoxRow g, int block,
                     int out_stride) {
  gather_tile(g, tile_of<kVec<E>>(g, blockIdx.x, block, out_stride), u, out);
}

// pack_boundary: the rows of the regions with elements, first CTAs
// increasing; a CTA finds its row by a binary search of `first` (uniform, in
// the parameter bank).  CAP: the rows a launch can take (32: 1 536 bytes of
// parameters; 64: 3 072).
template <int CAP>
struct BoxTable {
  int first[CAP];
  BoxRow g[CAP];
};

template <typename E, int CAP>
__global__ void __launch_bounds__(kPackThreads)
    pack_boundary_kernel(const __grid_constant__ BoxTable<CAP> tab, int nrows,
                         const E* __restrict__ u, E* __restrict__ out, int block, int total) {
  const int k = blockIdx.x;
  int lo = 0, hi = nrows - 1;  // the last row whose first CTA is <= k
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.first[mid] <= k)
      lo = mid;
    else
      hi = mid - 1;
  }
  const BoxRow& g = tab.g[lo];
  gather_tile(g, tile_of<kVec<E>>(g, k - tab.first[lo], block, total), u, out);
}

// A row of the wrapper's plan, checked: every field in range, the counts
// positive.
bool read_row(const long long* row, BoxRow& g) {
  for (int f = 0; f < kBoxFields; ++f)
    if (row[f] < 0 || row[f] > (f == 9 ? 0xffffffffLL : 0x7fffffffLL)) return false;
  g = BoxRow{static_cast<int>(row[0]), static_cast<int>(row[1]), static_cast<int>(row[2]),
             static_cast<int>(row[3]), static_cast<int>(row[4]), static_cast<int>(row[5]),
             static_cast<int>(row[6]), static_cast<int>(row[7]), static_cast<int>(row[8]),
             static_cast<unsigned>(row[9]), static_cast<int>(row[10])};
  return g.run >= 1 && g.runs >= 1 && g.slabs >= 1 && g.tiles >= 1 && g.flags <= 3 &&
         g.run_shift >= 31 && g.run_shift <= 62;
}

template <int CAP>
int pack_boundary_launch(int dtype, const void* u, void* out, const long long* table,
                         int nrows, int block, int total, int n_ctas, int n_ranks,
                         void* stream) {
  if ((dtype != kFloat32 && dtype != kBFloat16) || nrows < 1 || nrows > CAP || n_ctas < 1 ||
      n_ranks < 1 || n_ranks > 65535 || block < 1 || total < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  BoxTable<CAP> tab{};
  for (int j = 0; j < nrows; ++j) {
    const long long* row = table + (kBoxFields + 1) * j;
    if (!read_row(row + 1, tab.g[j]) || row[0] < 0 || row[0] >= n_ctas ||
        (j > 0 && row[0] <= tab.first[j - 1]) || (j == 0 && row[0] != 0))
      return static_cast<int>(cudaErrorInvalidValue);
    tab.first[j] = static_cast<int>(row[0]);
  }
  const dim3 grid(static_cast<unsigned>(n_ctas), static_cast<unsigned>(n_ranks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    pack_boundary_kernel<uint32_t, CAP><<<grid, kPackThreads, 0, s>>>(
        tab, nrows, static_cast<const uint32_t*>(u), static_cast<uint32_t*>(out), block, total);
  else
    pack_boundary_kernel<uint16_t, CAP><<<grid, kPackThreads, 0, s>>>(
        tab, nrows, static_cast<const uint16_t*>(u), static_cast<uint16_t*>(out), block, total);
  return static_cast<int>(cudaGetLastError());
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

bool valid_grid(int nseg, long long n_ranks) {
  return nseg >= 1 && nseg <= kMaxSegments && n_ranks >= 1 && n_ranks <= 65535;
}

// table: nreg rows of (x0, y0, z0, rx, ry, rz, offset, size); every box
// lies inside the (px, py, pz) block and the offsets are consecutive.
int unpack_boundary_launch(int dtype, void* u, const void* buf, long long n_ranks, int px,
                           int py, int pz, const int* table, int nreg, int total,
                           void* stream) {
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
      unpack_boundary_add_kernel<float><<<grid, kThreads, 0, s>>>(
          static_cast<float*>(u), static_cast<const float*>(buf), tab, nreg, px, py, pz, total);
      break;
    case kBFloat16:
      unpack_boundary_add_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          static_cast<__nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(buf), tab, nreg,
          px, py, pz, total);
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

// row: the wrapper's box plan (base, run, runs, run_stride, slabs,
// slab_stride, offset 0, tiles, flags, run_magic, run_shift), int64 each;
// block: elements of a rank's block; out_stride: elements of a rank's slab;
// n_ctas: tiles x slabs, the CTAs a rank.
int rt_halo_pack(int dtype, const void* u, void* out, const long long* row, int block,
                 int out_stride, int n_ctas, int n_ranks, void* stream) {
  BoxRow g;
  if (!read_row(row, g) || n_ctas < 1 || n_ranks < 1 || n_ranks > 65535 || block < 1 ||
      out_stride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_ctas), static_cast<unsigned>(n_ranks));
  switch (dtype) {
    case kFloat32:
      halo_pack_kernel<uint32_t><<<grid, kPackThreads, 0, s>>>(
          static_cast<const uint32_t*>(u), static_cast<uint32_t*>(out), g, block, out_stride);
      break;
    case kBFloat16:
      halo_pack_kernel<uint16_t><<<grid, kPackThreads, 0, s>>>(
          static_cast<const uint16_t*>(u), static_cast<uint16_t*>(out), g, block, out_stride);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// row: the wrapper's box plan (base, run, runs, run_stride, slabs,
// slab_stride, offset 0, tiles, flags, run_magic, run_shift), int64 each;
// block: elements of a rank's block; msg_stride: elements of a rank's slab;
// n_ctas: tiles x slabs, the CTAs a rank.
int rt_halo_unpack_add(int dtype, void* u, const void* msg, const long long* row, int block,
                       int msg_stride, int n_ctas, int n_ranks, void* stream) {
  BoxRow g;
  if (!read_row(row, g) || n_ctas < 1 || n_ranks < 1 || n_ranks > 65535 || block < 1 ||
      msg_stride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(n_ctas), static_cast<unsigned>(n_ranks));
  switch (dtype) {
    case kFloat32:
      halo_unpack_add_kernel<uint32_t><<<grid, kPackThreads, 0, s>>>(
          static_cast<uint32_t*>(u), static_cast<const uint32_t*>(msg), g, block, msg_stride);
      break;
    case kBFloat16:
      halo_unpack_add_kernel<uint16_t><<<grid, kPackThreads, 0, s>>>(
          static_cast<uint16_t*>(u), static_cast<const uint16_t*>(msg), g, block, msg_stride);
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

// table: nrows rows of (first CTA, *box row), int64 each, of the wrapper's
// boundary plan, the regions with elements, first CTAs increasing from 0;
// block: elements of a rank's block; total: of a rank's packed row; n_ctas:
// the CTAs a rank.
int rt_pack_boundary(int dtype, const void* u, void* out, const long long* table, int nrows,
                     int block, int total, int n_ctas, int n_ranks, void* stream) {
  if (nrows > 32)
    return pack_boundary_launch<kMaxSegments>(dtype, u, out, table, nrows, block, total,
                                              n_ctas, n_ranks, stream);
  return pack_boundary_launch<32>(dtype, u, out, table, nrows, block, total, n_ctas, n_ranks,
                                  stream);
}

int rt_unpack_boundary_add(int dtype, void* u, const void* buf, long long n_ranks, int px,
                           int py, int pz, const int* table, int nreg, int total,
                           void* stream) {
  return unpack_boundary_launch(dtype, u, buf, n_ranks, px, py, pz, table, nreg, total,
                                stream);
}

}  // extern "C"
