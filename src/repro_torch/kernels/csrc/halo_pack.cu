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
// argument table.  Every kernel launches a flat list of tiles planned on the
// host (kernels/halo_pack.py), 256 threads x 16 bytes a tile, with no idle
// CTA: pack_segments and unpack_segments over the columns of each member
// (segment_tiles), halo_pack, halo_unpack_add and pack_boundary over boxes
// (box_plan), unpack_boundary_add over the ordered cells of its regions
// (unpack_boundary_plan).  A CTA finds its row by a binary search of the
// rows' first CTAs (find_row).  Nothing is allocated; every kernel runs on
// the caller's stream, and each entry point returns cudaGetLastError() so
// the Python wrapper raises on a refused launch.
//
// A bfloat16 add is done in float32 and rounded once (round to nearest
// even), as PyTorch's own elementwise add does, so kernel and plain version
// agree bit for bit.
//
// The boundary pair moves all regions of a block (the 26 faces, edges and
// corners, in DIRECTIONS order) to and from ONE buffer at static offsets,
// every rank in one launch.  The pack is a box launch (below).  The
// unpack's regions overlap (a face holds its edges and corners), and the
// reference adds them in region order, rounding to the block's dtype after
// each add; a parallel scatter of the segments would race and reorder those
// adds.  So the unpack walks the disjoint cells of the regions' union, each
// with the ordered list of the regions that cover it: one thread an element
// makes the reference's sequence of adds, bit for bit, with no atomics
// (unpack_boundary_add_kernel, below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxSegments = 64;  // members of one fused transfer

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

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

// The last entry of first[0, n) at or below b: the row of a flat tile list
// that owns CTA b (first[0] == 0, increasing; uniform, in the parameter bank).
__device__ __forceinline__ int find_row(const int* first, int n, int b) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// Columns [begin, end) of one row of a segment tile: 16 bytes a thread where
// vec holds (thread t takes columns begin + t * V ...), element by element at
// the CTA's stride otherwise.  Raw 32- or 16-bit words, exact whatever the
// values.
template <typename E>
__device__ __forceinline__ void copy_tile(const E* __restrict__ src, E* __restrict__ dst,
                                          int begin, int end, bool vec) {
  constexpr int V = 16 / sizeof(E);
  if (vec) {
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

// E: a 32- or 16-bit word (float32 or bfloat16 bits).
template <typename E, int CAP>
__global__ void __launch_bounds__(kPackThreads)
    pack_segments_kernel(const __grid_constant__ PackTable<CAP> tab, int nseg,
                         E* __restrict__ out, int total) {
  constexpr int kTile = kTileBytes / sizeof(E);
  const int b = blockIdx.x;
  const int j = find_row(tab.first, nseg, b);
  const PackMember& m = tab.m[j];
  const int local = b - tab.first[j];
  const int r = local / m.tiles;
  const int begin = (local - r * m.tiles) * kTile;
  copy_tile(static_cast<const E*>(m.src) + static_cast<int64_t>(r) * m.src_stride,
            out + static_cast<int64_t>(r) * total + m.dst_col, begin,
            min(begin + kTile, m.size), m.vec != 0);
}

// unpack_segments: pack_segments turned round.  Member j, columns [src_col_j,
// src_col_j + n_j) of every row of the (ranks, total) received buffer, goes to
// the contiguous (ranks, n_j) slab dst_j, for the ranks whose mask byte is set
// (all when mask is null); the others keep their values.  The same flat tile
// list (kernels/halo_pack.py: unpack_plan): member j owns CTAs [first_j,
// first_j + tiles_j * ranks), rank-major, so the grid is exactly sum_j
// ceil(n_j / tile) * ranks CTAs (a Faces transfer, a 128^2 face and eight
// edges and corners of 8 ranks: 192 CTAs, one wave; the old grid of
// max_size x members x ranks launched 4608, ~90 % of them empty).  The mask
// stays on the device (the engines capture this launch into CUDA graphs): a
// CTA reads its rank's byte, uniform across the CTA, and returns at once
// when it is 0.  16 bytes a thread where the buffer at the member's column,
// its row stride, the slab and the slab's row keep alignment; element by
// element otherwise (a corner).
struct UnpackMember {
  void* dst;    // the member's slab: rank r's row at dst + r * size
  int src_col;  // the member's first column in the buffer's row
  int size;     // columns
  int tiles;    // tiles a rank
  int vec;      // 1: 16-byte accesses keep alignment
  int member;   // the member's row of the masks
  int pad_;
};
template <int CAP>
struct UnpackTable {
  int first[CAP];  // member j's first CTA, increasing
  UnpackMember m[CAP];
};

template <typename E, int CAP>
__global__ void __launch_bounds__(kPackThreads)
    unpack_segments_kernel(const __grid_constant__ UnpackTable<CAP> tab, int nseg,
                           const E* __restrict__ buf, int total,
                           const uint8_t* __restrict__ mask, int n_ranks) {
  constexpr int kTile = kTileBytes / sizeof(E);
  const int b = blockIdx.x;
  const int j = find_row(tab.first, nseg, b);
  const UnpackMember& m = tab.m[j];
  const int local = b - tab.first[j];
  const int r = local / m.tiles;
  if (mask != nullptr && !mask[static_cast<int64_t>(m.member) * n_ranks + r]) return;
  const int begin = (local - r * m.tiles) * kTile;
  copy_tile(buf + static_cast<int64_t>(r) * total + m.src_col,
            static_cast<E*>(m.dst) + static_cast<int64_t>(r) * m.size, begin,
            min(begin + kTile, m.size), m.vec != 0);
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
  const int j = find_row(tab.first, nrows, k);
  const BoxRow& g = tab.g[j];
  gather_tile(g, tile_of<kVec<E>>(g, k - tab.first[j], block, total), u, out);
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

// unpack_boundary_add: an ordered cell plan (kernels/halo_pack.py:
// unpack_boundary_plan).  The host cuts each axis of the block at every
// region's start and stop; the boxes of that cut that some region covers
// are the cells, disjoint, and each has ONE ordered list of the regions that
// cover it (a Faces shell: 26 cells, a face's interior covered by 1 region,
// an edge's by 3, a corner by 7).  A cell is a box in (outer, run) form, as
// a box row's, cut into tiles of kTileBytes over all its elements (slabs x
// runs x run) and listed flat: the grid is (CTAs a rank, ranks), no CTA idle.
// An element's run and slab come from the plan's multipliers for `run` and
// `runs`, and its element in covering region k's segment is affine in them
// (start_k + slab * slab_step_k + run * run_step_k + column), so a thread
// makes no box test and no division.  Each element of the union belongs to
// one thread, which loads it once, issues the loads of all its covers (up to
// kCoverLoads at once), adds them in region order, rounding after each add,
// and stores it once: the reference's sequence bit for bit, with no atomics.
// Where the cell's flag holds (runs of whole 16-byte words, every start,
// step and stride aligned on u and on each segment: the interiors of the x-
// and y-faces, which the plan cuts at 16-byte bounds), a thread adds 16
// bytes at a time; elsewhere it takes the elements start + threadIdx.x +
// e * 256 (e < V), coalesced on the segments.  Bound: the 32-byte sectors of
// the shell, read and written (a z-face element touches one), and the buffer
// read once; at Faces sizes, launch latency.
constexpr int kMaxCells = 40;    // cells of one launch (the wrapper's MAX_CELLS)
constexpr int kMaxCovers = 112;  // covers of all its cells (MAX_COVERS)

struct CellRow {
  int base;            // the cell's first element in a rank's block
  int run;             // contiguous elements of a run
  int runs;            // runs a slab
  int run_stride;      // elements between two runs in the block
  int slabs;           // slabs
  int slab_stride;     // elements between two slabs in the block
  int tiles;           // CTAs a rank
  int vec;             // 1: 16-byte accesses on u and on every cover
  unsigned run_magic;  // p / run == (p * run_magic) >> run_shift, p < 2^31
  int run_shift;
  unsigned runs_magic;  // the same for runs
  int runs_shift;
  int cover;           // the cell's first cover in the table
  int n_covers;        // the regions covering the cell, in region order
};
constexpr int kCellFields = 14;
// A region covering a cell: the segment element of the cell's first element
// in a rank's buffer row, and the segment's steps between two of the cell's
// runs and two of its slabs.
struct Cover {
  int start, run_step, slab_step;
};
struct CellTable {  // 3 744 bytes of parameters
  int first[kMaxCells];
  CellRow c[kMaxCells];
  Cover k[kMaxCovers];
};

// Element p of a cell in row-major order: its slab, its run in the slab and
// its column, by the plan's two multipliers.
struct CellIndex {
  int slab, run, col;
};
__device__ __forceinline__ CellIndex cell_index(const CellRow& g, int p) {
  const int r = static_cast<int>((static_cast<uint64_t>(p) * g.run_magic) >> g.run_shift);
  const int a = static_cast<int>((static_cast<uint64_t>(r) * g.runs_magic) >> g.runs_shift);
  return {a, r - a * g.runs, p - r * g.run};
}
__device__ __forceinline__ int box_at(const CellRow& g, const CellIndex& i) {
  return i.slab * g.slab_stride + i.run * g.run_stride + i.col;
}
__device__ __forceinline__ int seg_at(const Cover& h, const CellIndex& i) {
  return h.start + i.slab * h.slab_step + i.run * h.run_step + i.col;
}

template <typename E>
__global__ void __launch_bounds__(kPackThreads)
    unpack_boundary_add_kernel(const __grid_constant__ CellTable tab, int ncells,
                               E* __restrict__ u, const E* __restrict__ buf, int block,
                               int total) {
  constexpr int V = kVec<E>;
  constexpr int kCoverLoads = 32 / V;  // covers whose loads a thread has in flight
  const int i = find_row(tab.first, ncells, blockIdx.x);
  const CellRow& g = tab.c[i];
  const Cover* cov = tab.k + g.cover;
  const int n = g.slabs * g.runs * g.run;
  const int start = (static_cast<int>(blockIdx.x) - tab.first[i]) * (kTileBytes / sizeof(E));
  E* blk = u + static_cast<int64_t>(blockIdx.y) * block + g.base;
  const E* seg = buf + static_cast<int64_t>(blockIdx.y) * total;
  if (g.vec) {  // 16 bytes a thread on u and on every cover (run % V == 0)
    const int p = start + static_cast<int>(threadIdx.x) * V;
    if (p >= n) return;
    const CellIndex at = cell_index(g, p);
    uint4* x = reinterpret_cast<uint4*>(blk + box_at(g, at));
    Words<E> acc;
    acc.v = *x;
    for (int k0 = 0; k0 < g.n_covers; k0 += kCoverLoads) {
      Words<E> m[kCoverLoads];
#pragma unroll
      for (int j = 0; j < kCoverLoads; ++j)
        if (k0 + j < g.n_covers)
          m[j].v = __ldg(reinterpret_cast<const uint4*>(seg + seg_at(cov[k0 + j], at)));
#pragma unroll
      for (int j = 0; j < kCoverLoads; ++j)
        if (k0 + j < g.n_covers) {
#pragma unroll
          for (int e = 0; e < V; ++e) acc.e[e] = add_words(acc.e[e], m[j].e[e]);
        }
    }
    *x = acc.v;
    return;
  }
  // element by element: element e of a thread is the cell's element start +
  // threadIdx.x + e * kPackThreads (coalesced on the segments)
  CellIndex at[V];
  bool ok[V];
  E x[V] = {};
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int p = start + static_cast<int>(threadIdx.x) + e * kPackThreads;
    ok[e] = p < n;
    at[e] = cell_index(g, ok[e] ? p : 0);
    if (ok[e]) x[e] = blk[box_at(g, at[e])];
  }
  for (int k0 = 0; k0 < g.n_covers; k0 += kCoverLoads) {
    E m[kCoverLoads][V] = {};
#pragma unroll
    for (int j = 0; j < kCoverLoads; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (k0 + j < g.n_covers && ok[e]) m[j][e] = __ldg(seg + seg_at(cov[k0 + j], at[e]));
#pragma unroll
    for (int j = 0; j < kCoverLoads; ++j)
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (k0 + j < g.n_covers) x[e] = add_words(x[e], m[j][e]);
  }
#pragma unroll
  for (int e = 0; e < V; ++e)
    if (ok[e]) blk[box_at(g, at[e])] = x[e];
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

// unpack_segments' launch with a table of CAP members (the wrapper's plan; see
// rt_unpack_segments).
template <int CAP>
int unpack_launch(int dtype, const long long* table, int nseg, const void* buf,
                  long long n_ctas, long long total, const void* mask, int n_ranks,
                  void* stream) {
  constexpr long long kMax = 0x7fffffffLL;
  if ((dtype != kFloat32 && dtype != kBFloat16) || nseg < 1 || nseg > CAP || n_ctas < 1 ||
      n_ctas > kMax || total < 1 || total > kMax || n_ranks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  UnpackTable<CAP> tab{};
  for (int j = 0; j < nseg; ++j) {
    const long long* row = table + 7 * j;
    for (int f = 1; f < 7; ++f)
      if (row[f] < 0 || row[f] > kMax) return static_cast<int>(cudaErrorInvalidValue);
    if (row[3] < 1 || row[1] + row[2] > total || row[4] >= n_ctas ||
        (j > 0 && row[4] <= tab.first[j - 1]) || (j == 0 && row[4] != 0))
      return static_cast<int>(cudaErrorInvalidValue);
    tab.first[j] = static_cast<int>(row[4]);
    tab.m[j] = UnpackMember{reinterpret_cast<void*>(row[0]), static_cast<int>(row[1]),
                            static_cast<int>(row[2]), static_cast<int>(row[3]), row[5] != 0,
                            static_cast<int>(row[6]), 0};
  }
  const unsigned grid = static_cast<unsigned>(n_ctas);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    unpack_segments_kernel<uint32_t, CAP><<<grid, kPackThreads, 0, s>>>(
        tab, nseg, static_cast<const uint32_t*>(buf), static_cast<int>(total), m, n_ranks);
  else
    unpack_segments_kernel<uint16_t, CAP><<<grid, kPackThreads, 0, s>>>(
        tab, nseg, static_cast<const uint16_t*>(buf), static_cast<int>(total), m, n_ranks);
  return static_cast<int>(cudaGetLastError());
}

// A cell row of the wrapper's plan, after its first CTA, checked: every
// field in range, the counts positive, the covers inside the table.
bool read_cell(const long long* row, int ncovers, CellRow& g) {
  for (int f = 0; f < kCellFields; ++f)
    if (row[f] < 0 || row[f] > (f == 8 || f == 10 ? 0xffffffffLL : 0x7fffffffLL)) return false;
  g = CellRow{static_cast<int>(row[0]),       static_cast<int>(row[1]),
              static_cast<int>(row[2]),       static_cast<int>(row[3]),
              static_cast<int>(row[4]),       static_cast<int>(row[5]),
              static_cast<int>(row[6]),       static_cast<int>(row[7]),
              static_cast<unsigned>(row[8]),  static_cast<int>(row[9]),
              static_cast<unsigned>(row[10]), static_cast<int>(row[11]),
              static_cast<int>(row[12]),      static_cast<int>(row[13])};
  return g.run >= 1 && g.runs >= 1 && g.slabs >= 1 && g.tiles >= 1 && g.vec <= 1 &&
         g.run_shift >= 31 && g.run_shift <= 62 && g.runs_shift >= 31 && g.runs_shift <= 62 &&
         g.n_covers >= 1 && g.cover + g.n_covers <= ncovers;
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

// table: nseg rows of (destination address, buffer column, size, tiles a
// rank, first CTA, vector flag, member index), int64 each: the wrapper's
// plan, every member with columns, first CTAs increasing from 0; n_ctas: the
// CTAs of the flat tile list; total: columns of a buffer row; mask: members x
// n_ranks bytes on the device, or null.
int rt_unpack_segments(int dtype, const long long* table, int nseg, const void* buf,
                       long long n_ctas, long long total, const void* mask, int n_ranks,
                       void* stream) {
  if (nseg > 16)
    return unpack_launch<kMaxSegments>(dtype, table, nseg, buf, n_ctas, total, mask, n_ranks,
                                       stream);
  return unpack_launch<16>(dtype, table, nseg, buf, n_ctas, total, mask, n_ranks, stream);
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

// cells: ncells rows of (first CTA, base, run, runs, run_stride, slabs,
// slab_stride, tiles, vec, run_magic, run_shift, runs_magic, runs_shift,
// first cover, covers), covers: ncovers rows of (start, run_step,
// slab_step), int64 each: the wrapper's cell plan, first CTAs increasing
// from 0; block: elements of a rank's block; total: of a rank's buffer row;
// n_ctas: the CTAs a rank.
int rt_unpack_boundary_add(int dtype, void* u, const void* buf, const long long* cells,
                           int ncells, const long long* covers, int ncovers, int block,
                           int total, int n_ctas, int n_ranks, void* stream) {
  if ((dtype != kFloat32 && dtype != kBFloat16) || ncells < 1 || ncells > kMaxCells ||
      ncovers < 1 || ncovers > kMaxCovers || n_ctas < 1 || n_ranks < 1 || n_ranks > 65535 ||
      block < 1 || total < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CellTable tab{};
  for (int j = 0; j < ncells; ++j) {
    const long long* row = cells + (kCellFields + 1) * j;
    if (!read_cell(row + 1, ncovers, tab.c[j]) || row[0] >= n_ctas ||
        (j > 0 && row[0] <= tab.first[j - 1]) || (j == 0 && row[0] != 0))
      return static_cast<int>(cudaErrorInvalidValue);
    tab.first[j] = static_cast<int>(row[0]);
  }
  for (int j = 0; j < ncovers; ++j) {
    const long long* row = covers + 3 * j;
    for (int f = 0; f < 3; ++f)
      if (row[f] < 0 || row[f] >= total) return static_cast<int>(cudaErrorInvalidValue);
    tab.k[j] = Cover{static_cast<int>(row[0]), static_cast<int>(row[1]),
                     static_cast<int>(row[2])};
  }
  const dim3 grid(static_cast<unsigned>(n_ctas), static_cast<unsigned>(n_ranks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32)
    unpack_boundary_add_kernel<uint32_t><<<grid, kPackThreads, 0, s>>>(
        tab, ncells, static_cast<uint32_t*>(u), static_cast<const uint32_t*>(buf), block, total);
  else
    unpack_boundary_add_kernel<uint16_t><<<grid, kPackThreads, 0, s>>>(
        tab, ncells, static_cast<uint16_t*>(u), static_cast<const uint16_t*>(buf), block, total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
