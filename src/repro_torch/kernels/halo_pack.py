"""Hopper kernels of the Faces halo path: wrappers and launch counters.

Six hand-written CUDA kernels (``csrc/halo_pack.cu``, built for
``sm_90a`` at first use by :mod:`.build`) replace the Pallas kernels of
``repro.kernels.halo_pack``:

=======================  ==============================================
wrapper                  replaces (src/repro/kernels/halo_pack.py)
=======================  ==============================================
``halo_pack``            ``halo_pack_call`` (line 67)
``halo_unpack_add``      ``halo_unpack_add_call`` (line 84)
``pack_boundary``        ``pack_boundary_call`` (line 112)
``unpack_boundary_add``  ``unpack_boundary_add_call`` (line 134)
``pack_segments``        ``pack_segments_call`` (line 163)
``unpack_segments``      ``unpack_segments_call`` (line 202)
=======================  ==============================================

Each launch covers every rank of a buffer in the global layout.  All
six are copies at static offsets (plus one float add for the unpacks):
bound by the bytes moved against the card's memory rate (or the 32-byte
sectors a strided region touches) and, at Faces slab sizes, by launch
latency.  Each launches a flat list of 4 KB tiles planned here, on the
host, with no idle CTA: the segment kernels over their members' columns
(:func:`pack_plan`, :func:`unpack_plan`), ``halo_pack``,
``halo_unpack_add`` and ``pack_boundary`` over boxes (:func:`box_plan`,
:func:`boundary_plan`), ``unpack_boundary_add`` over the ordered cells
of its regions (:func:`unpack_boundary_plan`).  They allocate nothing
but their outputs, launch on ``torch.cuda.current_stream()`` and raise
if the launch is refused.

A wrapper runs the plain version of :mod:`.ref` for a CPU tensor, and
only then; for a CUDA tensor it launches its kernel or raises.  Each
wrapper's ``launches`` attribute counts the kernel launches it made
(a launch recorded into a CUDA graph counts once, at capture).
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import ref
from .build import check_launch, load_library, stream_arg, use_plain

MAX_SEGMENTS = 64       # members of one fused transfer (csrc kMaxSegments)
MAX_RANKS = 65535       # ranks of one segment or box launch (grid z or y)
TILE_BYTES = 4096       # a segment or box tile: 256 threads x 16 bytes (csrc kTileBytes)
_INT32_MAX = 2 ** 31 - 1
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: the C entry points of ``csrc/halo_pack.cu`` and their argument types
SIGNATURES = {
    "rt_halo_pack": [_I, _P, _P, _P, _I, _I, _I, _I, _P],
    "rt_halo_unpack_add": [_I, _P, _P, _P, _I, _I, _I, _I, _P],
    "rt_pack_segments": [_I, _P, _I, _P, _I64, _I64, _P],
    "rt_unpack_segments": [_I, _P, _I, _P, _I64, _I64, _P, _I, _P],
    "rt_pack_boundary": [_I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "rt_unpack_boundary_add": [_I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
}


def _dtype_code(*tensors: torch.Tensor, contiguous: bool = True) -> int:
    for t in tensors:
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"halo kernels take float32 or bfloat16, got {t.dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError("halo kernels take contiguous tensors")
    return _DTYPE_CODE[tensors[0].dtype]


def _lib():
    return load_library("halo_pack", SIGNATURES)


def _box(u: torch.Tensor, region) -> Tuple[int, ...]:
    """(n_ranks, px, py, pz, x0, y0, z0, rx, ry, rz) of a region launch."""
    if u.dim() < 3:
        raise ValueError(f"halo kernels take (..., px, py, pz) blocks, got {tuple(u.shape)}")
    block = tuple(u.shape[-3:])
    if any(s.stop > n for s, n in zip(region, block)):
        raise ValueError(f"region {region!r} exceeds block {block}")
    n_block = block[0] * block[1] * block[2]
    n_ranks = u.numel() // n_block if n_block else 0
    return (n_ranks, *block, *(s.start for s in region), *ref.region_shape(region))


def halo_pack(u: torch.Tensor, region: Sequence[slice]) -> torch.Tensor:
    """Copy one static face/edge/corner region of every rank's block into
    a new contiguous ``(*ranks, *region)`` slab.

    ``pack_boundary`` with one region whose segment is the whole row: one
    launch of the tiles of :func:`box_plan` (4 KB a CTA, grid (CTAs a
    rank, ranks), no idle CTA, no division per element), the same gather
    as ``pack_boundary``'s.  Where the region's runs and the layout allow
    (x- and y-faces, edges along z) a thread copies 16 bytes with one
    load and one store; elsewhere (a z-face, edges along x and y) it
    gathers 16 bytes of the slab with independent loads and stores them
    at once.  Bound: reads and writes the slab once (a 128x128 float32
    face of 8 ranks is 1 MiB of traffic, 0.31 us at 3.35 TB/s), or the
    32-byte sectors a strided region touches; at slab sizes, launch
    latency.
    """
    region = ref.region3(region)
    if use_plain(u):
        return ref.halo_pack(u, region)
    code = _dtype_code(u)
    n_ranks, *block = _box(u, region)[:4]
    out = torch.empty(tuple(u.shape[:-3]) + ref.region_shape(region),
                      dtype=u.dtype, device=u.device)
    row, n_ctas = _box_launch(tuple(block), _region_key(region), n_ranks,
                              u.element_size(), u.data_ptr() % 16, out.data_ptr() % 16)
    if n_ctas == 0:
        return out
    err = _lib().rt_halo_pack(code, u.data_ptr(), out.data_ptr(), row,
                              block[0] * block[1] * block[2], out.numel() // n_ranks,
                              n_ctas, n_ranks, stream_arg(u))
    check_launch("halo_pack", err)
    halo_pack.launches += 1
    return out


def halo_unpack_add(u: torch.Tensor, msg: torch.Tensor,
                    region: Sequence[slice]) -> torch.Tensor:
    """Add ``msg`` into every rank's ``region`` of ``u`` **in place** and
    return ``u``.

    The reference kernel returns a new block (``out_ref[...] =
    u_ref[...]``); on a 128^3 float32 field of 8 ranks that copy would
    move 67 MB per unpack, 26 times an iteration.  Here the kernel
    touches the region only, in one launch of the tiles of
    :func:`box_plan` (no idle CTA, no division per element).  Where the
    region's runs and the layout allow (x- and y-faces, edges along z),
    a thread adds 16 bytes of ``msg`` into 16 bytes of ``u`` with one
    access each; elsewhere (a z-face, edges along x and y, corners) it
    takes every 256th element of its tile and issues all its strided
    loads of ``u`` and ``msg`` before its first add.  A bfloat16 add is
    done in float32 and rounded once.  Bound: bytes, or the 32-byte
    sectors a strided region touches (a z-face reads and writes one
    sector of ``u`` per element); at slab sizes, launch latency.
    """
    region = ref.region3(region)
    want = tuple(u.shape[:-3]) + ref.region_shape(region)
    if tuple(msg.shape) != want:
        raise ValueError(f"message shape {tuple(msg.shape)} != region {want}")
    if msg.dtype != u.dtype:
        msg = msg.to(u.dtype)
    if use_plain(u, msg):
        return ref.halo_unpack_add(u, msg, region)
    code = _dtype_code(u, msg)
    n_ranks, *block = _box(u, region)[:4]
    row, n_ctas = _box_launch(tuple(block), _region_key(region), n_ranks,
                              u.element_size(), u.data_ptr() % 16, msg.data_ptr() % 16)
    if n_ctas == 0:
        return u
    err = _lib().rt_halo_unpack_add(code, u.data_ptr(), msg.data_ptr(), row,
                                    block[0] * block[1] * block[2],
                                    msg.numel() // n_ranks, n_ctas, n_ranks, stream_arg(u))
    check_launch("halo_pack", err)
    halo_unpack_add.launches += 1
    return u


def _region_key(region) -> Tuple[Tuple[int, int], ...]:
    return tuple((s.start, s.stop) for s in region)


def _slices(key) -> Tuple[slice, ...]:
    return tuple(slice(a, b) for a, b in key)


@functools.lru_cache(maxsize=4096)
def _box_launch(block, region, n_ranks, itemsize, u_align, packed_align):
    """The row of a one-region box launch (``halo_pack``,
    ``halo_unpack_add``) as a C array, and its CTAs a rank (the plan
    depends on the addresses only modulo 16, so it is cached)."""
    row, n_ctas = box_plan(block, _slices(region), n_ranks, itemsize, u_align, packed_align)
    return (None if row is None else (ctypes.c_int64 * len(row))(*row)), n_ctas


@functools.lru_cache(maxsize=1024)
def _pack_boundary_launch(block, regions, n_ranks, itemsize, u_align, out_align):
    """``pack_boundary``'s table as a C array, its rows and CTAs a rank."""
    rows, n_ctas, _ = boundary_plan(block, [_slices(r) for r in regions], n_ranks,
                                    itemsize, u_align, out_align)
    return ((ctypes.c_int64 * (len(BOX_FIELDS) * len(rows)))(*(v for r in rows for v in r)),
            len(rows), n_ctas)


def _boundary_regions(u: torch.Tensor, regions):
    """The boundary kernels' regions, validated against the block of
    ``u``, and the buffer's size a rank."""
    if not regions or len(regions) > MAX_SEGMENTS:
        raise ValueError(f"the boundary kernels take 1 to {MAX_SEGMENTS} regions, "
                         f"got {len(regions)}")
    regions = [ref.region3(r) for r in regions]
    for r in regions:
        _box(u, r)  # validates the region against the block
    total = sum(ref.region_size(r) for r in regions)
    if total >= 2 ** 31:
        raise ValueError("a boundary buffer holds fewer than 2^31 elements a rank")
    return regions, total


@functools.lru_cache(maxsize=1024)
def _unpack_boundary_launch(block, regions, n_ranks, itemsize, u_align, buf_align):
    """``unpack_boundary_add``'s cell and cover tables as C arrays, their
    rows and the CTAs a rank."""
    cells, covers, n_ctas, _ = unpack_boundary_plan(block, [_slices(r) for r in regions],
                                                    n_ranks, itemsize, u_align, buf_align)
    return ((ctypes.c_int64 * (len(CELL_FIELDS) * len(cells)))(*(v for r in cells for v in r)),
            len(cells),
            (ctypes.c_int64 * (len(COVER_FIELDS) * len(covers)))(*(v for r in covers for v in r)),
            len(covers), n_ctas)


def pack_boundary(u: torch.Tensor, regions: Sequence[Sequence[slice]]) -> torch.Tensor:
    """Copy the static ``regions`` of every rank's block into ONE
    contiguous ``(*ranks, total)`` buffer, region after region (the
    paper's step 2; DIRECTIONS order gives faces, edges, corners).

    One launch for all regions and ranks: the flat tile list of
    :func:`boundary_plan`, one :func:`box_plan` row per region in a
    table passed by value; a CTA finds its region by a binary search of
    the rows' first CTAs.  No CTA is idle; every store into the packed
    row is 16 bytes where its layout allows, and loads are 16 bytes on
    contiguous runs (x- and y-faces, edges along z).  Bound: each
    region element read once and written once (~0.4 MB a rank for the
    26 regions of a 128^3 float32 block), or the 32-byte sectors the
    strided regions touch; at Faces sizes, launch latency.
    """
    regions, total = _boundary_regions(u, regions)
    if use_plain(u):
        return ref.pack_boundary(u, regions)
    code = _dtype_code(u)
    block = tuple(u.shape[-3:])
    n_ranks = u.numel() // max(1, block[0] * block[1] * block[2])
    out = torch.empty(tuple(u.shape[:-3]) + (total,), dtype=u.dtype, device=u.device)
    if out.numel() == 0:
        return out
    table, n_rows, n_ctas = _pack_boundary_launch(
        block, tuple(_region_key(r) for r in regions), n_ranks, u.element_size(),
        u.data_ptr() % 16, out.data_ptr() % 16)
    err = _lib().rt_pack_boundary(code, u.data_ptr(), out.data_ptr(), table, n_rows,
                                  block[0] * block[1] * block[2], total, n_ctas, n_ranks,
                                  stream_arg(u))
    check_launch("halo_pack", err)
    pack_boundary.launches += 1
    return out


def unpack_boundary_add(u: torch.Tensor, buf: torch.Tensor,
                        regions: Sequence[Sequence[slice]]) -> torch.Tensor:
    """Add the segments of ``buf (*ranks, total)`` into their regions of
    every rank's block, **in place**, and return ``u`` (the paper's step
    6).

    Regions overlap (a face holds its edges and corners); the adds go in
    region order, each rounded to ``u``'s dtype, as the reference's do.
    One launch over the ordered cells of :func:`unpack_boundary_plan`:
    the disjoint boxes of the regions' union, each with the ordered list
    of the regions that cover it, so a thread loads an element of ``u``
    once, adds each covering region's segment element in turn (all its
    loads issued first), rounding after each add, and stores it once --
    the reference's sequence bit for bit, with no atomics, no box test
    and no division per element.  Cells whose runs and layout allow
    take 16 bytes a thread on ``u`` and on every segment (the interiors
    of the x- and y-faces, cut at 16-byte bounds).  The reference
    returns a new block; in place, the launch touches the boundary shell
    only.  Raises ``ValueError`` for a region set whose cell table does
    not fit the kernel's (every shell of 26 faces, edges and corners
    does).  Bound: the 32-byte sectors of the shell (a z-face element
    reads and writes one) and the buffer read once; at Faces sizes,
    launch latency.
    """
    regions, total = _boundary_regions(u, regions)
    want = tuple(u.shape[:-3]) + (total,)
    if tuple(buf.shape) != want:
        raise ValueError(f"buffer shape {tuple(buf.shape)} != {want}")
    if buf.dtype != u.dtype:
        buf = buf.to(u.dtype)
    if use_plain(u, buf):
        return ref.unpack_boundary_add(u, buf, regions)
    code = _dtype_code(u, buf)
    block = tuple(u.shape[-3:])
    n_ranks = u.numel() // max(1, block[0] * block[1] * block[2])
    if u.numel() == 0:
        return u
    cells, n_cells, covers, n_covers, n_ctas = _unpack_boundary_launch(
        block, tuple(_region_key(r) for r in regions), n_ranks, u.element_size(),
        u.data_ptr() % 16, buf.data_ptr() % 16)
    err = _lib().rt_unpack_boundary_add(code, u.data_ptr(), buf.data_ptr(), cells, n_cells,
                                        covers, n_covers, block[0] * block[1] * block[2],
                                        total, n_ctas, n_ranks, stream_arg(u))
    check_launch("halo_pack", err)
    unpack_boundary_add.launches += 1
    return u


def _check_members(n_ranks: int, widths, cols, sizes) -> None:
    """Shared checks of the segment kernels' member tables."""
    if not sizes:
        raise ValueError("segment kernels need at least one member")
    if len(sizes) > MAX_SEGMENTS or n_ranks > MAX_RANKS:
        raise ValueError(f"one launch takes at most {MAX_SEGMENTS} members "
                         f"and {MAX_RANKS} ranks")
    for w, col, n in zip(widths, cols, sizes):
        if col < 0 or n < 0 or col + n > w:
            raise ValueError(f"segment [{col}, {col + n}) does not fit "
                             f"{w} columns")


def segment_tiles(sizes: Sequence[int], n_ranks: int,
                  tile: int) -> Tuple[List[Tuple[int, int, int]], int]:
    """The flat tile list of a segment launch.

    Each member's row is cut into ``ceil(n_j / tile)`` tiles of ``tile``
    columns; member j owns the CTAs ``[first_j, first_j + tiles_j *
    n_ranks)``, rank-major, and a member without columns owns none.
    Returns ``[(member index, tiles a rank, first CTA), ...]`` for the
    members with columns, and the CTA count ``sum_j ceil(n_j / tile) *
    n_ranks`` -- every CTA has columns to copy.
    """
    out, first = [], 0
    for j, n in enumerate(sizes):
        tiles = -(-n // tile)
        if tiles and n_ranks:
            out.append((j, tiles, first))
            first += tiles * n_ranks
    return out, first


def vector_ok(src_addr: int, row_stride: int, dst_col: int, total: int,
              out_addr: int, itemsize: int) -> bool:
    """Whether a member may copy 16 bytes a thread: its source address
    (at its first column), its source row stride, its staging column,
    the staging row (``total`` columns) and the staging buffer's address
    all keep 16-byte alignment.  Layout alone decides."""
    return all(v % 16 == 0 for v in (src_addr, row_stride * itemsize, dst_col * itemsize,
                                     total * itemsize, out_addr))


def pack_plan(members: Sequence[Tuple[int, int, int]], n_ranks: int, itemsize: int,
              out_addr: int) -> Tuple[List[Tuple[int, ...]], int]:
    """The ``pack_segments`` launch: ``members[j] = (source address of
    its first column, source row stride, size)``, addresses in bytes and
    the rest in elements; members land at consecutive staging columns.
    Returns the C table's rows ``(source address, row stride, staging
    column, size, tiles a rank, first CTA, vector flag)`` of the members
    with columns, and the CTA count (0: nothing to launch)."""
    sizes = [n for _, _, n in members]
    total = sum(sizes)
    offsets = [0, *itertools.accumulate(sizes)][:-1]
    tiles, n_ctas = segment_tiles(sizes, n_ranks, TILE_BYTES // itemsize)
    if max([total, n_ctas] + [members[j][1] for j, _, _ in tiles]) > _INT32_MAX:
        raise ValueError("a segment launch takes fewer than 2^31 CTAs, staging "
                         "columns and source row strides")
    rows = []
    for j, n_tiles, first in tiles:
        addr, stride, n = members[j]
        rows.append((addr, stride, offsets[j], n, n_tiles, first,
                     int(vector_ok(addr, stride, offsets[j], total, out_addr, itemsize))))
    return rows, n_ctas


PACKED_VEC, BOX_VEC = 1, 2   # box plan flags (csrc kPackedVec, kBoxVec)
#: a box launch's C table row (``csrc/halo_pack.cu`` BoxRow, after ``first``)
BOX_FIELDS = ("first", "base", "run", "runs", "run_stride", "slabs", "slab_stride",
              "offset", "tiles", "flags", "run_magic", "run_shift")


def divider(d: int) -> Tuple[int, int]:
    """``(m, s)`` with ``n // d == (n * m) >> s`` for every ``0 <= n <
    2^31`` and ``m < 2^32``: the round-up multiplier of Granlund and
    Montgomery for 31-bit dividends (``m = ceil(2^(31 + l) / d)``, ``l
    = ceil(log2 d)``), so a kernel divides by a runtime ``d`` with one
    64-bit multiply and a shift."""
    s = 31 + (d - 1).bit_length()
    return -(-(1 << s) // d), s


def collapse_box(block: Sequence[int],
                 region: Sequence[slice]) -> Tuple[int, int, int, int, int, int]:
    """A region's box in ``(outer, run)`` form: ``(base, run, runs,
    run_stride, slabs, slab_stride)`` in elements of a ``(px, py, pz)``
    block.  Element ``c`` of run ``b`` of slab ``a`` lies at ``base + a
    * slab_stride + b * run_stride + c`` and is element ``(a * runs +
    b) * run + c`` of the region in row-major order.  Dimensions merge
    wherever the box is contiguous in the block: an x-face is one run of
    ``py * pz``, a y-face ``px`` runs of ``pz``, an edge along z one run
    of ``rz``; a z-face, edges along x or y and corners are runs of 1
    at a stride (``pz`` or ``py * pz``).  A stride whose count is 1 is
    0; only a box that is none of these (say 2 x 2 x 2 inside a block)
    has more than one slab."""
    _, py, pz = block
    x0, y0, z0 = (s.start for s in region)
    dims = []                        # (count, stride), outer to inner
    for n, stride in zip(ref.region_shape(region), (py * pz, pz, 1)):
        if n == 1:
            continue
        if dims and dims[-1][1] == n * stride:
            dims[-1] = (dims[-1][0] * n, stride)
        else:
            dims.append((n, stride))
    run = dims.pop()[0] if dims and dims[-1][1] == 1 else 1
    (slabs, slab_stride), (runs, run_stride) = ([(1, 0)] * 2 + dims)[-2:]
    return (x0 * py + y0) * pz + z0, run, runs, run_stride, slabs, slab_stride


def aligned16(addr: int, counts: Sequence[int], itemsize: int) -> bool:
    """Whether ``addr`` and every element count in ``counts`` keep
    16-byte alignment."""
    return addr % 16 == 0 and all(n * itemsize % 16 == 0 for n in counts)


def box_plan(block: Sequence[int], region: Sequence[slice], n_ranks: int, itemsize: int,
             box_addr: int, packed_addr: int, offset: int = 0,
             packed_stride: Optional[int] = None) -> Tuple[Optional[Tuple[int, ...]], int]:
    """The tiles of one region's launch between the ``(ranks, px, py,
    pz)`` block at ``box_addr`` and a packed buffer at ``packed_addr``
    that holds rank r's copy of the region, in row-major order, at
    element ``r * packed_stride + offset`` (``packed_stride`` defaults
    to the region's size: a ``(ranks, *region)`` slab).

    The region's box is taken in :func:`collapse_box` form; each slab
    (``runs * run`` packed elements) is cut into tiles of
    ``TILE_BYTES`` (256 threads of 16 bytes).  The grid is (CTAs a
    rank, ranks): CTA ``k`` of a rank is tile ``k % tiles`` of slab ``k
    // tiles``, so there are exactly ``tiles * slabs`` a rank, each with
    elements.  An element's run comes from the :func:`divider` of
    ``run``.  The flags say, from layout alone, whether 16 consecutive
    bytes of a tile are one aligned access on the packed side
    (``PACKED_VEC``: address, offset, slab and rank strides aligned) and
    on the box side (``BOX_VEC``: also the run length, so 16 bytes never
    leave a run).
    Returns the row ``(base, run, runs, run_stride, slabs, slab_stride,
    offset, tiles, flags, run_magic, run_shift)`` and the CTAs a rank,
    or ``(None, 0)`` when the region is empty."""
    base, run, runs, run_stride, slabs, slab_stride = collapse_box(block, region)
    n = runs * run                   # packed elements a slab
    if n == 0 or n_ranks == 0:
        return None, 0
    if packed_stride is None:
        packed_stride = n * slabs
    block_size = block[0] * block[1] * block[2]
    tiles = -(-n // (TILE_BYTES // itemsize))
    n_ctas = tiles * slabs
    if max(block_size, packed_stride, n_ctas * TILE_BYTES // itemsize) > _INT32_MAX:
        raise ValueError("a box launch takes blocks and packed rows of fewer than 2^31 "
                         "elements")
    if n_ranks > MAX_RANKS:
        raise ValueError(f"one launch takes at most {MAX_RANKS} ranks")
    # strides a launch never steps (one slab, one rank) impose nothing
    slab_packed = n if slabs > 1 else 0
    rank_packed, rank_box = (packed_stride, block_size) if n_ranks > 1 else (0, 0)
    flags = (PACKED_VEC * aligned16(packed_addr, (offset, slab_packed, rank_packed), itemsize)
             | BOX_VEC * aligned16(box_addr, (run, base, run_stride, slab_stride, rank_box),
                                   itemsize))
    return (base, run, runs, run_stride, slabs, slab_stride, offset, tiles, flags,
            *divider(run)), n_ctas


def boundary_plan(block: Sequence[int], regions: Sequence[Sequence[slice]], n_ranks: int,
                  itemsize: int, u_addr: int,
                  out_addr: int) -> Tuple[List[Tuple[int, ...]], int, int]:
    """The ``pack_boundary`` launch: the regions packed one after another
    into a row of ``total`` elements a rank, each with its
    :func:`box_plan` row and first CTA of a rank.  Returns the C table's
    rows ``(first CTA, *box row)`` of the regions with elements (first
    CTAs increasing), the CTAs a rank and ``total``."""
    total = sum(ref.region_size(r) for r in regions)
    rows, first, offset = [], 0, 0
    for r in regions:
        row, ctas = box_plan(block, r, n_ranks, itemsize, u_addr, out_addr, offset, total)
        if ctas:
            rows.append((first, *row))
            first += ctas
        offset += ref.region_size(r)
    return rows, first, total


def unpack_plan(members: Sequence[Tuple[int, int, int]], n_ranks: int, itemsize: int,
                buf_addr: int, total: int) -> Tuple[List[Tuple[int, ...]], int]:
    """The ``unpack_segments`` launch, :func:`pack_plan` turned round:
    ``members[j] = (destination address, buffer column, size)``, the
    address in bytes and the rest in elements; rank r's row of member j
    is columns ``[col_j, col_j + n_j)`` of row r of the ``(ranks,
    total)`` buffer at ``buf_addr``, and goes to ``n_j`` elements at
    ``dst_j + r * n_j * itemsize``.  The tiles are
    :func:`segment_tiles`' (member j owns ``tiles_j * n_ranks`` CTAs,
    rank-major; a member without columns owns none).  Returns the C
    table's rows ``(destination address, buffer column, size, tiles a
    rank, first CTA, vector flag, member index)`` of the members with
    columns (the index picks the member's row of the masks), and the
    CTA count (0: nothing to launch)."""
    sizes = [n for _, _, n in members]
    tiles, n_ctas = segment_tiles(sizes, n_ranks, TILE_BYTES // itemsize)
    if max(total, n_ctas) > _INT32_MAX:
        raise ValueError("a segment launch takes fewer than 2^31 CTAs and buffer columns")
    rows = []
    for j, n_tiles, first in tiles:
        dst, col, n = members[j]
        rows.append((dst, col, n, n_tiles, first,
                     int(vector_ok(buf_addr + col * itemsize, total, 0, n, dst, itemsize)), j))
    return rows, n_ctas


#: an ordered cell plan's cell row (``csrc/halo_pack.cu`` CellRow, after
#: ``first``), and the row of one region covering a cell (Cover)
CELL_FIELDS = ("first", "base", "run", "runs", "run_stride", "slabs", "slab_stride", "tiles",
               "vec", "run_magic", "run_shift", "runs_magic", "runs_shift", "cover",
               "n_covers")
COVER_FIELDS = ("start", "run_step", "slab_step")
MAX_CELLS, MAX_COVERS = 40, 112   # the kernel's table (csrc kMaxCells, kMaxCovers)


def cell_boxes(regions: Sequence[Sequence[slice]],
               ) -> List[Tuple[Tuple[slice, ...], Tuple[int, ...]]]:
    """The ordered cells of a region set: each axis cut at every
    region's start and stop, and the boxes of that cut that at least one
    region covers -- the disjoint boxes of the regions' union, in
    row-major order -- each with the indices of the regions that cover
    it, in region order.  A region either holds a box of the cut or
    misses it, so every element of a cell has the same cover list.  The
    26 regions of a Faces shell cut each axis into three intervals: 26
    cells, a face's interior covered by 1 region, an edge's by 3, a
    corner by 7."""
    full = [tuple(r) for r in regions if ref.region_size(r)]
    axes = []
    for d in range(3):
        cuts = sorted({b for r in full for b in (r[d].start, r[d].stop)})
        axes.append([slice(a, b) for a, b in zip(cuts, cuts[1:])])
    out = []
    for box in itertools.product(*axes):
        covers = tuple(k for k, r in enumerate(regions)
                       if all(r[d].start <= box[d].start and box[d].stop <= r[d].stop
                              for d in range(3)))
        if covers:
            out.append((box, covers))
    return out


def unpack_boundary_plan(block: Sequence[int], regions: Sequence[Sequence[slice]],
                         n_ranks: int, itemsize: int, u_addr: int, buf_addr: int,
                         ) -> Tuple[List[Tuple[int, ...]], List[Tuple[int, int, int]], int, int]:
    """The ``unpack_boundary_add`` launch: the :func:`cell_boxes` of the
    regions, each a box in :func:`collapse_box` form cut into tiles of
    ``TILE_BYTES`` over all its elements (``slabs * runs * run``), with
    the ordered list of the regions that cover it.

    The grid is (CTAs a rank, ranks): cell i owns CTAs ``[first_i,
    first_i + tiles_i)`` of a rank, each with elements.  An element's
    run and slab come from the :func:`divider` of ``run`` and of
    ``runs``; its segment element in covering region k is affine in
    them: ``start_k + slab * slab_step_k + run * run_step_k + column``
    (region k's segment is row-major over its box, and a dimension the
    cell's box merges spans the whole block, so every region holding
    the cell spans it too).  No box test and no division per element.
    A cell's ``vec`` flag says, from layout alone, that 16 consecutive
    bytes of a tile are one aligned access on ``u`` and on every
    covering segment (run, strides, steps, starts, rank strides and both
    addresses aligned).  A cell whose z-run starts or ends off a 16-byte
    bound is cut there when the aligned middle then takes the flag and
    holds at least a tile (the interiors of the x- and y-faces of a
    128^3 block: z in [1, 4), [4, 124), [124, 127) for float32).
    Returns the C tables' cell rows ``(first CTA, base, run, runs,
    run_stride, slabs, slab_stride, tiles, vec, run_magic, run_shift,
    runs_magic, runs_shift, first cover, covers)`` and cover rows
    ``(start, run_step, slab_step)``, the CTAs a rank and ``total``.
    Raises ``ValueError`` where the tables exceed the kernel's
    (``MAX_CELLS``, ``MAX_COVERS``)."""
    regions = [tuple(r) for r in regions]
    sizes = [ref.region_size(r) for r in regions]
    total = sum(sizes)
    offsets = [0, *itertools.accumulate(sizes)][:-1]
    block_size = block[0] * block[1] * block[2]
    v, tile = 16 // itemsize, TILE_BYTES // itemsize
    rank_u, rank_buf = (block_size, total) if n_ranks > 1 else (0, 0)

    def seg_index(k, offset):
        """Element ``offset`` of a rank's block in region k's segment."""
        x, rest = divmod(offset, block[1] * block[2])
        y, z = divmod(rest, block[2])
        r = regions[k]
        ry, rz = r[1].stop - r[1].start, r[2].stop - r[2].start
        return (offsets[k] + ((x - r[0].start) * ry + (y - r[1].start)) * rz
                + (z - r[2].start))

    def cell(box, covers):
        base, run, runs, run_stride, slabs, slab_stride = collapse_box(block, box)
        rows = []
        for k in covers:
            start = seg_index(k, base)
            rows.append((start, seg_index(k, base + run_stride) - start if runs > 1 else 0,
                         seg_index(k, base + slab_stride) - start if slabs > 1 else 0))
        vec = (run % v == 0 and aligned16(u_addr, (base, run_stride, slab_stride, rank_u),
                                          itemsize)
               and all(aligned16(buf_addr, (*c, rank_buf), itemsize) for c in rows))
        return (base, run, runs, run_stride, slabs, slab_stride, int(vec)), rows

    pieces = []
    for box, covers in cell_boxes(regions):
        z0, z1 = box[2].start, box[2].stop
        za, zb = -(-z0 // v) * v, z1 // v * v
        cut = [slice(z0, z1)]
        if (za > z0 or zb < z1) and zb > za and not cell(box, covers)[0][-1]:
            middle = (box[0], box[1], slice(za, zb))
            if cell(middle, covers)[0][-1] and ref.region_size(middle) >= tile:
                cut = [s for s in (slice(z0, za), slice(za, zb), slice(zb, z1))
                       if s.stop > s.start]
        pieces += [((box[0], box[1], s), covers) for s in cut]

    cells, cover_rows, first = [], [], 0
    for box, covers in pieces:
        (base, run, runs, run_stride, slabs, slab_stride, vec), rows = cell(box, covers)
        tiles = -(-ref.region_size(box) // tile)
        cells.append((first, base, run, runs, run_stride, slabs, slab_stride, tiles, vec,
                      *divider(run), *divider(runs), len(cover_rows), len(rows)))
        cover_rows += rows
        first += tiles
    if len(cells) > MAX_CELLS or len(cover_rows) > MAX_COVERS:
        raise ValueError(f"the regions cut the block into {len(cells)} cells with "
                         f"{len(cover_rows)} covers; the kernel's table holds "
                         f"{MAX_CELLS} and {MAX_COVERS}")
    if max(block_size, total, first * tile) > _INT32_MAX:
        raise ValueError("a cell launch takes blocks and buffers of fewer than 2^31 "
                         "elements")
    if n_ranks > MAX_RANKS:
        raise ValueError(f"one launch takes at most {MAX_RANKS} ranks")
    return cells, cover_rows, first, total


def pack_segments(sources: Sequence[Tuple[torch.Tensor, int]],
                  sizes: Sequence[int]) -> torch.Tensor:
    """Pack N members into one ``(R, sum(sizes))`` staging buffer.

    ``sources[j] = (tensor, col)``: member ``j`` is columns ``[col, col
    + sizes[j])`` of the 2-D ``(R, W)`` tensor — a slab flattened per
    rank, or a segment of an earlier hop's received buffer.  The whole
    fused transfer is ONE launch over the flat tile list of
    :func:`pack_plan` (no idle CTA; 16-byte copies where
    :func:`vector_ok` allows), its member table by value.  Bound: each
    member byte read once and written once; at Faces sizes (a face and
    eight edges/corners, ~66 KiB a rank) launch latency dominates.
    """
    sources = list(sources)
    sizes = [int(n) for n in sizes]
    if len(sources) != len(sizes):
        raise ValueError("one size per member")
    tensors = [t for t, _ in sources]
    if any(t.dim() != 2 or t.stride(1) != 1 and t.shape[1] > 1 for t in tensors):
        raise ValueError("segment sources are 2-D (ranks, columns) with unit "
                         "column stride")
    n_ranks = tensors[0].shape[0] if tensors else 0
    if any(t.shape[0] != n_ranks for t in tensors):
        raise ValueError("segment sources must share their rank count")
    if len({t.dtype for t in tensors}) > 1:
        raise ValueError("coalesced segments must share a dtype")
    _check_members(n_ranks, [t.shape[1] for t in tensors],
                   [c for _, c in sources], sizes)
    if use_plain(*tensors):
        return ref.pack_segments(sources, sizes)
    code = _dtype_code(*tensors, contiguous=False)
    out = torch.empty((n_ranks, sum(sizes)), dtype=tensors[0].dtype,
                      device=tensors[0].device)
    itemsize = out.element_size()
    rows, n_ctas = pack_plan([(t.data_ptr() + col * itemsize, t.stride(0), n)
                              for (t, col), n in zip(sources, sizes)],
                             n_ranks, itemsize, out.data_ptr())
    if n_ctas == 0:
        return out
    table = (ctypes.c_int64 * (7 * len(rows)))(*(v for r in rows for v in r))
    err = _lib().rt_pack_segments(code, table, len(rows), out.data_ptr(), n_ctas,
                                  out.shape[1], stream_arg(out))
    check_launch("halo_pack", err)
    pack_segments.launches += 1
    return out


def unpack_segments(buf: torch.Tensor, outs: Sequence[torch.Tensor],
                    offsets: Sequence[int],
                    masks: Optional[torch.Tensor] = None) -> None:
    """Split a received ``(R, S)`` staging buffer into N slabs, in place.

    ``outs[j]`` is a contiguous tensor of ``R * n_j`` elements (rank
    major) that takes columns ``[offsets[j], offsets[j] + n_j)`` of
    every rank whose byte in ``masks[j]`` is set (every rank when
    ``masks`` is None); the other ranks keep their values.  The engines
    pass the deposit destinations themselves, so a replace deposit costs
    this one launch per fused transfer: the flat tile list of
    :func:`unpack_plan` (no idle CTA; 16-byte copies where
    :func:`vector_ok` allows), its member table by value.  ``masks``
    stays on the device (the engines capture this launch into CUDA
    graphs): a CTA reads its rank's byte and returns at once when it is
    0.  Bound: each delivered byte read once and written once; at Faces
    sizes, launch latency.
    """
    outs = list(outs)
    offsets = [int(o) for o in offsets]
    if buf.dim() != 2 or len(outs) != len(offsets):
        raise ValueError("unpack_segments takes a 2-D buffer and one offset "
                         "per slab")
    n_ranks = buf.shape[0]
    if any(o.numel() % max(n_ranks, 1) for o in outs):
        raise ValueError(f"every slab must hold a whole row per rank ({n_ranks})")
    sizes = [o.numel() // max(n_ranks, 1) for o in outs]
    _check_members(n_ranks, [buf.shape[1]] * len(outs), offsets, sizes)
    if any(o.dtype != buf.dtype for o in outs):
        raise ValueError("coalesced segments must share a dtype")
    if masks is not None and (masks.dtype != torch.bool
                              or tuple(masks.shape) != (len(outs), n_ranks)):
        raise ValueError(f"masks must be bool of shape {(len(outs), n_ranks)}")
    extra = [] if masks is None else [masks]
    if use_plain(buf, *outs, *extra):
        ref.unpack_segments(buf, outs, offsets, masks)
        return
    code = _dtype_code(buf, *outs)
    if masks is not None and not masks.is_contiguous():
        raise ValueError("halo kernels take contiguous tensors")
    table, n_rows, n_ctas = _unpack_launch(
        tuple((o.data_ptr(), off, n) for o, off, n in zip(outs, offsets, sizes)),
        n_ranks, buf.element_size(), buf.data_ptr() % 16, buf.shape[1])
    if n_ctas == 0:
        return
    err = _lib().rt_unpack_segments(code, table, n_rows, buf.data_ptr(), n_ctas,
                                    buf.shape[1], None if masks is None else masks.data_ptr(),
                                    n_ranks, stream_arg(buf))
    check_launch("halo_pack", err)
    unpack_segments.launches += 1


@functools.lru_cache(maxsize=1024)
def _unpack_launch(members, n_ranks, itemsize, buf_align, total):
    """``unpack_segments``' member table as a C array, its rows and CTAs
    (the plan depends on the buffer's address only modulo 16)."""
    rows, n_ctas = unpack_plan(members, n_ranks, itemsize, buf_align, total)
    return (ctypes.c_int64 * (7 * len(rows)))(*(v for r in rows for v in r)), len(rows), n_ctas


KERNELS = (halo_pack, halo_unpack_add, pack_boundary, unpack_boundary_add,
           pack_segments, unpack_segments)
for _k in KERNELS:
    _k.launches = 0


def launch_counts() -> Dict[str, int]:
    """Kernel launches made by each wrapper since the last reset."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
