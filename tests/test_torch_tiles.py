"""The host-side plans of the port's redesigned kernels, on the CPU.

``pack_segments`` and ``unpack_segments`` launch a flat list of tiles
planned in Python (``halo_pack.segment_tiles`` / ``pack_plan`` /
``unpack_plan``), ``halo_pack``, ``halo_unpack_add`` and
``pack_boundary`` a flat list of tiles over boxes (``halo_pack.box_plan``
/ ``boundary_plan``), ``unpack_boundary_add`` one over the ordered cells
of its regions (``halo_pack.cell_boxes`` / ``unpack_boundary_plan``),
and ``rmsnorm`` picks its route and its row partition in Python
(``rmsnorm.route`` / ``partition``).  These tests hold the plans to
what the CUDA kernels rely on: the tiles cover every (member, rank,
column), every element of a region, or every element of the regions'
union, exactly once with no idle CTA, the 16-byte flags are set only
where every alignment condition holds, a plan decoded as the kernels
decode it copies, gathers, scatters and adds exactly what the plain
versions do, bit for bit (masked-out ranks keep their values; the cell
plan adds a cell's covers in region order, rounding after each add, as
the JAX kernel does), and the norm's route is a function of (rows, d,
dtype) and its partition of d alone -- one that both routes' thread
layouts follow.
The kernels themselves run in ``tests/test_torch_gpu.py``.
"""

import inspect
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core.halo import DIRECTIONS, _region_for
from repro_torch.kernels import halo_pack as hk
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rk


def _covered(sizes, n_ranks, itemsize):
    """Every (member, rank, column) the plan's CTAs copy, decoding each
    CTA as ``pack_segments_kernel`` does (the last member whose first
    CTA is at or below it; rank-major tiles)."""
    tile = hk.TILE_BYTES // itemsize
    rows, n_ctas = hk.pack_plan([(0, max(sizes) + 1, n) for n in sizes], n_ranks,
                                itemsize, 0)
    firsts = [r[5] for r in rows]
    seen = []
    for b in range(n_ctas):
        j = max(i for i, f in enumerate(firsts) if f <= b)
        _, _, off, n, tiles, first, _ = rows[j]
        rank, t = divmod(b - first, tiles)
        cols = range(t * tile, min(t * tile + tile, n))
        assert len(cols) > 0, f"CTA {b} has nothing to copy"
        seen += [(off + c, rank) for c in cols]
    return seen, n_ctas, rows


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n_ranks", [1, 3, 8])
@pytest.mark.parametrize("sizes", [
    [16384, 128, 128, 128, 128, 1, 1, 1, 1],   # a Faces transfer: face, edges, corners
    [0, 1, 3, 127, 1024, 1025, 2048, 2049, 0],
    [5] * 64,
    [0, 7],
    [0, 0],
])
def test_pack_tiles_cover_every_column_once(sizes, n_ranks, itemsize):
    seen, n_ctas, rows = _covered(sizes, n_ranks, itemsize)
    tile = hk.TILE_BYTES // itemsize
    assert n_ctas == sum(-(-n // tile) for n in sizes) * n_ranks
    assert sorted(seen) == sorted(itertools.product(range(sum(sizes)), range(n_ranks)))
    assert [r[3] for r in rows] == [n for n in sizes if n]   # no member without columns
    firsts = [r[5] for r in rows]
    assert firsts == sorted(set(firsts))


def test_faces_transfer_is_one_wave():
    """A 128^2 float32 face and eight edges and corners of 8 ranks: (16 +
    8) x 8 = 192 CTAs, under one wave of 132 SMs' resident CTAs."""
    _, n_ctas, _ = _covered([16384] + [128] * 4 + [1] * 4, 8, 4)
    assert n_ctas == 192


def test_vector_flag_only_where_every_alignment_holds():
    """Each condition in turn is broken by one element; the flag falls
    exactly when any is."""
    for itemsize in (4, 2):
        el = itemsize
        for src, stride, off, total, out in itertools.product(
                (4096, 4096 + el), (1024, 1024 + 1), (0, 1), (2048, 2048 + 1), (0, 8)):
            want = (src % 16 == 0 and stride * el % 16 == 0 and off * el % 16 == 0
                    and total * el % 16 == 0 and out % 16 == 0)
            assert hk.vector_ok(src, stride, off, total, out, el) == want


def test_pack_plan_sets_the_flag_per_member():
    """A face and an edge at aligned columns keep 16-byte copies; a
    corner does not (its row stride is one element), nor a relay at an
    odd column, nor any member once the staging row is unaligned."""
    members = [(1 << 20, 16384, 16384), (2 << 20, 4096, 128), (3 << 20, 1, 1),
               ((4 << 20) + 4 * 3, 4096, 127)]
    rows, _ = hk.pack_plan(members, 8, 4, 1 << 24)
    assert [r[2] for r in rows] == [0, 16384, 16512, 16513]
    assert [r[6] for r in rows] == [1, 1, 0, 0]
    rows, _ = hk.pack_plan(members[:3], 8, 4, 1 << 24)   # 16513 columns a row
    assert [r[6] for r in rows] == [0, 0, 0]


def test_pack_plan_refuses_what_the_kernel_cannot_index():
    with pytest.raises(ValueError, match="2\\^31"):
        hk.pack_plan([(0, 2 ** 31, 4)], 2, 4, 0)
    assert hk.pack_plan([(0, 4, 0)], 8, 4, 0) == ([], 0)


def test_rmsnorm_partition_is_a_function_of_d_alone():
    assert list(inspect.signature(rk.partition).parameters) == ["d"]
    # (groups of 8 columns, slots) at the served widths
    assert {d: rk.partition(d) for d in (8, 256, 1000, 1152, 2560, 5120, 8192, 32768)} == {
        8: (1, 32), 256: (32, 32), 1000: (125, 64), 1152: (144, 128), 2560: (320, 256),
        5120: (640, 512), 8192: (1024, 512), 32768: (4096, 1024)}


def test_rmsnorm_route_is_a_function_of_rows_d_dtype():
    assert list(inspect.signature(rk.route).parameters) == ["rows", "d", "dtype"]
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {(4096, 1152, bf16): "rows", (4, 1152, bf16): "team", (16, 256, bf16): "team",
             (4, 2560, bf16): "team", (4, 5120, bf16): "team",
             (16384, 256, bf16): "rows", (2048, 2560, bf16): "team",
             (1024, 2048, bf16): "rows", (1023, 2048, bf16): "team",
             (1024, 2049, bf16): "team", (4096, 1024, f32): "rows",
             (4096, 1025, f32): "team"}
    assert {c: rk.route(*c) for c in cases} == cases


@pytest.mark.parametrize("d", [1, 8, 9, 255, 256, 257, 1000, 1152, 1536, 2048, 2560, 5120,
                               8192, 8200, 16384, 16392, 32768])
def test_both_routes_deal_groups_to_the_partitions_slots(d):
    """The thread layouts of ``csrc/rmsnorm.cu``: on the rows route lane
    l's i-th group (g = l + 32 i, NG = pow2ceil(ceil(G / 32)) groups a
    lane) adds to slot l + 32 (i mod K) with K = max(1, NG / 2); on the
    team route (32 K threads, K = slots / 32) thread t's groups t + 32 K
    i add to slot t.  Both must put group g in slot g mod slots, in
    increasing g within a slot."""
    groups, slots = rk.partition(d)
    if d <= 2048:
        ng = 1 << max(0, (-(-groups // 32) - 1).bit_length())
        k = max(1, ng // 2)
        rows_slot = {l + 32 * i: l + 32 * (i % k) for l in range(32) for i in range(ng)}
        assert all(rows_slot[g] == g % slots for g in range(groups))
    team_slot = {t + slots * i: t for t in range(slots) for i in range(-(-groups // slots))}
    assert all(team_slot[g] == g % slots for g in range(groups))
    assert slots * 4 >= groups and slots <= 1024   # at most 4 groups a thread, 32 warps


# --------------------------------------------------------------------------
# box plans: halo_pack, halo_unpack_add and pack_boundary
# --------------------------------------------------------------------------

BOX_BLOCKS = [(5, 4, 6), (128, 128, 128), (1, 7, 3), (4, 4, 4)]
BOX_DTYPES = [torch.float32, torch.bfloat16]
_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _decode_boxes(kernel, rows, n_ctas, n_ranks, block, packed_stride, itemsize, box_addr,
                  packed_addr):
    """Every (block element, packed element) pair a box launch of
    ``kernel`` ("unpack" or "pack") moves, decoding each CTA and thread
    of the (``n_ctas``, ``n_ranks``) grid as ``csrc/halo_pack.cu`` does:
    the row by the last first CTA at or below the CTA (``rows`` lead
    with it), the slab and tile once a CTA, an element's run by the
    row's multiplier.  A thread of a row with both flags takes ``V = 16
    / itemsize`` consecutive packed elements; elsewhere the unpack's
    takes every 256th from its own, the pack's again ``V`` consecutive.
    Asserts that no CTA is idle and that every access a flag makes 16
    bytes wide is aligned and, on the block side, contiguous.  Returns
    the block and packed element indices in packed order."""
    v = 16 // itemsize
    tile = hk.TILE_BYTES // itemsize
    threads = tile // v
    table = np.array(rows, dtype=np.int64).reshape(-1, len(hk.BOX_FIELDS))
    cta = np.tile(np.arange(n_ctas), n_ranks)
    rank = np.repeat(np.arange(n_ranks), n_ctas)[:, None, None]
    g = table[np.searchsorted(table[:, 0], cta, side="right") - 1]
    (first, base, run, runs, run_stride, slabs, slab_stride, offset, tiles, flags, magic,
     shift) = (g[:, f, None, None] for f in range(len(hk.BOX_FIELDS)))
    local = cta[:, None, None] - first
    a = np.where(slabs > 1, local // tiles, 0)
    n = runs * run
    start = (local - a * tiles) * tile
    t, e = np.arange(threads)[None, :, None], np.arange(v)[None, None, :]
    both = flags == hk.PACKED_VEC | hk.BOX_VEC
    strided = ~both if kernel == "unpack" else np.zeros_like(both)
    p = start + np.where(strided, t + e * threads, t * v + e)
    b = (p * magic) >> shift
    assert (b == p // run).all()
    box = rank * (block[0] * block[1] * block[2]) + base + a * slab_stride + b * run_stride \
        + (p - b * run)
    packed = rank * packed_stride + offset + a * n + p
    valid = p < n
    assert valid.reshape(len(cta), -1).any(axis=1).all(), "a CTA has nothing to move"
    full = valid.all(axis=2) & ~strided[..., 0]
    packed_vec = full & (both | (flags & hk.PACKED_VEC > 0))[..., 0]
    box_vec = full & both[..., 0]
    assert ((packed_addr + packed[..., 0] * itemsize) % 16 == 0)[packed_vec].all()
    assert ((box_addr + box[..., 0] * itemsize) % 16 == 0)[box_vec].all()
    assert (box - box[..., :1] == np.arange(v))[box_vec].all()
    box, packed = box[valid], packed[valid]
    order = np.argsort(packed, kind="stable")
    return box[order], packed[order]


def _field(lead, block, dtype, seed):
    n = int(np.prod(lead)) * int(np.prod(block))
    x = np.random.RandomState(seed).standard_normal(n).astype(np.float32)
    return torch.from_numpy(x).to(dtype).view(*lead, *block)


def _flat_index(lead, block) -> torch.Tensor:
    return torch.arange(int(np.prod(lead)) * int(np.prod(block))).view(*lead, *block)


@pytest.mark.parametrize("n_ranks", [1, 8])
@pytest.mark.parametrize("dtype", BOX_DTYPES)
@pytest.mark.parametrize("block", BOX_BLOCKS)
def test_unpack_box_plans_scatter_as_the_plain_version(block, dtype, n_ranks):
    """The 26 regions of a block, each one ``halo_unpack_add`` launch:
    every element of the region is added once, from its own message
    element, and the emulated scatter equals ``ref.halo_unpack_add`` bit
    for bit (a bfloat16 add in float32, rounded once)."""
    lead, itemsize = (n_ranks,), torch.empty((), dtype=dtype).element_size()
    u = _field(lead, block, dtype, 0)
    index = _flat_index(lead, block)
    for direction in DIRECTIONS:
        region = _region_for(direction, block)
        row, n_ctas = hk.box_plan(block, region, n_ranks, itemsize, 0, 0)
        size = ref.region_size(region)
        assert n_ctas == -(-size // (hk.TILE_BYTES // itemsize))   # one slab a rank
        box, packed = _decode_boxes("unpack", [(0, *row)], n_ctas, n_ranks, block, size,
                                    itemsize, 0, 0)
        assert torch.equal(torch.from_numpy(packed), torch.arange(n_ranks * size))
        assert torch.equal(torch.from_numpy(box), index[(..., *region)].flatten())
        msg = _field(lead, ref.region_shape(region), dtype, 1)
        flat = u.clone().view(-1)
        got = (flat[box].float() + msg.view(-1)[packed].float()).to(dtype)
        want = ref.halo_unpack_add(u.clone(), msg, region)[(..., *region)].flatten()
        assert torch.equal(got.view(_BITS[dtype]), want.view(_BITS[dtype]))


@pytest.mark.parametrize("base", ["aligned", "unaligned"])
@pytest.mark.parametrize("n_ranks", [1, 8])
@pytest.mark.parametrize("dtype", BOX_DTYPES)
@pytest.mark.parametrize("block", [(128, 128, 128), (9, 5, 7)])
def test_halo_pack_plans_gather_as_the_plain_version(block, dtype, n_ranks, base):
    """The 26 regions of a block, each one ``halo_pack`` launch: a
    ``pack_boundary`` of one region whose segment is the slab's whole
    row, decoded as the gather does (V consecutive packed elements a
    thread).  Every slab element is copied once, from its own block
    element, and the emulated gather equals ``ref.halo_pack`` bit for
    bit; on an unaligned block (one element off 16 bytes) the block side
    takes no 16-byte access."""
    lead, itemsize = (n_ranks,), torch.empty((), dtype=dtype).element_size()
    u_addr = 0 if base == "aligned" else itemsize
    u = _field(lead, block, dtype, 3)
    for direction in DIRECTIONS:
        region = _region_for(direction, block)
        row, n_ctas = hk.box_plan(block, region, n_ranks, itemsize, u_addr, 0)
        size = ref.region_size(region)
        assert n_ctas == -(-size // (hk.TILE_BYTES // itemsize))   # one slab a rank
        if base == "unaligned":
            assert not row[8] & hk.BOX_VEC
        box, packed = _decode_boxes("pack", [(0, *row)], n_ctas, n_ranks, block, size,
                                    itemsize, u_addr, 0)
        assert torch.equal(torch.from_numpy(packed), torch.arange(n_ranks * size))
        got = u.view(-1)[box].view(n_ranks, *ref.region_shape(region))
        want = ref.halo_pack(u, region)
        assert torch.equal(got.view(_BITS[dtype]), want.view(_BITS[dtype]))


@pytest.mark.parametrize("n_ranks", [1, 8])
@pytest.mark.parametrize("dtype", BOX_DTYPES)
@pytest.mark.parametrize("block", BOX_BLOCKS)
def test_boundary_plan_gathers_as_the_plain_version(block, dtype, n_ranks):
    """All 26 regions in one ``pack_boundary`` launch: the CTAs cover
    every element of the packed buffer exactly once, and the emulated
    gather equals ``ref.pack_boundary`` bit for bit."""
    lead, itemsize = (n_ranks,), torch.empty((), dtype=dtype).element_size()
    regions = [_region_for(d, block) for d in DIRECTIONS]
    rows, n_ctas, total = hk.boundary_plan(block, regions, n_ranks, itemsize, 0, 0)
    firsts = [r[0] for r in rows]
    assert firsts == sorted(set(firsts)) and firsts[0] == 0
    box, packed = _decode_boxes("pack", rows, n_ctas, n_ranks, block, total, itemsize, 0, 0)
    assert torch.equal(torch.from_numpy(packed), torch.arange(n_ranks * total))
    u = _field(lead, block, dtype, 2)
    got = u.view(-1)[box].view(n_ranks, total)
    assert torch.equal(got.view(_BITS[dtype]), ref.pack_boundary(u, regions).view(_BITS[dtype]))


def test_boundary_plan_of_the_faces_field_has_no_idle_cta():
    """The 26 regions of a 128^3 float32 block of 8 ranks: 6 faces of 16
    tiles, 12 edges and 8 corners of one, on each of 8 ranks -- 116 x 8 =
    928 CTAs, all with elements (the old grid launched 13 312, 3 232
    with elements)."""
    block = (128, 128, 128)
    regions = [_region_for(d, block) for d in DIRECTIONS]
    rows, n_ctas, total = hk.boundary_plan(block, regions, 8, 4, 0, 0)
    assert (len(rows), n_ctas, total) == (26, 6 * 16 + 12 + 8, 99848)


@pytest.mark.parametrize("direction,form", [
    ((1, 0, 0), (1, 16384, 1, 0)),       # x-face: one run of py * pz
    ((0, 1, 0), (1, 128, 128, 16384)),   # y-face: px runs of pz
    ((0, 0, 1), (1, 1, 16384, 128)),     # z-face: runs of 1 at stride pz
    ((0, 1, 1), (1, 1, 128, 16384)),     # edge along x: stride py * pz
    ((1, 0, 1), (1, 1, 128, 128)),       # edge along y: stride pz
    ((1, 1, 0), (1, 128, 1, 0)),         # edge along z: one run of rz
    ((1, 1, 1), (1, 1, 1, 0)),           # corner
])
def test_collapse_box_merges_what_is_contiguous(direction, form):
    """(slabs, run, runs, run_stride) of each region class of a 128^3
    block; a box contiguous in no dimension pair keeps two levels."""
    base, run, runs, run_stride, slabs, slab_stride = hk.collapse_box(
        (128, 128, 128), _region_for(direction, (128, 128, 128)))
    assert (slabs, run, runs, run_stride) == form and slab_stride == 0
    assert hk.collapse_box((4, 5, 6), (slice(1, 3), slice(1, 3), slice(2, 5))) == (
        (1 * 5 + 1) * 6 + 2, 3, 2, 6, 2, 30)


def test_box_flags_fall_exactly_when_an_alignment_breaks():
    """A y-face whose runs are 16 bytes or longer keeps both flags; each
    condition in turn is broken by one element (or by one byte of
    address), and the flag of its side falls exactly when any of that
    side's conditions is."""
    for itemsize in (4, 2):
        el, v = itemsize, 16 // itemsize
        for pz, box_addr, packed_addr, offset, pad, n_ranks in itertools.product(
                (4 * v, 4 * v + 1), (0, el), (0, el), (0, 1), (0, 1), (1, 2)):
            block = (3, 5, pz)
            region = (slice(0, 3), slice(1, 2), slice(0, pz))
            size = 3 * pz
            stride = -(-(size + 1) // v) * v + pad
            row, _ = hk.box_plan(block, region, n_ranks, itemsize, box_addr, packed_addr,
                                 offset, stride)
            packed = (packed_addr % 16 == 0 and offset * el % 16 == 0
                      and (n_ranks == 1 or stride * el % 16 == 0))
            boxed = (box_addr % 16 == 0 and pz * el % 16 == 0
                     and (n_ranks == 1 or 3 * 5 * pz * el % 16 == 0))
            assert row[8] == hk.PACKED_VEC * packed + hk.BOX_VEC * boxed


def test_box_plans_of_the_main_path_take_16_byte_accesses():
    """At the Faces field's layout (aligned buffers, a 128^3 block of 8
    ranks) the message of every face and edge is 16 bytes a thread in
    both dtypes (a corner's, one element a rank, is not), and so is the
    block side of the regions that span z: the x- and y-faces and the
    edges along z.  In the boundary buffer every face and edge stores 16
    bytes a thread (a corner is one element)."""
    block = (128, 128, 128)
    regions = [_region_for(d, block) for d in DIRECTIONS]
    for itemsize in (4, 2):
        for d, region in zip(DIRECTIONS, regions):
            row, _ = hk.box_plan(block, region, 8, itemsize, 0, 0)
            packed = sum(map(abs, d)) < 3
            assert row[8] == hk.PACKED_VEC * packed + hk.BOX_VEC * (d[2] == 0), d
        rows, _, _ = hk.boundary_plan(block, regions, 8, itemsize, 0, 0)
        assert all(r[9] & hk.PACKED_VEC for r in rows[:18])


@pytest.mark.parametrize("d", [1, 2, 3, 7, 127, 128, 129, 16384, 16385, 99848,
                               2 ** 30 + 1, 2 ** 31 - 1])
def test_divider_divides_every_31_bit_dividend(d):
    """The kernels' run divider against ``//`` on dividends at the ends of
    the 31-bit range and around multiples of ``d``."""
    m, s = hk.divider(d)
    assert 0 < m < 2 ** 32
    near = [k * d + e for k in (1, 2, 3, (2 ** 31 - 1) // d) for e in (-1, 0, 1)]
    ns = np.array([0, 1, 2, 2 ** 31 - 2, 2 ** 31 - 1] + [n for n in near if 0 <= n < 2 ** 31]
                  + list(np.random.RandomState(d % 1000).randint(0, 2 ** 31 - 1, 2000)),
                  dtype=np.uint64)
    assert ((ns * np.uint64(m)) >> np.uint64(s) == ns // np.uint64(d)).all()


def test_box_plan_refuses_what_the_kernel_cannot_index():
    with pytest.raises(ValueError, match="2\\^31"):
        hk.box_plan((1024, 1024, 2048), (slice(0, 1), slice(0, 1), slice(0, 1)), 2, 4, 0, 0)
    with pytest.raises(ValueError, match="ranks"):
        hk.box_plan((4, 4, 4), (slice(0, 1), slice(0, 4), slice(0, 4)), 65536, 4, 0, 0)
    assert hk.box_plan((4, 4, 4), (slice(0, 0), slice(0, 4), slice(0, 4)), 8, 4, 0, 0) == (
        None, 0)


# --------------------------------------------------------------------------
# unpack_segments: the flat tile plan turned round
# --------------------------------------------------------------------------


def _unpack_tiles(members, n_ranks, itemsize, buf_addr, total):
    """Every CTA of an ``unpack_plan`` launch decoded as
    ``unpack_segments_kernel`` does (the last member whose first CTA is
    at or below it; rank-major tiles): ``(member, rank, plan row,
    columns)`` each, asserting that no CTA is without columns."""
    tile = hk.TILE_BYTES // itemsize
    rows, n_ctas = hk.unpack_plan(members, n_ranks, itemsize, buf_addr, total)
    firsts = [r[4] for r in rows]
    assert firsts == sorted(set(firsts)) and firsts[:1] in ([], [0])
    out = []
    for b in range(n_ctas):
        row = rows[max(i for i, f in enumerate(firsts) if f <= b)]
        rank, t = divmod(b - row[4], row[3])
        cols = range(t * tile, min(t * tile + tile, row[2]))
        assert len(cols) > 0, f"CTA {b} has nothing to copy"
        out.append((row[6], rank, row, cols))
    return out, n_ctas, rows


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n_ranks", [1, 3, 8])
@pytest.mark.parametrize("sizes", [
    [16384, 128, 128, 128, 128, 1, 1, 1, 1],   # a Faces transfer: face, edges, corners
    [0, 1, 3, 127, 1024, 1025, 2048, 2049, 0],
    [5] * 64,
    [0, 7],
    [0, 0],
])
def test_unpack_tiles_write_every_column_once(sizes, n_ranks, itemsize):
    """The grid is exactly sum_j ceil(n_j / tile) x ranks CTAs, and they
    write every (member, rank, column) once; a member without columns
    owns no CTA."""
    total = sum(sizes) + 3
    offsets = [(37 * j) % (total - n + 1) for j, n in enumerate(sizes)]
    members = [(4096 * (j + 1), off, n) for j, (off, n) in enumerate(zip(offsets, sizes))]
    tiles, n_ctas, rows = _unpack_tiles(members, n_ranks, itemsize, 0, total)
    tile = hk.TILE_BYTES // itemsize
    assert n_ctas == sum(-(-n // tile) for n in sizes) * n_ranks
    written = [(j, rank, c) for j, rank, _, cols in tiles for c in cols]
    assert sorted(written) == sorted((j, r, c) for j, n in enumerate(sizes)
                                     for r in range(n_ranks) for c in range(n))
    assert [r[6] for r in rows] == [j for j, n in enumerate(sizes) if n]


@pytest.mark.parametrize("dtype", BOX_DTYPES)
@pytest.mark.parametrize("n_ranks", [1, 8])
def test_unpack_plan_copies_as_the_plain_version(dtype, n_ranks):
    """The plan's copies, emulated CTA by CTA with the masks read as the
    kernel reads them (a CTA of a masked-out rank returns at once),
    equal ``ref.unpack_segments`` bit for bit: without masks, with
    random ones, and with a whole member masked out for every rank,
    whose slab keeps its values."""
    sizes = [16384, 127, 3, 1, 0, 128, 1025]
    total = sum(sizes) + 5
    offsets = [(37 * j) % (total - n + 1) for j, n in enumerate(sizes)]
    buf = _field((n_ranks,), (total, 1, 1), dtype, 7).view(n_ranks, total)
    rand = torch.from_numpy(np.random.RandomState(n_ranks).rand(len(sizes), n_ranks) < 0.5)
    whole = rand.clone()
    whole[0] = False
    itemsize = buf.element_size()
    for masks in (None, rand, whole):
        want = [torch.full((n_ranks, n), -1.0, dtype=dtype) for n in sizes]
        got = [t.clone() for t in want]
        ref.unpack_segments(buf, want, offsets, masks)
        members = [(g.data_ptr(), off, n) for g, off, n in zip(got, offsets, sizes)]
        by_addr = {g.data_ptr(): g for g in got}
        tiles, _, _ = _unpack_tiles(members, n_ranks, itemsize, buf.data_ptr(), total)
        for j, rank, (dst, col, *_), cols in tiles:
            if masks is not None and not masks[j, rank]:
                continue
            cols = torch.tensor(cols)
            by_addr[dst][rank, cols] = buf[rank, col + cols]
        for g, w in zip(got, want):
            assert torch.equal(g.view(_BITS[dtype]), w.view(_BITS[dtype]))
        if masks is whole:
            assert bool((got[0] == -1.0).all())


def test_unpack_vector_flag_falls_exactly_when_an_alignment_breaks():
    """The five conditions -- the buffer's address, its row stride, the
    member's column, the slab's address and its row -- each broken by one
    element in turn: the flag is set exactly when none is."""
    for el in (4, 2):
        for buf, total, col, n, dst in itertools.product(
                (4096, 4096 + el), (2048, 2049), (8, 9), (1024, 1025), (1 << 20, (1 << 20) + el)):
            rows, _ = hk.unpack_plan([(dst, col, n)], 8, el, buf, total)
            want = (buf % 16 == 0 and total * el % 16 == 0 and col * el % 16 == 0
                    and dst % 16 == 0 and n * el % 16 == 0)
            assert rows[0][5] == want


def test_unpack_faces_transfer_is_one_wave():
    """A 128^2 float32 face and eight edges and corners of 8 ranks: (16 +
    8) x 8 = 192 CTAs, under one wave of 132 SMs' 8 resident CTAs of 256
    threads; the face and the edges copy 16 bytes a thread, the corners
    do not (their rows are one element)."""
    sizes = [16384] + [128] * 4 + [1] * 4
    offsets = [0, *itertools.accumulate(sizes)][:-1]
    members = [(4096 * (j + 1), off, n) for j, (off, n) in enumerate(zip(offsets, sizes))]
    _, n_ctas, rows = _unpack_tiles(members, 8, 4, 0, sum(sizes))
    assert n_ctas == 192 <= 132 * 8
    assert [r[5] for r in rows] == [1] * 5 + [0] * 4


# --------------------------------------------------------------------------
# unpack_boundary_add: the ordered cell plan
# --------------------------------------------------------------------------

CELL_BLOCKS = [(128, 128, 128), (9, 5, 7), (5, 4, 6), (4, 4, 4), (2, 1, 3), (1, 1, 1)]


def _shell(block, mirrored=False):
    """The 26 regions of a block in DIRECTIONS order (``mirrored``: the
    ``-d`` regions the one-buffer path unpacks into)."""
    return [_region_for(tuple(-x for x in d) if mirrored else d, block) for d in DIRECTIONS]


@pytest.mark.parametrize("block", CELL_BLOCKS)
def test_cells_cover_the_union_once_with_ordered_covers(block):
    """The cells are disjoint and cover exactly the union of the
    regions, and each cell's cover list is the regions that hold every
    one of its elements, in region order (those that hold any of them
    hold all)."""
    regions = _shell(block)
    count = np.zeros(block, dtype=np.int64)
    union = np.zeros(block, dtype=bool)
    masks = []
    for r in regions:
        m = np.zeros(block, dtype=bool)
        m[r] = True
        masks.append(m)
        union |= m
    for box, covers in hk.cell_boxes(regions):
        count[box] += 1
        held = [k for k, m in enumerate(masks) if m[box].all()]
        assert [k for k, m in enumerate(masks) if m[box].any()] == held
        assert list(covers) == held
    assert ((count == 1) == union).all() and (count <= 1).all()


def test_cells_of_a_faces_shell():
    """26 cells on a block of at least 3 points a side: 6 face interiors
    covered by 1 region, 12 edge interiors by 3, 8 corners by 7."""
    cells = hk.cell_boxes(_shell((128, 128, 128)))
    assert sorted(len(c) for _, c in cells) == [1] * 6 + [3] * 12 + [7] * 8


def _decode_cells(cells, covers, n_ctas, n_ranks, block, total, itemsize, u_addr, buf_addr):
    """Every element of an ``unpack_boundary_plan`` launch decoded as
    ``unpack_boundary_add_kernel`` does, cell by cell: a CTA's cell by
    the last first CTA at or below it, an element's run and slab by the
    row's two multipliers, its segment element in each cover as the
    cover's start plus the steps.  A thread of a ``vec`` cell takes ``V
    = 16 / itemsize`` consecutive elements, any other every 256th from
    its own.  Asserts that no CTA is idle and that every 16-byte access
    is aligned and contiguous on ``u`` and on every segment.  Returns
    ``[(u indices, segment indices per cover)]`` a cell."""
    v, tile = 16 // itemsize, hk.TILE_BYTES // itemsize
    threads = tile // v
    table = np.array(cells, dtype=np.int64).reshape(-1, len(hk.CELL_FIELDS))
    cov = np.array(covers, dtype=np.int64).reshape(-1, len(hk.COVER_FIELDS))
    firsts = table[:, 0]
    assert firsts[0] == 0 and (np.diff(firsts) > 0).all()
    assert (np.append(firsts[1:], n_ctas) - firsts == table[:, 7]).all()
    block_size = block[0] * block[1] * block[2]
    out = []
    for i, (first, base, run, runs, run_stride, slabs, slab_stride, tiles, vec, magic, shift,
            runs_magic, runs_shift, c0, nc) in enumerate(table):
        cta = np.arange(first, first + tiles)
        assert (np.searchsorted(firsts, cta, side="right") - 1 == i).all()
        rank = np.arange(n_ranks)[:, None, None, None]
        start = ((cta - first) * tile)[None, :, None, None]
        t, e = np.arange(threads)[None, None, :, None], np.arange(v)[None, None, None, :]
        p = start + (t * v + e if vec else t + e * threads)
        n = slabs * runs * run
        valid = np.broadcast_to(p < n, (n_ranks, *p.shape[1:]))
        assert valid.reshape(n_ranks, len(cta), -1).any(axis=2).all(), "a CTA is idle"
        r = (p * magic) >> shift
        a = (r * runs_magic) >> runs_shift
        assert (r == p // run).all() and (a == r // runs).all()
        b, c = r - a * runs, p - r * run
        u_idx = rank * block_size + base + a * slab_stride + b * run_stride + c
        seg_idx = [rank * total + start_k + a * slab_k + b * run_k + c
                   for start_k, run_k, slab_k in cov[c0:c0 + nc]]
        if vec:
            assert run % v == 0 and (valid.all(axis=3) == valid[..., 0]).all()
            for idx, addr in [(u_idx, u_addr)] + [(s, buf_addr) for s in seg_idx]:
                idx = np.broadcast_to(idx, valid.shape)
                assert ((addr + idx[..., 0] * itemsize) % 16 == 0)[valid[..., 0]].all()
                assert (idx - idx[..., :1] == np.arange(v))[valid].all()
        out.append((np.broadcast_to(u_idx, valid.shape)[valid],
                     [np.broadcast_to(s, valid.shape)[valid] for s in seg_idx]))
    return out


def _cell_adds(u, buf, regions, u_addr=0, buf_addr=0):
    """``u`` after the adds of the cell plan, emulated as the kernel makes
    them (one add a cover, in order, each rounded to the dtype), and
    the u indices written."""
    block, itemsize = tuple(u.shape[-3:]), u.element_size()
    n_ranks = u.numel() // int(np.prod(block))
    cells, covers, n_ctas, total = hk.unpack_boundary_plan(block, regions, n_ranks, itemsize,
                                                           u_addr, buf_addr)
    flat, src = u.clone().view(-1), buf.reshape(-1)
    written = []
    for u_idx, seg_idx in _decode_cells(cells, covers, n_ctas, n_ranks, block, total,
                                        itemsize, u_addr, buf_addr):
        u_idx = torch.from_numpy(np.ascontiguousarray(u_idx))
        acc = flat[u_idx]
        for s in seg_idx:
            acc = (acc.float() + src[torch.from_numpy(np.ascontiguousarray(s))].float()
                   ).to(u.dtype)
        flat[u_idx] = acc
        written.append(u_idx)
    return flat.view(u.shape), torch.cat(written)


@pytest.mark.parametrize("n_ranks", [1, 8])
@pytest.mark.parametrize("dtype", BOX_DTYPES)
@pytest.mark.parametrize("block", CELL_BLOCKS)
def test_cell_plan_adds_as_the_plain_version(block, dtype, n_ranks):
    """The 26 regions of a block (as sent, and mirrored as the one-buffer
    path unpacks them) in one ``unpack_boundary_add`` launch: every
    element of the union is written once, by one thread, and the
    emulated adds equal ``ref.unpack_boundary_add`` bit for bit."""
    lead = (n_ranks,)
    u = _field(lead, block, dtype, 8)
    index = _flat_index(lead, block)
    for regions in (_shell(block), _shell(block, mirrored=True)):
        total = sum(ref.region_size(r) for r in regions)
        buf = _field(lead, (total, 1, 1), dtype, 9).view(n_ranks, total)
        got, written = _cell_adds(u, buf, regions)
        union = torch.zeros(block, dtype=torch.bool)
        for r in regions:
            union[r] = True
        assert torch.equal(written.sort().values, index[:, union].flatten().sort().values)
        want = ref.unpack_boundary_add(u.clone(), buf, regions)
        assert torch.equal(got.view(_BITS[dtype]), want.view(_BITS[dtype]))


def test_cell_plan_keeps_the_bf16_rounding_order():
    """Every segment adds 2^-8 to a block of ones: added one region at a
    time and rounded after each add, each add is half an ulp of 1.0 and
    rounds back to 1.0 (a sum of a corner's 7 segments first would give
    1.0234375)."""
    regions = _shell((4, 4, 4))
    u = torch.ones((2, 4, 4, 4), dtype=torch.bfloat16)
    buf = torch.full((2, 6 * 16 + 12 * 4 + 8), 2.0 ** -8, dtype=torch.bfloat16)
    got, _ = _cell_adds(u, buf, regions)
    assert torch.equal(got, ref.unpack_boundary_add(u.clone(), buf, regions))
    assert bool((got == 1.0).all())


def test_cell_plan_equals_the_jax_kernel():
    """On one (5, 4, 6) block, the emulated cell plan equals the JAX
    package's ``unpack_boundary_add_call`` in interpret mode."""
    import jax.numpy as jnp

    from repro.kernels.halo_pack import unpack_boundary_add_call

    block = (5, 4, 6)
    regions = _shell(block, mirrored=True)
    total = sum(ref.region_size(r) for r in regions)
    rs = np.random.RandomState(10)
    u = rs.standard_normal(block).astype(np.float32)
    buf = rs.standard_normal(total).astype(np.float32)
    got, _ = _cell_adds(torch.from_numpy(u)[None], torch.from_numpy(buf)[None], regions)
    want = unpack_boundary_add_call(jnp.asarray(u), jnp.asarray(buf), regions, interpret=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("itemsize", [4, 2])
def test_cell_plan_of_the_faces_field(itemsize):
    """The 26 mirrored regions of a 128^3 block of 8 ranks at aligned
    addresses: 34 cells, the interiors of the x- and y-faces cut in z at
    16-byte bounds, each middle taking 16 bytes a thread; 120 CTAs a
    rank for float32 (the old grid launched 13 312 for 8 ranks).  At an
    address one element off 16 bytes no cell takes the flag."""
    block = (128, 128, 128)
    regions = _shell(block, mirrored=True)
    v = 16 // itemsize
    cells, covers, n_ctas, total = hk.unpack_boundary_plan(block, regions, 8, itemsize, 0, 0)
    assert (len(cells), len(covers), total) == (34, 106, 99848)
    if itemsize == 4:
        assert n_ctas == 120
    vec = [c for c in cells if c[8]]
    assert len(vec) == 4
    assert all((c[2], c[1] % 128) == (128 - 2 * v, v) for c in vec)
    for u_addr, buf_addr in ((itemsize, 0), (0, itemsize)):
        cells, *_ = hk.unpack_boundary_plan(block, regions, 8, itemsize, u_addr, buf_addr)
        assert len(cells) == 26 and not any(c[8] for c in cells)


def test_cell_plan_refuses_what_the_table_cannot_hold():
    """Eight x-planes and eight y-planes of a 16^3 block cut it into 80
    cells, more than the kernel's table holds: a ``ValueError``, never
    a fallback."""
    regions = ([(slice(i, i + 1), slice(0, 16), slice(0, 16)) for i in range(8)]
               + [(slice(0, 16), slice(i, i + 1), slice(0, 16)) for i in range(8)])
    assert len(hk.cell_boxes(regions)) == 80
    with pytest.raises(ValueError, match="cells"):
        hk.unpack_boundary_plan((16, 16, 16), regions, 1, 4, 0, 0)
