"""The host-side plans of the port's redesigned kernels, on the CPU.

``pack_segments`` launches a flat list of tiles planned in Python
(``halo_pack.segment_tiles`` / ``pack_plan``), and ``rmsnorm`` picks
its route and its row partition in Python (``rmsnorm.route`` /
``partition``).  These tests hold the plans to what the CUDA kernels
rely on: the tiles cover every (member, rank, column) exactly once with
no idle CTA, the 16-byte flag is set only where every alignment
condition holds, and the norm's route is a function of (rows, d, dtype)
and its partition of d alone -- one that both routes' thread layouts
follow.  The kernels themselves run in ``tests/test_torch_gpu.py``.
"""

import inspect
import itertools

import pytest
import torch

from repro_torch.kernels import halo_pack as hk
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
