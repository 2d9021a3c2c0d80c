"""Tests that need the card (marker ``gpu``; they skip without CUDA).

Each hand-written CUDA kernel is held against its plain PyTorch version
on the same device inputs: the halo and boundary kernels bit for bit,
the SSD scan, flash attention and RMSNorm in float32 within the repo's
kernel-vs-reference bounds (rtol 2e-4 / atol 3e-5; RMSNorm 2e-5 /
1e-5), and in bfloat16 within one rounding of the output (2^-8 of the
two results' magnitudes; the SSD scan within ``chip_smoke.py``'s served
bf16 bound); flash attention's and the SSD scan's cases say which of
their two kernels (routes) each must take.  An RMSNorm row must come out the
same bits whatever rows, row stride and alignment it is launched with.
The engines' CUDA graphs and the
serve engines (mamba2 and gemma3 smoke models) are held against the CPU
run of the same program, and a warm serve prefill must be one graph
launch equal to the eager prefill bit for bit.  The convergence loop
(a graph conditional WHILE node set by the step kernel) is held against
the eager CPU loop, against ``FusedEngine`` called ``n_done`` times
(bit for bit), and its step kernel against the plain step on known
traces.  Composed schedules (the linked N-part Faces pipeline, one CUDA
stream a program) are held against the CPU run and the full-domain run
bit for bit; the captured graph has one stream's width a program; a
receiver that is slow to read its ghost planes is not overwritten by its
neighbour's next deposit; the sanitizer gives the same bits and refuses
a racy program before any launch.  This file imports no JAX, so it runs on a GPU
machine without it::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import make_mesh
from repro_torch.core import (
    FacesConfig,
    FusedEngine,
    HostEngine,
    PersistentEngine,
    SanitizeError,
    build_faces_part_program,
    build_faces_pipeline,
    build_faces_program,
    compose,
    faces_step_contiguous,
    global_residual_fn,
    merge_parts,
    part_configs,
    part_names,
    run_faces_persistent,
    run_faces_pipelined,
    run_faces_until_converged,
    split_parts,
    to_numpy,
)
from repro_torch.core.descriptors import KernelDesc, WaitDesc
from repro_torch.configs import get_config
from repro_torch.core.halo import AXES3, DIRECTIONS, _region_for
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import graph_loop
from repro_torch.kernels import halo_pack as hk
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rk
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch.serve import ServeEngine, serve, synthetic_batch
from repro_torch.models import Model
from repro_torch.models.nn import tree_leaves, tree_map

pytestmark = pytest.mark.gpu

REGIONS = [
    (slice(0, 1), slice(0, 5), slice(0, 7)),
    (slice(5, 6), slice(0, 1), slice(0, 7)),
    (slice(5, 6), slice(4, 5), slice(6, 7)),
    (slice(1, 5), slice(2, 3), slice(0, 7)),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(shape, dtype, device, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def _field(shape, dtype, device, seed):
    gen = torch.Generator(device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


# (ranks, block, region): four regions of a (6,5,7) block, then all 26
# DIRECTIONS regions of a 128^3 block of 8 ranks (the Faces field) and of a
# (9,5,7) block, whose pz breaks 16-byte alignment
HALO_CASES = ([((2, 3), (6, 5, 7), r) for r in REGIONS]
              + [((8,), (128, 128, 128), _region_for(d, (128, 128, 128))) for d in DIRECTIONS]
              + [((3,), (9, 5, 7), _region_for(d, (9, 5, 7))) for d in DIRECTIONS])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ranks,block,region", HALO_CASES)
def test_halo_kernels_equal_plain(cuda, ranks, block, region, dtype):
    u = _field((*ranks, *block), dtype, cuda, 0)
    before = dict(hk.launch_counts())
    assert torch.equal(hk.halo_pack(u, region), ref.halo_pack(u, region))
    msg = _field((*ranks, *ref.region_shape(region)), dtype, cuda, 1)
    got = hk.halo_unpack_add(u.clone(), msg, region)
    assert torch.equal(got, ref.halo_unpack_add(u.clone(), msg, region))
    after = hk.launch_counts()
    assert after["halo_pack"] == before["halo_pack"] + 1
    assert after["halo_unpack_add"] == before["halo_unpack_add"] + 1


SEG_SIZES = (16384, 127, 3, 1, 0)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("n_ranks", [1, 8])
@pytest.mark.parametrize("n_members", [1, 9, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_kernels_equal_plain(cuda, dtype, n_members, n_ranks, aligned):
    """Even members are slabs (read from column 0, 1 or 2), odd ones
    relays: column ranges of a received buffer read through a strided
    view, at columns that keep 16-byte alignment or not; member sizes
    cycle through SEG_SIZES.  The unpack reads the staged buffer back at
    arbitrary offsets (gaps and overlaps), without masks, with random
    ones, and with the first member masked out for every rank."""
    sizes = [SEG_SIZES[j % len(SEG_SIZES)] for j in range(n_members)]
    step, lead, pad = (8, 0, 8) if aligned else (8, 1, 3)
    relays = [j for j in range(n_members) if j % 2]
    cols, col = {}, lead
    for j in relays:
        cols[j] = col
        col += -(-sizes[j] // step) * step + step
    width = col + step
    recv = _randn((n_ranks, width + pad), dtype, cuda, 2)[:, :width]
    sources = [(recv, cols[j]) if j % 2 else
               (_randn((n_ranks, sizes[j] + j % 3), dtype, cuda, 3 + j), j % 3)
               for j in range(n_members)]
    before = hk.pack_segments.launches
    staged = hk.pack_segments(sources, sizes)
    assert hk.pack_segments.launches == before + 1
    assert torch.equal(staged, ref.pack_segments(sources, sizes))

    total = sum(sizes)
    offsets = [(37 * j) % (total - n + 1) for j, n in enumerate(sizes)]
    gen = torch.Generator().manual_seed(n_members)
    masks = (torch.rand(n_members, n_ranks, generator=gen) < 0.5).to(cuda)
    whole = masks.clone()
    whole[0] = False   # a whole member masked out for every rank keeps its values
    for m in (None, masks, whole):
        got = [torch.full((n_ranks, n), -1.0, dtype=dtype, device=cuda) for n in sizes]
        want = [t.clone() for t in got]
        hk.unpack_segments(staged, got, offsets, m)
        ref.unpack_segments(staged, want, offsets, m)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_kernels_refuse_what_they_do_not_take(cuda):
    u = torch.zeros(2, 6, 5, 7, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        hk.halo_pack(u.double(), REGIONS[0])
    with pytest.raises(ValueError, match="contiguous"):
        hk.halo_pack(u.transpose(1, 2), (slice(0, 1), slice(0, 5), slice(0, 5)))
    with pytest.raises(ValueError, match="exceeds"):
        hk.halo_pack(u, (slice(0, 7), slice(0, 5), slice(0, 7)))


@pytest.mark.parametrize("periodic", [False, True])
def test_engines_on_card_equal_cpu(cuda, periodic):
    n = 3
    cfg = FacesConfig(grid=(2, 2, 2), points=(6, 5, 4), periodic=periodic,
                      pack="kernel", damping=0.2)
    u0 = np.random.RandomState(4).randn(*cfg.grid, *cfg.points).astype(np.float32)
    cpu = build_faces_program(cfg, make_mesh(cfg.grid, AXES3, device="cpu"))
    want = to_numpy(PersistentEngine(cpu.persistent(n))(
        PersistentEngine(cpu.persistent(n)).init_buffers({"u": u0})))["u"]
    prog = build_faces_program(cfg, make_mesh(cfg.grid, AXES3))
    for mode in ("stream", "dataflow"):
        engines = [(FusedEngine(prog, mode=mode, donate=True), n),
                   (PersistentEngine(prog.persistent(n), mode=mode), 1)]
        if mode == "stream":
            engines.append((HostEngine(prog), n))
        for eng, calls in engines:
            mem = eng.init_buffers({"u": u0})
            for _ in range(calls):
                mem = eng(mem)
            np.testing.assert_array_equal(to_numpy(mem)["u"], want,
                                          err_msg=f"{type(eng).__name__} {mode}")
        assert engines[0][0].stats.dispatches == n
        assert engines[1][0].stats.dispatches == 1


# tests/test_kernels.py SSD_CASES, its init_state case, a tail case and a
# sequence shorter than one chunk
SSD_CASES = [
    dict(B=1, S=32, H=2, P=8, G=1, N=8, chunk=8, h0=False),
    dict(B=2, S=80, H=4, P=16, G=2, N=24, chunk=32, h0=False),
    dict(B=1, S=128, H=2, P=32, G=1, N=16, chunk=128, h0=False),
    dict(B=1, S=40, H=2, P=8, G=1, N=8, chunk=8, h0=True),
    dict(B=2, S=40, H=4, P=16, G=2, N=16, chunk=16, h0=True),
    dict(B=1, S=20, H=2, P=8, G=1, N=8, chunk=128, h0=True),  # S < chunk
    dict(B=2, S=300, H=4, P=64, G=1, N=128, chunk=128, h0=True),  # served widths
]


def _ssd_inputs(case, device, seed=8):
    rng = np.random.RandomState(seed)
    B, S, H, P, G, N = (case[k] for k in ("B", "S", "H", "P", "G", "N"))
    arrays = [rng.randn(B, S, H, P), np.abs(rng.randn(B, S, H)) * 0.1,
              -np.abs(rng.randn(H)), rng.randn(B, S, G, N), rng.randn(B, S, G, N),
              rng.randn(B, H, P, N) if case["h0"] else None]
    return [None if a is None else torch.from_numpy(a.astype(np.float32)).to(device)
            for a in arrays]


@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: f"S{c['S']}c{c['chunk']}N{c['N']}")
def test_ssd_kernel_matches_plain(cuda, case):
    x, dt, A, Bm, C, h0 = _ssd_inputs(case, cuda)
    before = ssd.ssd_scan.launches
    y, h = ssd.ssd_scan(x, dt, A, Bm, C, init_state=h0, chunk=case["chunk"],
                        return_state=True)
    torch.cuda.synchronize()
    assert ssd.ssd_scan.launches == before + 1
    yr, hr = ref.ssd_scan(x, dt, A, Bm, C, init_state=h0, return_state=True)
    torch.testing.assert_close(y, yr, rtol=2e-4, atol=3e-5)
    torch.testing.assert_close(h, hr, rtol=2e-4, atol=3e-5)


def test_ssd_kernel_reads_strided_bf16_views(cuda):
    """The served path's layout: bf16 x, B, C as views of one conv output."""
    B, S, H, P, G, N = 2, 70, 4, 64, 1, 128
    gen = torch.Generator(cuda).manual_seed(0)
    wide = torch.randn(B, S, H * P + 2 * G * N, device=cuda, generator=gen).bfloat16()
    x = wide[..., :H * P].reshape(B, S, H, P)
    Bm = wide[..., H * P:H * P + G * N].reshape(B, S, G, N)
    C = wide[..., H * P + G * N:].reshape(B, S, G, N)
    dt = torch.rand(B, S, H, device=cuda, generator=gen) * 0.2
    A = -torch.rand(H, device=cuda, generator=gen) - 0.5
    y, h = ssd.ssd_scan(x, dt, A, Bm, C, chunk=32, return_state=True)
    # against the plain version on float32 copies of the same values: the
    # kernel widens to float32 too, so only y's final bf16 rounding (at
    # most 2^-8 relative) and float32 reassociation separate them
    yr, hr = ref.ssd_scan(x.float(), dt, A, Bm.float(), C.float(), return_state=True)
    torch.testing.assert_close(h, hr, rtol=2e-4, atol=3e-5)
    assert bool(((y.float() - yr).abs() <= 2.0 ** -8 * yr.abs() + 3e-5).all())


def test_ssd_kernel_never_forms_the_upper_exponent(cuda):
    """chunk 128, dt ~ 1, A = -e: exp(cum_t - cum_u) for t < u would reach
    e^340 = inf; the kernel must select 0 there, never inf * 0."""
    B, S, H, P, N = 1, 256, 2, 64, 128
    gen = torch.Generator(cuda).manual_seed(1)
    x = torch.randn(B, S, H, P, device=cuda, generator=gen)
    Bm = torch.randn(B, S, 1, N, device=cuda, generator=gen)
    C = torch.randn(B, S, 1, N, device=cuda, generator=gen)
    dt = 1.0 + 0.01 * torch.rand(B, S, H, device=cuda, generator=gen)
    A = torch.full((H,), -float(np.e), device=cuda)
    y, h = ssd.ssd_scan(x, dt, A, Bm, C, chunk=128, return_state=True)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    yr, hr = ref.ssd_scan(x, dt, A, Bm, C, return_state=True)
    # Here cum falls to about -350 within a chunk, and the chunked form's
    # exponent cum_t - cum_u is a difference of two such numbers: each
    # rounds by ~350 x 2^-24 = 2e-5, which moves every term by that
    # fraction.  Where terms cancel, that error is relative to the sum of
    # the terms' magnitudes (the scan of |x|, |B|, |C|), not to the result,
    # so 1e-4 of that sum joins the repo's bound.  The JAX package's own
    # chunked form (Pallas, interpret mode) needs the same addition against
    # its sequential oracle on such inputs (tests/test_torch_ssd.py).
    yabs, habs = ref.ssd_scan(x.abs(), dt, A, Bm.abs(), C.abs(), return_state=True)
    assert bool(((y - yr).abs() <= 2e-4 * yr.abs() + 3e-5 + 1e-4 * yabs).all())
    assert bool(((h - hr).abs() <= 2e-4 * hr.abs() + 3e-5 + 1e-4 * habs).all())


def _served_ssd(cuda, B, S, H, G, kind, h0, seed):
    """bf16 x, B, C as views of one conv output (row stride H P + 2 G N),
    at the served widths P 64, N 128: ``"served"`` draws dt and A as the
    mamba2 prefill does, ``"extreme"`` the extreme decay above (dt ~ 1,
    A = -e)."""
    P, N = 64, 128
    gen = torch.Generator(cuda).manual_seed(seed)
    wide = torch.randn(B, S, H * P + 2 * G * N, device=cuda, generator=gen).bfloat16()
    x = wide[..., :H * P].reshape(B, S, H, P)
    Bm = wide[..., H * P:H * P + G * N].reshape(B, S, G, N)
    C = wide[..., H * P + G * N:].reshape(B, S, G, N)
    if kind == "served":
        dt = torch.nn.functional.softplus(torch.randn(B, S, H, device=cuda, generator=gen))
    else:
        dt = 1.0 + 0.01 * torch.rand(B, S, H, device=cuda, generator=gen)
    A = torch.full((H,), -float(np.e), device=cuda)
    h = torch.randn(B, H, P, N, device=cuda, generator=gen) if h0 else None
    return x, dt, A, Bm, C, h


def _within_served_bound(y, h, x, dt, A, Bm, C, h0):
    """``chip_smoke.py``'s served bf16 bound against the plain version:
    y within one bf16 rounding of each side plus (2^-8 + 2^-10) of the
    terms' magnitudes (the scan of |x|, |B|, |C|, |h0|), h within the
    latter; the plain version rounds each x*B product to bf16."""
    yp, hp = ref.ssd_scan(x, dt, A, Bm, C, init_state=h0, return_state=True)
    yabs, habs = ref.ssd_scan(x.float().abs(), dt, A, Bm.float().abs(), C.float().abs(),
                              init_state=None if h0 is None else h0.abs(), return_state=True)
    tol_y = 2.0 ** -8 * (y.float().abs() + yp.float().abs()) + (2.0 ** -8 + 2.0 ** -10) * yabs
    tol_h = (2.0 ** -8 + 2.0 ** -10) * habs
    return (bool(((y.float() - yp.float()).abs() <= tol_y).all())
            and bool(((h - hp).abs() <= tol_h).all()))


# bf16 at the served widths: the tensor-core route.  A short last chunk
# with init_state and 2 groups; one short chunk; the served prefill's 4
# chunks (one cluster); 11 chunks (a cluster of 8 walks two groups); the
# extreme decay
WGMMA_CASES = [dict(B=2, S=300, H=8, G=2, kind="served", h0=True),
               dict(B=1, S=100, H=4, G=1, kind="served", h0=False),
               dict(B=2, S=512, H=4, G=1, kind="served", h0=True),
               dict(B=1, S=1300, H=2, G=1, kind="served", h0=True),
               dict(B=1, S=256, H=2, G=1, kind="extreme", h0=False)]


@pytest.mark.parametrize("case", WGMMA_CASES,
                         ids=lambda c: f"S{c['S']}H{c['H']}G{c['G']}{c['kind']}")
def test_ssd_wgmma_route_meets_the_served_bound(cuda, case):
    x, dt, A, Bm, C, h0 = _served_ssd(cuda, **case, seed=case["S"])
    assert ssd.route(x.dtype, x.shape[3], Bm.shape[3], 128) == "wgmma"
    before = ssd.launch_counts()
    y, h = ssd.ssd_scan(x, dt, A, Bm, C, init_state=h0, chunk=128, return_state=True)
    torch.cuda.synchronize()
    after = ssd.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "ssd_scan": 1, "ssd_scan_wgmma": 1, "ssd_scan_cuda_core": 0}
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(h).all())
    assert _within_served_bound(y, h, x, dt, A, Bm, C, h0)
    if case["kind"] == "extreme":
        # the state also meets the float32 extreme-decay bound above,
        # against the plain version of the same values in float32
        _, hf = ref.ssd_scan(x.float(), dt, A, Bm.float(), C.float(), return_state=True)
        _, habs = ref.ssd_scan(x.float().abs(), dt, A, Bm.float().abs(), C.float().abs(),
                               return_state=True)
        assert bool(((h - hf).abs() <= 2e-4 * hf.abs() + 3e-5 + 1e-4 * habs).all())


@pytest.mark.parametrize("cluster", [1, 2, 3])
def test_ssd_wgmma_cluster_size_keeps_the_bound(cuda, cluster):
    """Three chunks in groups of 1, 2 or 3 CTAs (a group's last state
    carried on through hout): each meets the served bound."""
    x, dt, A, Bm, C, h0 = _served_ssd(cuda, 2, 300, 8, 2, "served", True, seed=3)
    y, h = ssd.ssd_scan_variant(x, dt, A, Bm, C, init_state=h0, cluster=cluster,
                                parts=ssd.PARTS)
    assert _within_served_bound(y, h, x, dt, A, Bm, C, h0)


def test_ssd_wgmma_route_copies_an_unaligned_view(cuda):
    """A view whose row stride breaks TMA's 16-byte rule (none on the
    served path) is copied first, and gives the result of its copy."""
    x, dt, A, Bm, C, h0 = _served_ssd(cuda, 1, 200, 2, 1, "served", True, seed=4)
    odd = torch.zeros(1, 200, 2 * 64 + 1, device=cuda, dtype=torch.bfloat16)
    odd[..., :128] = x.reshape(1, 200, 128)
    xv = odd[..., :128].reshape(1, 200, 2, 64)
    assert xv.stride(1) % 8
    got = ssd.ssd_scan(xv, dt, A, Bm, C, init_state=h0, chunk=128, return_state=True)
    want = ssd.ssd_scan(x.contiguous(), dt, A, Bm, C, init_state=h0, chunk=128,
                        return_state=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, A, Bm, C, _ = _ssd_inputs(SSD_CASES[0], cuda)
    with pytest.raises(TypeError, match="float32"):
        ssd.ssd_scan(x, dt.bfloat16(), A, Bm, C)
    with pytest.raises(TypeError, match="one dtype"):
        ssd.ssd_scan(x, dt, A, Bm.bfloat16(), C)
    wide = dict(SSD_CASES[0], P=72)  # the kernel holds P <= 64
    with pytest.raises(ValueError, match="P <= 64"):
        ssd.ssd_scan(*_ssd_inputs(wide, cuda)[:5])


@pytest.mark.parametrize("resident", [True, False])
def test_smoke_serve_on_card_equals_cpu(cuda, resident):
    cfg = get_config("mamba2-2.7b").smoke()
    params = Model(cfg).init(0, device="cpu")
    kw = dict(batch=4, prompt_len=40, gen_len=6, device_resident=resident)
    want, _ = serve(cfg, params=params, device="cpu",
                    batch_in=synthetic_batch(cfg, np.random.RandomState(0), 4, 40,
                                             device="cpu"), **kw)
    before = ssd.ssd_scan.launches
    got, stats = serve(cfg, params=tree_map(lambda t: t.to(cuda), params),
                       batch_in=synthetic_batch(cfg, np.random.RandomState(0), 4, 40),
                       **kw)
    np.testing.assert_array_equal(got, want)
    # a new engine's prefill graph: one eager warm-up pass, one captured
    # pass (counted at capture), then the launch, which counts nothing
    assert ssd.ssd_scan.launches == before + 2 * cfg.n_layers
    assert stats["decode_dispatches"] == (1 if resident else 5)
    eng = ServeEngine(cfg, slots=4, prompt_len=40, max_new=6)
    assert eng.device.type == "cuda"


# --------------------------------------------------------------------------
# boundary pack / unpack, RMSNorm, flash attention
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ranks,block", [((2, 3), (5, 4, 6)), ((8,), (128, 128, 128)),
                                         ((3,), (9, 5, 7)), ((8,), (1, 1, 1)),
                                         ((8,), (2, 1, 3))])
def test_boundary_kernels_equal_plain(cuda, ranks, block, dtype):
    regions = [_region_for(d, block) for d in DIRECTIONS]
    u = _field((*ranks, *block), dtype, cuda, 4)
    before = hk.launch_counts()
    buf = hk.pack_boundary(u, regions)
    assert torch.equal(buf, ref.pack_boundary(u, regions))
    msg = _field(tuple(buf.shape), dtype, cuda, 5)
    got = hk.unpack_boundary_add(u.clone(), msg, regions)
    assert torch.equal(got, ref.unpack_boundary_add(u.clone(), msg, regions))
    after = hk.launch_counts()
    assert after["pack_boundary"] == before["pack_boundary"] + 1
    assert after["unpack_boundary_add"] == before["unpack_boundary_add"] + 1


def test_boundary_unpack_refuses_a_cell_table_it_cannot_hold(cuda):
    """Eight x-planes and eight y-planes cut a 16^3 block into more cells
    than the kernel's table holds: a ValueError and no launch, never the
    plain version."""
    regions = ([(slice(i, i + 1), slice(0, 16), slice(0, 16)) for i in range(8)]
               + [(slice(0, 16), slice(i, i + 1), slice(0, 16)) for i in range(8)])
    u = torch.zeros((2, 16, 16, 16), device=cuda)
    buf = torch.ones((2, 16 * 256), device=cuda)
    before = hk.unpack_boundary_add.launches
    with pytest.raises(ValueError, match="cells"):
        hk.unpack_boundary_add(u, buf, regions)
    assert hk.unpack_boundary_add.launches == before and not bool(u.any())


def test_boundary_unpack_keeps_the_bf16_rounding_order(cuda):
    """Every segment adds 2^-8 to a block of ones.  Added one region at a
    time and rounded to bf16 after each add, as the reference does, each
    add is half an ulp of 1.0 and rounds back to 1.0 (ties to even); a
    sum of the segments first would give 1 + 7 x 2^-8 at a corner, which
    rounds to 1.0234375."""
    regions = [_region_for(d, (4, 4, 4)) for d in DIRECTIONS]
    u = torch.ones((2, 4, 4, 4), dtype=torch.bfloat16, device=cuda)
    buf = torch.full((2, 6 * 16 + 12 * 4 + 8), 2.0 ** -8, dtype=torch.bfloat16,
                     device=cuda)
    got = hk.unpack_boundary_add(u.clone(), buf, regions)
    assert torch.equal(got, ref.unpack_boundary_add(u.clone(), buf, regions))
    assert bool((got == 1.0).all())


def test_faces_step_contiguous_on_card_equals_the_host_engine(cuda):
    cfg = FacesConfig(grid=(2, 2, 2), points=(8, 8, 8), damping=0.12, pack="kernel")
    u0 = np.random.RandomState(6).randn(2, 2, 2, 8, 8, 8).astype(np.float32)
    mesh = make_mesh(cfg.grid, AXES3, device=cuda)
    host = HostEngine(build_faces_program(cfg, mesh))
    want = host(host.init_buffers({"u": u0}))["u"]
    before = hk.launch_counts()
    got = faces_step_contiguous(torch.from_numpy(u0).to(cuda), cfg)
    after = hk.launch_counts()
    assert torch.equal(got, want)
    assert after["pack_boundary"] == before["pack_boundary"] + 1
    assert after["unpack_boundary_add"] == before["unpack_boundary_add"] + 1


def _bf16_close(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Within one bf16 rounding of the output: both sides are float32
    results rounded to bf16, so they may land one ulp apart (at most
    2^-8 of their magnitudes) when the float32 values straddle a
    rounding boundary."""
    g, w = got.float(), want.float()
    return bool(((g - w).abs() <= 2.0 ** -8 * (g.abs() + w.abs()) + 1e-6).all())


NORM_SHAPES = [(37, 1152), (101, 256), (7, 2560), (3, 1000)] + [
    (rows, d) for rows in (1, 4, 16, 4097) for d in (256, 1152, 2560, 5120)]


@pytest.mark.parametrize("offset", [0.0, 1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", NORM_SHAPES)
def test_rmsnorm_kernel_matches_plain(cuda, rows, d, dtype, offset):
    x = _randn((rows, d), dtype, cuda, 7)
    w = _randn((d,), torch.float32, cuda, 8)
    before = rk.rmsnorm.launches
    got = rk.rmsnorm(x, w, eps=1e-6, weight_offset=offset)
    want = ref.rmsnorm(x, w, eps=1e-6, weight_offset=offset)
    assert rk.rmsnorm.launches == before + 1 and got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-5)
    else:
        assert _bf16_close(got, want)


@pytest.mark.parametrize("layout", ["contiguous", "stride+24", "stride+3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [256, 1000, 1152, 2560, 5120])
def test_rmsnorm_rows_are_independent(cuda, d, dtype, layout):
    """A row's output is the same bits whatever rows are launched with it
    (4097 rows take the rows route up to d 2048 in bf16, 1024 in float32;
    1, 4 and 16 the team route) and whatever its row stride and
    alignment (an odd stride takes element loads)."""
    extra = {"contiguous": 0, "stride+24": 24, "stride+3": 3}[layout]
    x = _randn((4097, d + extra), dtype, cuda, 11)[:, :d]
    w = _randn((d,), torch.float32, cuda, 12)
    full = rk.rmsnorm(x, w, weight_offset=1.0)
    for k in (1, 4, 16, 1500):
        assert torch.equal(rk.rmsnorm(x[:k], w, weight_offset=1.0), full[:k])
    assert torch.equal(rk.rmsnorm(x.contiguous(), w, weight_offset=1.0), full)
    assert torch.equal(rk.rmsnorm(x[1:], w, weight_offset=1.0), full[1:])


def test_rmsnorm_kernel_reads_strided_rows_and_leading_dims(cuda):
    wide = _randn((2, 3, 40, 264), torch.bfloat16, cuda, 9)
    x = wide[..., :256]            # row stride 264: read in place
    w = _randn((256,), torch.bfloat16, cuda, 10)
    got = rk.rmsnorm(x, w, weight_offset=1.0)
    assert tuple(got.shape) == (2, 3, 40, 256) and got.is_contiguous()
    assert _bf16_close(got, ref.rmsnorm(x, w, weight_offset=1.0))


BF16 = torch.bfloat16
FLASH_CASES = [
    # float32: the CUDA-core route, at the repo's bound
    # fully masked kv tiles: a window of 5 skips most tiles of a row block
    dict(B=1, Hq=2, Hkv=1, Sq=200, Skv=200, D=64, window=5),
    # rows that see no key at all: zeros
    dict(B=1, Hq=2, Hkv=1, Sq=40, Skv=40, D=32, window=0),
    # one query at the end of the cache
    dict(B=2, Hq=4, Hkv=1, Sq=1, Skv=300, D=128, q_offset=299),
    # window with GQA
    dict(B=2, Hq=8, Hkv=2, Sq=130, Skv=130, D=64, window=33),
    dict(B=1, Hq=2, Hkv=1, Sq=64, Skv=64, D=32, logit_softcap=15.0),
    dict(B=1, Hq=4, Hkv=1, Sq=150, Skv=150, D=256),
    dict(B=2, Hq=4, Hkv=1, Sq=70, Skv=200, D=256, q_offset=130, window=40),
    dict(B=1, Hq=2, Hkv=1, Sq=50, Skv=70, D=32, causal=False),
    dict(B=2, Hq=4, Hkv=4, Sq=48, Skv=48, D=16, causal=False),
    # bfloat16 at head_dim 64 / 128 / 256: the tensor-core route, within one
    # rounding of the output.  GQA groups 1, 4 and 8; ragged Sq and Skv
    dict(dtype=BF16, B=2, Hq=4, Hkv=4, Sq=100, Skv=100, D=64),
    dict(dtype=BF16, B=1, Hq=8, Hkv=2, Sq=130, Skv=130, D=128, window=7),
    dict(dtype=BF16, B=1, Hq=8, Hkv=1, Sq=200, Skv=333, D=256, q_offset=133),
    # the served layout ([B,S,H,D] views) with gemma3's window
    dict(dtype=BF16, B=2, Hq=4, Hkv=1, Sq=700, Skv=700, D=256, window=512, bshd=True),
    dict(dtype=BF16, B=1, Hq=2, Hkv=1, Sq=96, Skv=96, D=64, logit_softcap=15.0),
    # every row fully masked, and the first 10 rows (before any key)
    dict(dtype=BF16, B=1, Hq=2, Hkv=1, Sq=40, Skv=40, D=128, window=0),
    dict(dtype=BF16, B=1, Hq=4, Hkv=2, Sq=80, Skv=80, D=128, q_offset=-10),
    # one query at the end of a cache; a key-padding-free non-causal case
    dict(dtype=BF16, B=2, Hq=4, Hkv=2, Sq=1, Skv=300, D=256, q_offset=299),
    dict(dtype=BF16, B=1, Hq=2, Hkv=1, Sq=50, Skv=77, D=64, causal=False),
    # bfloat16 at head_dim 32: the CUDA-core route
    dict(dtype=BF16, B=1, Hq=2, Hkv=1, Sq=64, Skv=64, D=32, window=19),
]


def _case_id(case):
    return "-".join(f"{k}{'bf16' if v is BF16 else v}" for k, v in case.items())


@pytest.mark.parametrize("case", FLASH_CASES, ids=_case_id)
def test_flash_kernel_matches_plain(cuda, case):
    case = dict(case)
    B, Hq, Hkv, Sq, Skv, D = (case.pop(k) for k in ("B", "Hq", "Hkv", "Sq", "Skv", "D"))
    dtype, bshd = case.pop("dtype", torch.float32), case.pop("bshd", False)
    if bshd:   # [B,S,H,D] tensors passed as transposed views
        q = _randn((B, Sq, Hq, D), dtype, cuda, 11).transpose(1, 2)
        k = _randn((B, Skv, Hkv, D), dtype, cuda, 12).transpose(1, 2)
        v = _randn((B, Skv, Hkv, D), dtype, cuda, 13).transpose(1, 2)
    else:
        q = _randn((B, Hq, Sq, D), dtype, cuda, 11)
        k = _randn((B, Hkv, Skv, D), dtype, cuda, 12)
        v = _randn((B, Hkv, Skv, D), dtype, cuda, 13)
    route = "wgmma" if dtype == BF16 and D in (64, 128, 256) else "cuda_core"
    assert fk.route(dtype, D) == route
    before = fk.launch_counts()
    got = fk.flash_attention(q, k, v, **case)
    want = ref.attention(q, k, v, **case)
    after = fk.launch_counts()
    other = "cuda_core" if route == "wgmma" else "wgmma"
    assert after[f"flash_attention_{route}"] == before[f"flash_attention_{route}"] + 1
    assert after[f"flash_attention_{other}"] == before[f"flash_attention_{other}"]
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert got.dtype == dtype and got.transpose(1, 2).is_contiguous()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=3e-5)
    else:
        assert _bf16_close(got, want)
    if case.get("window") == 0:
        assert bool((got == 0).all())
    if case.get("q_offset", 0) < 0:
        assert bool((got[:, :, :-case["q_offset"]] == 0).all())


def test_flash_kernel_reads_the_model_layout_in_bf16(cuda):
    """gemma3's layout: q, k, v are [B,S,H,D] bf16 tensors passed as
    transposed views (no copy); the result is laid out [B,S,Hq,D]."""
    B, S, D = 2, 300, 256
    q = _randn((B, S, 4, D), torch.bfloat16, cuda, 14).transpose(1, 2)
    k = _randn((B, S, 1, D), torch.bfloat16, cuda, 15).transpose(1, 2)
    v = _randn((B, S, 1, D), torch.bfloat16, cuda, 16).transpose(1, 2)
    for window in (None, 64):
        got = fk.flash_attention(q, k, v, window=window)
        assert got.transpose(1, 2).is_contiguous() and got.dtype == torch.bfloat16
        assert _bf16_close(got, ref.attention(q, k, v, window=window))


def test_new_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fk.flash_attention(q, q[:, :1], q[:, :1])
    q = torch.zeros(1, 2, 8, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fk.flash_attention(q, q[:, :1], q[:, :1])
    # the tensor-core route loads through TMA: strides in multiples of 16 bytes
    q = torch.zeros(1, 2, 8, 68, device=cuda, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte"):
        fk.flash_attention(q, q[:, :1], q[:, :1])
    q = torch.zeros(1, 2, 8, 64, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fk.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="unit stride"):
        kt = torch.zeros(1, 2, 64, 8, device=cuda).transpose(2, 3)
        fk.flash_attention(q, kt, kt)
    x = torch.zeros(4, 64, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rk.rmsnorm(x.half(), torch.zeros(64, device=cuda))
    with pytest.raises(ValueError, match="merge"):
        rk.rmsnorm(torch.zeros(4, 6, 64, device=cuda).transpose(0, 1),
                   torch.zeros(64, device=cuda))
    with pytest.raises(ValueError, match="d <="):
        rk.rmsnorm(torch.zeros(2, rk.MAX_D + 1, device=cuda),
                   torch.zeros(rk.MAX_D + 1, device=cuda))
    regions = [_region_for(d, (4, 4, 4)) for d in DIRECTIONS]
    u = torch.zeros(2, 4, 4, 4, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        hk.pack_boundary(u.double(), regions)
    with pytest.raises(ValueError, match="contiguous"):
        hk.pack_boundary(u.transpose(1, 2), regions)


def _boosted_dense_params(cfg):
    """gemma3 smoke weights with the decoder's matrices scaled by 8, so
    that the served tokens depend on attention (``test_torch_dense.py``)."""
    params = Model(cfg).init(0, device="cpu")

    def boost(tree, name=""):
        if isinstance(tree, dict):
            return {k: boost(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [boost(v, name) for v in tree]
        return tree * 8 if name.startswith("w") else tree

    return {**params, "decoder": boost(params["decoder"])}


@pytest.mark.parametrize("resident", [True, False])
def test_dense_smoke_serve_on_card_equals_cpu(cuda, resident):
    cfg = get_config("gemma3-1b").smoke()
    params = _boosted_dense_params(cfg)
    kw = dict(batch=4, prompt_len=40, gen_len=6, device_resident=resident)
    want, _ = serve(cfg, params=params, device="cpu",
                    batch_in=synthetic_batch(cfg, np.random.RandomState(0), 4, 40,
                                             device="cpu"), **kw)
    before = (fk.flash_attention.launches, rk.rmsnorm.launches)
    got, stats = serve(cfg, params=tree_map(lambda t: t.to(cuda), params),
                       batch_in=synthetic_batch(cfg, np.random.RandomState(0), 4, 40),
                       **kw)
    np.testing.assert_array_equal(got, want)
    # one prefill: a flash launch per layer; four norms per layer and the
    # final one (the decode graphs' launches are counted at capture)
    assert fk.flash_attention.launches >= before[0] + cfg.n_layers
    assert rk.rmsnorm.launches >= before[1] + 4 * cfg.n_layers + 1
    assert stats["decode_dispatches"] == (1 if resident else 5)


@pytest.mark.parametrize("arch,dtype", [("mamba2-2.7b", "float32"), ("gemma3-1b", "float32"),
                                        ("gemma3-1b", "bfloat16")])
def test_warm_prefill_is_one_graph_launch_equal_to_eager(cuda, arch, dtype):
    """After set-up, ``eng.prefill`` is ONE CUDA-graph launch and launches
    no kernel eagerly; its logits and caches equal an eager
    ``Model.prefill`` bit for bit.  The graph holds a flash launch per
    attention layer, on the route of the compute dtype."""
    import dataclasses

    from repro_torch.kernels import ops

    cfg = dataclasses.replace(get_config(arch).smoke(), dtype=dtype)
    params = (_boosted_dense_params(cfg) if arch == "gemma3-1b"
              else Model(cfg).init(0, device="cpu"))
    params = tree_map(lambda t: t.to(cuda), params)
    eng = ServeEngine(cfg, slots=4, prompt_len=40, max_new=6)
    batch = synthetic_batch(cfg, np.random.RandomState(0), 4, 40)
    eng.prefill(params, batch, eng.init_state()[0])      # set-up
    caches = eng.init_state()[0]
    torch.cuda.synchronize()
    launches, counts = eng.graph_launches, ops.launch_counts()
    logits, got = eng.prefill(params, batch, caches)
    torch.cuda.synchronize()
    assert eng.graph_launches == {**launches, "prefill": launches["prefill"] + 1}
    assert ops.launch_counts() == counts
    assert eng.dispatches == 2
    want_logits, want = eng.model.prefill(eng.cast_params(params), batch,
                                          eng.init_state()[0])
    assert torch.equal(logits, want_logits)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(g, w)
    captured = eng.captured_launches("prefill")
    if arch == "gemma3-1b":
        route = "wgmma" if dtype == "bfloat16" else "cuda_core"
        assert captured["flash_attention"] == cfg.n_layers
        assert captured[f"flash_attention_{route}"] == cfg.n_layers
    else:
        assert captured["ssd_scan"] == cfg.n_layers


# -- the convergence loop: a conditional WHILE node set by the step kernel ---

CONV_CFG = FacesConfig(grid=(2, 2, 2), points=(6, 5, 4), pack="kernel", damping=0.12)


def _conv_u0():
    return np.random.RandomState(4).randn(*CONV_CFG.grid, *CONV_CFG.points).astype(np.float32)


@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("mode", ["stream", "dataflow"])
def test_graph_loop_equals_eager_cpu_loop(cuda, mode, double_buffer):
    """The graph loop stops where the eager CPU loop does, with the same
    field bit for bit (the same elementwise ops) and the residual trace
    within rtol 1e-5 (the sum of squares adds in another order)."""
    u0, tol = _conv_u0(), 3e-3
    runs = [run_faces_until_converged(CONV_CFG, make_mesh(CONV_CFG.grid, AXES3, device=d),
                                      u0, tol=tol, max_iters=40, mode=mode,
                                      double_buffer=double_buffer)
            for d in ("cpu", cuda)]
    (cpu_mem, cpu_res, cpu_n, _), (mem, res, n_done, stats) = runs
    assert n_done == cpu_n and 1 < n_done < 40
    assert (stats.dispatches, stats.sync_points) == (1, 0)
    np.testing.assert_allclose(res.cpu().numpy(), cpu_res.numpy(), rtol=1e-5)
    got, want = to_numpy(mem), to_numpy(cpu_mem)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _host_polled(prog, u0, tol, max_iters, mode):
    """FusedEngine called until the residual, read on the host after each
    call, falls below ``tol``: the loop the device-resident one replaces."""
    fused = FusedEngine(prog, mode=mode, donate=True)
    residual = global_residual_fn(CONV_CFG)
    mem, trace = fused.init_buffers({"u": u0}), []
    while True:
        mem = fused(mem)
        trace.append(residual(mem).reshape(1))
        if not (float(trace[-1]) >= tol and len(trace) < max_iters):
            break
    return mem, torch.cat(trace), fused


@pytest.mark.parametrize("mode", ["stream", "dataflow"])
def test_graph_loop_equals_fused_engine_bitwise(cuda, mode):
    """The loop runs the fused engine's pass ``n_done`` times: the fields,
    the slots and the residual trace equal a host-polled FusedEngine
    run bit for bit, in one dispatch against ``n_done``."""
    u0, tol = _conv_u0(), 3e-3
    prog = build_faces_program(CONV_CFG, make_mesh(CONV_CFG.grid, AXES3))
    want, trace, fused = _host_polled(prog, u0, tol, 40, mode)
    mem, res, n_done, stats = run_faces_until_converged(
        CONV_CFG, make_mesh(CONV_CFG.grid, AXES3), u0, tol=tol, max_iters=40, mode=mode)
    assert n_done == fused.stats.dispatches == len(trace) and stats.dispatches == 1
    assert torch.equal(res, trace)
    for name in want:
        assert torch.equal(mem[name], want[name]), name


@pytest.mark.parametrize("tol", [3e-2, 1e-2])  # n_done 3 and 10: odd and even
def test_graph_loop_double_buffer_parity(cuda, tol):
    """With double buffering the last pass is B's when ``n_done`` is even:
    every buffer, the slots included, equals the single-buffered loop's
    for odd and even counts."""
    u0 = _conv_u0()
    mesh = make_mesh(CONV_CFG.grid, AXES3)
    runs = {db: run_faces_until_converged(CONV_CFG, mesh, u0, tol=tol, max_iters=40,
                                          double_buffer=db) for db in (False, True)}
    assert runs[True][2] == runs[False][2] == {3e-2: 3, 1e-2: 10}[tol]
    assert torch.equal(runs[True][1], runs[False][1])
    for name, t in runs[False][0].items():
        assert torch.equal(runs[True][0][name], t), name


@pytest.mark.parametrize("double_buffer", [False, True])
def test_graph_loop_call_resets_and_launches_once(cuda, double_buffer):
    """Each call is ONE graph launch, launches no kernel eagerly, and
    starts from ``n_done == 0`` and zeroed reductions: a second call of
    the same engine on a smaller field stops earlier and pads with
    zeros, and a third on the first field repeats the first."""
    tol, u0 = 3e-3, _conv_u0()
    prog = build_faces_program(CONV_CFG, make_mesh(CONV_CFG.grid, AXES3)).persistent(
        40, until=lambda r: r >= tol)
    eng = PersistentEngine(prog, mode="dataflow", double_buffer=double_buffer,
                           reduce_fn=global_residual_fn(CONV_CFG))
    eng.compile()
    torch.cuda.synchronize()
    counts = {**hk.launch_counts(), **graph_loop.launch_counts()}
    runs = []
    for scale in (1.0, 0.05, 1.0):
        mem, red, n_done = eng(eng.init_buffers({"u": u0 * scale}))
        runs.append((to_numpy(mem)["u"], red.cpu().numpy(), int(n_done)))
    assert {**hk.launch_counts(), **graph_loop.launch_counts()} == counts
    assert eng._loop.graph_launches == eng.stats.dispatches == 3
    (u_a, red_a, n_a), (_, red_b, n_b), (u_c, red_c, n_c) = runs
    assert 1 <= n_b < n_a == n_c
    assert not red_b[n_b:].any() and red_b[:n_b].all()
    np.testing.assert_array_equal(u_c, u_a)
    np.testing.assert_array_equal(red_c, red_a)


# n_done 14 and 17 by the tolerance, 16, 7 and 1 by the bound, 1 by a first
# residual below the tolerance
@pytest.mark.parametrize("tol,max_iters", [(0.6, 32), (0.5, 32), (-1.0, 16), (-1.0, 7),
                                           (-1.0, 1), (2.0, 16)])
def test_step_kernel_equals_plain_step(cuda, tol, max_iters):
    """On a known trace the loop records the same reductions and stops at
    the same count as the plain step (the max_iters bound too), and the
    select of the last pass's parity leaves the last iteration's index."""
    trace = torch.linspace(1.0, 0.0, 32, device=cuda)
    loop, red, n_done, last = graph_loop.trace_loop(trace, tol, max_iters)
    want_red, want_n = graph_loop.trace_plain(trace, tol, max_iters)
    for _ in range(2):  # a second launch starts from n_done 0 again
        loop.launch()
        torch.cuda.synchronize()
        assert int(n_done) == int(want_n)
        assert torch.equal(red.cpu(), want_red)
        assert int(last) == int(want_n) - 1


def test_loop_body_holds_only_what_a_conditional_body_may(cuda):
    """The dataflow pass forks a comm stream: its capture must join it by
    edges, with no event, host or allocation node in the body."""
    prog = build_faces_program(CONV_CFG, make_mesh(CONV_CFG.grid, AXES3)).persistent(
        4, until=lambda r: r >= 0)
    eng = PersistentEngine(prog, mode="dataflow", reduce_fn=global_residual_fn(CONV_CFG))
    eng.compile()
    for graph in eng._loop.passes:
        kinds = graph_loop.node_types(graph)
        assert not set(kinds) & set(graph_loop.NOT_IN_A_BODY), kinds
    assert graph_loop.node_types(eng._loop.passes[0])["kernel"] > 0


def test_graph_loop_refuses_what_it_does_not_take(cuda):
    trace = torch.zeros(4, device=cuda)
    loop, red, n_done, _ = graph_loop.trace_loop(trace, 0.0, 4)
    pass_a, pass_b = loop.passes[:2]
    keep = torch.zeros((), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="n_done"):
        graph_loop.GraphLoop(pass_a, pass_b, red.sum(), keep, red, n_done.long(), 4)
    with pytest.raises(ValueError, match="reductions"):
        graph_loop.GraphLoop(pass_a, pass_b, red.sum(), keep, red, n_done, 5)
    with pytest.raises(ValueError, match="keep"):
        graph_loop.GraphLoop(pass_a, pass_b, red.sum(), keep.int(), red, n_done, 4)


# -- composed schedules: one CUDA stream a program ------------------------------

PIPE_CFG = FacesConfig(grid=(2, 2, 1), points=(8, 5, 4), pack="kernel", damping=0.2)


def _pipe_u0():
    return np.random.RandomState(6).randn(*PIPE_CFG.grid, *PIPE_CFG.points).astype(np.float32)


def _parts_init(n_parts, u0):
    return dict(zip([f"{n}/u" for n in part_names(n_parts)], split_parts(u0, n_parts)))


@pytest.mark.parametrize("n_parts", [2, 4])
@pytest.mark.parametrize("mode", ["stream", "dataflow"])
def test_linked_pipeline_on_card_equals_cpu(cuda, mode, n_parts):
    """The linked pipeline on the card equals its CPU run and the card's
    full-domain run bit for bit, in one dispatch and one graph launch."""
    u0 = _pipe_u0()
    cpu, _ = run_faces_pipelined(PIPE_CFG, make_mesh(PIPE_CFG.grid, AXES3, device="cpu"), u0,
                                 n_iters=3, n_parts=n_parts, mode=mode)
    mesh = make_mesh(PIPE_CFG.grid, AXES3)
    eng = PersistentEngine(build_faces_pipeline(PIPE_CFG, mesh, n_parts, 3), mode=mode)
    mem = eng(eng.init_buffers(_parts_init(n_parts, u0)))
    assert eng.stats.dispatches == eng.graph_launches == 1
    got, want = to_numpy(mem), to_numpy(cpu)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    full, _ = run_faces_persistent(PIPE_CFG, mesh, u0, n_iters=3, mode=mode)
    assert torch.equal(merge_parts([mem[f"{n}/u"] for n in part_names(n_parts)]), full["u"])


@pytest.mark.parametrize("mode", ["stream", "dataflow"])
def test_single_pass_engines_run_schedules_on_card(cuda, mode):
    u0 = _pipe_u0()
    mesh = make_mesh(PIPE_CFG.grid, AXES3)
    sched, full = build_faces_pipeline(PIPE_CFG, mesh, 2), build_faces_program(PIPE_CFG, mesh)
    engines = [(FusedEngine(sched, mode=mode), FusedEngine(full, mode=mode))]
    if mode == "stream":
        engines.append((HostEngine(sched), HostEngine(full)))
    for split, whole in engines:
        mem = split(split.init_buffers(_parts_init(2, u0)))
        want = whole(whole.init_buffers({"u": u0}))["u"]
        assert torch.equal(merge_parts([mem[f"{n}/u"] for n in part_names(2)]), want)


def _graph_width(eng):
    """Kernel-node width of one captured pass of ``eng`` (see
    ``graph_loop.dag_width``)."""
    eng.compile()
    graph, _ = graph_loop.capture(lambda: eng._run_into(eng._bufs))
    names, edges = graph_loop.graph_edges(graph)
    return graph_loop.dag_width(len(names), edges,
                                [i for i, t in enumerate(names) if t == "kernel"])


@pytest.mark.parametrize("mode", ["stream", "dataflow"])
def test_one_stream_per_program_in_the_graph(cuda, mode):
    """A plain program's stream-mode pass is one chain of kernels; the
    N-part schedule's is N chains wide in stream mode (a stream a
    program), and at most 2N in dataflow mode (a comm stream each)."""
    mesh = make_mesh(PIPE_CFG.grid, AXES3)
    plain = _graph_width(FusedEngine(build_faces_program(PIPE_CFG, mesh), mode=mode))
    assert plain == (1 if mode == "stream" else 2)
    for n_parts in (2, 4):
        width = _graph_width(FusedEngine(build_faces_pipeline(PIPE_CFG, mesh, n_parts),
                                         mode=mode))
        if mode == "stream":
            assert width == n_parts
        else:
            assert n_parts < width <= 2 * n_parts


def test_graph_edges_of_a_known_capture(cuda):
    """Two streams forked from the capture stream and joined back: the
    kernels form two chains, width 2."""
    x = torch.zeros(64, device=cuda)
    side = [torch.cuda.Stream(), torch.cuda.Stream()]

    def work():
        home = torch.cuda.current_stream()
        for s in side:
            s.wait_stream(home)
            with torch.cuda.stream(s):
                for _ in range(3):
                    x.add_(1.0)
        for s in side:
            home.wait_stream(s)

    work()
    torch.cuda.synchronize()
    graph, _ = graph_loop.capture(work)
    names, edges = graph_loop.graph_edges(graph)
    assert names.count("kernel") == 6 and len(edges) == 4
    assert graph_loop.dag_width(len(names), edges, range(len(names))) == 2


def test_receivers_reads_finish_before_the_next_deposit(cuda):
    """Receive slots are written in place.  Part B's stencil first spins
    (``torch.cuda._sleep``) and then reads ``glo``; part A reaches its next
    iteration's ghost deposit into ``glo`` long before.  A start waits on
    the streams it deposits into, so the run still equals the CPU's."""
    u0 = _pipe_u0()

    def slow_schedule(mesh):
        sched = build_faces_pipeline(PIPE_CFG, mesh, 2, n_iters=4)
        descs = list(sched.descriptors)
        i = next(i for i, d in enumerate(descs)
                 if isinstance(d, KernelDesc) and d.pid == 1 and d.name == "interior")
        fn = descs[i].fn

        def slow(u, glo, ghi):
            if u.is_cuda:
                torch.cuda._sleep(20_000_000)
            return fn(u, glo, ghi)

        descs[i] = dataclasses.replace(descs[i], fn=slow)
        return dataclasses.replace(sched, descriptors=tuple(descs))

    runs = []
    for device in ("cpu", None):
        eng = PersistentEngine(slow_schedule(make_mesh(PIPE_CFG.grid, AXES3, device=device)),
                               mode="stream", double_buffer=False)
        runs.append(to_numpy(eng(eng.init_buffers(_parts_init(2, u0)))))
    want, got = runs
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("mode", ["stream", "dataflow"])
def test_sanitized_engines_on_card_equal_plain(cuda, mode):
    u0 = _pipe_u0()
    mesh = make_mesh(PIPE_CFG.grid, AXES3)
    full = build_faces_program(PIPE_CFG, mesh)
    cases = [(FusedEngine, full, {"u": u0}),
             (PersistentEngine, full.persistent(3), {"u": u0}),
             (FusedEngine, build_faces_pipeline(PIPE_CFG, mesh, 2), _parts_init(2, u0)),
             (PersistentEngine, build_faces_pipeline(PIPE_CFG, mesh, 2, n_iters=3),
              _parts_init(2, u0))]
    for cls, prog, init in cases:
        plain, poisoned = cls(prog, mode=mode), cls(prog, mode=mode, sanitize=True)
        a = plain(plain.init_buffers(init))
        b = poisoned(poisoned.init_buffers(init))
        for name in a:
            assert torch.equal(a[name], b[name]), (cls.__name__, name)


def test_racy_program_refused_before_any_launch(cuda):
    prog = build_faces_program(PIPE_CFG, make_mesh(PIPE_CFG.grid, AXES3))
    descs = list(prog.descriptors)
    wi = max(i for i, d in enumerate(descs) if isinstance(d, WaitDesc))
    ki = next(i for i, d in enumerate(descs) if i > wi and isinstance(d, KernelDesc))
    descs.insert(wi, descs.pop(ki))
    bad = dataclasses.replace(prog, descriptors=tuple(descs))
    torch.cuda.synchronize()
    before = hk.launch_counts()
    for cls in (FusedEngine, PersistentEngine, HostEngine):
        with pytest.raises(SanitizeError, match="pending unwaited deposit"):
            cls(bad, sanitize=True)
    assert hk.launch_counts() == before
    silent = FusedEngine(bad)
    silent(silent.init_buffers({"u": _pipe_u0()}))
    assert silent.stats.dispatches == 1


# -- the masked schedule loop: every part to its own count or tolerance ---------

MASK_CFG = FacesConfig(grid=(2, 2, 1), points=(9, 5, 4), pack="kernel", damping=0.12)
# (n_parts, tolerances, max_iters): parts that stop at different counts, one
# of them by the bound
MASK_CASES = [(2, (2e-2, 1e-6), 12), (3, (5e-3, 1e-2, 1e-6), 12)]


def _mask_u0():
    return np.random.RandomState(8).randn(*MASK_CFG.grid, *MASK_CFG.points).astype(np.float32)


def _masked_engine(device, n_parts, tols, max_iters, exchange=True, **kw):
    mesh = make_mesh(MASK_CFG.grid, AXES3, device=device)
    sched = build_faces_pipeline(MASK_CFG, mesh, n_parts, max_iters, exchange, tols=tols)
    fns = {nm: global_residual_fn(c, buf=f"{nm}/u")
           for nm, c in zip(part_names(n_parts), part_configs(MASK_CFG, n_parts))}
    return PersistentEngine(sched, reduce_fns=fns, **kw)


def _masked_run(eng, n_parts):
    mem, reds, n_done = eng(eng.init_buffers(_parts_init(n_parts, _mask_u0())))
    return (to_numpy(mem), {k: v.cpu().numpy() for k, v in reds.items()},
            {k: int(v) for k, v in n_done.items()})


@pytest.mark.parametrize("exchange", [True, False], ids=["linked", "unlinked"])
@pytest.mark.parametrize("n_parts,tols,max_iters", MASK_CASES)
@pytest.mark.parametrize("mode", ["stream", "dataflow"])
def test_masked_loop_graph_equals_cpu_eager_loop(cuda, mode, n_parts, tols, max_iters,
                                                  exchange):
    """The masked loop's graph, one launch, stops each part where the CPU's
    eager loop does, with every buffer equal bit for bit (the same
    elementwise ops) and the residual traces within rtol 1e-5 (sums of
    squares in another order); against the eager loop run on the card's
    tensors the traces are equal too."""
    from repro_torch.core.engine_persistent import _run_schedule_while

    cpu = _masked_run(_masked_engine("cpu", n_parts, tols, max_iters, exchange, mode=mode),
                      n_parts)
    eng = _masked_engine(cuda, n_parts, tols, max_iters, exchange, mode=mode, donate=True)
    init = eng.init_buffers(_parts_init(n_parts, _mask_u0()))
    got = _masked_run(eng, n_parts)
    assert eng.stats.dispatches == eng.graph_launches == eng._loop.graph_launches == 1
    assert got[2] == cpu[2] and len(set(got[2].values())) > 1
    assert max(got[2].values()) <= max_iters
    for name in cpu[1]:
        np.testing.assert_allclose(got[1][name], cpu[1][name], rtol=1e-5, err_msg=name)
    for name in cpu[0]:
        np.testing.assert_array_equal(got[0][name], cpu[0][name], err_msg=name)
    reds = torch.zeros_like(eng._reductions)
    n_done = torch.zeros_like(eng._n_done)
    eager = _run_schedule_while(dict(init), sched=eng.program, mode=mode,
                                low=eng._lowering, slots=eng._slots,
                                reduce_fns=eng.reduce_fns, reductions=reds, n_done=n_done)
    subs = eng.program.subs
    for k, sub in enumerate(subs):
        assert int(n_done[k]) == got[2][sub.name]
        np.testing.assert_array_equal(reds[k].cpu().numpy(), got[1][sub.name])
    for name, t in to_numpy(eager).items():
        np.testing.assert_array_equal(got[0][name], t, err_msg=name)


@pytest.mark.parametrize("double_buffer", [True, False])
def test_masked_loop_mixed_counts_on_card(cuda, double_buffer):
    """Counts 3 and 6 without reductions: each unlinked part equals its
    own ``run_faces_persistent`` on the card bit for bit, in one launch
    that launches no kernel eagerly on a second call.  The part of count
    6, which cannot stop before the bound, gets no freeze graphs."""
    mesh = make_mesh(MASK_CFG.grid, AXES3)
    names, u0 = part_names(2), _mask_u0()
    progs = [build_faces_program(c, mesh, name=nm).persistent(n)
             for c, nm, n in zip(part_configs(MASK_CFG, 2), names, (3, 6))]
    eng = PersistentEngine(compose(*progs), mode="dataflow", double_buffer=double_buffer)
    init = eng.init_buffers(_parts_init(2, u0))
    eng(init)
    torch.cuda.synchronize()
    counts = {**hk.launch_counts(), **graph_loop.launch_counts()}
    mem, reds, n_done = eng(init)
    assert {**hk.launch_counts(), **graph_loop.launch_counts()} == counts
    assert reds == {} and {k: int(v) for k, v in n_done.items()} == dict(zip(names, (3, 6)))
    assert eng.graph_launches == 2
    assert eng._loop.freeze[0] is not None and eng._loop.freeze[1] is None
    for nm, pcfg, part, n in zip(names, part_configs(MASK_CFG, 2), split_parts(u0, 2), (3, 6)):
        alone, _ = run_faces_persistent(pcfg, mesh, part, n_iters=n,
                                        double_buffer=double_buffer)
        for buf, t in alone.items():
            assert torch.equal(mem[f"{nm}/{buf}"], t), f"{nm}/{buf}"


def test_masked_loop_body_holds_only_what_a_conditional_body_may(cuda):
    """Both passes (N streams forked and joined, cross-program events) and
    every snapshot, restore and select graph: no event, host or
    allocation node."""
    eng = _masked_engine(cuda, 3, MASK_CASES[1][1], 12, mode="dataflow")
    eng.compile()
    assert len(eng._loop.freeze) == 3 and all(len(f) == 4 for f in eng._loop.freeze)
    for graph in eng._loop.passes:
        kinds = graph_loop.node_types(graph)
        assert not set(kinds) & set(graph_loop.NOT_IN_A_BODY), kinds
    assert graph_loop.node_types(eng._loop.passes[0])["kernel"] > 0


# programs stopping by a tolerance, by their count, without a predicate, at
# the first pass, and every parity of the last pass
SCHED_STEP_CASES = [((0.6, None, 0.1), (16, 4, 9), 16), ((2.0, 0.45), (5, 16), 16),
                    ((None,), (7,), 7), ((-1.0, -1.0), (1, 2), 2)]


@pytest.mark.parametrize("tols,n_iters,max_iters", SCHED_STEP_CASES)
def test_schedule_step_equals_plain_step(cuda, tols, n_iters, max_iters):
    """On known traces the loop records the same reductions and counts as
    the plain schedule step, twice in a row, and each program's counter
    kept through its snapshots and restores equals its count."""
    traces = torch.stack([torch.linspace(1.0, 0.0, 16, device=cuda) * (k + 1)
                          for k in range(len(n_iters))])
    loop, red, n_done, v = graph_loop.trace_schedule_loop(traces, tols, n_iters, max_iters)
    want_red, want_n = graph_loop.trace_schedule_plain(traces, tols, n_iters, max_iters)
    for _ in range(2):
        for t in v:
            t.zero_()
        loop.launch()
        torch.cuda.synchronize()
        assert n_done.cpu().tolist() == want_n.tolist()
        assert torch.equal(red.cpu(), want_red)
        assert [int(t) for t in v] == want_n.tolist()
        assert int(loop.iter) == int(want_n.max())


def test_receivers_reads_finish_before_the_next_deposit_in_the_masked_body(cuda):
    """The receive-slot hazard inside the masked body: part B's stencil
    spins before it reads ``glo``, part A's next ghost deposit must wait,
    and a part that stopped still publishes its frozen planes."""
    u0 = _pipe_u0()

    def slow_schedule(mesh):
        progs = [build_faces_part_program(PIPE_CFG, mesh, k, 2).persistent(n)
                 for k, n in enumerate((2, 4))]
        names = part_names(2)
        links = sorted({(names[0], names[1]), (names[1], names[0])})
        sched = compose(*progs, links=links)
        descs = list(sched.descriptors)
        i = next(i for i, d in enumerate(descs)
                 if isinstance(d, KernelDesc) and d.pid == 1 and d.name == "interior")
        fn = descs[i].fn

        def slow(u, glo, ghi):
            if u.is_cuda:
                torch.cuda._sleep(20_000_000)
            return fn(u, glo, ghi)

        descs[i] = dataclasses.replace(descs[i], fn=slow)
        return dataclasses.replace(sched, descriptors=tuple(descs))

    runs = []
    for device in ("cpu", None):
        eng = PersistentEngine(slow_schedule(make_mesh(PIPE_CFG.grid, AXES3, device=device)),
                               mode="stream", double_buffer=False)
        mem, _, n_done = eng(eng.init_buffers(_parts_init(2, u0)))
        assert [int(n) for n in n_done.values()] == [2, 4]
        runs.append(to_numpy(mem))
    want, got = runs
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("mode", ["stream", "dataflow"])
def test_sanitized_masked_loop_equals_plain(cuda, mode):
    n_parts, tols, max_iters = MASK_CASES[0]
    runs = [_masked_run(_masked_engine(cuda, n_parts, tols, max_iters, mode=mode,
                                       sanitize=s), n_parts) for s in (False, True)]
    assert runs[0][2] == runs[1][2]
    for i in (0, 1):
        for name, t in runs[0][i].items():
            np.testing.assert_array_equal(runs[1][i][name], t, err_msg=name)


# -- the collectives and the tuner ---------------------------------------------


def _coll_builds(mesh, n):
    from repro_torch.core import collectives as C
    m, k, f = 8 * n * n, 4 * n, 4 * n
    return {"ag_matmul": C.build_all_gather_matmul(mesh, "x", 3 * n, 7, 5),
            "ag_matmul_bidi": C.build_all_gather_matmul(mesh, "x", 3 * n, 7, 5,
                                                        bidirectional=True),
            "matmul_rs": C.build_matmul_reduce_scatter(mesh, "x", 3 * n, 4 * n, 5),
            "a2a": C.build_all_to_all(mesh, "x", m, 3),
            "tp": C.build_tp_block(mesh, "x", m, k, f)}


def _coll_inputs(cm, seed):
    rng = np.random.RandomState(seed)
    out = {}
    for b in cm.inputs:
        shape = cm.program.buffers[b].shape
        a = rng.randn(*shape).astype(np.float32)
        out[b] = a / np.sqrt(shape[0]) if b.startswith("w") else a
    return out


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("mode", ["stream", "dataflow"])
def test_collective_builders_on_card_equal_cpu(cuda, mode, n):
    """Each collective builder on the card: one graph launch, equal to the
    port's decomposed oracle on the card bit for bit, and to its CPU run
    (copies bit for bit, the matmul builders at rtol=atol=1e-5)."""
    cpu = _coll_builds(make_mesh((n,), ("x",), device="cpu"), n)
    for name, cm in _coll_builds(make_mesh((n,), ("x",)), n).items():
        inputs = _coll_inputs(cm, seed=n)
        want_cpu = cpu[name]
        ceng = FusedEngine(want_cpu.program)
        on_cpu = ceng(ceng.init_buffers(inputs))[cm.output]
        for eng in (FusedEngine(cm.program, mode=mode),
                    PersistentEngine(cm.program, mode=mode)):
            got = eng(eng.init_buffers(inputs))[cm.output]
            assert eng.stats.dispatches == eng.graph_launches == 1
            oracle = cm.reference(*(inputs[b] for b in cm.inputs))
            assert torch.isfinite(got).all()
            assert torch.equal(got, oracle), f"{name} {type(eng).__name__}"
            if name == "a2a":
                assert torch.equal(got.cpu(), on_cpu), name
            else:
                torch.testing.assert_close(got.cpu(), on_cpu, rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.parametrize("mode", ["stream", "dataflow"])
def test_persistent_tp_chain_one_graph_launch(cuda, mode):
    """The 4-layer TP chain in ONE graph launch equals 4 decomposed block
    applications on the card bit for bit, and its CPU run within
    rtol=atol=1e-5."""
    from repro_torch.core import collectives as C
    n, layers = 4, 4
    cm = C.build_tp_block(make_mesh((n,), ("x",)), "x", 8 * n * n, 4 * n, 4 * n, chain=True)
    inputs = _coll_inputs(cm, seed=3)
    eng = PersistentEngine(cm.program.persistent(layers), mode=mode, donate=True)
    got = eng(eng.init_buffers(inputs))["out"]
    assert eng.stats.dispatches == eng.graph_launches == 1
    want = torch.as_tensor(inputs["x"], device=cuda)
    for _ in range(layers):
        want = cm.reference(want, inputs["w1"], inputs["w2"])
    assert torch.isfinite(got).all() and torch.equal(got, want)
    ccm = C.build_tp_block(make_mesh((n,), ("x",), device="cpu"), "x", 8 * n * n, 4 * n,
                           4 * n, chain=True)
    ceng = PersistentEngine(ccm.program.persistent(layers), mode=mode)
    torch.testing.assert_close(got.cpu(), ceng(ceng.init_buffers(inputs))["out"],
                               rtol=1e-5, atol=1e-5)


def test_enqueue_collective_on_card_equals_cpu(cuda):
    from repro_torch.core import STQueue

    def prog(device):
        q = STQueue(make_mesh((4,), ("x",), device=device), "colls")
        q.buffer("a", (32, 3), np.float32, pspec=("x",))
        q.buffer("g", (128, 3), np.float32, pspec=("x",))
        q.buffer("s", (8, 3), np.float32, pspec=("x",))
        q.buffer("t", (32, 3), np.float32, pspec=("x",))
        q.buffer("r", (2, 3), np.float32, pspec=())
        q.enqueue_collective("all_gather", "a", "g", "x", dim=0)
        q.enqueue_collective("reduce_scatter", "a", "s", "x", dim=0)
        q.enqueue_collective("all_to_all", "a", "t", "x", split_axis=0, concat_axis=0)
        q.enqueue_start()
        q.enqueue_wait()
        q.enqueue_collective("all_reduce", "s", "r", "x")
        q.enqueue_start()
        q.enqueue_wait()
        return q.build(verify="error")

    a = np.random.RandomState(4).randint(-8, 8, size=(32, 3)).astype(np.float32)
    cpu = HostEngine(prog("cpu"))
    want = to_numpy(cpu(cpu.init_buffers({"a": a})))
    for mode in ("stream", "dataflow"):
        for eng in (FusedEngine(prog(None), mode=mode), PersistentEngine(prog(None), mode=mode),
                    HostEngine(prog(None))):
            got = to_numpy(eng(eng.init_buffers({"a": a})))
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{mode} {k}")


def test_tuned_pipeline_winner_takes_one_launch(cuda):
    """A tuned 2-part pipeline: every candidate certified, the winner runs
    the real solve in one dispatch and one graph launch, equal to the
    untuned run bit for bit."""
    from repro_torch.launch.tune import Knobs, tune

    mesh = make_mesh(PIPE_CFG.grid, AXES3)
    u0 = _pipe_u0()
    mem, stats, tuned = run_faces_pipelined(PIPE_CFG, mesh, u0, n_iters=3, n_parts=2,
                                            tune=True, tune_repeats=2)
    assert stats.dispatches == 1 and tuned.best.engine.graph_launches == 1
    plain, _ = run_faces_pipelined(PIPE_CFG, mesh, u0, n_iters=3, n_parts=2)
    for k in plain:
        assert torch.equal(mem[k], plain[k]), k
    init = _parts_init(2, u0)

    def build(knobs):
        eng = PersistentEngine(build_faces_pipeline(PIPE_CFG, mesh, 2, 3,
                                                    interleave=knobs.interleave_policy()),
                               donate=True, **knobs.engine_kwargs())
        return eng, (lambda: eng.init_buffers(init))

    res = tune(build, {"interleave": ["round_robin", "sequential", 2],
                       "mode": ["dataflow", "stream"]},
               base=Knobs(), repeats=2, measure_top=6, certify=True)
    assert all(c.certificate.equivalent and c.error is None for c in res.candidates)
    assert len(res.measured) == 6 and all(c.stats["med_s"] > 0 for c in res.measured)
