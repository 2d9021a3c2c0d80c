"""Tests that need the card (marker ``gpu``; they skip without CUDA).

Each hand-written CUDA kernel is held against its plain PyTorch version
on the same device inputs: the halo and boundary kernels bit for bit,
the SSD scan, flash attention and RMSNorm in float32 within the repo's
kernel-vs-reference bounds (rtol 2e-4 / atol 3e-5; RMSNorm 2e-5 /
1e-5), and in bfloat16 within one rounding of the output (2^-8 of the
two results' magnitudes; the SSD scan within ``chip_smoke.py``'s served
bf16 bound); flash attention's and the SSD scan's cases say which of
their two kernels (routes) each must take.  Flash attention's backward
is held against ``ref.attention_vjp`` within the backward kernels' bound
on both routes and every mask (each case counted on the route
``route()`` gives), the tensor-core backward also against the CUDA-core
one at ragged shapes, two calls and a graphed forward and backward equal
eager bit for bit, and serving's forward (no
autograd) launches once, writes no log-sum-exp and gives the training
forward's bits.  An RMSNorm row must come out the
same bits whatever rows, row stride and alignment it is launched with.
The engines' CUDA graphs and the
serve engines (mamba2 and gemma3 smoke models) are held against the CPU
run of the same program, and a warm serve prefill must be one graph
launch equal to the eager prefill bit for bit (hymba and whisper smoke
too, with an admission beside a slot in flight; flash and the SSD scan
also at hymba's and whisper's served shapes: not causal over 1500
keys, a group of 5 with a window of 1024, one decode query, the SSD
scan on its N-16 tensor-core route (hymba's) with an initial state, its
CUDA-core route in bf16 at N 64).  The convergence loop
(a graph conditional WHILE node set by the step kernel) is held against
the eager CPU loop, against ``FusedEngine`` called ``n_done`` times
(bit for bit), and its step kernel against the plain step on known
traces.  Composed schedules (the linked N-part Faces pipeline, one CUDA
stream a program) are held against the CPU run and the full-domain run
bit for bit; the captured graph has one stream's width a program; a
receiver that is slow to read its ghost planes is not overwritten by its
neighbour's next deposit; the sanitizer gives the same bits and refuses
a racy program before any launch.  The embedding's backward kernel
equals its plain version bit for bit (ragged T and D, one id or all ids
distinct, a strided dy), replays in a graph, refuses a wrong dtype or
stride, and qwen smoke's gradients on the card match the CPU's; the
train steps' graph equals eager without deterministic mode.  This file imports no JAX, so it runs on a GPU
machine without it::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import importlib.util
import os

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
from repro_torch.kernels import embedding as ek
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import graph_loop
from repro_torch.kernels import halo_pack as hk
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as rk
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch.serve import ServeEngine, serve, serve_continuous, synthetic_batch
from repro_torch.models import Model
from repro_torch.models.nn import tree_leaves, tree_map

pytestmark = pytest.mark.gpu

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


def _served_ssd(cuda, B, S, H, G, kind, h0, seed, N=128):
    """bf16 x, B, C as views of one conv output (row stride H P + 2 G N),
    at P 64 and mamba2's N 128 (or hymba's 16): ``"served"`` draws dt
    and A as the prefill does, ``"extreme"`` the extreme decay above (dt
    ~ 1, A = -e)."""
    P = 64
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
        "ssd_scan": 1, "ssd_scan_wgmma": 1, "ssd_scan_wgmma_n16": 0, "ssd_scan_cuda_core": 0,
        "ssd_scan_bwd": 0, "ssd_scan_bwd_wgmma": 0, "ssd_scan_bwd_wgmma_n16": 0,
        "ssd_scan_bwd_cuda_core": 0}
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(h).all())
    assert _within_served_bound(y, h, x, dt, A, Bm, C, h0)
    if case["kind"] == "extreme":
        # the state also meets the float32 extreme-decay bound above,
        # against the plain version of the same values in float32
        _, hf = ref.ssd_scan(x.float(), dt, A, Bm.float(), C.float(), return_state=True)
        _, habs = ref.ssd_scan(x.float().abs(), dt, A, Bm.float().abs(), C.float().abs(),
                               return_state=True)
        assert bool(((h - hf).abs() <= 2e-4 * hf.abs() + 3e-5 + 1e-4 * habs).all())


# bf16 at hymba's widths (P 64, N 16, chunk 128): the tensor-core route of
# that width, with and without an initial state, a short last chunk, 11
# chunks (a cluster of 8 walks two groups), the extreme decay
HYMBA_SSD_CASES = [dict(B=2, S=640, H=50, G=1, kind="served", h0=True),
                   dict(B=2, S=300, H=6, G=1, kind="served", h0=True),
                   dict(B=1, S=200, H=4, G=1, kind="served", h0=False),
                   dict(B=1, S=1300, H=2, G=1, kind="served", h0=True),
                   dict(B=1, S=256, H=2, G=1, kind="extreme", h0=True)]


@pytest.mark.parametrize("case", HYMBA_SSD_CASES,
                         ids=lambda c: f"S{c['S']}H{c['H']}{c['kind']}h0{c['h0']}")
def test_ssd_wgmma_n16_route_meets_the_served_bound(cuda, case):
    x, dt, A, Bm, C, h0 = _served_ssd(cuda, **case, seed=case["S"] + 1, N=16)
    assert ssd.route(x.dtype, x.shape[3], Bm.shape[3], 128) == "wgmma_n16"
    before = ssd.launch_counts()
    y, h = ssd.ssd_scan(x, dt, A, Bm, C, init_state=h0, chunk=128, return_state=True)
    torch.cuda.synchronize()
    after = ssd.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "ssd_scan": 1, "ssd_scan_wgmma": 0, "ssd_scan_wgmma_n16": 1, "ssd_scan_cuda_core": 0,
        "ssd_scan_bwd": 0, "ssd_scan_bwd_wgmma": 0, "ssd_scan_bwd_wgmma_n16": 0,
        "ssd_scan_bwd_cuda_core": 0}
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(h).all())
    assert _within_served_bound(y, h, x, dt, A, Bm, C, h0)
    if case["kind"] == "extreme":
        _, hf = ref.ssd_scan(x.float(), dt, A, Bm.float(), C.float(), init_state=h0,
                             return_state=True)
        _, habs = ref.ssd_scan(x.float().abs(), dt, A, Bm.float().abs(), C.float().abs(),
                               init_state=h0.abs(), return_state=True)
        assert bool(((h - hf).abs() <= 2e-4 * hf.abs() + 3e-5 + 1e-4 * habs).all())


@pytest.mark.parametrize("cluster", [1, 2, 3, 5])
def test_ssd_wgmma_n16_cluster_size_keeps_the_bound(cuda, cluster):
    """hymba's prefill width (5 chunks) in groups of 1, 2, 3 or 5 CTAs (a
    group's last state carried on through hout), x, B and C views of one
    conv output: each meets the served bound."""
    x, dt, A, Bm, C, h0 = _served_ssd(cuda, 2, 640, 6, 1, "served", True, seed=5, N=16)
    y, h = ssd.ssd_scan_variant(x, dt, A, Bm, C, init_state=h0, cluster=cluster,
                                parts=ssd.PARTS_N16)
    assert _within_served_bound(y, h, x, dt, A, Bm, C, h0)
    yc, hc = ssd.ssd_scan(x.contiguous(), dt, A, Bm.contiguous(), C.contiguous(),
                          init_state=h0, chunk=128, return_state=True)
    if cluster == ssd.default_cluster(640, 16):
        assert torch.equal(y, yc) and torch.equal(h, hc)


# bf16 at P 64, N 64 (chunk 128): the CUDA-core route in bf16, with and
# without an initial state, a short last chunk (hymba's N 16 takes the
# tensor-core route of that width)
CUDA_CORE_BF16_CASES = [dict(B=2, S=640, H=50, G=1, kind="served", h0=True),
                        dict(B=2, S=300, H=6, G=1, kind="served", h0=True),
                        dict(B=1, S=200, H=4, G=1, kind="served", h0=False),
                        dict(B=1, S=256, H=2, G=1, kind="extreme", h0=True)]


@pytest.mark.parametrize("case", CUDA_CORE_BF16_CASES,
                         ids=lambda c: f"S{c['S']}H{c['H']}{c['kind']}h0{c['h0']}")
def test_ssd_cuda_core_route_meets_the_served_bound_in_bf16(cuda, case):
    x, dt, A, Bm, C, h0 = _served_ssd(cuda, **case, seed=case["S"] + 1, N=64)
    assert ssd.route(x.dtype, x.shape[3], Bm.shape[3], 128) == "cuda_core"
    before = ssd.launch_counts()
    y, h = ssd.ssd_scan(x, dt, A, Bm, C, init_state=h0, chunk=128, return_state=True)
    torch.cuda.synchronize()
    after = ssd.launch_counts()
    assert {k: after[k] - before[k] for k in ("ssd_scan", "ssd_scan_wgmma", "ssd_scan_wgmma_n16",
                                               "ssd_scan_cuda_core")} == {
        "ssd_scan": 1, "ssd_scan_wgmma": 0, "ssd_scan_wgmma_n16": 0, "ssd_scan_cuda_core": 1}
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(h).all())
    assert _within_served_bound(y, h, x, dt, A, Bm, C, h0)


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
    # the served shapes of hymba and whisper, in their [B,S,H,D] layout:
    # whisper's cross attention (not causal, Sq != Skv, Skv 1500: a tail
    # in the q and the kv tiles), its encoder (1500 x 1500, not causal),
    # one decode query against the 1500 frames; hymba's 25 query heads
    # over 5 kv heads (a group of 5) with its window of 1024
    dict(dtype=BF16, B=2, Hq=20, Hkv=20, Sq=70, Skv=1500, D=64, causal=False, bshd=True),
    dict(dtype=BF16, B=1, Hq=4, Hkv=4, Sq=1500, Skv=1500, D=64, causal=False, bshd=True),
    dict(dtype=BF16, B=4, Hq=20, Hkv=20, Sq=1, Skv=1500, D=64, causal=False, bshd=True),
    dict(dtype=BF16, B=1, Hq=25, Hkv=5, Sq=640, Skv=640, D=64, window=1024, bshd=True),
    dict(dtype=BF16, B=2, Hq=25, Hkv=5, Sq=1200, Skv=1200, D=64, window=1024, bshd=True),
    # MLA's pair (deepseek-v3): q and k at 192, v at 128.  The tensor-core
    # route in bf16 (a prefill, one at a depth with a ragged tail, a window,
    # a decode query, the served layout), the CUDA-core route in float32 and
    # at the smoke config's (48, 32)
    dict(dtype=BF16, B=2, Hq=8, Hkv=8, Sq=130, Skv=130, D=192, Dv=128),
    dict(dtype=BF16, B=1, Hq=4, Hkv=4, Sq=70, Skv=200, D=192, Dv=128, q_offset=130),
    dict(dtype=BF16, B=1, Hq=4, Hkv=2, Sq=96, Skv=96, D=192, Dv=128, window=20),
    dict(dtype=BF16, B=2, Hq=4, Hkv=4, Sq=1, Skv=300, D=192, Dv=128, q_offset=299),
    dict(dtype=BF16, B=1, Hq=16, Hkv=16, Sq=512, Skv=512, D=192, Dv=128, bshd=True),
    dict(B=1, Hq=2, Hkv=2, Sq=70, Skv=90, D=192, Dv=128, q_offset=20),
    dict(B=1, Hq=4, Hkv=4, Sq=50, Skv=50, D=48, Dv=32),
    dict(dtype=BF16, B=1, Hq=2, Hkv=1, Sq=40, Skv=40, D=48, Dv=32, window=9),
]


def _case_id(case):
    return "-".join(f"{k}{'bf16' if v is BF16 else v}" for k, v in case.items())


@pytest.mark.parametrize("case", FLASH_CASES, ids=_case_id)
def test_flash_kernel_matches_plain(cuda, case):
    case = dict(case)
    B, Hq, Hkv, Sq, Skv, D = (case.pop(k) for k in ("B", "Hq", "Hkv", "Sq", "Skv", "D"))
    dtype, bshd = case.pop("dtype", torch.float32), case.pop("bshd", False)
    Dv = case.pop("Dv", D)
    if bshd:   # [B,S,H,D] tensors passed as transposed views
        q = _randn((B, Sq, Hq, D), dtype, cuda, 11).transpose(1, 2)
        k = _randn((B, Skv, Hkv, D), dtype, cuda, 12).transpose(1, 2)
        v = _randn((B, Skv, Hkv, Dv), dtype, cuda, 13).transpose(1, 2)
    else:
        q = _randn((B, Hq, Sq, D), dtype, cuda, 11)
        k = _randn((B, Hkv, Skv, D), dtype, cuda, 12)
        v = _randn((B, Hkv, Skv, Dv), dtype, cuda, 13)
    wgmma = ((64, 64), (128, 128), (256, 256), (192, 128))
    route = "wgmma" if dtype == BF16 and (D, Dv) in wgmma else "cuda_core"
    assert fk.route(dtype, D, Dv) == route
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


def test_flash_mla_pair_reads_the_model_layout(cuda):
    """MLA's layout: k the concatenation [B,S,H,192], v the last 128 columns
    of the expanded ``kv`` [B,S,H,256] (a strided view, no copy), both
    passed transposed; at a depth with ``q_offset``; the result laid out
    [B,S,H,128]."""
    B, S, H = 2, 200, 8
    q = _randn((B, S, H, 192), BF16, cuda, 21).transpose(1, 2)
    k = _randn((B, S, H, 192), BF16, cuda, 22).transpose(1, 2)
    kv = _randn((B, S, H, 256), BF16, cuda, 23)
    v = kv[..., 128:].transpose(1, 2)
    for sq, q_offset in ((S, 0), (60, S - 60)):
        before = fk.launch_counts()["flash_attention_wgmma"]
        got = fk.flash_attention(q[:, :, S - sq:], k, v, q_offset=q_offset,
                                 scale=192 ** -0.5)
        assert fk.launch_counts()["flash_attention_wgmma"] == before + 1
        assert tuple(got.shape) == (B, H, sq, 128) and got.transpose(1, 2).is_contiguous()
        want = ref.attention(q[:, :, S - sq:], k, v, q_offset=q_offset, scale=192 ** -0.5)
        assert _bf16_close(got, want)


def test_graphed_moe_layer_equals_eager(cuda):
    """deepseek-v3's MoE layer (sigmoid router with a bias, a shared
    expert) and grok-1's (softmax) in bf16 at 8 experts, top-2, 96 tokens,
    at the default capacity and at one that drops: one CUDA-graph replay
    equals the eager call bit for bit (no float atomics, no host reads),
    twice, on new inputs copied into the graph's."""
    from repro_torch.models import moe

    for arch in ("deepseek-v3-671b", "grok-1-314b"):
        cfg = dataclasses.replace(get_config(arch).smoke(), n_experts=8, dtype="bfloat16",
                                  param_dtype="bfloat16")
        p = moe.init_moe(torch.Generator(cuda).manual_seed(3), cfg, device=cuda)
        if "router_bias" in p:
            p["router_bias"].copy_(torch.linspace(-0.02, 0.02, 8, device=cuda))
        for capacity in (None, 4):
            x = _field((4, 24, cfg.d_model), BF16, cuda, 5)
            eager, aux = moe.apply_moe(p, x, cfg, capacity=capacity)
            if capacity:
                assert float(aux["dropped_frac"]) > 0
            static = x.clone()
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                moe.apply_moe(p, static, cfg, capacity=capacity)
            torch.cuda.current_stream().wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out, gaux = moe.apply_moe(p, static, cfg, capacity=capacity)
            for seed in (5, 6):
                xi = _field((4, 24, cfg.d_model), BF16, cuda, seed)
                want, waux = moe.apply_moe(p, xi, cfg, capacity=capacity)
                if seed == 5:   # x's draw: eager twice gives the same bits
                    assert torch.equal(want, eager)
                static.copy_(xi)
                graph.replay()
                torch.cuda.synchronize()
                assert torch.equal(out, want), (arch, capacity, seed)
                for key in waux:
                    assert torch.equal(gaux[key], waux[key]), (arch, key)


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


#: hymba and whisper smoke in float32 (the CUDA-core routes) and bf16 (flash
#: on the tensor-core route; hymba's smoke SSD, P 16 and chunk 16, on the
#: CUDA-core one)
FAMILY_CASES = [("hymba-1.5b", "float32"), ("hymba-1.5b", "bfloat16"),
                ("whisper-large-v3", "float32"), ("whisper-large-v3", "bfloat16")]


@pytest.mark.parametrize("arch,dtype", FAMILY_CASES)
def test_family_prefill_and_admission_graphs_equal_eager(cuda, arch, dtype):
    """hymba (meta tokens, hybrid layers) and whisper (the encoder, cross
    attention, ``enc_out`` in the slot buffers): a warm prefill is ONE
    graph launch equal to an eager ``Model.prefill`` bit for bit; the
    prefill graph holds a flash launch per attention (whisper: encoder,
    self and cross) and hymba's an SSD launch per layer; an admission
    beside a slot in flight is one launch equal to the eager admission,
    and the decode graph reads ``enc_out`` from the shared buffers."""
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(get_config(arch).smoke(), dtype=dtype)
    params = tree_map(lambda t: t.to(cuda), Model(cfg).init(0, device="cpu"))
    eng = ServeEngine(cfg, slots=4, prompt_len=24, max_new=6, chunk=2)
    batch = synthetic_batch(cfg, np.random.RandomState(0), 4, 24)
    eng.prefill(params, batch, eng.init_state()[0])      # set-up
    torch.cuda.synchronize()
    launches, counts = eng.graph_launches, ops.launch_counts()
    logits, got = eng.prefill(params, batch, eng.init_state()[0])
    torch.cuda.synchronize()
    assert eng.graph_launches == {**launches, "prefill": launches["prefill"] + 1}
    assert ops.launch_counts() == counts
    cast = eng.cast_params(params)
    want_logits, want = eng.model.prefill(cast, batch, eng.init_state()[0])
    assert torch.equal(logits, want_logits)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(g, w)
    assert int(got["pos"][0]) == eng.prefix_len + 24
    held = eng.captured_launches("prefill")
    route = "wgmma" if dtype == "bfloat16" else "cuda_core"
    flashes = cfg.n_layers + (cfg.n_enc_layers + cfg.n_layers if cfg.enc_dec else 0)
    assert held["flash_attention"] == held[f"flash_attention_{route}"] == flashes
    assert held["ssd_scan"] == held["ssd_scan_cuda_core"] == (
        cfg.n_layers if cfg.hybrid else 0)
    # an admission into slots 2 and 3 beside slots 0 and 1 in flight
    state = eng.init_state()
    mask0 = torch.tensor([True, True, False, False], device=cuda)
    rem = torch.full((4,), 6, dtype=torch.int32, device=cuda)
    state = eng.admit_decode(params, *state, batch, mask0, rem)[:4]
    before = tree_map(torch.clone, tuple(state))
    args = (batch, ~mask0, rem)
    n = eng.graph_launches["admit_decode"]
    got = eng.admit_decode(params, *state, *args)
    torch.cuda.synchronize()
    assert eng.graph_launches["admit_decode"] == n + 1
    (caches, tok, active, rem_, *_), (first, out, n_) = eng._admit_decode_inner(
        cast, *before, *args)
    for g, w in zip(tree_leaves(got), tree_leaves((caches, tok, active, rem_, first, out,
                                                   n_))):
        assert torch.equal(g, w)
    if cfg.enc_dec:
        # the decode graph's input state holds enc_out in the shared buffers
        dec_state = eng.decode(params, *got[:4])[0]
        assert dec_state["enc_out"].data_ptr() == got[0]["enc_out"].data_ptr()


#: deepseek-v3 (MLA: flash at (48, 32), on the CUDA-core route in both dtypes)
#: and grok-1 (flash at 64: CUDA-core in float32, tensor-core in bf16) smoke
MOE_CASES = [("deepseek-v3-671b", "float32"), ("deepseek-v3-671b", "bfloat16"),
             ("grok-1-314b", "float32"), ("grok-1-314b", "bfloat16")]


@pytest.mark.parametrize("arch,dtype", MOE_CASES)
def test_moe_prefill_graph_equals_eager_and_serves_as_the_cpu(cuda, arch, dtype):
    """The MoE smoke models: a warm prefill is ONE graph launch equal to an
    eager ``Model.prefill`` bit for bit (logits, MLA's ``c_kv`` and
    ``k_rope`` or K and V) and holds a flash launch per layer; served in
    float32, resident and host-stepped, the tokens equal the CPU's."""
    from repro_torch.kernels import ops

    cfg = dataclasses.replace(get_config(arch).smoke(), dtype=dtype)
    cpu_params = Model(cfg).init(0, device="cpu")
    params = tree_map(lambda t: t.to(cuda), cpu_params)
    eng = ServeEngine(cfg, slots=4, prompt_len=24, max_new=6, chunk=5)
    batch = synthetic_batch(cfg, np.random.RandomState(0), 4, 24)
    eng.prefill(params, batch, eng.init_state()[0])      # set-up
    torch.cuda.synchronize()
    launches, counts = eng.graph_launches, ops.launch_counts()
    logits, got = eng.prefill(params, batch, eng.init_state()[0])
    torch.cuda.synchronize()
    assert eng.graph_launches == {**launches, "prefill": launches["prefill"] + 1}
    assert ops.launch_counts() == counts
    want_logits, want = eng.model.prefill(eng.cast_params(params), batch,
                                          eng.init_state()[0])
    assert torch.equal(logits, want_logits)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(g, w)
    held = eng.captured_launches("prefill")
    head = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim) if cfg.use_mla \
        else (cfg.resolved_head_dim(), cfg.resolved_head_dim())
    route = fk.route(getattr(torch, dtype), *head)
    assert held["flash_attention"] == held[f"flash_attention_{route}"] == cfg.n_layers
    if dtype == "float32":
        cpu_batch = {k: v.cpu() for k, v in batch.items()}
        shape = dict(batch=4, prompt_len=24, gen_len=6)
        cpu, _ = serve(cfg, params=cpu_params, batch_in=cpu_batch, device="cpu", **shape)
        for resident in (True, False):
            gen, _ = serve(cfg, params=params, batch_in=batch, engine=eng,
                           device_resident=resident, **shape)
            np.testing.assert_array_equal(gen, cpu)


# -- continuous batching: admission as one graph launch ----------------------


def _continuous_params(arch, cuda):
    cfg = get_config(arch).smoke()
    params = (_boosted_dense_params(cfg) if arch in ("qwen1.5-0.5b", "gemma3-1b")
              else Model(cfg).init(0, device="cpu"))
    return cfg, tree_map(lambda t: t.to(cuda), params)


def _admit_args(cfg, slots, prompt_len, max_new, admit, seed, cuda):
    prompts = np.random.RandomState(seed).randint(0, cfg.vocab, (slots, prompt_len))
    mask = np.isin(np.arange(slots), admit)
    rows = np.where(mask[:, None], prompts, 0).astype(np.int32)
    return ({"tokens": torch.from_numpy(rows).to(cuda)}, torch.from_numpy(mask).to(cuda),
            torch.from_numpy(np.where(mask, max_new, 0).astype(np.int32)).to(cuda))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "gemma3-1b", "mamba2-2.7b",
                                  "deepseek-v3-671b", "grok-1-314b"])
def test_admit_graph_equals_eager(cuda, arch):
    """Admit slots 0 and 1, one decode round, admit slots 2 and 3: each
    admission is ONE graph launch equal to the eager admission on the same
    state bit for bit (every output and cache leaf), and the admission and
    decode graphs hand the same state buffers on (no cache copy)."""
    cfg, params = _continuous_params(arch, cuda)
    eng = ServeEngine(cfg, slots=4, prompt_len=40, max_new=12, chunk=4)
    cast = eng.cast_params(params)
    state = eng.init_state()
    ptrs = set()
    for step, admit in enumerate(([0, 1], None, [2, 3])):
        if admit is None:
            *state, _, _ = eng.decode(params, *state)
        else:
            args = _admit_args(cfg, 4, 40, 12, admit, step, cuda)
            before = tree_map(torch.clone, tuple(state))
            launches = eng.graph_launches["admit_decode"]
            got = eng.admit_decode(params, *state, *args)
            torch.cuda.synchronize()
            assert eng.graph_launches["admit_decode"] == launches + 1
            (caches, tok, active, rem, *_), (first, out, n) = eng._admit_decode_inner(
                cast, *before, *args)
            want = (caches, tok, active, rem, first, out, n)
            for g, w in zip(tree_leaves(got), tree_leaves(want)):
                assert torch.equal(g, w)
            state = got[:4]
        ptrs.add(tuple(t.data_ptr() for t in tree_leaves(tuple(state))))
    assert len(ptrs) == 1, "a round moved the state to other buffers"
    assert eng.dispatches == 3 and eng.prefill.calls == 0
    # the admission merges into the shared buffers in place: its graph's
    # closing copies move no more than a decode round's
    tail = {key[0]: g.tail_bytes for key, g in eng._graphs.items()}
    assert tail["admit_decode"] == tail["decode"]


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-2.7b"])
def test_continuous_equals_serial_on_card(cuda, arch):
    """``serve_continuous`` (5 requests, 2 slots, chunk 3) on the card: each
    request's tokens equal serving its prompt alone, in the same slot of an
    engine with as many slots, bit for bit; a round is one dispatch, one
    sync and one graph launch.  Every request runs to ``gen`` tokens (no
    EOS), so they are admitted in pairs and request ``rid`` takes slot
    ``rid % slots``."""
    cfg, params = _continuous_params(arch, cuda)
    n, slots, prompt_len, gen = 5, 2, 8, 6
    prompts = np.random.RandomState(1).randint(0, cfg.vocab, (n, prompt_len)).astype(np.int32)
    results, stats = serve_continuous(cfg, slots=slots, prompt_len=prompt_len, max_new=gen,
                                      n_requests=n, chunk=3, params=params,
                                      prompts={"tokens": torch.from_numpy(prompts).to(cuda)})
    assert stats["prefill_dispatches"] == 0
    assert stats["sync_points"] == stats["dispatches"]
    assert stats["graph_launches"]["admit_decode"] == stats["admit_dispatches"]
    assert stats["graph_launches"]["decode"] == stats["decode_dispatches"]
    eng = ServeEngine(cfg, slots=slots, prompt_len=prompt_len, max_new=gen, chunk=gen - 1)
    assert stats["admit_dispatches"] == -(-n // slots)
    assert all(len(r.tokens) == gen for r in results)
    for r in results:
        slot = r.rid % slots
        rows = np.zeros((slots, prompt_len), np.int32)
        rows[slot] = prompts[r.rid]
        alone, _ = serve(cfg, batch=slots, prompt_len=prompt_len, gen_len=gen,
                         params=params, engine=eng,
                         batch_in={"tokens": torch.from_numpy(rows).to(cuda)})
        np.testing.assert_array_equal(r.tokens, alone[slot])


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


# -- the backward kernels (training) ----------------------------------------

def _grad_close(got: torch.Tensor, want: torch.Tensor, rtol: float, atol_frac: float) -> None:
    """``got`` within ``rtol`` of ``want`` plus ``atol_frac`` of want's
    largest magnitude (gradients sum over rows, batch or time, so the
    absolute part scales with the leaf), and, for a bf16 result, one
    rounding of the output (2^-8 of the magnitudes) on top."""
    g, w = got.float(), want.float()
    bound = rtol * w.abs() + atol_frac * float(w.abs().max()) + 1e-30
    if got.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -8 * (g.abs() + w.abs())
    assert bool(((g - w).abs() <= bound).all()), float((g - w).abs().max())


# then: the rows route at its widest bf16 d (float32 takes the team route
# there) and at float32's widest, each route's element path (a base one
# element off; d 1000 at an odd row stride), d 1000 whole, an odd d (a
# short last group), a row across a cluster of 4 CTAs (d MAX_D) and of 3,
# more rows than partials on teams of one warp
NORM_BWD_CASES = [((2048, 2560), "contiguous"), ((2048, 5120), "contiguous"),
                  ((37, 1152), "contiguous"), ((3, 1000), "stride+24"),
                  ((4, 6, 37, 256), "contiguous"), ((4097, 256), "stride+3"),
                  ((1, 5120), "contiguous"),
                  ((4096, 1024), "contiguous"), ((2048, 512), "contiguous"),
                  ((4096, 1024), "offset+1"), ((2048, 5120), "offset+1"),
                  ((3, 1000), "contiguous"), ((1100, 1000), "stride+3"),
                  ((37, 1001), "contiguous"),
                  ((3, 32768), "contiguous"), ((5, 16392), "stride+24"),
                  ((900, 256), "contiguous")]


@pytest.mark.parametrize("offset", [0.0, 1.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,layout", NORM_BWD_CASES)
def test_rmsnorm_bwd_kernel_matches_plain_vjp(cuda, shape, layout, dtype, offset):
    """dx and dw of the backward kernel against ``autograd.grad`` of the
    plain norm on the same inputs (both routes of ``rmsnorm.bwd_plan``,
    its 16-byte and element loads, leading dimensions, strided rows, a
    misaligned base, a cluster of CTAs a row): dx at the forward's bounds
    (float32 rtol 2e-5 / atol 1e-5 of the largest dx; bf16 one rounding),
    dw (a sum over rows) at rtol 2e-5 plus 1e-5 of its largest entry; two
    runs equal bit for bit."""
    extra, start = {"contiguous": (0, 0), "stride+24": (24, 0), "stride+3": (3, 0),
                    "offset+1": (8, 1)}[layout]
    x = _randn((*shape[:-1], shape[-1] + extra), dtype, cuda, 21)[..., start:start + shape[-1]]
    w = _randn((shape[-1],), torch.float32, cuda, 22)
    dy = _randn(shape, dtype, cuda, 23)
    before = rk.rmsnorm_bwd.launches
    dx, dw = rk.rmsnorm_bwd(x, w, dy, eps=1e-5, weight_offset=offset)
    assert rk.rmsnorm_bwd.launches == before + 1
    want_dx, want_dw = ref.rmsnorm_vjp(x, w, dy, eps=1e-5, weight_offset=offset)
    assert dx.dtype == dtype and dw.dtype == torch.float32
    _grad_close(dx, want_dx, 2e-5, 1e-5)
    _grad_close(dw, want_dw, 2e-5, 1e-5)
    again = rk.rmsnorm_bwd(x, w, dy, eps=1e-5, weight_offset=offset)
    assert torch.equal(again[0], dx) and torch.equal(again[1], dw)


@pytest.mark.parametrize("shape", [(2048, 5120), (4096, 1024), (3, 32768)], ids=str)
def test_rmsnorm_bwd_in_a_cuda_graph_equals_eager(cuda, shape):
    """The backward captured into a CUDA graph (the team route, the rows
    route, a cluster of CTAs a row) gives eager's dx and dw bit for bit,
    replay after replay."""
    x = _randn(shape, torch.bfloat16, cuda, 27)
    w = _randn((shape[-1],), torch.float32, cuda, 28)
    dy = _randn(shape, torch.bfloat16, cuda, 29)
    eager = rk.rmsnorm_bwd(x, w, dy, eps=1e-5, weight_offset=1.0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = rk.rmsnorm_bwd(x, w, dy, eps=1e-5, weight_offset=1.0)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])


def test_rmsnorm_is_differentiable_through_the_kernels(cuda):
    x = _randn((4, 9, 2560), torch.bfloat16, cuda, 24).requires_grad_()
    w = _randn((2560,), torch.float32, cuda, 25).requires_grad_()
    before = (rk.rmsnorm.launches, rk.rmsnorm_bwd.launches)
    y = rk.rmsnorm(x, w, eps=1e-5, weight_offset=1.0)
    dy = _randn(tuple(y.shape), torch.bfloat16, cuda, 26)
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    assert (rk.rmsnorm.launches, rk.rmsnorm_bwd.launches) == (before[0] + 1, before[1] + 1)
    want_dx, want_dw = ref.rmsnorm_vjp(x.detach(), w.detach(), dy, eps=1e-5, weight_offset=1.0)
    _grad_close(dx, want_dx, 2e-5, 1e-5)
    _grad_close(dw, want_dw, 2e-5, 1e-5)


# (batch, S, H, P, G, N, init_state, dtype): the served bf16 shape at a
# shorter sequence (chip_smoke.py phase 18 runs it at S 512), and the float32
# CUDA-core cases: a short last sub-chunk, init_state, 2 groups, the smoke
# model's P 16 / N 16; then the tensor-core route's (bf16, P 64, N 128): a
# short last chunk with init_state, dh and 2 groups, and S 1100 (9 chunks:
# more than one cluster of 8, so two groups of chunks); then the N-16
# tensor-core route's (bf16, P 64, N 16): hymba's training width, dy only,
# and the same short-last-chunk, init_state and two-group cases
SSD_BWD_CASES = [
    (1, 256, 8, 64, 1, 128, False, torch.bfloat16),
    (2, 45, 4, 64, 2, 128, True, torch.float32),
    (2, 100, 4, 16, 1, 16, True, torch.float32),
    (1, 33, 6, 32, 3, 64, False, torch.float32),
    (3, 32, 2, 8, 2, 8, True, torch.bfloat16),
    (2, 300, 8, 64, 2, 128, True, torch.bfloat16),
    (1, 1100, 4, 64, 1, 128, True, torch.bfloat16),
    (1, 640, 50, 64, 1, 16, False, torch.bfloat16),
    (2, 300, 8, 64, 2, 16, True, torch.bfloat16),
    (1, 1100, 4, 64, 1, 16, True, torch.bfloat16),
    (2, 100, 4, 64, 1, 16, True, torch.float32),
]


def _ssd_bwd_inputs(Bsz, S, H, P, G, N, init, dtype, device, seed):
    rs = np.random.RandomState(seed)
    t = lambda a, dt=torch.float32: torch.from_numpy(a.astype(np.float32)).to(device, dt)
    x = t(rs.randn(Bsz, S, H, P), dtype)
    dt_ = t(np.log1p(np.exp(rs.randn(Bsz, S, H) - 1.0)))   # softplus, as the model's
    A = t(-np.exp(rs.randn(H) * 0.5))
    Bm = t(rs.randn(Bsz, S, G, N) * 0.3, dtype)
    C = t(rs.randn(Bsz, S, G, N) * 0.3, dtype)
    h0 = t(rs.randn(Bsz, H, P, N)) if init else None
    dy = t(rs.randn(Bsz, S, H, P), dtype)
    dh = t(rs.randn(Bsz, H, P, N))
    return x, dt_, A, Bm, C, h0, dy, dh


@pytest.mark.parametrize("case", SSD_BWD_CASES, ids=str)
def test_ssd_bwd_kernel_matches_plain_vjp(cuda, case):
    """The backward kernel against ``autograd.grad`` of the plain scan in
    float32 on the same (widened) inputs: float32 results at rtol 2e-4 plus
    2e-5 of the leaf's largest entry (sums over S, the batch and a group's
    heads), bf16 results (dx, dB, dC of bf16 inputs) within one rounding
    more; two runs equal bit for bit."""
    x, dt_, A, Bm, C, h0, dy, dh = _ssd_bwd_inputs(*case, cuda, 31)
    route = ssd.bwd_route(x.dtype, x.shape[3], Bm.shape[3])
    before = ssd.launch_counts()
    got = ssd.ssd_scan_bwd(x, dt_, A, Bm, C, init_state=h0, dy=dy, dh=dh)
    after = ssd.launch_counts()
    assert after["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 1
    assert after[f"ssd_scan_bwd_{route}"] == before[f"ssd_scan_bwd_{route}"] + 1
    _hold_ssd_bwd(got, x, dt_, A, Bm, C, h0, dy, dh)
    again = ssd.ssd_scan_bwd(x, dt_, A, Bm, C, init_state=h0, dy=dy, dh=dh)
    assert all(torch.equal(a, b) for a, b in zip(again, got) if a is not None)


def _hold_ssd_bwd(got, x, dt_, A, Bm, C, h0, dy, dh):
    """The backward kernels' bound against the plain VJP of the widened
    inputs (see test_ssd_bwd_kernel_matches_plain_vjp)."""
    wide = [None if t is None else t.float() for t in (x, dt_, A, Bm, C, h0, dy, dh)]
    want = ref.ssd_scan_vjp(*wide)
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC", "dh0"), got, want):
        assert (g is None) == (w is None), name
        if g is not None:
            assert g.shape == w.shape, name
            _grad_close(g, w, 2e-4, 2e-5)


def test_ssd_bwd_wgmma_reads_strided_views_and_any_cluster(cuda):
    """x, B and C as slices of one conv output (the model's path) give the
    contiguous inputs' gradients bit for bit; dy alone (no dh, no
    init_state) meets the bound at every cluster size (1 to 3 CTAs: 3, 2
    or 1 groups of chunks)."""
    x, dt_, A, Bm, C, _, dy, _ = _ssd_bwd_inputs(2, 300, 8, 64, 2, 128, False, torch.bfloat16,
                                                 cuda, 35)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2:]
    xbc = torch.cat([x.reshape(Bsz, S, -1), Bm.reshape(Bsz, S, -1), C.reshape(Bsz, S, -1)], -1)
    xv = xbc[..., :H * P].reshape(Bsz, S, H, P)
    bv = xbc[..., H * P:H * P + G * N].reshape(Bsz, S, G, N)
    cv = xbc[..., H * P + G * N:].reshape(Bsz, S, G, N)
    assert not xv.is_contiguous() and ssd._tma_ok(xv) and ssd._tma_ok(bv)
    got = ssd.ssd_scan_bwd(x, dt_, A, Bm, C, dy=dy)
    views = ssd.ssd_scan_bwd(xv, dt_, A, bv, cv, dy=dy)
    assert all(torch.equal(a, b) for a, b in zip(views, got) if a is not None)
    _hold_ssd_bwd(got, x, dt_, A, Bm, C, None, dy, None)
    for cluster in (1, 2, 3):
        _hold_ssd_bwd(ssd.ssd_scan_bwd_variant(xv, dt_, A, bv, cv, dy=dy, cluster=cluster,
                                               parts=ssd.BWD_PARTS),
                      x, dt_, A, Bm, C, None, dy, None)


@pytest.mark.parametrize("cluster", [1, 3])
def test_ssd_bwd_wgmma_groups_of_chunks_meet_the_bound(cuda, cluster):
    """A long sequence in many groups of chunks (S 1100: 9 chunks, so 9
    groups of 1 or 3 of 3, each group's end state and U carried through
    global memory), 2 batches and 2 groups, with init_state and dh: within
    the bound, and the same call twice bit for bit."""
    x, dt_, A, Bm, C, h0, dy, dh = _ssd_bwd_inputs(2, 1100, 4, 64, 2, 128, True,
                                                   torch.bfloat16, cuda, 37)
    run = lambda: ssd.ssd_scan_bwd_variant(x, dt_, A, Bm, C, init_state=h0, dy=dy, dh=dh,  # noqa: E731
                                           cluster=cluster)
    got = run()
    _hold_ssd_bwd(got, x, dt_, A, Bm, C, h0, dy, dh)
    assert all(torch.equal(a, b) for a, b in zip(run(), got))


def test_ssd_bwd_wgmma_n16_views_clusters_and_graph_replay(cuda):
    """The N-16 tensor-core backward at hymba's widths: x, B and C as
    slices of one conv output give the contiguous inputs' gradients bit
    for bit; every cluster size (1, 2, 3, 5 CTAs: 5 to 1 groups of chunks)
    meets the bound; a CUDA-graph replay equals the eager call bit for
    bit."""
    x, dt_, A, Bm, C, h0, dy, dh = _ssd_bwd_inputs(2, 640, 6, 64, 1, 16, True, torch.bfloat16,
                                                   cuda, 38)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2:]
    assert ssd.bwd_route(x.dtype, P, N) == "wgmma_n16"
    xbc = torch.cat([x.reshape(Bsz, S, -1), Bm.reshape(Bsz, S, -1), C.reshape(Bsz, S, -1)], -1)
    xv = xbc[..., :H * P].reshape(Bsz, S, H, P)
    bv = xbc[..., H * P:H * P + G * N].reshape(Bsz, S, G, N)
    cv = xbc[..., H * P + G * N:].reshape(Bsz, S, G, N)
    assert not xv.is_contiguous() and ssd._tma_ok(xv) and ssd._tma_ok(bv) and ssd._tma_ok(cv)
    before = ssd.launch_counts()
    got = ssd.ssd_scan_bwd(x, dt_, A, Bm, C, init_state=h0, dy=dy, dh=dh)
    after = ssd.launch_counts()
    assert {k: after[k] - before[k] for k in after if "bwd" in k} == {
        "ssd_scan_bwd": 1, "ssd_scan_bwd_wgmma": 0, "ssd_scan_bwd_wgmma_n16": 1,
        "ssd_scan_bwd_cuda_core": 0}
    views = ssd.ssd_scan_bwd(xv, dt_, A, bv, cv, init_state=h0, dy=dy, dh=dh)
    assert all(torch.equal(a, b) for a, b in zip(views, got) if a is not None)
    _hold_ssd_bwd(got, x, dt_, A, Bm, C, h0, dy, dh)
    for cluster in (1, 2, 3, 5):
        _hold_ssd_bwd(ssd.ssd_scan_bwd_variant(xv, dt_, A, bv, cv, init_state=h0, dy=dy, dh=dh,
                                               cluster=cluster, parts=ssd.BWD_PARTS_N16),
                      x, dt_, A, Bm, C, h0, dy, dh)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ssd.ssd_scan_bwd(x, dt_, A, Bm, C, init_state=h0, dy=dy, dh=dh)  # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ssd.ssd_scan_bwd(x, dt_, A, Bm, C, init_state=h0, dy=dy, dh=dh)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, got) if a is not None)


def test_ssd_bwd_wgmma_graph_replay_equals_eager(cuda):
    """The tensor-core backward captured in a CUDA graph and replayed gives
    the eager call's gradients bit for bit (no float atomics)."""
    x, dt_, A, Bm, C, h0, dy, dh = _ssd_bwd_inputs(2, 300, 8, 64, 2, 128, True, torch.bfloat16,
                                                   cuda, 36)
    eager = ssd.ssd_scan_bwd(x, dt_, A, Bm, C, init_state=h0, dy=dy, dh=dh)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        ssd.ssd_scan_bwd(x, dt_, A, Bm, C, init_state=h0, dy=dy, dh=dh)  # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ssd.ssd_scan_bwd(x, dt_, A, Bm, C, init_state=h0, dy=dy, dh=dh)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, eager))


def test_ssd_scan_is_differentiable_through_the_kernels(cuda):
    """Under autograd the route's forward kernel runs, and the backward
    kernel gives every input's gradient; only y used (dh is None)."""
    x, dt_, A, Bm, C, h0, dy, _ = _ssd_bwd_inputs(1, 256, 8, 64, 1, 128, True, torch.bfloat16,
                                               cuda, 32)
    ins = [t.requires_grad_() for t in (x, dt_, A, Bm, C, h0)]
    before = dict(ssd.launch_counts())
    y = ssd.ssd_scan(*ins[:5], init_state=ins[5], chunk=128)
    grads = torch.autograd.grad(y, ins, dy)
    after = ssd.launch_counts()
    assert after["ssd_scan_wgmma"] == before["ssd_scan_wgmma"] + 1
    assert after["ssd_scan_bwd"] == before["ssd_scan_bwd"] + 1
    assert after["ssd_scan_bwd_wgmma"] == before["ssd_scan_bwd_wgmma"] + 1
    want = ref.ssd_scan_vjp(*[t.detach().float() for t in ins], dy.float(), None)
    for g, w in zip(grads, want):
        _grad_close(g, w, 2e-4, 2e-5)


def test_ssd_scan_n16_is_differentiable_through_the_kernels(cuda):
    """The same at hymba's widths: the N-16 forward kernel, then the N-16
    backward kernel, nothing on the CUDA-core route."""
    x, dt_, A, Bm, C, h0, dy, _ = _ssd_bwd_inputs(2, 640, 10, 64, 1, 16, True, torch.bfloat16,
                                               cuda, 39)
    ins = [t.requires_grad_() for t in (x, dt_, A, Bm, C, h0)]
    before = dict(ssd.launch_counts())
    y = ssd.ssd_scan(*ins[:5], init_state=ins[5], chunk=128)
    grads = torch.autograd.grad(y, ins, dy)
    after = ssd.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "ssd_scan": 1, "ssd_scan_wgmma": 0, "ssd_scan_wgmma_n16": 1, "ssd_scan_cuda_core": 0,
        "ssd_scan_bwd": 1, "ssd_scan_bwd_wgmma": 0, "ssd_scan_bwd_wgmma_n16": 1,
        "ssd_scan_bwd_cuda_core": 0}
    want = ref.ssd_scan_vjp(*[t.detach().float() for t in ins], dy.float(), None)
    for g, w in zip(grads, want):
        _grad_close(g, w, 2e-4, 2e-5)


#: flash attention's backward, (dtype, B, Hq, Hkv, Sq, Skv, D, Dv, kwargs):
#: both forward routes (the tensor-core one in bf16 at 64 / 128 / 256 /
#: (192, 128)), every mask, GQA, the soft-cap, rows that see no key
FLASH_BWD_CASES = [
    (torch.float32, 1, 2, 2, 70, 70, 64, 64, {}),
    (torch.float32, 2, 4, 1, 100, 100, 32, 32, dict(window=33)),
    (torch.float32, 1, 4, 2, 40, 130, 128, 128, dict(q_offset=90, window=60)),
    (torch.float32, 1, 2, 1, 50, 90, 16, 16, dict(causal=False)),
    (torch.float32, 1, 2, 2, 70, 70, 48, 32, dict(scale=192 ** -0.5)),
    (torch.float32, 1, 2, 1, 40, 40, 16, 16, dict(window=0)),
    (BF16, 1, 4, 1, 200, 200, 256, 256, dict(window=64)),
    (BF16, 2, 8, 2, 96, 96, 128, 128, dict(logit_softcap=15.0)),
    (BF16, 1, 4, 4, 70, 100, 64, 64, dict(causal=False)),
    (BF16, 1, 4, 2, 80, 80, 192, 128, dict(q_offset=-10)),
    (BF16, 1, 2, 1, 64, 64, 32, 32, dict(window=19)),
    # glm4-9b's GQA group of 16: the dK/dV kernel's cluster of 8, 2 heads a CTA
    (BF16, 1, 32, 2, 130, 130, 128, 128, {}),
]


def _flash_bwd_inputs(case, device, seed=41):
    dtype, B, Hq, Hkv, Sq, Skv, D, Dv, kw = case
    q = _randn((B, Sq, Hq, D), dtype, device, seed).transpose(1, 2)
    k = _randn((B, Skv, Hkv, D), dtype, device, seed + 1).transpose(1, 2)
    v = _randn((B, Skv, Hkv, Dv), dtype, device, seed + 2).transpose(1, 2)
    dout = _randn((B, Sq, Hq, Dv), dtype, device, seed + 3).transpose(1, 2)
    return q, k, v, dout, kw


@pytest.mark.parametrize("case", FLASH_BWD_CASES, ids=lambda c: _case_id(
    dict(zip(("dtype", "B", "Hq", "Hkv", "Sq", "Skv", "D", "Dv"), c[:8]), **c[8])))
def test_flash_backward_matches_plain_vjp(cuda, case):
    """Under autograd the route's forward kernel runs once and the backward
    kernels once; the gradients within the backward kernels' bound of
    ``ref.attention_vjp`` on float32 copies of the inputs (rtol 2e-4 plus
    2e-5 of the leaf's largest entry, one bf16 rounding more in bf16), in
    the model's [B,S,H,D] layout; rows that see no key get zeros."""
    q, k, v, dout, kw = _flash_bwd_inputs(case, cuda)
    ins = [t.detach().requires_grad_() for t in (q, k, v)]
    before = fk.launch_counts()
    out = fk.flash_attention(*ins, **kw)
    grads = torch.autograd.grad(out, ins, dout)
    after = fk.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    which = fk.route(q.dtype, q.shape[3], v.shape[3])
    other = "cuda_core" if which == "wgmma" else "wgmma"
    assert after[f"flash_attention_bwd_{which}"] == before[f"flash_attention_bwd_{which}"] + 1
    assert after[f"flash_attention_bwd_{other}"] == before[f"flash_attention_bwd_{other}"]
    want = ref.attention_vjp(*(t.float() for t in (q, k, v, dout)), **kw)
    for g, w, t in zip(grads, want, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
        _grad_close(g, w, 2e-4, 2e-5)
    with torch.no_grad():
        assert torch.equal(out, fk.flash_attention(q, k, v, **kw))


def test_flash_backward_is_deterministic_and_graphs(cuda):
    """Two calls give the same bits, and a CUDA graph of the forward and
    backward (autograd inside the capture) replays the eager bits, at
    gemma3's group of 4, D 256, a window, bf16 (the tensor-core forward)
    and float32 (the CUDA-core one)."""
    for dtype in (BF16, torch.float32):
        q, k, v, dout, kw = _flash_bwd_inputs((dtype, 2, 4, 1, 160, 160, 256, 256,
                                               dict(window=48)), cuda, seed=51)

        def step():
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            out = fk.flash_attention(*ins, **kw)
            return (out, *torch.autograd.grad(out, ins, dout))

        first, second = step(), step()
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            step()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = step()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, first)), dtype


def _cuda_core_flash_bwd(q, k, v, o32, lse, dout, causal=True, scale=None, window=None,
                         logit_softcap=None, q_offset=0):
    """The CUDA-core backward on bf16 inputs through its C entry point
    (the route rule gives it only float32 and the small pairs)."""
    from repro_torch.kernels.build import check_launch, load_library, stream_arg

    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[3]
    dq = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((B, Skv, Hkv, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((B, Skv, Hkv, Dv), dtype=q.dtype, device=q.device).transpose(1, 2)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    ts = (q, k, v, dout, o32, dq, dk, dv)
    err = load_library("flash_attention", fk.SIGNATURES).rt_flash_attention_bwd(
        1, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), o32.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Hq, Hkv, Sq, Skv, D, Dv, *[st for t in ts for st in t.stride()[:3]],
        D ** -0.5 if scale is None else float(scale),
        0.0 if logit_softcap is None else float(logit_softcap), int(bool(causal)),
        -1 if window is None else int(window), int(q_offset), stream_arg(q))
    check_launch("flash_attention", err)
    return dq, dk, dv


#: the tensor-core backward at each of its pairs, bf16, Sq and Skv not
#: multiples of 64: GQA with a window and a depth, the soft-cap, cross
#: attention, rows that see no key
FLASH_BWD_WGMMA_CASES = [
    (BF16, 1, 8, 2, 100, 170, 256, 256, dict(q_offset=70, window=90)),
    (BF16, 2, 6, 1, 77, 77, 128, 128, dict(logit_softcap=30.0)),
    (BF16, 1, 5, 5, 45, 130, 64, 64, dict(causal=False)),
    (BF16, 1, 4, 4, 150, 150, 192, 128, dict(q_offset=-30, window=50, scale=192 ** -0.5)),
]


@pytest.mark.parametrize("case", FLASH_BWD_WGMMA_CASES, ids=lambda c: _case_id(
    dict(zip(("dtype", "B", "Hq", "Hkv", "Sq", "Skv", "D", "Dv"), c[:8]), **c[8])))
def test_flash_backward_wgmma_against_cuda_core(cuda, case):
    """On the same input the tensor-core backward (one counted launch of
    its route) and the CUDA-core one are each within the backward's bound
    of the plain VJP and of each other; two calls give the same bits; a
    call captured in a CUDA graph replays the eager bits; rows that see no
    key get zeros."""
    q, k, v, dout, kw = _flash_bwd_inputs(case, cuda, seed=71)
    _, o32, lse = fk.forward_with_lse(q, k, v, **kw)
    before = fk.launch_counts()
    got = fk.flash_attention_bwd(q, k, v, o32, lse, dout, **kw)
    after = fk.launch_counts()
    assert after["flash_attention_bwd_wgmma"] == before["flash_attention_bwd_wgmma"] + 1
    assert after["flash_attention_bwd_cuda_core"] == before["flash_attention_bwd_cuda_core"]
    core = _cuda_core_flash_bwd(q, k, v, o32, lse, dout, **kw)
    want = ref.attention_vjp(*(t.float() for t in (q, k, v, dout)), **kw)
    for g, c, w in zip(got, core, want):
        _grad_close(g, w, 2e-4, 2e-5)
        _grad_close(c, w, 2e-4, 2e-5)
        _grad_close(g, c.float(), 2e-4, 2e-5)
    again = fk.flash_attention_bwd(q, k, v, o32, lse, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fk.flash_attention_bwd(q, k, v, o32, lse, dout, **kw)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(captured, got))
    if kw.get("q_offset", 0) < 0:
        blind = -kw["q_offset"]
        assert bool((got[0][:, :, :blind] == 0).all())


def test_flash_forward_without_grad_is_unchanged(cuda):
    """Serving's forward (no autograd) asks for no log-sum-exp: one launch,
    no backward; its output equals the training forward's bit for bit, on
    both routes; the training forward's L is each row's log-sum-exp (-inf
    for a row that sees no key) and its float32 output rounds to the
    result."""
    for dtype, D in ((BF16, 128), (torch.float32, 64), (BF16, 32)):
        q, k, v, _, kw = _flash_bwd_inputs((dtype, 1, 4, 2, 90, 90, D, D,
                                            dict(q_offset=-5, window=40)), cuda, seed=61)
        before = fk.launch_counts()
        with torch.no_grad():
            served = fk.flash_attention(q, k, v, **kw)
        after = fk.launch_counts()
        assert after["flash_attention"] == before["flash_attention"] + 1
        assert after["flash_attention_bwd"] == before["flash_attention_bwd"]
        out, o32, lse = fk.forward_with_lse(q, k, v, **kw)
        assert torch.equal(out, served) and torch.equal(o32.to(dtype), out)
        logits = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                              k.float().repeat_interleave(2, dim=1)) * D ** -0.5
        qpos = torch.arange(90, device=cuda)[:, None] - 5
        kpos = torch.arange(90, device=cuda)[None, :]
        mask = (kpos <= qpos) & (kpos > qpos - 40)
        want = torch.logsumexp(logits.masked_fill(~mask, float("-inf")), dim=-1)
        seen = mask.any(-1)
        assert bool((lse[:, :, ~seen] == float("-inf")).all())
        torch.testing.assert_close(lse[:, :, seen], want[:, :, seen], rtol=1e-5, atol=1e-5)


# -- training on the card ------------------------------------------------------


def _train_setup(device, remat="block", scan_layers=True):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import steps as st
    cfg = dataclasses.replace(get_config("mamba2-2.7b").smoke(), remat=remat,
                              scan_layers=scan_layers)
    shape = ShapeConfig("t", 40, 2, "train")   # 40 % 32: a short last sub-chunk
    mesh = make_mesh((1, 1), ("data", "model"), device=device)
    bundle = st.build_train_step(cfg, shape, mesh)
    source = SyntheticTokens(cfg, shape)
    batches = [{k: torch.from_numpy(v).to(device) for k, v in source.batch(i).items()}
               for i in range(3)]
    return cfg, bundle, batches


def _plain_moe_backwards(*args):
    """``chip_smoke.plain_moe_backwards``: the dispatch's and the combine's
    backwards written plainly."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke.plain_moe_backwards(torch, *args)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "grok-1-314b"])
def test_moe_layer_backward_is_deterministic_without_the_mode(cuda, arch):
    """The MoE layer's forward and backward in bf16 at smoke width (8
    experts, top-2, 96 tokens; at the default capacity and at one that
    drops), run twice with ``torch.use_deterministic_algorithms(False)``:
    the output and every gradient (x, the router, the experts) equal bit
    for bit; the dispatch's and the combine's gradients equal their plain
    versions bit for bit."""
    from repro_torch.models import moe

    cfg = dataclasses.replace(get_config(arch).smoke(), n_experts=8, dtype="bfloat16",
                              param_dtype="bfloat16")
    p = moe.init_moe(torch.Generator(cuda).manual_seed(3), cfg, device=cuda)
    mode = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        for capacity in (None, 4):
            runs = []
            for _ in range(2):
                live = {k: v.detach().requires_grad_(k != "router_bias") for k, v in p.items()}
                x = _field((4, 24, cfg.d_model), BF16, cuda, 5).requires_grad_()
                y, aux = moe.apply_moe(live, x, cfg, capacity=capacity)
                dy = _field(tuple(y.shape), BF16, cuda, 6)
                wrt = [x] + [v for k, v in live.items() if k != "router_bias"]
                grads = torch.autograd.grad((y * dy).sum() + aux["lb_loss"], wrt)
                runs.append([y.detach(), *grads])
            if capacity:
                assert float(aux["dropped_frac"]) > 0
            assert all(torch.equal(a, b) for a, b in zip(*runs)), (arch, capacity)
            # the two Functions alone against their plain backwards
            T, E = 96, cfg.n_experts
            x2d = _field((T, cfg.d_model), BF16, cuda, 7).requires_grad_()
            idx, w, _ = moe._route(p, x2d.detach(), cfg)
            C = capacity or int(np.ceil(T * cfg.top_k / E * cfg.capacity_factor))
            xin, plan = moe._dispatch(x2d, idx, E, C)
            dxin = _field((E * C, cfg.d_model), BF16, cuda, 8)
            (dx,) = torch.autograd.grad(xin.reshape(E * C, -1), x2d, dxin)
            yout = _field((E * C, cfg.d_model), BF16, cuda, 9).requires_grad_()
            wl = w.detach().requires_grad_()
            dy = _field((T, cfg.d_model), BF16, cuda, 10)
            dyout, dw = torch.autograd.grad(moe._combine(yout, wl, plan), (yout, wl), dy)
            _, slot, keep, _ = moe.dispatch_plan(idx, E, C)
            want = _plain_moe_backwards(dxin, dy, yout.detach(), wl.detach(), slot, keep)
            for name, got, ref_ in zip(("dx", "dyout", "dw"), (dx, dyout, dw), want):
                assert torch.equal(got, ref_), (arch, capacity, name)
    finally:
        torch.use_deterministic_algorithms(mode)


def _fresh_state(cfg, device):
    from repro_torch.optim import AdamWConfig, adamw_init
    params = Model(cfg).init(0, device="cpu")
    params = tree_map(lambda t: t.to(device), params)
    return params, adamw_init(params, AdamWConfig())


def test_smoke_loss_and_every_gradient_on_card_match_cpu(cuda):
    """The smoke model's loss and gradients on the card (SSD and RMSNorm
    forward and backward kernels, layers checkpointed, stacked params
    split by unbind) against the port on the CPU (the plain versions):
    loss rtol 1e-5, every leaf present, finite, not all zero, within rtol
    1e-4 plus 1e-4 of its largest entry."""
    cfg, bundle, batches = _train_setup(cuda)
    _, cpu_bundle, cpu_batches = _train_setup("cpu")
    params, _ = _fresh_state(cfg, cuda)
    before = {**rk.launch_counts(), **ssd.launch_counts()}
    grads, met = bundle.grad_fn(params, batches[0])
    torch.cuda.synchronize()
    after = {**rk.launch_counts(), **ssd.launch_counts()}
    assert after["ssd_scan_bwd"] - before["ssd_scan_bwd"] == cfg.n_layers
    # each layer's scan runs twice: the forward and the checkpoint's recompute
    assert after["ssd_scan"] - before["ssd_scan"] == 2 * cfg.n_layers
    assert after["rmsnorm_bwd"] - before["rmsnorm_bwd"] == 2 * cfg.n_layers + 1
    cpu_grads, cpu_met = cpu_bundle.grad_fn(tree_map(lambda t: t.cpu(), params), cpu_batches[0])
    np.testing.assert_allclose(float(met["loss"]), float(cpu_met["loss"]), rtol=1e-5)
    for g, w in zip(tree_leaves(grads), tree_leaves(cpu_grads)):
        assert g is not None and bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0)
        _grad_close(g.cpu(), w, 1e-4, 1e-4)


def test_no_gradient_leaf_is_none_after_backward(cuda):
    cfg, bundle, batches = _train_setup(cuda, remat="none", scan_layers=False)
    params, _ = _fresh_state(cfg, cuda)
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    loss, _ = bundle.model.loss(params, batches[0])
    loss.backward()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all()) for p in leaves)


@pytest.mark.parametrize("kind", ["persistent", "pipelined"])
def test_multi_step_dispatch_is_one_graph_launch_equal_to_eager(cuda, kind):
    """3 steps as ONE CUDA-graph launch equal, bit for bit, to the same
    steps run eagerly on the card (params, AdamW state, metrics), without
    ``torch.use_deterministic_algorithms``; a second call replays the
    graph."""
    from repro_torch.launch import steps as st
    cfg, bundle, batches = _train_setup(cuda)
    stack = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    wrap = st.persistent_steps if kind == "persistent" else st.pipelined_steps
    p0, o0 = _fresh_state(cfg, cuda)
    eager_fn = wrap(bundle, 3, stacked=True).step_fn._eager
    p_e, o_e, m_e = eager_fn(p0, o0, stack)
    p1, o1 = _fresh_state(cfg, cuda)
    multi = wrap(bundle, 3, stacked=True).step_fn
    p_g, o_g, m_g = multi(p1, o1, stack)
    torch.cuda.synchronize()
    assert (multi.dispatches, multi.captures) == (1, 1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves((p_e, o_e)), tree_leaves((p_g, o_g))))
    for k in m_e:
        assert torch.equal(m_e[k].to(cuda), m_g[k]), k
    multi(p1, o1, stack)
    assert (multi.dispatches, multi.captures) == (2, 1)
    assert int(o1["step"]) == 6


@pytest.mark.parametrize("factor", [2.0, 0.5])
def test_plateau_graph_loop_equals_host_polled(cuda, factor):
    """until=loss_plateau through the graph-loop WHILE node: steps_done and
    the loss trace equal the eager loop's with the predicate polled on the
    host, bit for bit (eps twice or half the first loss move: it stops
    after 2 steps, or runs to the bound of 3)."""
    from repro_torch.launch import steps as st
    cfg, bundle, batches = _train_setup(cuda)
    stack = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    p0, o0 = _fresh_state(cfg, cuda)
    _, _, m0 = st.persistent_steps(bundle, 3, stacked=True).step_fn._eager(p0, o0, stack)
    eps = factor * abs(float(m0["loss"][1]) - float(m0["loss"][0]))
    p_e, o_e = _fresh_state(cfg, cuda)
    eager = st.persistent_steps(bundle, 3, until=st.loss_plateau(eps), stacked=True)
    p_e, o_e, m_e = eager.step_fn._eager(p_e, o_e, stack)
    p_g, o_g = _fresh_state(cfg, cuda)
    loop = st.persistent_steps(bundle, 3, until=st.loss_plateau(eps), stacked=True).step_fn
    p_g, o_g, m_g = loop(p_g, o_g, stack)
    done = int(m_g["steps_done"])
    assert done == int(m_e["steps_done"]) == (2 if factor > 1 else 3)
    for k in ("loss", "ce", "grad_norm", "lr"):
        assert torch.equal(m_g[k], m_e[k].to(cuda)), k
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves((p_e, o_e)), tree_leaves((p_g, o_g))))


# -- the embedding's backward ------------------------------------------------------


# (ids, D, vocab, dtype, kind): ragged T and D (odd D takes the element
# path, even D the paired one), one id repeated, all distinct, a few values
EMB_CASES = [(4096, 1024, 151936, BF16, "few"), (4096, 1024, 151936, BF16, "one_id"),
             (1792, 1280, 5000, BF16, "distinct"), (37, 7, 50, BF16, "few"),
             (300, 130, 64, torch.float32, "few"), (1, 64, 9, torch.float32, "one_id"),
             (4097, 4096, 1000, BF16, "few"), (0, 64, 10, BF16, "few")]


def _emb_inputs(T, D, V, dtype, kind, device, seed=0):
    rng = np.random.RandomState(seed)
    ids = {"few": rng.choice(rng.randint(0, V, 16), T), "one_id": np.full(T, V - 1),
           "distinct": rng.permutation(V)[:T]}[kind]
    return (_randn((T, D), dtype, device, seed + 1),
            torch.from_numpy(ids.astype(np.int64)).to(device))


@pytest.mark.parametrize("case", EMB_CASES, ids=str)
def test_embedding_bwd_kernel_equals_plain(cuda, case):
    """The kernel equals its plain version bit for bit (each id's rows in
    token order, every add rounded), every row written (zeros where no id
    falls), with int32 ids and a row-strided dy too; two calls equal."""
    T, D, V, dtype, kind = case
    dy, ids = _emb_inputs(T, D, V, dtype, kind, cuda)
    before = ek.embedding_bwd.launches
    got = ek.embedding_bwd(dy, ids, V)
    assert ek.embedding_bwd.launches == before + 1
    want = ref.embedding_bwd(dy, ids, V)
    assert got.dtype == dtype and torch.equal(got, want)
    assert torch.equal(ek.embedding_bwd(dy, ids.int(), V), got)
    wide = torch.zeros((T, D + 8), dtype=dtype, device=cuda)
    wide[:, :D] = dy
    assert torch.equal(ek.embedding_bwd(wide[:, :D], ids, V), got)


def test_embedding_bwd_graph_replay_equals_eager(cuda):
    """Sort and kernel captured into one CUDA graph (nothing read back on
    the host): a replay on new ids and rows equals an eager call."""
    dy, ids = _emb_inputs(4096, 1024, 151936, BF16, "few", cuda)
    eager = ek.embedding_bwd(dy, ids, 151936)
    graph, out = graph_loop.capture(lambda: ek.embedding_bwd(dy, ids, 151936),
                                    keep_graph=False)
    dy2, ids2 = _emb_inputs(4096, 1024, 151936, BF16, "few", cuda, seed=5)
    dy.copy_(dy2)
    ids.copy_(ids2)
    graph.replay()
    assert torch.equal(out, ek.embedding_bwd(dy2, ids2, 151936))
    assert not torch.equal(out, eager)


def test_embedding_bwd_refuses_wrong_dtype_or_stride(cuda):
    dy, ids = _emb_inputs(64, 32, 100, BF16, "few", cuda)
    with pytest.raises(ValueError):
        ek.embedding_bwd(dy.half(), ids, 100)
    with pytest.raises(ValueError):
        ek.embedding_bwd(dy.t().contiguous().t(), ids, 100)   # column-major: stride 64
    with pytest.raises(ValueError):
        ek.embedding_bwd(dy, ids.float(), 100)
    with pytest.raises(ValueError):
        ek.embedding_bwd(dy, ids[:10], 100)


def test_qwen_smoke_gradients_on_card_match_cpu(cuda):
    """qwen1.5-0.5b smoke's ``Model.loss`` on tokens that repeat heavily:
    the loss and every gradient on the card (the embedding backward kernel
    once, the tied table's two contributions added) against the port on
    the CPU at rtol 1e-5 (loss) and rtol 1e-4 plus 1e-4 of a leaf's
    largest entry; two runs on the card equal bit for bit."""
    from repro_torch.launch import steps as st
    from repro_torch.configs.base import ShapeConfig
    cfg = get_config("qwen1.5-0.5b").smoke()
    shape = ShapeConfig("t", 32, 2, "train")
    rng = np.random.RandomState(4)
    tokens = rng.choice([1, 7, 100, cfg.vocab - 1], (2, 32)).astype(np.int32)
    targets = rng.randint(0, cfg.vocab, (2, 32)).astype(np.int32)
    out = {}
    for dev in ("cpu", cuda):
        bundle = st.build_train_step(cfg, shape, make_mesh((1, 1), ("data", "model"),
                                                           device=dev))
        params = tree_map(lambda t: t.to(dev), Model(cfg).init(0, device="cpu"))
        batch = {"tokens": torch.from_numpy(tokens).to(dev),
                 "targets": torch.from_numpy(targets).to(dev)}
        before = ek.embedding_bwd.launches
        out[str(dev)] = [bundle.grad_fn(params, batch) for _ in range(2 if dev == cuda else 1)]
        if dev == cuda:
            torch.cuda.synchronize()
            assert ek.embedding_bwd.launches == before + 2
    (cpu_grads, cpu_met), = out["cpu"]
    (g1, m1), (g2, m2) = out[str(cuda)]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g1), tree_leaves(g2)))
    np.testing.assert_allclose(float(m1["loss"]), float(cpu_met["loss"]), rtol=1e-5)
    for g, w in zip(tree_leaves(g1), tree_leaves(cpu_grads)):
        assert bool(torch.isfinite(g).all())
        _grad_close(g.cpu(), w, 1e-4, 1e-4)
