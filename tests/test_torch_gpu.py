"""Tests that need the card (marker ``gpu``; they skip without CUDA).

Each hand-written CUDA kernel is held against its plain PyTorch version
on the same device inputs: the halo kernels bit for bit, the SSD scan
within the repo's chunked-vs-sequential bound (rtol 2e-4, atol 3e-5).
The engines' CUDA graphs and the serve engine are held against the CPU
run of the same program.  This file imports no JAX, so it runs on a GPU
machine without it::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from repro_torch import make_mesh
from repro_torch.core import (
    FacesConfig,
    FusedEngine,
    HostEngine,
    PersistentEngine,
    build_faces_program,
    to_numpy,
)
from repro_torch.configs import get_config
from repro_torch.core.halo import AXES3
from repro_torch.kernels import halo_pack as hk
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch.serve import ServeEngine, serve, synthetic_batch
from repro_torch.models import Model
from repro_torch.models.nn import tree_map

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("region", REGIONS)
def test_halo_kernels_equal_plain(cuda, region, dtype):
    u = _randn((2, 3, 6, 5, 7), dtype, cuda, 0)
    before = dict(hk.launch_counts())
    assert torch.equal(hk.halo_pack(u, region), ref.halo_pack(u, region))
    msg = _randn((2, 3, *ref.region_shape(region)), dtype, cuda, 1)
    got = hk.halo_unpack_add(u.clone(), msg, region)
    assert torch.equal(got, ref.halo_unpack_add(u.clone(), msg, region))
    after = hk.launch_counts()
    assert after["halo_pack"] == before["halo_pack"] + 1
    assert after["halo_unpack_add"] == before["halo_unpack_add"] + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_kernels_equal_plain(cuda, dtype):
    recv = _randn((4, 40), dtype, cuda, 2)
    slab = _randn((4, 3, 5), dtype, cuda, 3).view(4, -1)
    sources, sizes = [(slab, 0), (recv, 7), (recv, 0), (slab, 14)], [15, 9, 1, 1]
    staged = hk.pack_segments(sources, sizes)
    assert torch.equal(staged, ref.pack_segments(sources, sizes))
    masks = torch.tensor([[True, False, True, True], [False] * 4,
                          [True] * 4], device=cuda)
    for m in (None, masks):
        got = [torch.full((4, n), -1.0, dtype=dtype, device=cuda) for n in (5, 3, 2)]
        want = [t.clone() for t in got]
        hk.unpack_segments(staged, got, [0, 5, 20], m)
        ref.unpack_segments(staged, want, [0, 5, 20], m)
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
    assert ssd.ssd_scan.launches == before + cfg.n_layers
    assert stats["decode_dispatches"] == (1 if resident else 5)
    eng = ServeEngine(cfg, slots=4, prompt_len=40, max_new=6)
    assert eng.device.type == "cuda"
