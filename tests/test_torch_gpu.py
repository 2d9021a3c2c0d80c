"""Tests that need the card (marker ``gpu``; they skip without CUDA).

Each hand-written CUDA kernel is held against its plain PyTorch version
on the same device inputs, bit for bit, and the engines' CUDA graphs are
held against the CPU run of the same program.  This file imports no
JAX, so it runs on a GPU machine without it::

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
from repro_torch.core.halo import AXES3
from repro_torch.kernels import halo_pack as hk
from repro_torch.kernels import ref

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
