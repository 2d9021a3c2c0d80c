"""The port's engines against the JAX engines, the NumPy oracle and
each other, on the CPU (``device="cpu"``: the plain kernel versions).

Tolerances, and why:

* bitwise against the JAX engines when the interior stencil is off —
  the work is copies and single adds, so both packages round alike;
* ``rtol=atol=1e-5`` against the JAX engines with the stencil on, over
  at most 4 iterations (the repo's engine-vs-engine bound,
  tests/test_persistent.py): XLA:CPU reassociates the stencil's sum,
  which moves results by up to ~2.4e-7 per iteration;
* ``rtol=atol=1e-4`` against ``faces_oracle`` (tests/test_persistent.py),
  whose stencil sums in another order;
* bitwise between the port's own engines and pack modes, and between
  the host engine and the one-buffer path (``faces_step_contiguous``):
  the same ops in the same order per buffer.
"""

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.halo as jhalo
from repro.parallel import make_mesh as jax_make_mesh
from repro_torch import make_mesh
from repro_torch.core import (
    FacesConfig,
    FusedEngine,
    HostEngine,
    PersistentEngine,
    build_faces_program,
    faces_oracle,
    faces_step_contiguous,
    from_reference,
    run_faces_persistent,
    slot_buffers,
    to_numpy,
)
from repro_torch.core.halo import AXES3


def _u0(cfg, seed=0):
    return np.random.RandomState(seed).randn(*cfg.grid, *cfg.points).astype(np.float32)


def _port_prog(cfg, **kw):
    return build_faces_program(cfg, make_mesh(cfg.grid, AXES3, device="cpu"), **kw)


def _jax_prog(cfg):
    jcfg = jhalo.FacesConfig(**{f: getattr(cfg, f) for f in (
        "grid", "points", "dtype", "granularity", "batched", "periodic",
        "interior_compute", "damping")})
    return jhalo.build_faces_program(jcfg, jax_make_mesh((1, 1, 1), AXES3))


def _run(engine, u0, n):
    mem = engine.init_buffers({"u": u0})
    for _ in range(n):
        mem = engine(mem)
    return mem


def _port_u(mem):
    return to_numpy(mem)["u"]


# -- against the JAX engines, (1,1,1)-periodic, in process --------------------


@pytest.mark.parametrize("granularity,batched,damping", [
    ("direct26", True, 0.0),
    ("direct26", False, 0.5),
    ("staged3", True, 0.0),
])
def test_fused_bitwise_vs_jax_without_stencil(granularity, batched, damping):
    cfg = FacesConfig(grid=(1, 1, 1), points=(4, 3, 5), periodic=True,
                      granularity=granularity, batched=batched,
                      interior_compute=False, damping=damping)
    u0 = _u0(cfg, seed=1)
    want = _run(jcore.FusedEngine(_jax_prog(cfg)), u0, 2)
    got = _run(FusedEngine(_port_prog(cfg)), u0, 2)
    for name in want:
        np.testing.assert_array_equal(to_numpy(got)[name],
                                      np.asarray(want[name]), err_msg=name)


def test_host_and_persistent_bitwise_vs_jax_without_stencil():
    cfg = FacesConfig(grid=(1, 1, 1), points=(3, 4, 2), periodic=True,
                      interior_compute=False)
    u0 = _u0(cfg, seed=2)
    jprog = _jax_prog(cfg)
    want_host = _run(jcore.HostEngine(jprog), u0, 1)
    np.testing.assert_array_equal(_port_u(_run(HostEngine(_port_prog(cfg)), u0, 1)),
                                  np.asarray(want_host["u"]))
    want = _run(jcore.PersistentEngine(jprog.persistent(3)), u0, 1)
    got = _run(PersistentEngine(_port_prog(cfg).persistent(3)), u0, 1)
    np.testing.assert_array_equal(_port_u(got), np.asarray(want["u"]))


@pytest.mark.parametrize("mode", ["stream", "dataflow"])
def test_engines_vs_jax_with_stencil(mode):
    n = 4
    cfg = FacesConfig(grid=(1, 1, 1), points=(4, 3, 5), periodic=True)
    u0 = _u0(cfg, seed=3)
    jprog = _jax_prog(cfg).persistent(n)
    want = _run(jcore.PersistentEngine(jprog, mode=mode), u0, 1)["u"]
    prog = _port_prog(cfg).persistent(n)
    for eng, calls in ((PersistentEngine(prog, mode=mode), 1),
                       (FusedEngine(prog, mode=mode), n)):
        np.testing.assert_allclose(_port_u(_run(eng, u0, calls)),
                                   np.asarray(want), rtol=1e-5, atol=1e-5)


def test_state_from_reference_engine_buffers():
    cfg = FacesConfig(grid=(1, 1, 1), points=(3, 3, 3), periodic=True)
    u0 = _u0(cfg, seed=4)
    jeng = jcore.FusedEngine(_jax_prog(cfg))
    jmem = {k: np.asarray(v) for k, v in jeng.init_buffers({"u": u0}).items()}
    prog = _port_prog(cfg)
    mem = from_reference(jmem, prog)
    assert set(mem) == set(prog.buffers)
    for name, arr in jmem.items():
        assert mem[name].dtype == torch.float32
        np.testing.assert_array_equal(mem[name].numpy(), arr)
    np.testing.assert_array_equal(to_numpy(mem)["u"], u0)
    # one step from the carried state equals one JAX step
    want = jeng(jeng.init_buffers({"u": u0}))["u"]
    got = FusedEngine(prog)(mem)["u"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(KeyError, match="lacks"):
        from_reference({"u": u0}, prog)


# -- eight ranks against the NumPy oracle ------------------------------------


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("grid", [(2, 2, 2), (8, 1, 1)])
def test_eight_ranks_vs_oracle(grid, periodic):
    n = 2
    cfg = FacesConfig(grid=grid, points=(4, 3, 5), periodic=periodic,
                      pack="kernel", damping=0.25)
    u0 = _u0(cfg, seed=5)
    want = u0
    for _ in range(n):
        want = faces_oracle(want, cfg)
    prog = _port_prog(cfg)
    for eng, calls in ((HostEngine(prog), n),
                       (FusedEngine(prog, mode="dataflow"), n),
                       (PersistentEngine(prog.persistent(n)), 1)):
        np.testing.assert_allclose(_port_u(_run(eng, u0, calls)), want,
                                   rtol=1e-4, atol=1e-4)


# -- the port's own engines ---------------------------------------------------


@pytest.mark.parametrize("granularity,batched,coalesce", [
    ("direct26", True, True), ("direct26", True, False),
    ("direct26", False, True), ("staged3", True, True),
])
def test_port_engines_bitwise(granularity, batched, coalesce):
    n = 3
    cfg = FacesConfig(grid=(2, 2, 2), points=(3, 4, 3), periodic=True,
                      granularity=granularity, batched=batched, damping=0.2)
    u0 = _u0(cfg, seed=6)
    prog = _port_prog(cfg, coalesce=coalesce)
    host = _port_u(_run(HostEngine(prog), u0, n))
    for eng, calls in ((FusedEngine(prog), n),
                       (FusedEngine(prog, mode="dataflow", coalesce=False), n),
                       (PersistentEngine(prog.persistent(n)), 1),
                       (PersistentEngine(prog.persistent(n), mode="dataflow"), 1)):
        np.testing.assert_array_equal(_port_u(_run(eng, u0, calls)), host)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_and_torch_pack_modes_bitwise(dtype):
    kw = dict(grid=(2, 2, 2), points=(4, 4, 3), periodic=True, dtype=dtype,
              damping=0.1)
    u0 = _u0(FacesConfig(**kw), seed=7)
    outs = [_port_u(_run(PersistentEngine(
                _port_prog(FacesConfig(pack=p, **kw)).persistent(3)), u0, 1))
            for p in ("kernel", "torch")]
    assert np.isfinite(outs[0]).all()
    np.testing.assert_array_equal(outs[0], outs[1])


def test_dispatch_counts():
    n = 4
    cfg = FacesConfig(grid=(2, 2, 2), points=(3, 3, 3))
    prog = _port_prog(cfg)
    assert prog.dispatch_count_host() == 79
    u0 = _u0(cfg)
    host, fused = HostEngine(prog), FusedEngine(prog)
    _run(host, u0, n)
    _run(fused, u0, n)
    pers = PersistentEngine(prog.persistent(n))
    _run(pers, u0, 1)
    assert host.stats.dispatches == 79 * n
    assert host.stats.sync_points == 80 * n  # every op + the wait
    assert (fused.stats.dispatches, pers.stats.dispatches) == (n, 1)
    batch = HostEngine(prog, sync="batch")
    _run(batch, u0, 1)
    assert (batch.stats.dispatches, batch.stats.sync_points) == (79, 2)


def test_donate_and_caller_buffers():
    cfg = FacesConfig(grid=(2, 1, 1), points=(3, 3, 3), periodic=True)
    prog = _port_prog(cfg)
    keep = FusedEngine(prog)
    mem = keep.init_buffers({"u": _u0(cfg)})
    before = {k: v.clone() for k, v in mem.items()}
    out = keep(mem)
    for k in mem:
        assert torch.equal(mem[k], before[k]), k  # caller's tensors untouched
    assert keep(mem)["u"] is not out["u"]
    donating = FusedEngine(prog, donate=True)
    m1 = donating(mem)
    m2 = donating(m1)  # chains on the engine's own tensors
    assert m2["u"] is m1["u"]
    np.testing.assert_array_equal(m2["u"].numpy(), _run(keep, _u0(cfg), 2)["u"].numpy())


def test_persistent_reductions_and_double_buffer():
    n = 3
    cfg = FacesConfig(grid=(2, 2, 1), points=(3, 3, 3), damping=0.2)
    prog = build_faces_program(cfg, make_mesh((2, 2, 1), AXES3, device="cpu")).persistent(n)
    assert slot_buffers(prog) == tuple(sorted(
        [f"in{i}" for i in range(26)] + [f"out{i}" for i in range(26)]))
    norm = lambda mem: mem["u"].float().square().sum()
    u0 = _u0(cfg, seed=8)
    (mem_a, red), stats = run_faces_persistent(cfg, make_mesh((2, 2, 1), AXES3, device="cpu"),
                                               u0, n, reduce_fn=norm)
    assert stats.dispatches == 1 and red.shape == (n,)
    single = PersistentEngine(prog, mode="dataflow", double_buffer=False)
    mem_b = _run(single, u0, 1)
    np.testing.assert_array_equal(_port_u(mem_a), _port_u(mem_b))
    ref = u0
    for i in range(n):
        ref = faces_oracle(ref, cfg)
        np.testing.assert_allclose(float(red[i]), float(np.square(ref).sum()),
                                   rtol=1e-4)
    with pytest.raises(ValueError, match="requires reduce_fn"):
        PersistentEngine(prog, cond_fn=lambda r: r > 0)


# -- a program with regions, add deposits and wrap-around ---------------------


@pytest.mark.parametrize("coalesce", [True, False])
def test_region_add_and_replace_channels(coalesce):
    """Send regions, add-mode deposits into a region, a periodic replace
    channel and a non-periodic one, against a NumPy model of ppermute."""
    from repro_torch.core import OffsetPeer, STQueue

    mesh = make_mesh((4, 1, 1), AXES3, device="cpu")
    q = STQueue(mesh, name="regions")
    shape = (4, 1, 1, 3, 2)
    for b in ("a", "b", "c", "d"):
        q.buffer(b, shape, "float32", pspec=AXES3)
    rows = lambda lo, hi: (slice(0, 1),) * 3 + (slice(lo, hi),)
    q.enqueue_recv("b", OffsetPeer("gx", -1), tag=0, region=rows(2, 3), mode="add")
    q.enqueue_recv("c", OffsetPeer("gx", 1, periodic=True), tag=1)
    q.enqueue_recv("d", OffsetPeer("gx", 1), tag=2)
    q.enqueue_send("a", OffsetPeer("gx", 1), tag=0, region=rows(0, 1))
    q.enqueue_send("a", OffsetPeer("gx", -1, periodic=True), tag=1)
    q.enqueue_send("a", OffsetPeer("gx", -1), tag=2)
    q.enqueue_start()
    q.enqueue_wait()
    prog = q.build(coalesce=coalesce)
    assert prog.is_coalesced == coalesce

    rng = np.random.RandomState(9)
    init = {k: rng.randn(*shape).astype(np.float32) for k in "abcd"}
    a, want = init["a"], {k: v.copy() for k, v in init.items()}
    want["b"][1:, :, :, 2:3] += a[:-1, :, :, 0:1]      # rank r from r-1
    want["c"] = np.roll(a, -1, axis=0)                  # rank r from r+1, wrapping
    want["d"][:-1] = a[1:]                              # rank 3 has no sender
    for eng in (HostEngine(prog), FusedEngine(prog, coalesce=coalesce),
                PersistentEngine(prog, mode="dataflow")):
        got = to_numpy(eng(eng.init_buffers(init)))
        for k in "abcd":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_engines_refuse_buffers_outside_the_rank_major_layout():
    """Outside the rank-major layout a buffer is held as the stack of its
    rank-local blocks: a replicated one runs on every engine, one copy a
    rank, and comes back as rank 0's copy; a buffer whose sharded dim
    does not divide by its mesh axes has no rank-local block and is
    refused."""
    from repro_torch.core import STQueue

    mesh = make_mesh((2, 1, 1), AXES3, device="cpu")
    q = STQueue(mesh)
    q.buffer("w", (3, 3), "float32")  # replicated: no rank axes
    q.enqueue_kernel(lambda w: w * 2.0, ["w"], ["w"])
    prog = q.build()
    w = np.arange(9, dtype=np.float32).reshape(3, 3)
    for eng in (HostEngine(prog), FusedEngine(prog), PersistentEngine(prog.persistent(2))):
        np.testing.assert_array_equal(to_numpy(eng(eng.init_buffers({"w": w})))["w"],
                                      w * (4.0 if isinstance(eng, PersistentEngine) else 2.0))
    assert FusedEngine(prog)._lowering.storage["w"] == (2, 3, 3)
    q = STQueue(mesh)
    q.buffer("v", (3, 3), "float32", pspec=("gx",))  # 3 rows over 2 ranks
    q.enqueue_kernel(lambda v: v, ["v"], ["v"])
    with pytest.raises(ValueError, match="does not divide"):
        FusedEngine(q.build())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("interior", [True, False], ids=["stencil", "no_stencil"])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("grid", [(2, 2, 2), (1, 1, 1), (8, 1, 1), (3, 2, 1), (4, 4, 1)])
def test_one_buffer_path_equals_the_host_engine(grid, periodic, interior, dtype):
    """The paper's one contiguous buffer a rank (``faces_step_contiguous``:
    ``pack_boundary``, a rank shift a segment, ONE ``unpack_boundary_add``
    in DIRECTIONS order) equals one ``direct26`` iteration of the host
    engine bit for bit, on the CPU's plain kernel versions."""
    cfg = FacesConfig(grid=grid, points=(4, 3, 5), periodic=periodic,
                      interior_compute=interior, damping=0.12, dtype=dtype)
    u0 = _u0(cfg, seed=sum(grid))
    host = HostEngine(_port_prog(cfg))
    mem = host.init_buffers({"u": u0})
    got = faces_step_contiguous(mem["u"].clone(), cfg)
    want = host(mem)["u"]
    assert got.dtype == want.dtype == getattr(torch, dtype)
    assert torch.equal(got, want)
