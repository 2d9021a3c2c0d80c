"""The port's masked multi-queue loop against the JAX package's, on the
CPU (``device="cpu"``: the eager ``_run_schedule_while`` and the plain
schedule step).

Composed programs of different counts, with per-program predicates, or
with ``reduce_fns`` run each to its own count or tolerance in one
dispatch.  The same seeded inputs go through ``repro`` and
``repro_torch``, ported from ``tests/test_schedule.py`` (mixed counts,
per-program predicates, reduce traces), ``tests/test_links.py`` (the
linked freeze, both regimes) and ``tests/test_coalesce.py`` (diverging
counts, coalescing on and off).  Bounds:

* ``n_done`` equal exactly;
* with ``interior_compute=False`` fields and traces bit for bit (the
  traces then use an order-free reduction, the max of ``|u|``);
* with the stencil, fields within ``rtol=atol=1e-5`` (the repo's
  engine-vs-engine bound: XLA:CPU reassociates the stencil's sum) and
  residual traces within ``rtol=1e-5`` (the packages add the squares in
  another order);
* inside the port, an unlinked part equals its own
  ``run_faces_until_converged`` / ``run_faces_persistent`` bit for bit,
  and double buffering changes no bit.

The (2,2,1) grid needs four JAX devices, so its reference runs in a
subprocess with four host devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.parallel import make_mesh as jax_make_mesh
from repro_torch import make_mesh
from repro_torch.core import (
    FacesConfig,
    PersistentEngine,
    build_faces_pipeline,
    build_faces_program,
    compose,
    part_configs,
    part_names,
    run_faces_persistent,
    run_faces_pipelined,
    run_faces_until_converged,
    split_parts,
    to_numpy,
)
from repro_torch.core.halo import AXES3
from repro_torch.kernels import graph_loop

_FIELDS = ("grid", "points", "dtype", "granularity", "batched", "periodic",
           "interior_compute", "damping")
BOUND = dict(rtol=1e-5, atol=1e-5)


def _u0(cfg, seed=0):
    return np.random.RandomState(seed).randn(*cfg.grid, *cfg.points).astype(np.float32)


def _jcfg(cfg):
    return jcore.FacesConfig(**{f: getattr(cfg, f) for f in _FIELDS})


def _mesh(grid=(1, 1, 1)):
    return make_mesh(grid, AXES3, device="cpu")


def _jmesh(grid=(1, 1, 1)):
    return jax_make_mesh(grid, AXES3)


def _sq(pkg, buf):
    """Sum of squares of ``buf`` (the reference's test reduction)."""
    if pkg == "jax":
        return lambda mem: jax.lax.psum(jnp.sum(mem[buf].astype(jnp.float32) ** 2), AXES3)
    return lambda mem: torch.sum(mem[buf].float() ** 2)


def _max_abs(pkg, buf):
    """The max of ``|buf|``: the same bits in any order of reduction."""
    if pkg == "jax":
        return lambda mem: jax.lax.pmax(jnp.max(jnp.abs(mem[buf])), AXES3)
    return lambda mem: mem[buf].abs().max()


def _composed(pkg, cfg, specs, reduce=None, **engine_kw):
    """Both packages' engine of ``compose`` over Faces programs named by
    ``specs`` ``{name: (count, tol or None)}``; with ``reduce`` (``_sq``
    or ``_max_abs``) every program gets ``reduce_fns[name]`` on its
    field, and a tolerance means ``until=lambda r: r >= tol``."""
    core, mesh = (jcore, _jmesh(cfg.grid)) if pkg == "jax" else (None, _mesh(cfg.grid))
    build = jcore.build_faces_program if pkg == "jax" else build_faces_program
    fcfg = _jcfg(cfg) if pkg == "jax" else cfg
    progs = []
    for name, (count, tol) in specs.items():
        until = None if tol is None else (lambda r, t=tol: r >= t)
        progs.append(build(fcfg, mesh, name=name).persistent(count, until=until))
    sched = (jcore.compose if pkg == "jax" else compose)(*progs)
    reduce_fns = None if reduce is None else {n: reduce(pkg, f"{n}/u") for n in specs}
    eng_cls = jcore.PersistentEngine if pkg == "jax" else PersistentEngine
    return eng_cls(sched, reduce_fns=reduce_fns, **engine_kw)


def _call(eng, init):
    mem, reds, n_done = eng(eng.init_buffers(init))
    if isinstance(eng, PersistentEngine):
        return (to_numpy(mem), {k: v.numpy() for k, v in reds.items()},
                {k: int(v) for k, v in n_done.items()})
    return ({k: np.asarray(v) for k, v in mem.items()},
            {k: np.asarray(v) for k, v in reds.items()}, {k: int(v) for k, v in n_done.items()})


def _check_vs_jax(got, want, exact: bool):
    """``(mem, reds, n_done)`` of the port against JAX's."""
    mem, reds, n_done = got
    jmem, jreds, jn = want
    assert n_done == jn
    assert set(reds) == set(jreds) and set(mem) == set(jmem)
    for name in jreds:
        assert reds[name].shape == jreds[name].shape
        if exact:
            np.testing.assert_array_equal(reds[name], jreds[name], err_msg=name)
        else:
            np.testing.assert_allclose(reds[name], jreds[name], rtol=1e-5, err_msg=name)
    for name in jmem:
        if exact:
            np.testing.assert_array_equal(mem[name], jmem[name], err_msg=name)
        else:
            np.testing.assert_allclose(mem[name], jmem[name], **BOUND, err_msg=name)


# -- tests/test_schedule.py:275-292 ---------------------------------------------


@pytest.mark.parametrize("interior", [True, False], ids=["stencil", "no_stencil"])
def test_mixed_iteration_counts_match_jax(interior):
    """Counts 2 and 5: each program freezes at its own count, equal to its
    own run in the port (bit for bit) and to JAX's masked loop."""
    cfg = FacesConfig(grid=(1, 1, 1), points=(4, 4, 4), periodic=True,
                      interior_compute=interior)
    ua, ub = _u0(cfg, seed=3), _u0(cfg, seed=4)
    init = {"facesA/u": ua, "facesB/u": ub}
    specs = {"facesA": (2, None), "facesB": (5, None)}
    eng = _composed("torch", cfg, specs, mode="dataflow")
    got = _call(eng, init)
    assert got[1] == {} and got[2] == {"facesA": 2, "facesB": 5}
    assert eng.stats.dispatches == 1
    _check_vs_jax(got, _call(_composed("jax", cfg, specs, mode="dataflow"), init),
                  exact=not interior)
    for nm, u, n in (("facesA", ua, 2), ("facesB", ub, 5)):
        ind, _ = run_faces_persistent(cfg, _mesh(), u, n_iters=n)
        for buf, t in to_numpy(ind).items():
            np.testing.assert_array_equal(got[0][f"{nm}/{buf}"], t, err_msg=f"{nm}/{buf}")


# -- tests/test_schedule.py:295-323 ---------------------------------------------


@pytest.mark.parametrize("double_buffer", [True, False])
def test_per_program_predicates_match_jax(double_buffer):
    """Unlinked halves, each to its own tolerance in one dispatch: equal to
    JAX's ``run_faces_pipelined(tols=)`` and, bit for bit, to each half's
    own ``run_faces_until_converged``."""
    cfg = FacesConfig(grid=(1, 1, 1), points=(6, 3, 4), periodic=True, damping=0.12)
    u0, tols = _u0(cfg, seed=5), (1e-1, 1e-3)
    mem, reds, n_done, stats = run_faces_pipelined(
        cfg, _mesh(), u0, tols=tols, max_iters=50, double_buffer=double_buffer,
        exchange=False)
    assert (stats.dispatches, stats.sync_points) == (1, 0)
    assert n_done["facesA"] < n_done["facesB"] < 50
    jmem, jreds, jn, jstats = jcore.run_faces_pipelined(
        _jcfg(cfg), _jmesh(), u0, tols=tols, max_iters=50, double_buffer=double_buffer,
        exchange=False)
    assert jstats.dispatches == 1
    _check_vs_jax((to_numpy(mem), {k: v.numpy() for k, v in reds.items()}, n_done),
                  ({k: np.asarray(v) for k, v in jmem.items()}, jreds, jn), exact=False)
    for nm, pcfg, part, tol in zip(part_names(2), part_configs(cfg, 2), split_parts(u0, 2),
                                   tols):
        ind, res, n, _ = run_faces_until_converged(pcfg, _mesh(), part, tol=tol,
                                                   max_iters=50,
                                                   double_buffer=double_buffer)
        assert n == n_done[nm]
        assert torch.equal(reds[nm], res), nm
        for buf, t in ind.items():
            assert torch.equal(mem[f"{nm}/{buf}"], t), f"{nm}/{buf}"


# -- tests/test_schedule.py:390-420 ---------------------------------------------


def test_reduce_traces_without_predicates_match_jax():
    """``reduce_fns`` alone: every program's trace is recorded, equal to
    the plain engine's ``reduce_fn`` trace bit for bit, and the fields
    equal the fixed-count composed run's bit for bit."""
    cfg = FacesConfig(grid=(1, 1, 1), points=(3, 3, 3), periodic=True)
    ua, ub = _u0(cfg, seed=9), _u0(cfg, seed=10)
    init = {"facesA/u": ua, "facesB/u": ub}
    specs = {"facesA": (3, None), "facesB": (3, None)}
    eng = _composed("torch", cfg, specs, reduce=_sq, mode="dataflow")
    got = _call(eng, init)
    assert got[2] == {"facesA": 3, "facesB": 3}
    assert {k: v.shape for k, v in got[1].items()} == {"facesA": (3,), "facesB": (3,)}
    _check_vs_jax(got, _call(_composed("jax", cfg, specs, reduce=_sq, mode="dataflow"),
                             init), exact=False)
    ref = PersistentEngine(build_faces_program(cfg, _mesh()).persistent(3),
                           mode="dataflow", reduce_fn=_sq("torch", "u"))
    _, ref_red = ref(ref.init_buffers({"u": ua}))
    np.testing.assert_array_equal(got[1]["facesA"], ref_red.numpy())
    fixed = _composed("torch", cfg, specs, mode="dataflow")
    assert not fixed._masked
    for name, t in to_numpy(fixed(fixed.init_buffers(init))).items():
        np.testing.assert_array_equal(got[0][name], t, err_msg=name)


@pytest.mark.parametrize("double_buffer", [True, False])
def test_predicates_bitwise_vs_jax_without_stencil(double_buffer):
    """Without the stencil the work is copies and single adds, and the
    max of ``|u|`` reduces in any order to the same bits: the fields,
    slots and traces equal JAX's bit for bit, with counts set by the
    predicates (two of the three programs stop early) and by a bound."""
    cfg = FacesConfig(grid=(1, 1, 1), points=(4, 3, 5), periodic=False,
                      interior_compute=False, damping=0.3)
    init = {f"p{k}/u": _u0(cfg, seed=20 + k) for k in range(3)}
    specs = {"p0": (12, 0.5), "p1": (12, 0.05), "p2": (7, None)}
    got = _call(_composed("torch", cfg, specs, reduce=_max_abs,
                          double_buffer=double_buffer), init)
    assert 1 < got[2]["p0"] < got[2]["p1"] < 12 and got[2]["p2"] == 7
    want = _call(_composed("jax", cfg, specs, reduce=_max_abs,
                           double_buffer=double_buffer), init)
    _check_vs_jax(got, want, exact=True)


# -- tests/test_links.py:363-395 -----------------------------------------------


@pytest.mark.parametrize("tols", [(1e-1, 1e-1), (1e-1, 1e-3)], ids=["equal", "unequal"])
def test_linked_tolerances_freeze_parts_as_jax(tols):
    """Linked halves with per-part tolerances.  Equal tolerances: both
    converge.  A much tighter one: the loose part freezes, its frozen
    boundary keeps injecting energy into the tight part, whose residual
    plateaus above its tolerance, so it runs to ``max_iters``.  A pass
    that skipped the frozen part would leave the tight part's ghost
    slots stale and not plateau there.  The port equals JAX's masked
    loop."""
    cfg = FacesConfig(grid=(1, 1, 1), points=(6, 3, 4), periodic=True, damping=0.12)
    u0 = _u0(cfg, seed=14)
    mem, reds, n_done, stats = run_faces_pipelined(cfg, _mesh(), u0, tols=tols,
                                                   max_iters=50)
    assert (stats.dispatches, stats.sync_points) == (1, 0)
    reds = {k: v.numpy() for k, v in reds.items()}
    if tols[0] == tols[1]:
        for nm in part_names(2):
            assert 1 <= n_done[nm] < 50
            assert reds[nm][-1] < 1e-1 <= reds[nm][:-1].min()
    else:
        assert n_done["facesA"] < 50 and reds["facesA"][-1] < 1e-1
        assert n_done["facesB"] == 50 and reds["facesB"][-1] >= 1e-3
        np.testing.assert_allclose(reds["facesB"][-1], reds["facesB"][-5], rtol=1e-3)
    jmem, jreds, jn, _ = jcore.run_faces_pipelined(_jcfg(cfg), _jmesh(), u0, tols=tols,
                                                   max_iters=50)
    _check_vs_jax((to_numpy(mem), reds, n_done),
                  ({k: np.asarray(v) for k, v in jmem.items()}, jreds, jn), exact=False)


@pytest.mark.parametrize("mode", ["stream", "dataflow"])
def test_linked_parts_double_buffer_changes_no_bit(mode):
    """Three linked parts stopping at three counts: double-buffered and
    single-buffered runs agree on every buffer, slots included (each
    slot holds its program's last realized write)."""
    cfg = FacesConfig(grid=(1, 1, 1), points=(9, 3, 4), periodic=True, damping=0.12)
    u0 = _u0(cfg, seed=15)
    runs = [run_faces_pipelined(cfg, _mesh(), u0, tols=(0.1, 0.01, 0.045), max_iters=12,
                                n_parts=3, mode=mode, double_buffer=db)
            for db in (True, False)]
    (mem, reds, n_done, _), (mem1, reds1, n_done1, _) = runs
    assert n_done == n_done1 and len(set(n_done.values())) == 3
    for nm in reds:
        assert torch.equal(reds[nm], reds1[nm]), nm
    for name, t in mem.items():
        assert torch.equal(mem1[name], t), name


def test_linked_grid_221_matches_jax(subproc, tmp_path):
    """A (2,2,1) rank grid, linked halves, per-part tolerances: the port
    against JAX's ``run_faces_pipelined`` on four host devices."""
    cfg = FacesConfig(grid=(2, 2, 1), points=(6, 3, 4), damping=0.12)
    u0, tols = _u0(cfg, seed=16), (5e-2, 1e-2)
    np.save(tmp_path / "u0.npy", u0)
    out = tmp_path / "jax.npz"
    r = subproc(f"""
import numpy as np
from repro.core import FacesConfig, run_faces_pipelined
from repro.parallel import make_mesh
cfg = FacesConfig(**{ {f: getattr(cfg, f) for f in _FIELDS}!r})
mem, reds, n_done, stats = run_faces_pipelined(
    cfg, make_mesh(cfg.grid, ("gx", "gy", "gz")), np.load({str(tmp_path / "u0.npy")!r}),
    tols={tols!r}, max_iters=30)
np.savez({str(out)!r}, dispatches=stats.dispatches,
         **{{"n_" + k: v for k, v in n_done.items()}},
         **{{"red_" + k: np.asarray(v) for k, v in reds.items()}},
         **{{"mem_" + k: np.asarray(v) for k, v in mem.items()}})
""", devices=cfg.n_ranks)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    got = np.load(out)
    pick = lambda pre: {k[len(pre):]: got[k] for k in got.files if k.startswith(pre)}
    want = (pick("mem_"), pick("red_"), {k: int(v) for k, v in pick("n_").items()})
    assert int(got["dispatches"]) == 1
    mem, reds, n_done, stats = run_faces_pipelined(cfg, _mesh(cfg.grid), u0, tols=tols,
                                                   max_iters=30)
    assert stats.dispatches == 1 and n_done["facesA"] != n_done["facesB"]
    _check_vs_jax((to_numpy(mem), {k: v.numpy() for k, v in reds.items()}, n_done), want,
                  exact=False)


# -- tests/test_coalesce.py:202-232 ---------------------------------------------


@pytest.mark.parametrize("coalesce", [True, False])
def test_diverging_counts_coalesced_and_not(coalesce):
    """Counts 2 and 3: the masked loop gives the same bits with coalesced
    and per-channel transfers, and JAX's results."""
    cfg = FacesConfig(grid=(1, 1, 1), points=(4, 4, 4), periodic=True)
    init = {"qa/u": _u0(cfg), "qb/u": _u0(cfg, seed=1)}
    specs = {"qa": (2, None), "qb": (3, None)}
    got = _call(_composed("torch", cfg, specs, mode="dataflow", coalesce=coalesce), init)
    assert got[2] == {"qa": 2, "qb": 3}
    other = _call(_composed("torch", cfg, specs, mode="dataflow", coalesce=not coalesce),
                  init)
    assert other[2] == got[2]
    for name, t in got[0].items():
        np.testing.assert_array_equal(other[0][name], t, err_msg=name)
    _check_vs_jax(got, _call(_composed("jax", cfg, specs, mode="dataflow",
                                       coalesce=coalesce), init), exact=False)


# -- the schedule step's plain version -------------------------------------------


def test_schedule_step_plain_on_known_traces():
    """Three programs over decreasing traces: one stops by its predicate,
    one by its count, one without a predicate runs its count; frozen
    programs record nothing more, and the loop ends with the last."""
    traces = torch.stack([torch.linspace(1.0, 0.0, 16)] * 3)
    reductions, n_done = graph_loop.trace_schedule_plain(traces, (0.6, None, 0.1),
                                                         (16, 4, 9), 16)
    assert n_done.tolist() == [7, 4, 9]
    for k, n in enumerate(n_done.tolist()):
        assert torch.equal(reductions[k, :n], traces[k, :n])
        assert not reductions[k, n:].any()
    reductions, n_done = graph_loop.trace_schedule_plain(traces[:1], (2.0,), (5,), 5)
    assert n_done.tolist() == [1] and reductions[0, 0] == 1.0


def test_schedule_loop_refuses_what_it_does_not_take():
    """Checked before anything is built, so on any device."""
    red = torch.zeros(33)
    with pytest.raises(ValueError, match="1 to 32 programs"):
        graph_loop.ScheduleLoop(None, None, [None] * 33, red, red.bool(), red.int(),
                                red.int(), torch.zeros(33, 4), [1] * 33, [True] * 33,
                                [False] * 33, 4)
    red = torch.zeros(2)
    with pytest.raises(ValueError, match="max_iters"):
        graph_loop.ScheduleLoop(None, None, [None] * 2, red, red.bool(), red.int(),
                                red.int(), torch.zeros(2, 4), [1, 5], [True] * 2,
                                [False] * 2, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        graph_loop.ScheduleLoop(None, None, [None] * 2, red, red.bool(), red.int(),
                                red.int(), torch.zeros(2, 4), [1, 4], [True] * 2,
                                [False] * 2, 4)
