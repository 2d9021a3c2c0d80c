"""The port's cost model and tuner (``launch/costing.py``,
``launch/tune.py``, ``run_faces_pipelined(tune=True)``) against the JAX
package's, on the CPU.

* ``schedule_cost(...).row()`` equals the reference's field for field on
  every build of ``tests/test_costing.py`` (on (1,1,1) and on the 2×2×2
  grid, whose ghost-ring identity elisions and cross-rank transfers both
  occur), on the collective builders and ``enqueue_collective`` programs
  (``CollDesc`` pricing), and ``predict_ranking`` gives the reference's
  ranking;
* the orderings the tuner prunes on and the rename invariance of
  ``tests/test_costing.py`` hold in the port;
* the three cases of ``tests/test_effects.py::TestTuneCertification``
  hold with the port's engines;
* ``run_faces_pipelined(tune=True)`` equals the untuned run bit for bit,
  runs its winner in one dispatch, and prices every knob as the
  reference's cost model does.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.core as jcore
from repro.core import collectives as JC
from repro.launch import costing as jcosting
from repro.launch.tune import Knobs as JKnobs
from repro_torch import make_mesh
from repro_torch.core import (
    FacesConfig,
    PersistentEngine,
    STQueue,
    build_faces_part_program,
    build_faces_program,
    collectives as C,
    compose,
    half_config,
    part_names,
    run_faces_pipelined,
    split_halves,
)
from repro_torch.core.halo import AXES3
from repro_torch.launch.costing import (
    DEFAULT_PARAMS,
    ScheduleCost,
    predict_ranking,
    schedule_cost,
)
from repro_torch.launch.tune import Knobs, measure, tune

N = 5
_FIELDS = ("grid", "points", "dtype", "granularity", "batched", "periodic",
           "interior_compute", "damping")


def _mesh(grid=(1, 1, 1)):
    return make_mesh(grid, AXES3, device="cpu")


def _jmesh(grid=(1, 1, 1)):
    return AbstractMesh(grid, AXES3)


def _cfg(grid=(1, 1, 1)):
    return FacesConfig(grid=grid, points=(6, 4, 4))


def _jcfg(cfg):
    return jcore.FacesConfig(**{f: getattr(cfg, f) for f in _FIELDS})


def _prog(name=None, grid=(1, 1, 1), jax=False):
    if jax:
        return jcore.build_faces_program(_jcfg(_cfg(grid)), _jmesh(grid), name=name)
    return build_faces_program(_cfg(grid), _mesh(grid), name=name)


def _linked(n_parts, interleave=None, grid=(1, 1, 1), jax=False, names=None):
    names = names or part_names(n_parts)
    if jax:
        progs = [jcore.build_faces_part_program(_jcfg(_cfg(grid)), _jmesh(grid), k, n_parts,
                                                names=names).persistent(N)
                 for k in range(n_parts)]
        return jcore.compose(*progs, verify="off", interleave=interleave)
    progs = [build_faces_part_program(_cfg(grid), _mesh(grid), k, n_parts,
                                      names=names).persistent(N)
             for k in range(n_parts)]
    return compose(*progs, verify="off", interleave=interleave)


# every configuration tests/test_costing.py prices, as (build, schedule_cost kwargs)
COST_CASES = [
    ("host", lambda g, j: _prog(grid=g, jax=j), dict(engine="host", n_iters=N)),
    ("fused", lambda g, j: _prog(grid=g, jax=j), dict(engine="fused", n_iters=N)),
    ("persistent", lambda g, j: _prog(grid=g, jax=j).persistent(N), {}),
    ("uncoalesced", lambda g, j: _prog(grid=g, jax=j).persistent(N), dict(coalesce=False)),
    ("stream", lambda g, j: _prog(grid=g, jax=j).persistent(N), dict(mode="stream")),
    ("double_buffer", lambda g, j: _prog(grid=g, jax=j).persistent(N), dict(double_buffer=True)),
    ("single_buffer", lambda g, j: _prog(grid=g, jax=j).persistent(N), dict(double_buffer=False)),
    ("fused_slots", lambda g, j: _prog(grid=g, jax=j).persistent(N), dict(engine="fused")),
    ("pricier", lambda g, j: _prog(grid=g, jax=j).persistent(N), dict(params="x10")),
    ("linked2", lambda g, j: _linked(2, grid=g, jax=j), {}),
    ("linked4", lambda g, j: _linked(4, grid=g, jax=j), {}),
    ("linked4_seq", lambda g, j: _linked(4, "sequential", grid=g, jax=j), {}),
    ("linked4_host", lambda g, j: _linked(4, grid=g, jax=j), dict(engine="host")),
    ("linked4_stream", lambda g, j: _linked(4, grid=g, jax=j), dict(mode="stream",
                                                                   coalesce=False)),
]


def _kw(kw, params_cls):
    kw = dict(kw)
    if kw.get("params") == "x10":
        kw["params"] = dataclasses.replace(params_cls(), dispatch_us=10000.0)
    return kw


@pytest.mark.parametrize("grid", [(1, 1, 1), (2, 2, 2)])
@pytest.mark.parametrize("case", COST_CASES, ids=[c[0] for c in COST_CASES])
def test_rows_equal_reference(case, grid):
    _, build, kw = case
    got = schedule_cost(build(grid, False), **_kw(kw, type(DEFAULT_PARAMS))).row()
    want = jcosting.schedule_cost(build(grid, True),
                                  **_kw(kw, type(jcosting.DEFAULT_PARAMS))).row()
    assert got == want


def test_default_params_are_the_reference_constants():
    assert dataclasses.asdict(DEFAULT_PARAMS) == dataclasses.asdict(jcosting.DEFAULT_PARAMS)


@pytest.mark.parametrize("grid", [(1, 1, 1), (2, 2, 2)])
def test_predict_ranking_equals_reference(grid):
    pairs = lambda jax: [("full", _prog(grid=grid, jax=jax).persistent(N)),
                         ("linked4", _linked(4, grid=grid, jax=jax)),
                         ("linked2", _linked(2, grid=grid, jax=jax)),
                         ("seq4", _linked(4, "sequential", grid=grid, jax=jax))]
    assert predict_ranking(pairs(False)) == jcosting.predict_ranking(pairs(True))


def _collective_builds(n, P, mesh):
    m, k, f = 8 * n * n, 4 * n, 4 * n
    return [P.build_all_gather_matmul(mesh, "x", m, k, f).program,
            P.build_all_gather_matmul(mesh, "x", m, k, f, bidirectional=True).program,
            P.build_matmul_reduce_scatter(mesh, "x", m, k, f).program,
            P.build_all_to_all(mesh, "x", m, k).program,
            P.build_tp_block(mesh, "x", m, k, f, chain=True).program.persistent(N)]


def _coll_queue_program(mesh, queue_cls):
    q = queue_cls(mesh, "colls")
    q.buffer("a", (32, 3), np.float32, pspec=("x",))
    q.buffer("g", (128, 3), np.float32, pspec=("x",))
    q.buffer("s", (8, 3), np.float32, pspec=("x",))
    q.buffer("r", (8, 3), np.float32, pspec=())
    q.buffer("z", (8, 3), np.float32, pspec=("x",))
    q.enqueue_kernel(lambda a: a, ["a"], ["a"], name="k0")
    q.enqueue_collective("all_gather", "a", "g", "x", dim=0)
    q.enqueue_collective("reduce_scatter", "a", "s", "x", dim=0)
    q.enqueue_start()
    q.enqueue_kernel(lambda z: z, ["z"], ["z"], name="k1")  # in the window
    q.enqueue_wait()
    q.enqueue_collective("all_reduce", "s", "r", "x")
    q.enqueue_start()
    q.enqueue_wait()
    return q.build(verify="error")


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("kw", [{}, dict(engine="fused", n_iters=3), dict(engine="host", n_iters=2),
                                dict(mode="stream", coalesce=False)],
                         ids=["persistent", "fused", "host", "stream"])
def test_collective_programs_price_as_reference(n, kw):
    """``CollDesc`` pricing (a whole buffer a collective) and the ring
    programs of the collective builders."""
    mesh, jmesh = make_mesh((n,), ("x",), device="cpu"), AbstractMesh((n,), ("x",))
    progs = _collective_builds(n, C, mesh) + [_coll_queue_program(mesh, STQueue)]
    jprogs = _collective_builds(n, JC, jmesh) + [_coll_queue_program(jmesh, jcore.STQueue)]
    for p, jp in zip(progs, jprogs):
        got, want = schedule_cost(p, **kw).row(), jcosting.schedule_cost(jp, **kw).row()
        assert got == want, p.name
    if n > 1:
        assert schedule_cost(progs[-1], **kw).n_collectives == 3


# -- orderings and invariants of tests/test_costing.py, in the port ------------


def test_orderings_hold_in_the_port():
    prog = _prog()
    host = schedule_cost(prog, engine="host", n_iters=N).total_us
    fused = schedule_cost(prog, engine="fused", n_iters=N).total_us
    pers = schedule_cost(prog.persistent(N), engine="persistent").total_us
    assert pers < fused < host
    pprog = prog.persistent(N)
    assert schedule_cost(pprog, coalesce=True).total_us < \
        schedule_cost(pprog, coalesce=False).total_us
    assert schedule_cost(pprog).total_us < schedule_cost(_linked(4)).total_us
    rr, seq = schedule_cost(_linked(4)), schedule_cost(_linked(4, "sequential"))
    assert seq.switch_us < rr.switch_us and seq.total_us < rr.total_us
    assert [n for n, _ in predict_ranking([("full", pprog), ("linked4", _linked(4))])] \
        == ["full", "linked4"]
    db, single = schedule_cost(pprog, double_buffer=True), schedule_cost(pprog, double_buffer=False)
    assert db.slot_bytes == 2 * single.slot_bytes and db.slot_us > single.slot_us
    assert schedule_cost(pprog, engine="fused").slot_bytes == 0
    full = schedule_cost(_prog(grid=(2, 2, 2)).persistent(N))
    linked = schedule_cost(_linked(4, grid=(2, 2, 2)))
    assert linked.n_elided > 0 and linked.n_collectives > full.n_collectives > 0


def _random_names(seed, n):
    rng = np.random.RandomState(seed)
    alphabet = "abcdefghij_"
    out = []
    while len(out) < n:
        nm = "".join(alphabet[i] for i in rng.randint(0, len(alphabet), rng.randint(1, 13)))
        if nm not in out:
            out.append(nm)
    return out


@pytest.mark.parametrize("name", ["alpha", "omega"] + _random_names(0, 6))
def test_rename_invariance(name):
    assert schedule_cost(_prog(name=name).persistent(N)).row() == \
        schedule_cost(_prog().persistent(N)).row()


@pytest.mark.parametrize("seed", range(4))
def test_rename_invariance_composed(seed):
    a = schedule_cost(_linked(2, names=tuple(_random_names(seed, 2))))
    assert a.row() == schedule_cost(_linked(2)).row()


def test_accounting_and_errors():
    cost = schedule_cost(_prog().persistent(N))
    parts = (cost.dispatch_us + cost.collective_us + cost.bytes_us + cost.kernel_us
             + cost.staging_us + cost.slot_us + cost.exposed_us + cost.switch_us)
    assert cost.total_us == pytest.approx(parts)
    assert cost.row()["total_us"] == pytest.approx(cost.total_us)
    json.dumps(cost.row())
    assert isinstance(schedule_cost(_prog()), ScheduleCost)
    prog = _prog()
    assert schedule_cost(prog, engine="host", n_iters=N).n_dispatches == \
        prog.dispatch_count_host() * N
    with pytest.raises(ValueError, match="engine"):
        schedule_cost(prog, engine="nic")
    with pytest.raises(ValueError, match="mode"):
        schedule_cost(prog, mode="chaotic")


# -- the tuner -------------------------------------------------------------------


GRID, POINTS, INNER = (1, 1, 1), (6, 6, 6), 2


def _halves_sched(interleave=None):
    cfg = half_config(FacesConfig(grid=GRID, points=POINTS))
    progs = [build_faces_program(cfg, _mesh(), name=nm).persistent(INNER)
             for nm in ("facesA", "facesB")]
    return compose(*progs, verify="off", interleave=interleave)


def _halves_inputs():
    rng = np.random.RandomState(0)
    return split_halves(rng.randn(*GRID, *POINTS).astype(np.float32))


class TestTuneCertification:
    """``tests/test_effects.py::TestTuneCertification`` with the port's
    engines."""

    def _build(self, knobs):
        ua, ub = _halves_inputs()
        eng = PersistentEngine(_halves_sched(interleave=knobs.interleave_policy()),
                               mode=knobs.mode, donate=True)
        return eng, (lambda: eng.init_buffers({"facesA/u": ua, "facesB/u": ub}))

    SPACE = {"interleave": ["round_robin", "sequential"]}

    def test_certified_candidates_skip_check(self):
        calls = []
        res = tune(self._build, self.SPACE, inner=1, repeats=1, measure_top=1,
                   certify=True, check=calls.append)
        assert calls == []  # the proof replaced the allclose
        for c in res.candidates:
            assert c.certificate is not None and c.certificate.equivalent
            assert c.error is None

    def test_certification_does_not_change_measured_pool(self):
        r1 = tune(self._build, self.SPACE, inner=1, repeats=1, measure_top=2, certify=True)
        r0 = tune(self._build, self.SPACE, inner=1, repeats=1, measure_top=2)
        assert sorted(c.knobs.label() for c in r1.measured) == \
            sorted(c.knobs.label() for c in r0.measured)

    def test_uncertified_candidates_fall_back_to_check(self):
        def reject(cand):
            raise AssertionError("numerics rejected")

        with pytest.raises(ValueError, match="no measured candidate"):
            tune(self._build, self.SPACE, inner=1, repeats=1, measure_top=1, check=reject)
        res = tune(self._build, self.SPACE, inner=1, repeats=1, measure_top=1,
                   certify=True, check=reject)
        assert res.best.certificate.equivalent


def test_knobs_and_space_as_reference():
    for kn, jkn in ((Knobs(), JKnobs()), (Knobs(interleave=2, mode="stream"),
                                          JKnobs(interleave=2, mode="stream"))):
        assert kn.asdict() == jkn.asdict() and kn.label() == jkn.label()
        assert kn.engine_kwargs() == jkn.engine_kwargs()
        assert dataclasses.astuple(kn.interleave_policy()) == \
            dataclasses.astuple(jkn.interleave_policy())
    from repro_torch.launch.tune import _expand_space
    assert len(_expand_space({"mode": ["stream", "dataflow"], "coalesce": [True, False]},
                             Knobs())) == 4
    with pytest.raises(ValueError, match="unknown knob"):
        _expand_space({"nic": [1]}, Knobs())
    with pytest.raises(ValueError, match="no viable"):
        tune(lambda k: (_ for _ in ()).throw(RuntimeError("nope")), {"mode": ["stream"]})


def test_measure_row_shape():
    ua, ub = _halves_inputs()
    eng = PersistentEngine(_halves_sched(), donate=True)
    row = measure(eng, lambda: eng.init_buffers({"facesA/u": ua, "facesB/u": ub}),
                  inner=2, repeats=3)
    assert set(row) == {"avg_s", "min_s", "max_s", "med_s"}
    assert 0 < row["min_s"] <= row["med_s"] <= row["max_s"]
    assert eng.stats.dispatches == 1 + 2 * 3


@pytest.mark.parametrize("n_parts,periodic", [(2, True), (4, False)])
def test_tuned_pipeline_equals_untuned_and_prices_as_reference(n_parts, periodic):
    cfg = FacesConfig(grid=(1, 1, 1), points=(8, 4, 4), periodic=periodic)
    u0 = np.random.RandomState(n_parts).randn(1, 1, 1, *cfg.points).astype(np.float32)
    mem, stats, tuned = run_faces_pipelined(cfg, _mesh(), u0, n_iters=3, n_parts=n_parts,
                                            tune=True, tune_repeats=1)
    plain, _ = run_faces_pipelined(cfg, _mesh(), u0, n_iters=3, n_parts=n_parts)
    assert stats.dispatches == 1
    assert set(mem) == set(plain)
    for k in plain:
        assert torch.equal(mem[k], plain[k]), k
    assert len(tuned.candidates) == 6 and len(tuned.measured) == 3
    assert tuned.best.stats is not None and tuned.best.error is None
    # the reference's cost model on the reference's composition, knob for knob
    names = part_names(n_parts)
    jprogs = [jcore.build_faces_part_program(_jcfg(cfg), _jmesh(), k, n_parts,
                                             names=names).persistent(3)
              for k in range(n_parts)]
    links = sorted({(names[0], names[-1]), (names[-1], names[0])}
                   | {(names[k], names[(k + 1) % n_parts]) for k in range(n_parts)}
                   | {(names[(k + 1) % n_parts], names[k]) for k in range(n_parts)})
    for cand in tuned.candidates:
        kn = cand.knobs
        jk = JKnobs(**dataclasses.asdict(kn))
        jsched = jcore.compose(*jprogs, links=links, interleave=jk.interleave_policy())
        want = jcosting.schedule_cost(jsched, engine="persistent", mode=kn.mode,
                                      coalesce=kn.coalesce,
                                      double_buffer=kn.double_buffer).total_us
        assert cand.predicted_us == want, kn.label()
