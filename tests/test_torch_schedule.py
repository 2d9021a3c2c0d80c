"""The port's composition (``compose``, cross-program links, the linked
N-part Faces pipeline) against the JAX package's, on the CPU.

* structure and every error of ``tests/test_schedule.py`` and
  ``tests/test_links.py``: namespacing, interleave policies, FIFO order
  per program, segments, ``ScheduleError`` and link errors;
* the build layer: ``program_digest``, ``collective_counts()`` and the
  re-coalesced plans of composed batches equal the reference's (the
  tiny linked pair; 2-, 3- and 4-part linked Faces), and
  ``certify_equivalence`` gives the reference's verdicts across
  interleave policies;
* transfer counts: for seeded random channel sets drawn as
  ``tests/test_coalesce.py``'s property test draws them (the known
  flake's lone periodic diagonal among them), the port's coalescing
  plans equal the reference's, transfer for transfer;
* numbers: the linked pipeline equals the port's full-domain run bit for
  bit in ``stream`` and ``dataflow``, coalesced and not, at the four
  ``(n_parts, points)`` of ``tests/test_links.py`` — stricter than the
  reference's 4 ULP x n_iters, which covers an XLA contraction the port
  does not have.  Against the JAX package's ``run_faces_pipelined``:
  bit for bit without the stencil, ``rtol=atol=1e-5`` over 3 iterations
  with it (the ROADMAP's engine-vs-engine bound), on (1,1,1) and on
  (2,2,1) through a 4-device JAX subprocess;
* the masked multi-queue loop runs (``tests/test_torch_masked.py``
  holds it against the reference); ``tune=`` raises
  ``NotImplementedError``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.core as jcore
from repro.core import effects as jeffects
from repro.core.descriptors import GridOffsetPeer as JGrid
from repro.core.descriptors import OffsetPeer as JOffset
from repro.parallel import make_mesh as jax_make_mesh
from repro_torch import make_mesh
from repro_torch.core import (
    FacesConfig,
    FusedEngine,
    GridOffsetPeer,
    HostEngine,
    InterleavePolicy,
    OffsetPeer,
    PersistentEngine,
    QueueError,
    ScheduleError,
    STQueue,
    STSchedule,
    build_faces_part_program,
    build_faces_pipeline,
    build_faces_program,
    certify_equivalence,
    compose,
    effect_trace,
    faces_oracle,
    merge_parts,
    part_configs,
    part_names,
    program_digest,
    run_faces_persistent,
    run_faces_pipelined,
    split_parts,
    to_numpy,
)
from repro_torch.core.descriptors import (
    KernelDesc,
    RecvDesc,
    SendDesc,
    StartDesc,
    WaitDesc,
    dtype_str,
)
from repro_torch.core.halo import AXES3
from repro_torch.core.schedule import _segments

_FIELDS = ("grid", "points", "dtype", "granularity", "batched", "periodic",
           "interior_compute", "damping")
LINKED = [(2, (6, 4, 3)), (2, (5, 4, 3)), (3, (7, 3, 4)), (4, (6, 3, 3))]


def _meshx():
    return make_mesh((1,), ("x",), device="cpu")


def _mesh(grid=(1, 1, 1)):
    return make_mesh(grid, AXES3, device="cpu")


def _u0(cfg, seed=0):
    return np.random.RandomState(seed).randn(*cfg.grid, *cfg.points).astype(np.float32)


def _jcfg(cfg):
    return jcore.FacesConfig(**{f: getattr(cfg, f) for f in _FIELDS})


def _tiny_program(name, n_batches=1, waited=True):
    q = STQueue(_meshx(), name=name)
    q.buffer("a", (1, 4), np.float32, pspec=("x",))
    q.buffer("b", (1, 4), np.float32, pspec=("x",))
    for t in range(n_batches):
        q.enqueue_kernel(lambda a: a * 2.0, ["a"], ["a"], name=f"k{t}")
        q.enqueue_recv("b", OffsetPeer("x", -1, periodic=True), tag=t)
        q.enqueue_send("a", OffsetPeer("x", 1, periodic=True), tag=t)
        q.enqueue_start()
    if waited:
        q.enqueue_wait()
    return q.build()


def _linked_pair(jax=False):
    queue, peer_cls = (jcore.STQueue, JOffset) if jax else (STQueue, OffsetPeer)
    mesh = jax_make_mesh((1,), ("x",)) if jax else _meshx()
    shape = (1, 4)  # the rank dimension the port's engines need, in both
    qa = queue(mesh, name="A")
    qa.buffer("a", shape, np.float32, pspec=("x",))
    qa.enqueue_send("a", peer_cls("x", 0, periodic=True), tag=7, remote="B")
    qa.enqueue_start()
    qa.enqueue_wait()
    qb = queue(mesh, name="B")
    qb.buffer("slot", shape, np.float32, pspec=("x",))
    qb.buffer("out", shape, np.float32, pspec=("x",))
    qb.enqueue_recv("slot", peer_cls("x", 0, periodic=True), tag=7, remote="A")
    qb.enqueue_start()
    qb.enqueue_wait()
    qb.enqueue_kernel(lambda s: s * 2.0, ["slot"], ["out"], name="double")
    return qa.build(), qb.build()


# -- structure -------------------------------------------------------------------


def test_namespacing_and_sub_metadata():
    pa, pb = _tiny_program("A", n_batches=2), _tiny_program("B")
    sched = compose(pa, pb)
    assert isinstance(sched, STSchedule) and sched.name == "A+B"
    assert set(sched.buffers) == {"A/a", "A/b", "B/a", "B/b"}
    assert sched.buffers["A/a"].name == "A/a"
    assert [s.name for s in sched.subs] == ["A", "B"]
    assert sched.buffers_by_pid() == {0: ("A/a", "A/b"), 1: ("B/a", "B/b")}
    assert sched.buffer_name("B", "a") == "B/a"
    with pytest.raises(KeyError):
        sched.buffer_name("A", "nope")
    assert sorted(b.index for b in sched.batches) == [0, 1, 2]
    assert [b.pid for b in sorted(sched.batches, key=lambda b: b.index)] == [0, 0, 1]
    assert {d.pid for d in sched.descriptors} == {0, 1}
    assert sched.n_batches == pa.n_batches + pb.n_batches
    assert sched.n_channels == pa.n_channels + pb.n_channels
    assert sched.dispatch_count_host() == pa.dispatch_count_host() + pb.dispatch_count_host()


def test_round_robin_puts_b_inside_a_window():
    sched = compose(_tiny_program("A"), _tiny_program("B"))
    descs = sched.descriptors
    a_wait = next(i for i, d in enumerate(descs) if isinstance(d, WaitDesc) and d.pid == 0)
    b_start = next(i for i, d in enumerate(descs) if isinstance(d, StartDesc) and d.pid == 1)
    assert b_start < a_wait


@pytest.mark.parametrize("interleave", [None, "sequential",
                                        InterleavePolicy(order=(1, 0), granularity=2)])
def test_fifo_order_preserved_per_program(interleave):
    pa, pb = _tiny_program("A", n_batches=3), _tiny_program("B", n_batches=2)
    sched = compose(pa, pb, interleave=interleave)
    for pid, orig in ((0, pa), (1, pb)):
        mine = [d for d in sched.descriptors if d.pid == pid]
        assert [type(d) for d in mine] == [type(d) for d in orig.descriptors]
        for got, want in zip(mine, orig.descriptors):
            if isinstance(want, (SendDesc, RecvDesc)):
                assert got.buf.split("/", 1)[1] == want.buf and got.tag == want.tag
            elif isinstance(want, KernelDesc):
                assert got.name == want.name


def test_policies_order_the_stream_as_the_reference():
    """Each policy merges the programs' segments as the reference's does:
    the same (pid, kind) sequence."""
    jpa, jpb = [jcore.STQueue(jax_make_mesh((1,), ("x",)), name=n) for n in "AB"]
    for q in (jpa, jpb):
        q.buffer("a", (4,), np.float32, pspec=("x",))
        q.buffer("b", (4,), np.float32, pspec=("x",))
    for q, n in ((jpa, 3), (jpb, 2)):
        for t in range(n):
            q.enqueue_kernel(lambda a: a * 2.0, ["a"], ["a"], name=f"k{t}")
            q.enqueue_recv("b", JOffset("x", -1, periodic=True), tag=t)
            q.enqueue_send("a", JOffset("x", 1, periodic=True), tag=t)
            q.enqueue_start()
        q.enqueue_wait()
    jprogs = (jpa.build(), jpb.build())
    progs = (_tiny_program("A", n_batches=3), _tiny_program("B", n_batches=2))
    for policy in (None, "round_robin", "sequential", (None, 2), ((1, 0), 1), ((1, 0), 3)):
        if isinstance(policy, tuple):
            jp = jcore.InterleavePolicy(order=policy[0], granularity=policy[1])
            tp = InterleavePolicy(order=policy[0], granularity=policy[1])
        else:
            jp = tp = policy
        want = [(d.pid, type(d).__name__) for d in jcore.compose(*jprogs, interleave=jp).descriptors]
        got = [(d.pid, type(d).__name__) for d in compose(*progs, interleave=tp).descriptors]
        assert got == want, policy


def test_bad_policies_rejected():
    progs = (_tiny_program("A"), _tiny_program("B"))
    with pytest.raises(ScheduleError, match="unknown interleave policy"):
        compose(*progs, interleave="zigzag")
    with pytest.raises(ScheduleError, match="granularity"):
        compose(*progs, interleave=InterleavePolicy(granularity=0))
    with pytest.raises(ScheduleError, match="permutation"):
        compose(*progs, interleave=InterleavePolicy(order=(0, 0)))
    with pytest.raises(ScheduleError, match="InterleavePolicy"):
        compose(*progs, interleave=3)


def test_segments_keep_batches_whole():
    q = STQueue(_meshx(), "W")
    q.buffer("a", (1, 4), np.float32, pspec=("x",))
    q.buffer("b", (1, 4), np.float32, pspec=("x",))
    q.enqueue_recv("b", OffsetPeer("x", -1, periodic=True), tag=0)
    q.enqueue_send("a", OffsetPeer("x", 1, periodic=True), tag=0)
    q.enqueue_start()
    q.enqueue_recv("b", OffsetPeer("x", -1, periodic=True), tag=1)
    q.enqueue_wait()
    q.enqueue_send("a", OffsetPeer("x", 1, periodic=True), tag=1)
    q.enqueue_start()
    q.enqueue_wait()
    for seg in _segments(list(q.build().descriptors)):
        open_comm = 0
        for d in seg:
            if isinstance(d, (SendDesc, RecvDesc)):
                open_comm += 1
            elif isinstance(d, StartDesc):
                open_comm = 0
        assert open_comm == 0


def test_compose_three_programs():
    sched = compose(*[_tiny_program(n) for n in "ABC"])
    assert [s.pid for s in sched.subs] == [0, 1, 2]
    assert len(sched.buffers) == 6
    assert sorted(b.index for b in sched.batches) == [0, 1, 2]


# -- errors ------------------------------------------------------------------------


def test_compose_errors():
    pa = _tiny_program("A")
    with pytest.raises(ScheduleError, match="alias"):
        compose(pa, pa)
    other = dataclasses.replace(_tiny_program("B"), mesh=make_mesh((1,), ("y",), device="cpu"))
    with pytest.raises(ScheduleError, match="mesh"):
        compose(pa, other)
    sched = compose(pa, _tiny_program("B"))
    with pytest.raises(ScheduleError, match="nested"):
        compose(sched, _tiny_program("C"))
    with pytest.raises(ScheduleError):
        compose()
    with pytest.raises(ScheduleError, match="per-program"):
        sched.persistent(4)
    pair = pa.concurrent_with(_tiny_program("B"), name="pair")
    assert isinstance(pair, STSchedule) and pair.name == "pair"


def test_persistent_engine_checks_on_schedules():
    sched = compose(_tiny_program("A"), _tiny_program("B"))
    with pytest.raises(ValueError, match="n_iters"):
        PersistentEngine(sched, n_iters=3)
    with pytest.raises(ValueError, match="does not apply"):
        PersistentEngine(sched, cond_fn=lambda r: r > 0, reduce_fn=lambda m: 0.0)
    with pytest.raises(ValueError, match="unknown sub-program"):
        PersistentEngine(sched, reduce_fns={"nope": lambda m: 0.0})
    cfg = FacesConfig(grid=(1, 1, 1), points=(3, 3, 3), periodic=True)
    pa = build_faces_program(cfg, _mesh(), name="A").persistent(4, until=lambda r: r >= 1e-3)
    pb = build_faces_program(cfg, _mesh(), name="B").persistent(4)
    with pytest.raises(ValueError, match="reduce_fns"):
        PersistentEngine(compose(pa, pb))
    with pytest.raises(ValueError, match="reduce_fns"):
        PersistentEngine(build_faces_program(cfg, _mesh()), reduce_fns={"faces": lambda m: 0.0})


def test_masked_loop_requests_raise():
    """The masked cases (different counts, a predicate, ``reduce_fns``
    alone) run and return ``(mem, reductions, n_done)``, each program
    equal to its own persistent run bit for bit; ``run_faces_pipelined``
    with ``tols=`` returns ``(mem, residuals, n_done, stats)`` in one
    dispatch.  ``tune=`` still raises ``NotImplementedError``, and a
    missing ``n_iters``/``tols``, ``tols`` without ``max_iters`` and a
    wrong number of tolerances raise ``ValueError``."""
    cfg = FacesConfig(grid=(1, 1, 1), points=(4, 3, 3), periodic=True)
    pa = build_faces_program(cfg, _mesh(), name="A")
    pb = build_faces_program(cfg, _mesh(), name="B")
    size = lambda buf: lambda m: m[buf].abs().sum()
    ua, ub = _u0(cfg, seed=1), _u0(cfg, seed=2)
    for progs, kw, counts in (((pa.persistent(2), pb.persistent(3)), {}, (2, 3)),
                              ((pa.persistent(2, until=lambda r: r >= 0.1), pb.persistent(2)),
                               {"reduce_fns": {"A": size("A/u")}}, (2, 2)),
                              ((pa.persistent(2), pb.persistent(2)),
                               {"reduce_fns": {"B": size("B/u")}}, (2, 2))):
        eng = PersistentEngine(compose(*progs), **kw)
        mem, reds, n_done = eng(eng.init_buffers({"A/u": ua, "B/u": ub}))
        assert eng.stats.dispatches == 1
        assert {k: int(v) for k, v in n_done.items()} == dict(zip("AB", counts))
        assert set(reds) == set(kw.get("reduce_fns", {}))
        for name, u, n in zip("AB", (ua, ub), counts):
            alone = PersistentEngine(build_faces_program(cfg, _mesh()).persistent(n),
                                     reduce_fn=size("u") if name in reds else None)
            out = alone(alone.init_buffers({"u": u}))
            if name in reds:
                out, red = out
                assert reds[name].shape == (max(counts),)
                assert torch.equal(reds[name][:n], red), name
            for buf, t in out.items():
                assert torch.equal(mem[f"{name}/{buf}"], t), f"{name}/{buf}"
    u0 = _u0(cfg)
    mem, reds, n_done, stats = run_faces_pipelined(cfg, _mesh(), u0, tols=(1e-1, 1e-1),
                                                   max_iters=8)
    assert stats.dispatches == 1 and set(n_done) == set(part_names(2))
    assert all(reds[nm].shape == (n_done[nm],) for nm in n_done)
    with pytest.raises(NotImplementedError, match="Cost model and tuner"):
        run_faces_pipelined(cfg, _mesh(), u0, n_iters=2, tune=True)
    with pytest.raises(ValueError, match="n_iters"):
        run_faces_pipelined(cfg, _mesh(), u0)
    with pytest.raises(ValueError, match="requires max_iters"):
        run_faces_pipelined(cfg, _mesh(), u0, tols=(1e-1, 1e-1))
    with pytest.raises(ValueError, match="one tolerance per part"):
        run_faces_pipelined(cfg, _mesh(), u0, tols=(1e-1,), max_iters=8)


def test_link_structure():
    pa, pb = _linked_pair()
    assert pa.open_links == 1 and pb.open_links == 1
    sched = compose(pa, pb, links=[("A", "B")])
    assert sched.open_links == 0
    (link,) = sched.links
    assert (link.src, link.dst, link.tag, link.dst_buf) == ("A", "B", 7, "B/slot")
    ba = next(b for b in sched.batches if b.pid == 0)
    bb = next(b for b in sched.batches if b.pid == 1)
    (cross,) = [c for c in ba.channels if c.dst_pid is not None]
    assert (cross.dst_pid, cross.src_buf, cross.dst_buf) == (1, "A/a", "B/slot")
    assert bb.cross_recv_bufs == ("B/slot",)
    with pytest.raises(ScheduleError, match="links="):
        compose(*_linked_pair(), links=[("A", "B"), ("B", "A")])


def test_link_errors():
    pa, _ = _linked_pair()
    with pytest.raises(ScheduleError, match="unknown program"):
        compose(pa)
    q = STQueue(_meshx(), name="A")
    q.buffer("a", (1, 4), np.float32, pspec=("x",))
    q.enqueue_send("a", OffsetPeer("x", 0, periodic=True), tag=0, remote="A")
    q.enqueue_start()
    with pytest.raises(QueueError, match="itself"):
        q.build()
    qb = STQueue(_meshx(), name="B")
    qb.buffer("slot", (1, 4), np.float32, pspec=("x",))
    with pytest.raises(ScheduleError, match="unmatched cross-program"):
        compose(pa, qb.build())

    qb = STQueue(_meshx(), name="B")
    qb.buffer("slot", (1, 4), np.float32, pspec=("x",))
    qb.buffer("out", (1, 4), np.float32, pspec=("x",))
    qb.enqueue_recv("slot", OffsetPeer("x", 0, periodic=True), tag=7, remote="A")
    qb.enqueue_start()  # never waited: the deposit has no gate
    qb.enqueue_kernel(lambda s: s * 2.0, ["slot"], ["out"], name="k")
    with pytest.raises(ScheduleError, match="no following enqueue_wait"):
        compose(pa, qb.build())

    def cyclic(name, peer):
        q = STQueue(_meshx(), name=name)
        q.buffer("a", (1, 4), np.float32, pspec=("x",))
        q.buffer("slot", (1, 4), np.float32, pspec=("x",))
        q.enqueue_recv("slot", OffsetPeer("x", 0, periodic=True), tag=0, remote=peer)
        q.enqueue_start()
        q.enqueue_wait()
        q.enqueue_send("a", OffsetPeer("x", 0, periodic=True), tag=0, remote=peer)
        q.enqueue_start()
        q.enqueue_wait()
        return q.build()

    with pytest.raises(ScheduleError, match="cycle"):
        compose(cyclic("A", "B"), cyclic("B", "A"))


def test_linked_split_needs_direct26_batched_and_two_parts():
    with pytest.raises(ValueError, match="direct26"):
        build_faces_part_program(FacesConfig(points=(6, 3, 3), granularity="staged3"),
                                 _mesh((2, 2, 2)), 0, 2)
    with pytest.raises(ValueError, match="batched"):
        build_faces_part_program(FacesConfig(points=(6, 3, 3), batched=False),
                                 _mesh((2, 2, 2)), 0, 2)
    with pytest.raises(ValueError, match="n_parts"):
        build_faces_part_program(FacesConfig(points=(6, 3, 3)), _mesh((2, 2, 2)), 0, 1)


@pytest.mark.parametrize("n_parts,points", LINKED)
def test_faces_part_links_and_trigger_order(n_parts, points):
    cfg = FacesConfig(grid=(1, 1, 1), points=points, periodic=True)
    sched = build_faces_pipeline(cfg, _mesh(), n_parts, n_iters=2)
    names = part_names(n_parts)
    ring = {(names[k], names[(k + 1) % n_parts]) for k in range(n_parts)}
    ring |= {(b, a) for a, b in ring}
    assert {(l.src, l.dst) for l in sched.links} == ring | {(names[0], names[-1]),
                                                            (names[-1], names[0])}
    assert len(sched.links) == 2 * n_parts + 18
    descs = sched.descriptors
    for l in sched.links:
        src, dst = sched.sub(l.src).pid, sched.sub(l.dst).pid
        start = next(i for i, d in enumerate(descs) if isinstance(d, StartDesc)
                     and d.pid == src and d.batch == l.src_batch)
        wait = next(i for i, d in enumerate(descs) if isinstance(d, WaitDesc)
                    and d.pid == dst and d.batch >= l.dst_batch)
        assert start < wait, l


# -- the build layer against the reference ----------------------------------------


def _plan_layout(plan, to_str):
    if plan is None:
        return None
    return (tuple((t.axis, t.perm, to_str(t.dtype), t.stage,
                   tuple((s.channel, s.hop, s.offset, s.size) for s in t.segments),
                   t.staging) for t in plan.transfers),
            plan.routes, plan.shapes)


def _batch_layout(prog, to_str):
    return [(b.index, b.pid, b.waited, b.coalesce, b.cross_recv_bufs,
             [(c.src_buf, c.dst_buf, c.tag, c.mode, c.dst_pid) for c in b.channels],
             _plan_layout(b.plan, to_str),
             [(e.buf, e.kind, e.source, e.pid, e.region) for e in b.effects])
            for b in prog.batches]


def _linked_pair_schedules():
    return compose(*_linked_pair()), jcore.compose(*_linked_pair(jax=True))


@pytest.mark.parametrize("grid,periodic", [((1, 1, 1), True), ((2, 2, 2), False)])
@pytest.mark.parametrize("n_parts", [2, 3, 4])
@pytest.mark.parametrize("coalesce", [True, False])
def test_linked_faces_build_layer_equals_reference(grid, periodic, n_parts, coalesce):
    cfg = FacesConfig(grid=grid, points=(6, 4, 3), periodic=periodic)
    jmesh = AbstractMesh(grid, AXES3)
    jprogs = [jcore.build_faces_part_program(_jcfg(cfg), jmesh, k, n_parts,
                                             coalesce=coalesce).persistent(2)
              for k in range(n_parts)]
    jsched = jcore.compose(*jprogs)
    sched = build_faces_pipeline(cfg, _mesh(grid), n_parts, n_iters=2, coalesce=coalesce)
    assert program_digest(sched) == jeffects.program_digest(jsched)
    assert sched.collective_counts() == jsched.collective_counts()
    assert [(d.pid, type(d).__name__) for d in sched.descriptors] == \
        [(d.pid, type(d).__name__) for d in jsched.descriptors]
    assert [dataclasses.astuple(l) for l in sched.links] == \
        [dataclasses.astuple(l) for l in jsched.links]
    assert _batch_layout(sched, dtype_str) == \
        _batch_layout(jsched, lambda d: np.dtype(d).str)


def test_linked_pair_build_layer_equals_reference():
    sched, jsched = _linked_pair_schedules()
    assert program_digest(sched) == jeffects.program_digest(jsched)
    assert sched.collective_counts() == jsched.collective_counts()
    assert effect_trace(sched) == jeffects.effect_trace(jsched)


def test_certificates_equal_reference_across_policies():
    cfg = FacesConfig(grid=(1, 1, 1), points=(6, 4, 3), periodic=True)
    policies = [(None, None), ("sequential", "sequential"),
                (InterleavePolicy(order=(1, 0), granularity=3),
                 jcore.InterleavePolicy(order=(1, 0), granularity=3))]

    def both(policy, jpolicy, coalesce=True):
        progs = [build_faces_part_program(cfg, _mesh(), k, 2, coalesce=coalesce).persistent(2)
                 for k in range(2)]
        jprogs = [jcore.build_faces_part_program(_jcfg(cfg), jax_make_mesh((1, 1, 1), AXES3),
                                                 k, 2, coalesce=coalesce).persistent(2)
                  for k in range(2)]
        return (compose(*progs, interleave=policy, verify="off"),
                jcore.compose(*jprogs, interleave=jpolicy, verify="off"))

    base, jbase = both(None, None)
    for policy, jpolicy in policies[1:] + [(None, None)]:
        cand, jcand = both(policy, jpolicy)
        cert, jcert = certify_equivalence(base, cand), jeffects.certify_equivalence(jbase, jcand)
        assert cert.equivalent and cert.race_free
        assert (cert.equivalent, cert.race_free, cert.baseline_digest, cert.candidate_digest,
                cert.n_buffers, cert.reason) == \
            (jcert.equivalent, jcert.race_free, jcert.baseline_digest,
             jcert.candidate_digest, jcert.n_buffers, jcert.reason)
    uncoalesced, juncoalesced = both(None, None, coalesce=False)
    assert certify_equivalence(base, uncoalesced).equivalent
    # a structural change breaks the certificate, in both packages alike
    descs = list(cand.descriptors)
    ki = next(i for i, d in enumerate(descs) if isinstance(d, KernelDesc))
    descs[ki] = dataclasses.replace(descs[ki], name="tampered")
    jdescs = list(jcand.descriptors)
    jdescs[ki] = dataclasses.replace(jdescs[ki], name="tampered")
    cert = certify_equivalence(base, dataclasses.replace(cand, descriptors=tuple(descs)))
    jcert = jeffects.certify_equivalence(jbase, dataclasses.replace(jcand,
                                                                    descriptors=tuple(jdescs)))
    assert not cert.equivalent and cert.reason == jcert.reason


# -- transfer counts: the port's plans against the reference's ----------------------


def _random_channels(rng, n):
    """A channel set as tests/test_coalesce.py's strategy draws one."""
    out = []
    for _ in range(n):
        periodic = bool(rng.randint(2))
        if rng.randint(2):
            axis, delta = ("x", "y")[rng.randint(2)], int(rng.choice([-2, -1, 1, 2]))
            peers = (OffsetPeer(axis, delta, periodic), JOffset(axis, delta, periodic))
        else:
            deltas = (0, 0)
            while not any(deltas):
                deltas = tuple(int(v) for v in rng.randint(-1, 2, size=2))
            peers = (GridOffsetPeer(("x", "y"), deltas, periodic),
                     JGrid(("x", "y"), deltas, periodic))
        out.append((peers, int(rng.randint(4)), ("replace", "add")[rng.randint(2)],
                    bool(rng.randint(2))))
    return out


def _random_program(channels, jax, mesh_shape):
    if jax:
        q = jcore.STQueue(AbstractMesh(mesh_shape, ("x", "y")), name="prop")
    else:
        q = STQueue(make_mesh(mesh_shape, ("x", "y"), device="cpu"), name="prop")
    for i in range(len(channels)):
        q.buffer(f"s{i}", (2, 3), np.float32)
        q.buffer(f"d{i}", (2, 3), np.float32)
    for i, (peers, tag, mode, use_region) in enumerate(channels):
        q.enqueue_recv(f"d{i}", peers[jax].inverse(), tag=tag, mode=mode,
                       region=(slice(0, 1),) if use_region else None)
    for i, (peers, tag, mode, use_region) in enumerate(channels):
        q.enqueue_send(f"s{i}", peers[jax], tag=tag,
                       region=(slice(0, 1),) if use_region else None)
    q.enqueue_start()
    q.enqueue_wait()
    return q.build(verify="off")


@pytest.mark.parametrize("seed", range(12))
def test_random_channel_sets_coalesce_as_reference(seed):
    rng = np.random.RandomState(seed)
    for mesh_shape in ((1, 1), (2, 3)):
        channels = _random_channels(rng, 1 + rng.randint(8))
        got = _random_program(channels, False, mesh_shape)
        want = _random_program(channels, True, mesh_shape)
        assert got.collective_counts() == want.collective_counts()
        assert _batch_layout(got, dtype_str) == _batch_layout(want, lambda d: np.dtype(d).str)


def test_lone_periodic_diagonal_gives_two_transfers_in_both():
    """The known flake's input: one periodic diagonal channel is planned
    as two by-axis transfers, by the reference and by the port."""
    peers = (GridOffsetPeer(("x", "y"), (1, 1), True), JGrid(("x", "y"), (1, 1), True))
    channels = [(peers, 0, "replace", False)]
    got = _random_program(channels, False, (1, 1))
    want = _random_program(channels, True, (1, 1))
    assert got.collective_counts() == want.collective_counts() == {0: (1, 2)}
    assert _batch_layout(got, dtype_str) == _batch_layout(want, lambda d: np.dtype(d).str)


# -- numbers -------------------------------------------------------------------------


def _pipelined(cfg, u0, n_parts, n_iters, mode, coalesce=True, exchange=True):
    sched = build_faces_pipeline(cfg, _mesh(cfg.grid), n_parts, n_iters, exchange, coalesce)
    eng = PersistentEngine(sched, mode=mode, donate=True)
    names = part_names(n_parts)
    mem = eng(eng.init_buffers(dict(zip([f"{n}/u" for n in names], split_parts(u0, n_parts)))))
    assert (eng.stats.dispatches, eng.stats.sync_points) == (1, 0)
    return mem, merge_parts([mem[f"{n}/u"] for n in names])


@pytest.mark.parametrize("n_parts,points", LINKED)
@pytest.mark.parametrize("mode", ["stream", "dataflow"])
@pytest.mark.parametrize("coalesce", [True, False])
def test_linked_pipeline_equals_full_domain(n_parts, points, mode, coalesce):
    cfg = FacesConfig(grid=(1, 1, 1), points=points, periodic=True)
    u0 = _u0(cfg, seed=11)
    n = 3
    full = PersistentEngine(build_faces_program(cfg, _mesh(), coalesce=coalesce).persistent(n),
                            mode=mode)
    want = full(full.init_buffers({"u": u0}))["u"]
    _, got = _pipelined(cfg, u0, n_parts, n, mode, coalesce)
    assert torch.equal(got, want)
    ref = u0
    for _ in range(n):
        ref = faces_oracle(ref, cfg)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_run_faces_pipelined_entry_point():
    cfg = FacesConfig(grid=(1, 1, 1), points=(6, 3, 4), periodic=True, damping=0.25)
    u0 = _u0(cfg, seed=2)
    full, _ = run_faces_persistent(cfg, _mesh(), u0, n_iters=4, mode="stream")
    for mode in ("stream", "dataflow"):
        mem, stats = run_faces_pipelined(cfg, _mesh(), u0, n_iters=4, n_parts=3, mode=mode)
        assert (stats.dispatches, stats.sync_points) == (1, 0)
        got = merge_parts([mem[f"{n}/u"] for n in part_names(3)])
        assert torch.equal(got, full["u"])


@pytest.mark.parametrize("mode", ["stream", "dataflow"])
def test_unlinked_parts_equal_independent_runs(mode):
    cfg = FacesConfig(grid=(1, 1, 1), points=(7, 3, 4), periodic=True)
    u0 = _u0(cfg, seed=5)
    mem, _ = _pipelined(cfg, u0, 3, 3, mode, exchange=False)
    for name, part_cfg, part in zip(part_names(3), part_configs(cfg, 3), split_parts(u0, 3)):
        want, _ = run_faces_persistent(part_cfg, _mesh(), part, n_iters=3, mode=mode)
        assert torch.equal(mem[f"{name}/u"], want["u"]), name


def test_single_pass_engines_equal_full_program():
    cfg = FacesConfig(grid=(1, 1, 1), points=(6, 3, 3), periodic=True)
    u0 = _u0(cfg, seed=13)
    sched = build_faces_pipeline(cfg, _mesh(), 3)
    init = dict(zip([f"{n}/u" for n in part_names(3)], split_parts(u0, 3)))
    full = build_faces_program(cfg, _mesh())
    for cls, kw in ((FusedEngine, {"mode": "stream"}), (FusedEngine, {"mode": "dataflow"}),
                    (HostEngine, {})):
        ref = cls(full, **kw)
        want = ref(ref.init_buffers({"u": u0}))["u"]
        eng = cls(sched, **kw)
        mem = eng(eng.init_buffers(init))
        assert torch.equal(merge_parts([mem[f"{n}/u"] for n in part_names(3)]), want)


@pytest.mark.parametrize("engine", ["fused_stream", "fused_dataflow", "host", "persistent"])
def test_tiny_link_deposits_across_programs(engine):
    sched = compose(*_linked_pair())
    eng = {"fused_stream": lambda: FusedEngine(sched, mode="stream"),
           "fused_dataflow": lambda: FusedEngine(sched, mode="dataflow"),
           "host": lambda: HostEngine(sched),
           "persistent": lambda: PersistentEngine(sched, mode="dataflow")}[engine]()
    a = np.arange(4, dtype=np.float32).reshape(1, 4) + 1.0
    out = eng(eng.init_buffers({"A/a": a}))
    np.testing.assert_array_equal(out["B/slot"].numpy(), a)
    np.testing.assert_array_equal(out["B/out"].numpy(), 2.0 * a)


# -- against the JAX package's run_faces_pipelined ------------------------------------


def _jax_pipelined(cfg, u0, n_parts, n_iters, mode):
    mem, stats = jcore.run_faces_pipelined(_jcfg(cfg), jax_make_mesh(cfg.grid, AXES3), u0,
                                           n_iters=n_iters, n_parts=n_parts, mode=mode)
    assert stats.dispatches == 1
    return {k: np.asarray(v) for k, v in mem.items()}


@pytest.mark.parametrize("interior,mode,n_parts", [
    (False, "stream", 2), (False, "dataflow", 3), (True, "dataflow", 2)])
def test_pipeline_against_jax(interior, mode, n_parts):
    cfg = FacesConfig(grid=(1, 1, 1), points=(6, 4, 3), periodic=True,
                      interior_compute=interior, damping=0.5)
    u0 = _u0(cfg, seed=21)
    want = _jax_pipelined(cfg, u0, n_parts, 3, mode)
    mem, stats = run_faces_pipelined(cfg, _mesh(), u0, n_iters=3, n_parts=n_parts, mode=mode)
    got = to_numpy(mem)
    assert set(got) == set(want)
    for name in want:
        if interior:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_pipeline_against_jax_on_four_ranks(subproc, tmp_path):
    """(2,2,1): the x-crossing messages also hop ranks.  The reference runs
    in a subprocess with four JAX devices."""
    cfg = FacesConfig(grid=(2, 2, 1), points=(6, 4, 3), damping=0.12)
    u0 = _u0(cfg, seed=22)
    np.save(tmp_path / "u0.npy", u0)
    out = tmp_path / "jax.npz"
    r = subproc(f"""
import numpy as np
from repro.core import FacesConfig, run_faces_pipelined
from repro.parallel import make_mesh
cfg = FacesConfig(**{ {f: getattr(cfg, f) for f in _FIELDS}!r})
mem, stats = run_faces_pipelined(cfg, make_mesh(cfg.grid, ("gx", "gy", "gz")),
                                 np.load({str(tmp_path / "u0.npy")!r}), n_iters=3,
                                 n_parts=2, mode="stream")
np.savez({str(out)!r}, **{{k.replace("/", "__"): np.asarray(v) for k, v in mem.items()}})
""", devices=cfg.n_ranks)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    want = {k.replace("__", "/"): v for k, v in np.load(out).items()}
    for mode in ("stream", "dataflow"):
        mem, _ = run_faces_pipelined(cfg, _mesh(cfg.grid), u0, n_iters=3, n_parts=2, mode=mode)
        got = to_numpy(mem)
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5, atol=1e-5,
                                       err_msg=f"{mode} {name}")


def test_dag_width_counts_unordered_nodes():
    """The width the GPU tests read off a captured graph: one chain is 1,
    two joined chains 2, a fork of four 4, and an order through a node
    outside ``keep`` still orders the two it links."""
    from repro_torch.kernels.graph_loop import dag_width

    assert dag_width(4, [(0, 1), (1, 2), (2, 3)], range(4)) == 1
    assert dag_width(7, [(0, 1), (1, 2), (3, 4), (4, 5), (2, 6), (5, 6)], range(7)) == 2
    assert dag_width(5, [(0, k) for k in range(1, 5)], range(5)) == 4
    assert dag_width(3, [(0, 1), (1, 2)], [0, 2]) == 1
    assert dag_width(3, [], [0, 2]) == 2
    with pytest.raises(ValueError, match="cycle"):
        dag_width(2, [(0, 1), (1, 0)], range(2))


@pytest.mark.parametrize("seed", range(4))
def test_dag_width_equals_the_largest_antichain(seed):
    """On seeded random DAGs of 9 nodes, ``dag_width`` equals the largest
    antichain found by trying every subset of ``keep``."""
    from itertools import combinations

    from repro_torch.kernels.graph_loop import dag_width

    rng = np.random.RandomState(seed)
    n = 9
    for _ in range(20):
        edges = [(a, b) for a in range(n) for b in range(a + 1, n) if rng.rand() < 0.25]
        keep = [v for v in range(n) if rng.rand() < 0.8]
        reach = [{v} for v in range(n)]
        for v in reversed(range(n)):  # edges go up in index: a reverse sweep closes them
            for a, b in edges:
                if a == v:
                    reach[v] |= reach[b]

        def unordered(s):
            return all(w not in reach[v] for v in s for w in s if v != w)

        want = max(k for k in range(len(keep) + 1)
                   if any(unordered(s) for s in combinations(keep, k)))
        assert dag_width(n, edges, keep) == want, (edges, keep)


# -- tests/test_effects.py's halves: certificates and interleave invariance ----------

EFFECT_POLICIES = [None, "sequential", ((1, 0), 3), ((0, 1), 2)]


def _halves(policy, coalesce=True, jax=False):
    cfg = FacesConfig(grid=(1, 1, 1), points=(6, 6, 6), periodic=True)
    half = part_configs(cfg, 2)[0]
    if isinstance(policy, tuple):
        policy = (jcore.InterleavePolicy if jax else InterleavePolicy)(
            order=policy[0], granularity=policy[1])
    if jax:
        mesh = jax_make_mesh((1, 1, 1), AXES3)
        progs = [jcore.build_faces_program(_jcfg(half), mesh, name=n,
                                           coalesce=coalesce).persistent(2)
                 for n in part_names(2)]
        return jcore.compose(*progs, verify="off", interleave=policy)
    progs = [build_faces_program(half, _mesh(), name=n, coalesce=coalesce).persistent(2)
             for n in part_names(2)]
    return compose(*progs, verify="off", interleave=policy)


@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("policy", EFFECT_POLICIES, ids=str)
def test_halves_certificates_equal_reference(policy, coalesce):
    from repro_torch.core import program_certificate

    base, jbase = _halves(None), _halves(None, jax=True)
    cand, jcand = _halves(policy, coalesce), _halves(policy, coalesce, jax=True)
    cert, jcert = certify_equivalence(base, cand), jeffects.certify_equivalence(jbase, jcand)
    assert cert.equivalent and cert.race_free
    assert dataclasses.astuple(cert) == dataclasses.astuple(jcert)
    assert dataclasses.astuple(program_certificate(cand)) == \
        dataclasses.astuple(jeffects.program_certificate(jcand))


def test_different_buffer_sets_not_equivalent():
    cfg = part_configs(FacesConfig(grid=(1, 1, 1), points=(6, 6, 6), periodic=True), 2)[0]
    solo = build_faces_program(cfg, _mesh(), name="facesA").persistent(2)
    cert = certify_equivalence(_halves(None), solo)
    assert not cert.equivalent and "buffer" in cert.reason


def test_certified_interleavings_run_bit_identical():
    """A certified race-free schedule gives the same bits under every
    legal merge of its programs' streams (seeded orders and
    granularities, both trigger modes)."""
    u0 = np.random.RandomState(0).randn(1, 1, 1, 6, 6, 6).astype(np.float32)
    init = dict(zip([f"{n}/u" for n in part_names(2)], split_parts(u0, 2)))
    rng = np.random.RandomState(1234)
    for mode in ("stream", "dataflow"):
        ref = None
        for policy in [None] + [(tuple(rng.permutation(2)), int(rng.choice([1, 2, 3, 5, 50])))
                                for _ in range(3)]:
            sched = _halves(policy)
            assert certify_equivalence(_halves(None), sched).equivalent
            eng = PersistentEngine(sched, mode=mode)
            out = eng(eng.init_buffers(init))
            if ref is None:
                ref = out
            assert all(torch.equal(ref[k], out[k]) for k in ref), (mode, policy)
