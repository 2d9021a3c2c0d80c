"""The port's static verifier and runtime sanitizer against the JAX
package's, on the CPU.

Every mutation program of ``tests/test_verify.py`` (the rules, the
happens-before rules, the policies, the enqueue sites) is built with the
same enqueue calls and the same ``dataclasses.replace`` mutation in both
packages, and the two verifiers must report equal sets of ``(rule, pid,
severity, descriptor index, message)``.  The port's buffers carry the
leading rank dimension its engines need (``(1, 4)`` where the reference
declares ``(4,)``); no rule reads a shape.

The sanitizer: the fused and persistent engines give the same bits with
and without ``sanitize=True`` (plain programs and composed schedules,
both trigger modes), the canaries really are planted, a racy program
raises ``SanitizeError`` in the constructor (before any dispatch), and
the host engine sanitizes statically.

The collective builders lint clean in both packages, on the degenerate
one-rank ring and on four ranks (``tests/test_verify.py``'s ST013/ST014
builder case), deferred collectives (``CollDesc``) are read and
deposited as the reference's verifier has them, and every program of the
analysis registry lints clean (the benchmark sweep).
"""

import dataclasses
import types
import warnings

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.collectives as jcoll
import repro.core.verify as jverify
import repro_torch.core as tcore
import repro_torch.core.collectives as tcoll
import repro_torch.core.verify as tverify
from jax.sharding import AbstractMesh
from repro.core import descriptors as jdesc
from repro.parallel import make_mesh as jax_make_mesh
from repro_torch import make_mesh
from repro_torch.core import descriptors as tdesc
from repro_torch.core.halo import AXES3


def _pkg(port: bool):
    if port:
        core, desc, coll = tcore, tdesc, tcoll
        mesh = lambda shape, axes: make_mesh(shape, axes, device="cpu")
        mesh4 = lambda: make_mesh((4,), ("x",), device="cpu")
    else:
        core, desc, coll, mesh = jcore, jdesc, jcoll, jax_make_mesh
        mesh4 = lambda: AbstractMesh((4,), ("x",))
    return types.SimpleNamespace(
        core=core, d=desc, coll=coll, meshx4=mesh4,
        meshx=lambda: mesh((1,), ("x",)), mesh111=lambda: mesh((1, 1, 1), AXES3),
        vec=(1, 4) if port else (4,))


PKGS = {"jax": _pkg(False), "port": _pkg(True)}


def _sig(diags):
    return sorted((d.rule, d.pid, d.severity, d.index, d.message) for d in diags)


def _idx(prog, kind, pid=None, last=False):
    hits = [i for i, d in enumerate(prog.descriptors)
            if isinstance(d, kind) and (pid is None or d.pid == pid)]
    return hits[-1] if last else hits[0]


def _with_descs(prog, descs):
    return dataclasses.replace(prog, descriptors=tuple(descs))


def _move(descs, src, dst):
    descs = list(descs)
    descs.insert(dst, descs.pop(src))
    return descs


# -- the programs of tests/test_verify.py, in either package ------------------


def _exchange(P, n_batches=1, wait=True, kernel=True, name="p"):
    q = P.core.STQueue(P.meshx(), name=name)
    q.buffer("u", P.vec, np.float32, pspec=("x",))
    q.buffer("out", P.vec, np.float32, pspec=("x",))
    for b in range(n_batches):
        q.buffer(f"halo{b}", P.vec, np.float32, pspec=("x",))
    for b in range(n_batches):
        q.enqueue_send("u", P.core.OffsetPeer("x", 0, periodic=True), tag=b)
        q.enqueue_recv(f"halo{b}", P.core.OffsetPeer("x", 0, periodic=True), tag=b)
        q.enqueue_start()
    if wait:
        q.enqueue_wait()
    if kernel:
        q.enqueue_kernel(lambda h: h + 1.0, ["halo0"], ["out"], name="unpack")
    return q.build(verify="off")


def _linked_pair(P):
    peer = P.core.OffsetPeer("x", 0, periodic=True)
    qa = P.core.STQueue(P.meshx(), name="A")
    qa.buffer("a", P.vec, np.float32, pspec=("x",))
    qa.enqueue_send("a", peer, tag=7, remote="B")
    qa.enqueue_start()
    qa.enqueue_wait()
    qb = P.core.STQueue(P.meshx(), name="B")
    qb.buffer("slot", P.vec, np.float32, pspec=("x",))
    qb.buffer("out", P.vec, np.float32, pspec=("x",))
    qb.enqueue_recv("slot", peer, tag=7, remote="A")
    qb.enqueue_start()
    qb.enqueue_wait()
    qb.enqueue_kernel(lambda s: s * 2.0, ["slot"], ["out"], name="double")
    return qa.build(), qb.build()


def _linked_chain(P, persistent=0, deposits=1):
    peer = P.core.OffsetPeer("x", 0, periodic=True)
    qa = P.core.STQueue(P.meshx(), name="A")
    qa.buffer("a", P.vec, np.float32, pspec=("x",))
    for t in range(deposits):
        qa.enqueue_send("a", peer, tag=7 + t, remote="B")
        qa.enqueue_start()
        qa.enqueue_wait()
    qb = P.core.STQueue(P.meshx(), name="B")
    qb.buffer("slot", P.vec, np.float32, pspec=("x",))
    qb.buffer("out", P.vec, np.float32, pspec=("x",))
    for t in range(deposits):
        qb.enqueue_recv("slot", peer, tag=7 + t, remote="A")
        qb.enqueue_start()
        qb.enqueue_wait()
    qb.enqueue_kernel(lambda s: s * 2.0, ["slot"], ["out"], name="double")
    pa, pb = qa.build(verify="off"), qb.build(verify="off")
    if persistent:
        pa, pb = pa.persistent(persistent), pb.persistent(persistent)
    return P.core.compose(pa, pb, verify="off")


def _ring_accumulator(P, steps=3):
    peer = P.core.OffsetPeer("x", 0, periodic=True)
    q = P.core.STQueue(P.meshx(), name="ring")
    q.buffer("y", P.vec, np.float32, pspec=("x",))
    q.buffer("acc", P.vec, np.float32, pspec=("x",))
    q.enqueue_kernel(lambda y: y * 1.0, ["y"], ["acc"], name="seed")
    for s in range(steps):
        q.enqueue_send("acc", peer, tag=s)
        q.enqueue_recv("acc", peer, tag=s)
        q.enqueue_start()
        q.enqueue_wait()
        q.enqueue_kernel(lambda a, y: a + y, ["acc", "y"], ["acc"], name=f"acc{s}")
    return q.build(verify="off")


def _faces(P, periodic=True):
    cfg = P.core.FacesConfig(grid=(1, 1, 1), points=(4, 4, 4), periodic=periodic)
    return P.core.build_faces_program(cfg, P.mesh111())


def _move_kernel(prog, dest):
    descs = list(prog.descriptors)
    ki = next(i for i, d in enumerate(descs) if isinstance(d, (jdesc.KernelDesc, tdesc.KernelDesc)))
    return _with_descs(prog, _move(descs, ki, dest))


def _replan(prog, bi, **kw):
    batches = list(prog.batches)
    batches[bi] = dataclasses.replace(batches[bi], **kw)
    return dataclasses.replace(prog, batches=tuple(batches))


def m_clean_1(P):
    return _exchange(P)


def m_clean_2(P):
    return _exchange(P, n_batches=2)


def m_clean_linked(P):
    return P.core.compose(*_linked_pair(P))


def m_st001_own(P):
    prog = _exchange(P, n_batches=2)
    return _with_descs(prog, _move(prog.descriptors, _idx(prog, P.d.WaitDesc),
                                   _idx(prog, P.d.StartDesc, last=True)))


def m_st001_cross(P):
    sched = P.core.compose(*_linked_pair(P))
    return _with_descs(sched, [d for d in sched.descriptors
                               if not (isinstance(d, (P.d.StartDesc, P.d.WaitDesc))
                                       and d.pid == 0)])


def m_st002(P):
    prog = _exchange(P)
    descs = list(prog.descriptors)
    wi, si = _idx(prog, P.d.WaitDesc), _idx(prog, P.d.StartDesc)
    descs[wi], descs[si] = descs[si], descs[wi]
    return _with_descs(prog, descs)


def m_st003(P):
    prog = _exchange(P, n_batches=2)
    descs = list(prog.descriptors)
    si = _idx(prog, P.d.SendDesc)
    descs[si] = dataclasses.replace(descs[si], threshold=99)
    return _with_descs(prog, descs)


def m_st004(P):
    prog = _exchange(P, kernel=False)
    return _with_descs(prog, [d for d in prog.descriptors
                              if not isinstance(d, (P.d.StartDesc, P.d.WaitDesc))])


def m_st005(P):
    return _exchange(P, wait=False, kernel=False)


def m_st005_persistent(P):
    prog = _exchange(P, kernel=False).persistent(3)
    return _with_descs(prog, [d for d in prog.descriptors if not isinstance(d, P.d.WaitDesc)])


def m_st006(P):
    q = P.core.STQueue(P.meshx(), name="clobber")
    q.buffer("u", P.vec, np.float32, pspec=("x",))
    q.buffer("halo", P.vec, np.float32, pspec=("x",))
    for tag in (0, 1):
        q.enqueue_send("u", P.core.OffsetPeer("x", 0, periodic=True), tag=tag)
        q.enqueue_recv("halo", P.core.OffsetPeer("x", 0, periodic=True), tag=tag)
        q.enqueue_start()
    q.enqueue_wait()
    return q.build(verify="off")


def m_st007(P):
    prog = _exchange(P)
    return _with_descs(prog, _move(prog.descriptors, _idx(prog, P.d.KernelDesc),
                                   _idx(prog, P.d.WaitDesc)))


def m_st008_plan(P):
    prog = _faces(P)
    bi, b = next((i, b) for i, b in enumerate(prog.batches) if b.plan is not None)
    t0 = b.plan.transfers[0]
    seg = t0.segments[-1]
    segs = t0.segments[:-1] + (dataclasses.replace(seg, offset=seg.offset + 1),)
    plan = dataclasses.replace(b.plan, transfers=(dataclasses.replace(t0, segments=segs),)
                               + b.plan.transfers[1:])
    return _replan(prog, bi, plan=plan)


def m_st008_route(P):
    prog = _faces(P)
    bi, b = next((i, b) for i, b in enumerate(prog.batches) if b.plan is not None)
    ci, route = next((ci, r) for ci, r in enumerate(b.plan.routes) if r)
    ti, off = route[0]
    routes = list(b.plan.routes)
    routes[ci] = ((ti, off + 1),) + route[1:]
    return _replan(prog, bi, plan=dataclasses.replace(b.plan, routes=tuple(routes)))


def m_st009(P):
    sched = P.core.compose(*_linked_pair(P))
    descs = list(sched.descriptors)
    ki = next(i for i, d in enumerate(descs)
              if isinstance(d, P.d.KernelDesc) and d.name == "double")
    descs[ki] = dataclasses.replace(descs[ki], reads=("A/a",))
    return _with_descs(sched, descs)


def m_st010(P):
    prog = _exchange(P).persistent(2)
    bi, b = next((i, b) for i, b in enumerate(prog.batches) if b.channels)
    chans = [dataclasses.replace(b.channels[0], mode="add")] + list(b.channels[1:])
    return _replan(prog, bi, channels=chans)


def m_st010_oneshot(P):
    return dataclasses.replace(m_st010(P), n_iters=1)


def m_st011(P):
    prog = _faces(P, periodic=False)
    return dataclasses.replace(prog, batches=tuple(
        dataclasses.replace(b, plan=None, coalesce=True) for b in prog.batches))


def m_st011_clean(P):
    return _faces(P, periodic=False)


def m_st013(P):
    prog = _ring_accumulator(P)
    bi, b = next((i, b) for i, b in enumerate(prog.batches) if b.channels)
    return _replan(prog, bi, channels=list(b.channels) + [b.channels[0]], plan=None)


def m_ring_clean(P):
    return _ring_accumulator(P)


def m_st014(P):
    prog = _ring_accumulator(P, steps=3)
    descs = list(prog.descriptors)
    ki = next(i for i, d in enumerate(descs)
              if isinstance(d, P.d.KernelDesc) and d.name == "acc1")
    descs[ki] = dataclasses.replace(descs[ki], reads=("y",))
    return _with_descs(prog, descs)


def _builders(P, mesh, n):
    C = P.coll
    m, k, f = 8 * n * n, 4 * n, 4 * n
    return (C.build_all_gather_matmul(mesh, "x", m, k, f),
            C.build_all_gather_matmul(mesh, "x", m, k, f, bidirectional=True),
            C.build_matmul_reduce_scatter(mesh, "x", m, k, f),
            C.build_all_to_all(mesh, "x", m, k),
            C.build_tp_block(mesh, "x", m, k, f),
            C.build_tp_block(mesh, "x", m, k, f, chain=True))


def m_builders_1(P):
    progs = [cm.program for cm in _builders(P, P.meshx(), 1)]
    return progs[-1].persistent(3)


def m_builders_4(P):
    return _builders(P, P.meshx4(), 4)[-1].program.persistent(3)


def _colls(P, kernel_in_window=False, name="colls"):
    q = P.core.STQueue(P.meshx(), name=name)
    q.buffer("a", P.vec, np.float32, pspec=("x",))
    q.buffer("g", P.vec, np.float32, pspec=("x",))
    q.enqueue_collective("all_gather", "a", "g", "x", dim=0)
    q.enqueue_start()
    if kernel_in_window:
        q.enqueue_kernel(lambda g: g, ["g"], ["g"], name="early")
    q.enqueue_wait()
    q.enqueue_kernel(lambda g: g, ["g"], ["a"], name="late")
    return q.build(verify="off")


def m_coll_clean(P):
    return _colls(P)


def m_coll_st007(P):
    return _colls(P, kernel_in_window=True)


def m_coll_st009(P):
    sched = P.core.compose(_colls(P), _colls(P, name="other"), verify="off")
    descs = list(sched.descriptors)
    i = next(i for i, d in enumerate(descs) if isinstance(d, P.d.CollDesc))
    descs[i] = dataclasses.replace(descs[i], out="other/g")
    return _with_descs(sched, descs)


def m_chain(P):
    return _linked_chain(P)


def m_chain_persistent(P):
    return _linked_chain(P, persistent=3)


def m_chain_two(P):
    return _linked_chain(P, persistent=3, deposits=2)


def m_st015(P):
    prog = _linked_chain(P)
    return _move_kernel(prog, _idx(prog, P.d.WaitDesc, pid=1))


def m_st015_blind(P):
    return _move_kernel(_linked_chain(P), 0)


def m_st016(P):
    prog = _linked_chain(P, persistent=3)
    return _move_kernel(prog, _idx(prog, P.d.WaitDesc, pid=1))


def m_st017(P):
    prog = _exchange(P, n_batches=2)
    return dataclasses.replace(prog, batches=tuple(
        dataclasses.replace(b, plan=dataclasses.replace(b.plan, transfers=tuple(
            dataclasses.replace(t, staging="~stage/shared") for t in b.plan.transfers)))
        for b in prog.batches))


def m_st017_ordered(P):
    q = P.core.STQueue(P.meshx(), name="p")
    q.buffer("u", P.vec, np.float32, pspec=("x",))
    for b in range(2):
        q.buffer(f"halo{b}", P.vec, np.float32, pspec=("x",))
    for b in range(2):
        q.enqueue_send("u", P.core.OffsetPeer("x", 0, periodic=True), tag=b)
        q.enqueue_recv(f"halo{b}", P.core.OffsetPeer("x", 0, periodic=True), tag=b)
        q.enqueue_start()
        q.enqueue_wait()
    prog = q.build(verify="off")
    return dataclasses.replace(prog, batches=tuple(
        dataclasses.replace(b, plan=dataclasses.replace(b.plan, transfers=tuple(
            dataclasses.replace(t, staging="~stage/shared") for t in b.plan.transfers)))
        for b in prog.batches))


def m_st018(P):
    prog = _linked_chain(P, persistent=3, deposits=2)
    return _move_kernel(prog, _idx(prog, P.d.WaitDesc, pid=1, last=True))


def m_st019(P):
    q = P.core.STQueue(P.meshx(), name="ic")
    q.buffer("u", P.vec, np.float32, pspec=("x",))
    q.buffer("v", P.vec, np.float32, pspec=("x",))
    q.enqueue_compute(lambda u: u + 1.0, writes=["v"])
    return q.build(verify="off")


def m_st019_declared(P):
    q = P.core.STQueue(P.meshx(), name="ok")
    q.buffer("u", P.vec, np.float32, pspec=("x",))
    q.buffer("v", P.vec, np.float32, pspec=("x",))
    q.enqueue_compute(lambda u: u + 1.0, reads=["u"], writes=["v"])
    return q.build(verify="off")


def m_faces_linked2(P):
    cfg = P.core.FacesConfig(grid=(1, 1, 1), points=(6, 3, 3), periodic=True)
    mesh = P.mesh111()
    return P.core.compose(*[P.core.build_faces_part_program(cfg, mesh, k, 2).persistent(2)
                            for k in range(2)])


# case -> the rules the reference's test requires (empty: lint-clean),
# and rules it requires absent
MUTATIONS = {
    m_clean_1: ((), ("*",)), m_clean_2: ((), ("*",)), m_clean_linked: ((), ("*",)),
    m_st001_own: (("ST001",), ()), m_st001_cross: (("ST001",), ()),
    m_st002: (("ST002",), ()), m_st003: (("ST003",), ()), m_st004: (("ST004",), ()),
    m_st005: (("ST005",), ()), m_st005_persistent: (("ST005",), ()),
    m_st006: (("ST006",), ()), m_st007: (("ST007",), ()),
    m_st008_plan: (("ST008",), ()), m_st008_route: (("ST008",), ()),
    m_st009: (("ST009",), ()), m_st010: (("ST010",), ()), m_st010_oneshot: ((), ("ST010",)),
    m_st011: (("ST011",), ()), m_st011_clean: ((), ("ST011",)),
    m_st013: (("ST013",), ()), m_ring_clean: ((), ("ST013", "ST014")),
    m_st014: (("ST014",), ()),
    m_chain: ((), ("ST015", "ST016", "ST017", "ST018")),
    m_chain_persistent: ((), ("ST015", "ST016", "ST017", "ST018")),
    m_chain_two: ((), ("ST015", "ST016", "ST017", "ST018")),
    m_st015: (("ST015",), ()), m_st015_blind: (("ST015",), ()),
    m_st016: (("ST016",), ()), m_st017: (("ST017",), ()),
    m_st017_ordered: ((), ("ST017",)), m_st018: (("ST018",), ("ST016",)),
    m_st019: (("ST019",), ()), m_st019_declared: ((), ("ST019",)),
    m_faces_linked2: ((), ("*",)),
    m_builders_1: ((), ("*",)), m_builders_4: ((), ("*",)),
    m_coll_clean: ((), ("*",)), m_coll_st007: (("ST007",), ()),
    m_coll_st009: (("ST009",), ()),
}


@pytest.mark.parametrize("n", [1, 4])
def test_st013_st014_collective_builders_lint_clean(n):
    """Every collective builder lints clean in both packages, on the
    degenerate one-rank ring and on four ranks."""
    for port, jax in zip(_builders(PKGS["port"], PKGS["port"].meshx() if n == 1
                                   else PKGS["port"].meshx4(), n),
                         _builders(PKGS["jax"], PKGS["jax"].meshx() if n == 1
                                   else PKGS["jax"].meshx4(), n)):
        assert not tverify.verify_program(port.program)
        assert not jverify.verify_program(jax.program)


def test_every_benchmark_program_lints_clean():
    """The registry sweep of ``tests/test_verify.py::TestBenchmarkSweep``:
    the same names as the reference's, each lint-clean."""
    from repro.analysis import lint_all as jlint_all
    from repro_torch.analysis import lint_all

    results = lint_all(device_count=1, device="cpu")
    names = [n for n, _ in results]
    assert names == [n for n, _ in jlint_all(device_count=1)]
    assert {"faces_fig8_1d", "faces_pipeline_linked_n2", "serve_admission",
            "overlap_tp_chain"} <= set(names)
    dirty = {n: [str(d) for d in ds] for n, ds in results if ds}
    assert not dirty, dirty


@pytest.mark.parametrize("case", list(MUTATIONS), ids=lambda f: f.__name__[2:])
def test_diagnostics_equal_reference(case):
    want = _sig(jverify.verify_program(case(PKGS["jax"])))
    got = _sig(tverify.verify_program(case(PKGS["port"])))
    assert got == want
    present, absent = MUTATIONS[case]
    rules = {d[0] for d in got}
    assert set(present) <= rules
    assert (not rules) if absent == ("*",) else not rules & set(absent)


def test_st015_blind_walk_is_hb_only():
    """Moved to the front, the kernel is walk-silent: only the happens-
    before graph reports it, in both packages."""
    assert {d.rule for d in tverify.verify_program(m_st015_blind(PKGS["port"]))} == {"ST015"}


def test_hb_race_diagnostics_equal_reference():
    for case in (m_st015, m_st016, m_st017, m_st018, m_chain_two):
        want = _sig(jverify.hb_race_diagnostics(case(PKGS["jax"])))
        assert _sig(tverify.hb_race_diagnostics(case(PKGS["port"]))) == want, case.__name__


def test_rule_catalog_equal_reference():
    assert tverify.RULES == jverify.RULES
    for rule, (sev, _) in tverify.RULES.items():
        assert sev in ("error", "warning")
        assert rule in tverify.__doc__


def test_st012_open_program_refused_by_every_engine():
    pa, _ = _linked_pair(PKGS["port"])
    assert pa.open_links == 1
    for cls in (tcore.HostEngine, tcore.FusedEngine, tcore.PersistentEngine):
        with pytest.raises(ValueError, match=r"\[ST012\]"):
            cls(pa)


def test_st019_flags_the_implicit_read_set():
    prog = m_st019(PKGS["port"])
    kd = next(x for x in prog.descriptors if isinstance(x, tdesc.KernelDesc))
    assert kd.implicit_effects and kd.reads == ("u", "v")
    d = next(d for d in tverify.verify_program(prog) if d.rule == "ST019")
    assert d.site and "test_torch_verify.py" in d.site


# -- policies -------------------------------------------------------------------


def _bad():
    return m_st007(PKGS["port"])  # ST007: error severity


def test_policy_off_skips():
    assert tverify.run_verify(_bad(), "off") == []


def test_policy_rejects_unknown_names():
    with pytest.raises(ValueError, match="verify must be"):
        tverify.run_verify(_bad(), "loud")
    q = tcore.STQueue(make_mesh((1,), ("x",), device="cpu"), name="w")
    q.buffer("u", (1, 4), np.float32, pspec=("x",))
    q.enqueue_send("u", tcore.OffsetPeer("x", 0, periodic=True), tag=0)
    q.enqueue_recv("u", tcore.OffsetPeer("x", 0, periodic=True), tag=0)
    q.enqueue_start()
    q.enqueue_wait()
    with pytest.raises(ValueError, match="verify must be"):
        q.build(verify="loud")
    with pytest.raises(ValueError, match="verify must be"):
        tcore.compose(*_linked_pair(PKGS["port"]), verify="loud")


def test_policy_error_raises_with_error_diagnostics():
    with pytest.raises(tverify.VerifyError) as e:
        tverify.run_verify(_bad(), "error")
    assert e.value.diagnostics
    assert all(d.severity == "error" for d in e.value.diagnostics)


def test_policy_warn_warns():
    with pytest.warns(tverify.STLintWarning, match=r"\[ST007\]"):
        tverify.run_verify(_bad(), "warn")


def test_policy_error_only_warns_on_warning_severity():
    prog = m_st005(PKGS["port"])
    with pytest.warns(tverify.STLintWarning, match=r"\[ST005\]"):
        diags = tverify.run_verify(prog, "error")
    assert [d.rule for d in diags] == ["ST005"]


def test_build_defaults_to_warn_and_compose_to_error():
    P = PKGS["port"]
    q = tcore.STQueue(P.meshx(), name="late")
    q.buffer("u", (1, 4), np.float32, pspec=("x",))
    q.buffer("h", (1, 4), np.float32, pspec=("x",))
    q.enqueue_send("u", tcore.OffsetPeer("x", 0, periodic=True), tag=0)
    q.enqueue_recv("h", tcore.OffsetPeer("x", 0, periodic=True), tag=0)
    q.enqueue_start()
    with pytest.warns(tverify.STLintWarning, match=r"\[ST005\]"):
        q.build()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m_clean_1(P)
        _exchange(P, n_batches=2)
    # a deadlocking link order is an error at compose
    qa = tcore.STQueue(P.meshx(), name="A")
    qa.buffer("a", (1, 4), np.float32, pspec=("x",))
    qa.enqueue_send("a", tcore.OffsetPeer("x", 0, periodic=True), tag=0, remote="B")
    qa.enqueue_start()
    qb = tcore.STQueue(P.meshx(), name="B")
    qb.buffer("s", (1, 4), np.float32, pspec=("x",))
    qb.buffer("o", (1, 4), np.float32, pspec=("x",))
    qb.enqueue_recv("s", tcore.OffsetPeer("x", 0, periodic=True), tag=0, remote="A")
    qb.enqueue_start()
    qb.enqueue_wait()
    qb.enqueue_kernel(lambda s: s, ["s"], ["o"], name="k")
    pa, pb = qa.build(verify="off"), qb.build(verify="off")
    pb = _move_kernel(pb, 0)
    with pytest.raises(tverify.VerifyError, match="ST015"):
        tcore.compose(pa, pb)
    assert tcore.compose(pa, pb, verify="off").links


def test_diagnostic_formatting():
    d = tverify.Diagnostic(rule="ST007", severity="error", pid=1, message="boom",
                           index=4, site="a.py:9")
    assert str(d) == str(jverify.Diagnostic(rule="ST007", severity="error", pid=1,
                                            message="boom", index=4, site="a.py:9"))
    table = tverify.format_diagnostics([d])
    assert "ST007" in table and "boom" in table
    assert "clean" in tverify.format_diagnostics([])


def test_descriptors_channels_and_diagnostics_carry_sites():
    prog = _exchange(PKGS["port"])
    for d in prog.descriptors:
        assert d.site and "test_torch_verify.py" in d.site, d
    ch = next(ch for b in prog.batches for ch in b.channels)
    assert "test_torch_verify.py" in ch.send_site and "test_torch_verify.py" in ch.recv_site
    d = next(d for d in tverify.verify_program(m_st007(PKGS["port"])) if d.rule == "ST007")
    assert d.site and "test_torch_verify.py" in d.site and "enqueued at" in str(d)


# -- the sanitizer ----------------------------------------------------------------


def _faces_pair():
    cfg = tcore.FacesConfig(grid=(1, 1, 1), points=(4, 4, 4), periodic=True)
    prog = tcore.build_faces_program(cfg, make_mesh((1, 1, 1), AXES3, device="cpu"))
    u0 = np.random.RandomState(0).randn(1, 1, 1, 4, 4, 4).astype(np.float32)
    return prog, u0


def _race(prog):
    """A post-wait unpack kernel moved ahead of the wait
    (tests/test_verify.py's ``_race``)."""
    descs = list(prog.descriptors)
    wi = max(i for i, d in enumerate(descs) if isinstance(d, tdesc.WaitDesc))
    ki = next(i for i, d in enumerate(descs) if i > wi and isinstance(d, tdesc.KernelDesc))
    return _with_descs(prog, _move(descs, ki, wi))


def _linked_faces(mode_points=(6, 4, 3), n_parts=2, n_iters=2, **cfg_kw):
    cfg = tcore.FacesConfig(grid=(1, 1, 1), points=mode_points, periodic=True, **cfg_kw)
    mesh = make_mesh((1, 1, 1), AXES3, device="cpu")
    sched = tcore.build_faces_pipeline(cfg, mesh, n_parts, n_iters)
    u0 = np.random.RandomState(3).randn(1, 1, 1, *mode_points).astype(np.float32)
    init = dict(zip([f"{n}/u" for n in tcore.part_names(n_parts)],
                    tcore.split_parts(u0, n_parts)))
    return sched, init


def test_canary_buffers_equal_reference():
    prog, _ = _faces_pair()
    jprog = jcore.build_faces_program(
        jcore.FacesConfig(grid=(1, 1, 1), points=(4, 4, 4), periodic=True),
        jax_make_mesh((1, 1, 1), AXES3))
    assert tverify.canary_buffers(prog) == jverify.canary_buffers(jprog)
    assert tverify.canary_buffers(prog) and "u" not in tverify.canary_buffers(prog)
    sched, _ = _linked_faces()
    jsched = m_faces_linked2(PKGS["jax"])
    assert tverify.canary_buffers(m_faces_linked2(PKGS["port"])) == \
        jverify.canary_buffers(jsched)
    assert "facesB/glo" in tverify.canary_buffers(sched)


@pytest.mark.parametrize("mode", ["stream", "dataflow"])
def test_fused_and_persistent_equal_under_canaries(mode):
    prog, u0 = _faces_pair()
    for make in (lambda s: tcore.FusedEngine(prog, mode=mode, sanitize=s),
                 lambda s: tcore.PersistentEngine(prog.persistent(3), mode=mode,
                                                  sanitize=s)):
        plain, poisoned = make(False), make(True)
        a = plain(plain.init_buffers({"u": u0}))
        b = poisoned(poisoned.init_buffers({"u": u0}))
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("mode", ["stream", "dataflow"])
def test_linked_schedule_equal_under_canaries(mode):
    sched, init = _linked_faces()
    for cls in (tcore.FusedEngine, tcore.PersistentEngine):
        plain, poisoned = cls(sched, mode=mode), cls(sched, mode=mode, sanitize=True)
        a = plain(plain.init_buffers(init))
        b = poisoned(poisoned.init_buffers(init))
        assert all(torch.equal(a[k], b[k]) for k in a), cls.__name__


def test_canaries_are_planted_and_saved():
    """A pass starts with every canary buffer NaN and its value saved."""
    from repro_torch.core.engine_fused import PassStreams, _plant_canaries

    prog, _ = _faces_pair()
    eng = tcore.FusedEngine(prog, sanitize=True)
    gen = torch.Generator().manual_seed(0)
    mem = {n: torch.randn(s.shape, generator=gen) for n, s in prog.buffers.items()}
    before = {n: t.clone() for n, t in mem.items()}
    saved = _plant_canaries(mem, eng.program, PassStreams(None, eng.device))
    assert sorted(saved) == list(tverify.canary_buffers(prog))
    for n, t in mem.items():
        if n in saved:
            assert torch.isnan(t).all() and torch.equal(saved[n], before[n]), n
        else:
            assert torch.equal(t, before[n]), n


@pytest.mark.parametrize("cls", ["FusedEngine", "PersistentEngine", "HostEngine"])
def test_race_caught_before_any_dispatch(cls):
    prog, u0 = _faces_pair()
    bad = _race(prog)
    engine = getattr(tcore, cls)
    silent = engine(bad)
    silent(silent.init_buffers({"u": u0}))  # runs, silently wrong
    assert silent.stats.dispatches > 0
    with pytest.raises(tverify.SanitizeError, match="pending unwaited deposit"):
        engine(bad, sanitize=True)
    # the reference's sanitizer rejects the same program
    jprog = jcore.build_faces_program(
        jcore.FacesConfig(grid=(1, 1, 1), points=(4, 4, 4), periodic=True),
        jax_make_mesh((1, 1, 1), AXES3))
    descs = list(jprog.descriptors)
    wi = max(i for i, d in enumerate(descs) if isinstance(d, jdesc.WaitDesc))
    ki = next(i for i, d in enumerate(descs) if i > wi and isinstance(d, jdesc.KernelDesc))
    with pytest.raises(jverify.SanitizeError, match="pending unwaited deposit"):
        jverify.check_deposit_order(_with_descs(jprog, _move(descs, ki, wi)))


def test_host_engine_sanitizes_statically():
    prog, u0 = _faces_pair()
    tverify.check_deposit_order(prog)
    eng = tcore.HostEngine(prog, sanitize=True)
    ref = tcore.FusedEngine(prog, mode="dataflow")
    a = eng(eng.init_buffers({"u": u0}))
    b = ref(ref.init_buffers({"u": u0}))
    assert torch.equal(a["u"], b["u"])
