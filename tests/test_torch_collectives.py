"""The port's collectives (``core/overlap.py``, ``core/collectives.py``,
``STQueue.enqueue_collective``) against the JAX package's, on the CPU.

* build layer: ``program_digest`` and ``collective_counts()`` of every
  collective builder, of ``enqueue_collective`` programs and of the
  admission schedule equal the reference's, at n=1 in process (and at
  n=2, 4, 8 on ``AbstractMesh``), and at n=4 on real JAX devices through
  a subprocess;
* numbers against JAX, from one 4-device JAX subprocess: the pure
  all-gather (no compute) and the all-to-all bit for bit; the matmul
  builders and the TP chain over 3 layers at ``rtol=atol=1e-5`` (XLA:CPU
  and torch sum float32 matmuls in different orders); every
  ``enqueue_collective`` op on integer-valued data bit for bit, on a
  one-axis mesh and on a (2, 2) mesh over one axis and over both;
* the port's ST programs equal the port's decomposed oracles
  (``CollectiveMatmul.reference``) bit for bit on every engine, trigger
  mode and ring size 1-4, uni- and bidirectional, and the persistent TP
  chain equals that many oracle applications;
* uneven tiles raise ``QueueError``.
"""

import json

import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.core.effects as jeffects
from repro.core import collectives as JC
from repro.core import queue as jqueue
from repro.launch.serve import build_admission_schedule as jadmission
from repro_torch import make_mesh
from repro_torch.core import (
    FusedEngine,
    HostEngine,
    PersistentEngine,
    QueueError,
    STQueue,
    collectives as C,
    overlap,
    program_digest,
    to_numpy,
)
from repro_torch.launch.serve import build_admission_schedule

N_REF = 4  # ranks of the JAX subprocess
TP_SHAPE = (8 * N_REF * N_REF, 4 * N_REF, 4 * N_REF)  # the "tp" builder's (m, k, f)


def _mesh(n=1):
    return make_mesh((n,), ("x",), device="cpu")


def _builders(n):
    """(name, build(mesh, package)) at the registry's shapes for ring n;
    uneven tiles (m = 3 rows a rank, k and f sharing no factor with n)
    for the matmul builders."""
    m, k, f = 8 * n * n, 4 * n, 4 * n
    return [
        ("ag_matmul", lambda mesh, P: P.build_all_gather_matmul(mesh, "x", 3 * n, 7, 5)),
        ("ag_matmul_bidi", lambda mesh, P: P.build_all_gather_matmul(
            mesh, "x", 3 * n, 7, 5, bidirectional=True)),
        ("matmul_rs", lambda mesh, P: P.build_matmul_reduce_scatter(mesh, "x", 3 * n, 4 * n, 5)),
        ("a2a", lambda mesh, P: P.build_all_to_all(mesh, "x", m, 3)),
        ("tp", lambda mesh, P: P.build_tp_block(mesh, "x", m, k, f)),
        ("tp_chain_bidi", lambda mesh, P: P.build_tp_block(
            mesh, "x", m, k, f, chain=True, bidirectional=True)),
    ]


def _gather_only(mesh, queue_cls, m=8, k=3):
    """A pure ring all-gather (no compute): x row-sharded, out replicated."""
    q = queue_cls(mesh, "gather")
    q.buffer("x", (m, k), np.float32, pspec=("x",))
    q.buffer("out", (m, k), np.float32, pspec=())
    q.enqueue_all_gather("x", "out", "x")
    return q.build()


# enqueue_collective cases: (name, mesh shape, axes, buffers {name: (shape, pspec)},
# op, buf, out, coll axis, kwargs)
_X, _AB = ((N_REF,), ("x",)), ((2, 2), ("a", "b"))
COLL_CASES = [
    ("ag_dim0", *_X, {"b": ((8, 3), ("x",)), "o": ((32, 3), ("x",))},
     "all_gather", "x", {"dim": 0}),
    ("ag_dim1", *_X, {"b": ((8, 3), ("x",)), "o": ((8, 12), ("x",))},
     "all_gather", "x", {"dim": 1}),
    ("ag_untiled", *_X, {"b": ((8, 3), ("x",)), "o": ((16, 2, 3), ("x",))},
     "all_gather", "x", {"dim": 0, "tiled": False}),
    ("rs_dim0", *_X, {"b": ((32, 3), ("x",)), "o": ((8, 3), ("x",))},
     "reduce_scatter", "x", {"dim": 0}),
    ("rs_dim1", *_X, {"b": ((8, 8), ("x",)), "o": ((8, 2), ("x",))},
     "reduce_scatter", "x", {"dim": 1}),
    ("allreduce_replicated", *_X, {"b": ((8, 3), ("x",)), "o": ((2, 3), ())},
     "all_reduce", "x", {}),
    ("a2a_tiled", *_X, {"b": ((32, 3), ("x",)), "o": ((32, 3), ("x",))},
     "all_to_all", "x", {"split_axis": 0, "concat_axis": 0}),
    ("a2a_split1", *_X, {"b": ((8, 8), ("x",)), "o": ((32, 2), ("x",))},
     "all_to_all", "x", {"split_axis": 1, "concat_axis": 0}),
    ("ppermute_partial", *_X, {"b": ((8, 3), ("x",)), "o": ((8, 3), ("x",))},
     "ppermute", "x", {"perm": [(0, 1), (1, 2), (2, 0)]}),
    ("allreduce_over_b", *_AB, {"b": ((8, 3), ("a",)), "o": ((8, 3), ("a",))},
     "all_reduce", "b", {}),
    ("ag_over_ab", *_AB, {"b": ((8, 3), (("a", "b"),)), "o": ((32, 3), (("a", "b"),))},
     "all_gather", ("a", "b"), {"dim": 0}),
    ("rs_over_a", *_AB, {"b": ((8, 4), (None, "b")), "o": ((8, 4), ("a", "b"))},
     "reduce_scatter", "a", {"dim": 0}),
]


def _coll_program(case, mesh, queue_cls):
    name, _, _, bufs, op, axis, kw = case
    q = queue_cls(mesh, name)
    for b, (shape, pspec) in bufs.items():
        q.buffer(b, shape, np.float32, pspec=pspec)
    q.enqueue_collective(op, "b", "o", axis, **kw)
    q.enqueue_start()
    q.enqueue_wait()
    return q.build()


def _coll_input(case):
    shape = case[3]["b"][0]
    rng = np.random.RandomState(sum(map(ord, case[0])))
    return rng.randint(-8, 8, size=shape).astype(np.float32)  # sums stay exact


def _inputs(cm, seed=0):
    """Seeded inputs of a builder (weights scaled by 1/sqrt(fan-in))."""
    rng = np.random.RandomState(seed)
    out = {}
    for b in cm.inputs:
        shape = cm.program.buffers[b].shape
        a = rng.randn(*shape).astype(np.float32)
        out[b] = a / np.sqrt(shape[0]) if b.startswith("w") else a
    return out


# -- build layer ---------------------------------------------------------------


def _build_sig(prog, digest):
    return digest(prog), {int(k): tuple(v) for k, v in prog.collective_counts().items()}


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_builders_digests_and_counts_equal_reference(n):
    for name, build in _builders(n):
        got = _build_sig(build(_mesh(n), C).program, program_digest)
        want = _build_sig(build(AbstractMesh((n,), ("x",)), JC).program,
                          jeffects.program_digest)
        assert got == want, name
    assert _build_sig(_gather_only(_mesh(n), C.CollectiveQueue), program_digest) == \
        _build_sig(_gather_only(AbstractMesh((n,), ("x",)), JC.CollectiveQueue),
                   jeffects.program_digest)


@pytest.mark.parametrize("n,slots", [(1, 4), (4, 4), (8, 1)])
def test_admission_schedule_digest_and_counts_equal_reference(n, slots):
    got = build_admission_schedule(_mesh(n), slots=slots)
    want = jadmission(AbstractMesh((n,), ("x",)), slots=slots)
    assert _build_sig(got, program_digest) == _build_sig(want, jeffects.program_digest)
    assert [(d.pid, type(d).__name__) for d in got.descriptors] == \
        [(d.pid, type(d).__name__) for d in want.descriptors]


@pytest.mark.parametrize("case", COLL_CASES, ids=[c[0] for c in COLL_CASES])
def test_enqueue_collective_digest_and_counts_equal_reference(case):
    mesh = make_mesh(case[1], case[2], device="cpu")
    got = _coll_program(case, mesh, STQueue)
    want = _coll_program(case, AbstractMesh(case[1], case[2]), jqueue.STQueue)
    assert _build_sig(got, program_digest) == _build_sig(want, jeffects.program_digest)
    assert got.dispatch_count_host() == want.dispatch_count_host() == 1
    assert got.batches[0].colls[0].op == case[4]


def test_enqueue_collective_errors():
    q = STQueue(_mesh(), "bad")
    q.buffer("b", (1, 2), np.float32, pspec=("x",))
    with pytest.raises(QueueError, match="unknown collective"):
        q.enqueue_collective("gather", "b", "b", "x")
    with pytest.raises(QueueError, match="undeclared"):
        q.enqueue_collective("all_reduce", "b", "nope", "x")
    q.enqueue_collective("all_reduce", "b", "b", "x")
    from repro_torch.core import MatchError
    with pytest.raises(MatchError, match="ST004"):
        q.build()  # a collective no start covers never fires


def test_uneven_tiles_raise():
    mesh = _mesh(8)
    for bad in (lambda: C.build_all_gather_matmul(mesh, "x", 20, 4, 4),
                lambda: C.build_matmul_reduce_scatter(mesh, "x", 20, 4, 4),
                lambda: C.build_all_to_all(mesh, "x", 96, 4),  # % 64 != 0
                lambda: C.build_tp_block(mesh, "x", 16, 4, 12)):
        with pytest.raises(QueueError):
            bad()
    q = C.CollectiveQueue(mesh, "rot")
    q.buffer("x", (16, 2), np.float32, pspec=(None, "x"))
    q.buffer("o", (16, 2), np.float32, pspec=())
    with pytest.raises(QueueError, match="must shard dim 0"):
        q.enqueue_all_gather("x", "o", "x")


# -- numbers: ST program == decomposed oracle, bit for bit ---------------------


def _engines(prog):
    yield "fused_stream", FusedEngine(prog)
    yield "fused_dataflow", FusedEngine(prog, mode="dataflow")
    yield "fused_uncoalesced", FusedEngine(prog, mode="dataflow", coalesce=False)
    yield "host", HostEngine(prog)
    yield "persistent_dataflow", PersistentEngine(prog, mode="dataflow")


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_st_programs_equal_decomposed_oracles(n):
    mesh = _mesh(n)
    for name, build in _builders(n):
        cm = build(mesh, C)
        inputs = _inputs(cm, seed=n)
        want = cm.reference(*(inputs[b] for b in cm.inputs))
        assert torch.isfinite(want).all()
        for ename, eng in _engines(cm.program):
            got = eng(eng.init_buffers(inputs))[cm.output]
            assert eng.stats.dispatches == (cm.program.dispatch_count_host()
                                            if ename == "host" else 1)
            assert torch.equal(got, want), f"{name} {ename} n={n}"
        stock = cm.reference_stock(*(inputs[b] for b in cm.inputs))
        torch.testing.assert_close(want, stock, rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("mode", ["stream", "dataflow"])
def test_persistent_tp_chain_equals_oracle_layers(n, mode):
    cm = C.build_tp_block(_mesh(n), "x", 8 * n, 4 * n, 4 * n, chain=True)
    inputs = _inputs(cm, seed=7)
    eng = PersistentEngine(cm.program.persistent(4), mode=mode, donate=True)
    got = eng(eng.init_buffers(inputs))["out"]
    assert eng.stats.dispatches == 1
    want = torch.as_tensor(inputs["x"])
    for _ in range(4):
        want = cm.reference(want, inputs["w1"], inputs["w2"])
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)


def test_oracles_keep_stacked_layouts():
    """The decomposed oracles on stacked blocks equal the plain global
    composition (copies bit for bit)."""
    mesh = _mesh(4)
    rng = np.random.RandomState(3)
    x = torch.as_tensor(rng.randn(4, 2, 3).astype(np.float32))  # 4 ranks x (2, 3)
    full = x.reshape(8, 3)
    for bidi in (False, True):
        got = overlap.all_gather_ring(x, mesh, "x", bidirectional=bidi)
        assert torch.equal(got, full.expand(4, 8, 3))
    got = overlap.all_to_all_ppermute(torch.arange(4 * 8 * 1.).reshape(4, 8, 1), mesh, "x")
    assert torch.equal(got[1, :2, 0], torch.tensor([2., 3.]))  # rank 0's block 1
    parts = torch.as_tensor(rng.randint(-4, 4, size=(4, 8, 3)).astype(np.float32))
    rs = overlap.reduce_scatter_ring(parts, mesh, "x")
    assert torch.equal(rs.reshape(8, 3), parts.sum(0))
    assert torch.equal(overlap.axis_index(make_mesh((2, 3), ("a", "b"), device="cpu"), "b"),
                       torch.tensor([0, 1, 2, 0, 1, 2]))
    calls = []
    wrapped = overlap.triggered(lambda v: v * 2.0, None)
    assert torch.equal(wrapped(torch.ones(2)), torch.full((2,), 2.0))
    token = type("Token", (), {"wait": lambda self: calls.append(1)})()
    overlap.triggered(lambda v: v, token)(torch.ones(1))
    assert calls == [1]


# -- numbers: the port against the JAX package on 4 JAX devices ----------------


_REF_SCRIPT = """
import json, numpy as np
from repro.core import collectives as C
from repro.core.engine_fused import FusedEngine
from repro.core.engine_persistent import PersistentEngine
from repro.core.queue import STQueue
from repro.core.effects import program_digest
from repro.parallel import make_mesh
import tests.test_torch_collectives as T

inp = dict(np.load({inp!r}))
mesh = make_mesh((4,), ("x",))
out, sig = {{}}, {{}}

def run(name, prog, inputs, n=None):
    eng = FusedEngine(prog, mode="dataflow") if n is None else \\
        PersistentEngine(prog.persistent(n), donate=True)
    got = eng(eng.init_buffers(inputs))
    sig[name] = (program_digest(prog),
                 {{str(k): v for k, v in prog.collective_counts().items()}})
    return got

g = T._gather_only(mesh, C.CollectiveQueue)
out["gather"] = np.asarray(run("gather", g, {{"x": inp["gather/x"]}})["out"])
for name, build in T._builders(4):
    cm = build(mesh, C)
    args = {{b: inp[name + "/" + b] for b in cm.inputs}}
    out[name] = np.asarray(run(name, cm.program, args)[cm.output])
cm = C.build_tp_block(mesh, "x", *T.TP_SHAPE, chain=True)
args = {{b: inp["tp/" + b] for b in cm.inputs}}
out["chain3"] = np.asarray(run("chain3", cm.program, args, n=3)["out"])
for case in T.COLL_CASES:
    prog = T._coll_program(case, make_mesh(case[1], case[2]), STQueue)
    out["coll/" + case[0]] = np.asarray(run("coll/" + case[0], prog,
                                            {{"b": inp["coll/" + case[0]]}})["o"])
from repro.launch.serve import build_admission_schedule
adm = build_admission_schedule(mesh)
sig["admission"] = (program_digest(adm),
                    {{str(k): v for k, v in adm.collective_counts().items()}})
import jax
q = STQueue(mesh, "replicated")
q.buffer("r", (2, 3), np.float32, pspec=())
q.enqueue_kernel(lambda r: r + jax.lax.axis_index("x").astype(r.dtype), ["r"], ["r"])
rep = run("replicated", q.build(), {{"r": inp["replicated/r"]}})["r"]
out["replicated"] = np.asarray(rep)
out["replicated_shards"] = np.stack([np.asarray(sh.data) for sh in
                                     sorted(rep.addressable_shards, key=lambda sh: sh.device.id)])
np.savez({res!r}, **out)
json.dump(sig, open({sig!r}, "w"))
"""


@pytest.fixture(scope="module")
def jax_runs(subproc, tmp_path_factory):
    """Every program of this file's JAX cases, run on 4 JAX devices."""
    d = tmp_path_factory.mktemp("coll")
    mesh = _mesh(N_REF)
    inp = {"gather/x": np.random.RandomState(11).randn(8, 3).astype(np.float32)}
    for name, build in _builders(N_REF):
        cm = build(mesh, C)
        inp.update({f"{name}/{b}": a for b, a in _inputs(cm, seed=5).items()})
    for case in COLL_CASES:
        inp[f"coll/{case[0]}"] = _coll_input(case)
    inp["replicated/r"] = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.savez(d / "inp.npz", **inp)
    import os
    code = _REF_SCRIPT.format(inp=str(d / "inp.npz"), res=str(d / "res.npz"),
                              sig=str(d / "sig.json"))
    code = f"import sys; sys.path.insert(0, {os.path.dirname(os.path.dirname(__file__))!r})\n" + code
    r = subproc(code, devices=N_REF)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    return inp, dict(np.load(d / "res.npz")), json.load(open(d / "sig.json"))


def test_builders_against_jax_on_four_ranks(jax_runs):
    inp, res, sig = jax_runs
    mesh = _mesh(N_REF)
    g = _gather_only(mesh, C.CollectiveQueue)
    for ename, eng in _engines(g):
        got = to_numpy(eng(eng.init_buffers({"x": inp["gather/x"]})))["out"]
        np.testing.assert_array_equal(got, res["gather"], err_msg=ename)
    assert [program_digest(g), {str(k): list(v) for k, v in g.collective_counts().items()}] \
        == sig["gather"]
    for name, build in _builders(N_REF):
        cm = build(mesh, C)
        args = {b: inp[f"{name}/{b}"] for b in cm.inputs}
        assert [program_digest(cm.program),
                {str(k): list(v) for k, v in cm.program.collective_counts().items()}] \
            == sig[name], name
        for ename, eng in _engines(cm.program):
            got = to_numpy(eng(eng.init_buffers(args)))[cm.output]
            if name == "a2a":  # pure copies
                np.testing.assert_array_equal(got, res[name], err_msg=f"{name} {ename}")
            else:
                np.testing.assert_allclose(got, res[name], rtol=1e-5, atol=1e-5,
                                           err_msg=f"{name} {ename}")


def test_tp_chain_against_jax_on_four_ranks(jax_runs):
    inp, res, sig = jax_runs
    cm = C.build_tp_block(_mesh(N_REF), "x", *TP_SHAPE, chain=True)
    args = {b: inp[f"tp/{b}"] for b in cm.inputs}
    for mode in ("stream", "dataflow"):
        eng = PersistentEngine(cm.program.persistent(3), mode=mode, donate=True)
        got = to_numpy(eng(eng.init_buffers(args)))["out"]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, res["chain3"], rtol=1e-5, atol=1e-5, err_msg=mode)
    assert program_digest(cm.program) == sig["chain3"][0]


def test_admission_schedule_against_jax_on_four_ranks(jax_runs):
    inp, res, sig = jax_runs
    adm = build_admission_schedule(_mesh(N_REF))
    assert [program_digest(adm), {str(k): list(v) for k, v in adm.collective_counts().items()}] \
        == sig["admission"]
    p = np.random.RandomState(5).randn(16, 8).astype(np.float32)
    for ename, eng in _engines(adm):
        got = eng(eng.init_buffers({"prefill/prompt": p}))
        torch.testing.assert_close(got["decode/tok"], torch.cumsum(torch.tanh(
            torch.as_tensor(p)), dim=-1), rtol=0, atol=0, msg=ename)


@pytest.mark.parametrize("case", COLL_CASES, ids=[c[0] for c in COLL_CASES])
def test_enqueue_collective_against_jax_lax(jax_runs, case):
    """Each op, as ``jax.lax`` computes it on four devices, bit for bit
    on every engine (integer-valued data: sums are exact)."""
    inp, res, sig = jax_runs
    prog = _coll_program(case, make_mesh(case[1], case[2], device="cpu"), STQueue)
    assert [program_digest(prog),
            {str(k): list(v) for k, v in prog.collective_counts().items()}] \
        == sig[f"coll/{case[0]}"]
    for ename, eng in _engines(prog):
        got = to_numpy(eng(eng.init_buffers({"b": inp[f"coll/{case[0]}"]})))["o"]
        np.testing.assert_array_equal(got, res[f"coll/{case[0]}"], err_msg=ename)


def test_replicated_buffer_returns_rank_zeros_copy(jax_runs):
    """A replicated buffer whose ranks hold different values: the JAX
    engine's global array (``np.asarray``) is device 0's copy, and so is
    the port's; the port keeps every rank's copy inside."""
    inp, res, sig = jax_runs
    shards = res["replicated_shards"]
    assert not np.array_equal(shards[0], shards[1])  # the copies really differ
    np.testing.assert_array_equal(res["replicated"], shards[0])
    mesh = _mesh(N_REF)
    q = C.CollectiveQueue(mesh, "replicated")
    q.buffer("r", (2, 3), np.float32, pspec=())
    idx = overlap.axis_index(mesh, "x")
    q.enqueue_blocks(lambda r: r + idx[:, None, None].to(r.dtype), reads=("r",),
                     writes=("r",), name="kernel")
    prog = q.build()
    assert program_digest(prog) == sig["replicated"][0]
    for ename, eng in _engines(prog):
        got = to_numpy(eng(eng.init_buffers({"r": inp["replicated/r"]})))["r"]
        np.testing.assert_array_equal(got, res["replicated"], err_msg=ename)
    eng = FusedEngine(prog)
    eng(eng.init_buffers({"r": inp["replicated/r"]}))
    np.testing.assert_array_equal(eng._bufs["r"].numpy(), shards)


LAYOUTS = [((4,), ("x",), (8, 3), ("x",)), ((4,), ("x",), (3, 8), (None, "x")),
           ((4,), ("x",), (5, 6), ()), ((4,), ("x",), (4, 3), ("x", None)),
           ((2, 3), ("a", "b"), (4, 9), ("a", "b")), ((2, 3), ("a", "b"), (12, 2), (("b", "a"),)),
           ((2, 3), ("a", "b"), (4, 5), ("a",)), ((2, 3), ("a", "b"), (2, 3, 5), ("a", "b"))]


@pytest.mark.parametrize("mshape,axes,shape,pspec", LAYOUTS)
def test_storage_layouts_hold_each_ranks_block(mshape, axes, shape, pspec):
    """Stored = rank-major global tensor, or the stack of the rank-local
    blocks (rank r's block at coordinates r over the mesh, a dim sharded
    over several axes split major to minor in the entry's order); the
    global layout comes back (rank 0's copy where replicated)."""
    from repro_torch.core.descriptors import BufferSpec
    from repro_torch.core.state import is_rank_major, local_shape, to_global, to_storage
    mesh = make_mesh(mshape, axes, device="cpu")
    spec = BufferSpec("b", shape, torch.float32, pspec)
    g = torch.arange(float(np.prod(shape))).reshape(shape)
    st = to_storage(spec, mesh, g)
    assert torch.equal(to_global(spec, mesh, st), g)
    if is_rank_major(spec, mesh):
        assert st.shape == g.shape
        return
    loc = local_shape(spec, mesh)
    assert st.shape == (mesh.size, *loc)
    for r, coord in enumerate(np.ndindex(*mshape)):
        at = dict(zip(axes, coord))
        index = []
        for d, entry in enumerate(tuple(pspec) + (None,) * (len(shape) - len(pspec))):
            names = () if entry is None else (entry,) if isinstance(entry, str) else entry
            block = 0
            for a in names:
                block = block * mesh.shape[a] + at[a]
            index.append(slice(block * loc[d], (block + 1) * loc[d]))
        assert torch.equal(st[r], g[tuple(index)]), (r, coord)
