"""Build layer of the port against the JAX package, on the same configs,
and the build of the port's CUDA sources.

The JAX package builds the Faces program on an abstract mesh (no
devices needed), so 8-rank grids compare in-process.  Counts, batches,
coalescing plans, effect sets and the program digest must be equal.
The CUDA sources are compiled on the card only; here the source list,
the entry-point table and the content hash of the library names are
checked, without ``nvcc``.
"""

import importlib
import re

import numpy as np
import pytest
from jax.sharding import AbstractMesh

import repro.core.halo as jhalo
from repro.core.effects import program_digest as jax_digest
from repro_torch import make_mesh
from repro_torch.core import (
    GridOffsetPeer,
    MatchError,
    QueueError,
    STQueue,
)
from repro_torch.core import halo as thalo
from repro_torch.core.descriptors import dtype_str
from repro_torch.core.effects import program_digest
from repro_torch.kernels import build

GRIDS = [((1, 1, 1), True), ((2, 2, 2), False), ((8, 1, 1), False)]


def _pair(grid, periodic, granularity, batched, coalesce, points=(4, 3, 5)):
    kw = dict(grid=grid, points=points, periodic=periodic,
              granularity=granularity, batched=batched)
    ref = jhalo.build_faces_program(jhalo.FacesConfig(**kw),
                                    AbstractMesh(grid, jhalo.AXES3),
                                    coalesce=coalesce)
    port = thalo.build_faces_program(
        thalo.FacesConfig(**kw), make_mesh(grid, thalo.AXES3, device="cpu"),
        coalesce=coalesce)
    return ref, port


def _plan_layout(plan, to_str):
    if plan is None:
        return None
    return (tuple((t.axis, t.perm, to_str(t.dtype), t.stage,
                   tuple((s.channel, s.hop, s.offset, s.size)
                         for s in t.segments), t.staging)
                  for t in plan.transfers),
            plan.routes, plan.shapes, plan.n_collectives, plan.dead_channels)


def _effects(batch):
    return tuple((e.buf, e.kind, e.source, e.pid, e.region)
                 for e in batch.effects)


@pytest.mark.parametrize("coalesce", [True, False])
@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("granularity", ["direct26", "staged3"])
@pytest.mark.parametrize("grid,periodic", GRIDS)
def test_faces_build_layer_equals_reference(grid, periodic, granularity,
                                            batched, coalesce):
    ref, port = _pair(grid, periodic, granularity, batched, coalesce)
    assert port.collective_counts() == ref.collective_counts()
    assert port.max_collectives_per_start() == ref.max_collectives_per_start()
    assert port.dispatch_count_host() == ref.dispatch_count_host()
    assert port.is_coalesced == ref.is_coalesced
    assert program_digest(port) == jax_digest(ref)
    assert [type(d).__name__ for d in port.descriptors] == \
        [type(d).__name__ for d in ref.descriptors]
    assert len(port.batches) == len(ref.batches)
    for pb, rb in zip(port.batches, ref.batches):
        assert (pb.index, pb.waited, len(pb.channels)) == \
            (rb.index, rb.waited, len(rb.channels))
        assert [k.name for k in pb.kernels_before] == \
            [k.name for k in rb.kernels_before]
        assert _plan_layout(pb.plan, dtype_str) == \
            _plan_layout(rb.plan, lambda d: np.dtype(d).str)
        assert _effects(pb) == _effects(rb)


def test_direct26_counts_at_eight_ranks():
    _, port = _pair((2, 2, 2), False, "direct26", True, True)
    assert port.collective_counts() == {0: (26, 6)}
    assert port.dispatch_count_host() == 79
    assert (port.dispatch_count_fused(), port.dispatch_count_persistent()) == (1, 1)


def test_digest_sees_structure_not_pack_mode():
    mesh = make_mesh((2, 2, 2), thalo.AXES3, device="cpu")
    base = thalo.FacesConfig(grid=(2, 2, 2), points=(3, 3, 3))
    torch_prog = thalo.build_faces_program(base, mesh)
    kernel_prog = thalo.build_faces_program(
        thalo.FacesConfig(grid=(2, 2, 2), points=(3, 3, 3), pack="kernel"), mesh)
    staged = thalo.build_faces_program(
        thalo.FacesConfig(grid=(2, 2, 2), points=(3, 3, 3),
                          granularity="staged3"), mesh)
    assert program_digest(torch_prog) == program_digest(kernel_prog)
    assert program_digest(torch_prog) != program_digest(staged)


def _queue():
    mesh = make_mesh((2, 1, 1), thalo.AXES3, device="cpu")
    q = STQueue(mesh, name="t")
    q.buffer("a", (2, 1, 1, 3), "float32", pspec=thalo.AXES3)
    q.buffer("b", (2, 1, 1, 3), "float32", pspec=thalo.AXES3)
    return q


def test_unmatched_send_raises():
    q = _queue()
    q.enqueue_send("a", GridOffsetPeer(thalo.AXES3, (1, 0, 0)), tag=0)
    q.enqueue_start()
    with pytest.raises(MatchError, match="unmatched ST send"):
        q.build()


def test_wait_before_start_raises():
    with pytest.raises(QueueError, match="before any enqueue_start"):
        _queue().enqueue_wait()


def test_persistent_guards():
    q = _queue()
    q.enqueue_recv("b", GridOffsetPeer(thalo.AXES3, (-1, 0, 0)), tag=0)
    q.enqueue_send("a", GridOffsetPeer(thalo.AXES3, (1, 0, 0)), tag=0)
    q.enqueue_start()
    prog = q.build()
    with pytest.raises(QueueError, match="non-quiescent"):
        prog.persistent(2)
    # a predicate may always run more than one pass: the guard holds at 1
    with pytest.raises(QueueError, match="non-quiescent"):
        prog.persistent(1, until=lambda r: r > 0)
    assert prog.persistent(1).n_iters == 1


def test_freed_queue_rejects_use():
    q = _queue()
    q.free()
    with pytest.raises(QueueError, match="freed"):
        q.enqueue_start()


def test_every_cuda_source_is_built_and_declared():
    """Every source has a wrapper module of its name that declares the C
    types of exactly the entry points the source exports."""
    names = set(build.sources())
    assert names == {"halo_pack", "ssd_scan", "rmsnorm", "flash_attention", "graph_loop",
                     "embedding"}
    for name in names:
        wrapper = importlib.import_module(f"repro_torch.kernels.{name}")
        text = build.sources()[name].read_text()
        exported = set(re.findall(r"^int (rt_\w+)\(", text, flags=re.M))
        assert exported and set(wrapper.SIGNATURES) == exported
    paths = {build.library_path(n) for n in names}
    assert len(paths) == len(names)
    assert all(p.parent == build.BUILD_DIR for p in paths)


def test_library_name_hashes_its_source(tmp_path, monkeypatch):
    """An edited source gets a new library; an unchanged one is reused
    without calling nvcc."""
    src = tmp_path / "csrc"
    src.mkdir()
    for name, path in build.sources().items():
        (src / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(build, "CSRC", src)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    before = {n: build.library_path(n) for n in build.sources()}
    (src / "ssd_scan.cu").write_text((src / "ssd_scan.cu").read_text() + "\n// edit\n")
    after = {n: build.library_path(n) for n in build.sources()}
    assert after["halo_pack"] == before["halo_pack"]
    assert after["ssd_scan"] != before["ssd_scan"]

    def no_nvcc():
        raise AssertionError("nvcc must not run for a library that exists")

    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    build.BUILD_DIR.mkdir()
    for path in after.values():
        path.touch()
    infos = build.build_all()
    assert {n: i.path for n, i in infos.items()} == after
    assert all(i.seconds is None for i in infos.values())
