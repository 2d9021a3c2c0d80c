"""The port stands alone: no JAX, no ``repro``, entry points on the card."""

import ast
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch import make_mesh
from repro_torch.core.descriptors import GridOffsetPeer, OffsetPeer, perm_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def _port_sources():
    for root, _, files in os.walk(PORT):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imported(path: str):
    """Every absolute module name ``path`` imports, at any depth."""
    for node in ast.walk(ast.parse(open(path).read(), filename=path)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_import_leaves_out_jax_and_repro(subproc):
    code = ("import sys, repro_torch, repro_torch.core, "
            "repro_torch.kernels.halo_pack, repro_torch.kernels.build, "
            "repro_torch.kernels.ssd_scan, repro_torch.kernels.rmsnorm, "
            "repro_torch.kernels.flash_attention, repro_torch.kernels.ops, "
            "repro_torch.kernels.embedding, "
            "repro_torch.configs, "
            "repro_torch.models, repro_torch.models.convert, repro_torch.models.frontends, "
            "repro_torch.launch.serve, repro_torch.launch.costing, "
            "repro_torch.launch.tune, repro_torch.core.overlap, "
            "repro_torch.core.collectives, repro_torch.analysis, "
            "repro_torch.analysis.programs, repro_torch.optim, repro_torch.data, "
            "repro_torch.checkpoint, repro_torch.launch.steps, repro_torch.launch.train, "
            "repro_torch.parallel, repro_torch.launch.mesh, repro_torch.launch.dryrun, "
            "repro_torch.launch.trace_analysis\n"
            "assert 'jax' not in sys.modules\n"
            "assert not any(m == 'repro' or m.startswith('repro.') "
            "for m in sys.modules), sorted(sys.modules)\n")
    proc = subproc(code, devices=1, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("path", list(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_no_jax_or_repro(path):
    bad = [m for m in _imported(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", list(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_import_torch_numpy_and_the_standard_library(path):
    """The port's stated dependencies: nothing else (no scipy, which only
    JAX brings along) may reach the card's machine."""
    allowed = {"torch", "numpy", "repro_torch", *sys.stdlib_module_names}
    bad = [m for m in _imported(path) if m.split(".")[0] not in allowed]
    assert not bad, f"{path} imports {bad}"


def _calls(path: str):
    """``(dotted callee, enclosing function, call)`` of every call in ``path``."""
    tree = ast.parse(open(path).read(), filename=path)

    def walk(node, fn):
        for child in ast.iter_child_nodes(node):
            inner = child.name if isinstance(child, (ast.FunctionDef,
                                                     ast.AsyncFunctionDef)) else fn
            if isinstance(child, ast.Call):
                yield ast.unparse(child.func), fn, child
            yield from walk(child, inner)

    yield from walk(tree, None)


def test_every_capture_goes_through_the_guarded_helper():
    """Every CUDA-graph capture of the port is ``graph_loop.capture``'s,
    which turns Python's cyclic collector off while it captures
    (``ROADMAP.md`` §3, fault 4)."""
    sites = [(os.path.relpath(path, PORT), fn) for path in _port_sources()
             if path.startswith(PORT) for name, fn, _ in _calls(path)
             if name in ("torch.cuda.graph", "torch.cuda.CUDAGraph")]
    assert sites == [("kernels/graph_loop.py", "capture")] * 2, sites


def test_nothing_turns_deterministic_mode_on():
    """No module of the port and no phase of ``chip_smoke.py`` turns
    ``torch.use_deterministic_algorithms`` on: no training step needs it."""
    on = [(path, call.lineno) for path in _port_sources() for name, _, call in _calls(path)
          if name.endswith("use_deterministic_algorithms")
          and not (call.args and isinstance(call.args[0], ast.Constant)
                   and call.args[0].value is False)]
    assert not on, on


def test_make_mesh_defaults_to_cuda():
    if torch.cuda.is_available():
        assert make_mesh((1, 1, 1), ("gx", "gy", "gz")).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_mesh((1, 1, 1), ("gx", "gy", "gz"))


def test_make_mesh_validates_shape():
    with pytest.raises(ValueError):
        make_mesh((2, 2), ("gx", "gy", "gz"), device="cpu")
    with pytest.raises(ValueError):
        make_mesh((0, 1, 1), ("gx", "gy", "gz"), device="cpu")


@pytest.mark.parametrize("peer", [
    GridOffsetPeer(("gx", "gy", "gz"), (1, -1, 0)),
    GridOffsetPeer(("gx", "gy", "gz"), (-1, 1, 1), periodic=True),
    GridOffsetPeer(("gz", "gx"), (1, 1)),
    OffsetPeer("gy", -1, periodic=True),
])
def test_rank_sources_match_the_peer_permutation(peer):
    """``rank_sources`` is the rank-major form of ``perm_for``: every
    (src, dst) pair of the peer, lifted to whole-mesh ranks."""
    mesh = make_mesh((2, 3, 2), ("gx", "gy", "gz"), device="cpu")
    axes, perm = perm_for(peer, mesh.shape)
    axes = (axes,) if isinstance(axes, str) else axes
    got = mesh.rank_sources(axes, perm)
    dims = [mesh.shape[a] for a in axes]
    want = np.full(mesh.size, -1)
    for coord in np.ndindex(*mesh.axis_sizes):
        for s, d in perm:
            sub = tuple(coord[mesh.axis_names.index(a)] for a in axes)
            if np.ravel_multi_index(sub, dims) != d:
                continue
            src = list(coord)
            for a, c in zip(axes, np.unravel_index(s, dims)):
                src[mesh.axis_names.index(a)] = c
            want[mesh.linear_rank(coord)] = mesh.linear_rank(src)
    np.testing.assert_array_equal(got, want)
    assert sorted(mesh.pairs(peer)) == sorted(perm)
