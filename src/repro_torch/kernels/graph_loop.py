"""Device-resident convergence loop: a CUDA-graph conditional WHILE node
whose body is two captured passes, and the step kernel that sets it.

The hand-written ``csrc/graph_loop.cu`` (built for ``sm_90a`` at first
use by :mod:`.build`) takes the place of the ``jax.lax.while_loop`` of
``_run_persistent_while`` (``src/repro/core/engine_persistent.py:495``);
the reference has no Pallas kernel there.  No PyTorch call sets a graph
conditional from the device, so the loop needs this one.

:class:`GraphLoop` builds the graph around passes that PyTorch captured
(``torch.cuda.CUDAGraph(keep_graph=True)``) and launches it once on the
current stream.  A trip runs pass A, the step kernel, and then, if the
loop goes on, pass B under an IF node and the step again; the step does
``reductions[n_done] = red; n_done += 1`` and the loop goes on while
``keep and n_done < max_iters`` (:func:`step_plain` is its plain
version, which the CPU loop runs).  ``n_done`` and ``reductions`` are
reset by memset nodes at the start of every launch.  After the loop the
last pass was A's (``n_done`` odd) or B's (even), and an IF node runs
the select graph of that parity, which puts the last pass's results
where the caller reads them (the source draws the graph).

The graph needs CUDA 12.4 or later, both at build and installed;
without it building the graph raises.  ``GraphLoop.launches`` counts the step kernels
built into graphs, two a loop (a graphed launch counts once, when it
is recorded, as the other kernels' counters do).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch

from .build import check_launch, load_library, stream_arg

_P, _I = ctypes.c_void_p, ctypes.c_int
_INVALID_VALUE = 1  # cudaErrorInvalidValue
#: the C entry points of ``csrc/graph_loop.cu`` and their argument types
SIGNATURES = {
    "rt_graph_loop_build": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "rt_graph_loop_launch": [_P, _P],
    "rt_graph_loop_destroy": [_P, _P],
    "rt_graph_node_types": [_P, _P, _I],
    "rt_graph_edges": [_P, _P, _I, _P, _P, _I, _P],
}
#: ``cudaGraphNodeType`` values, by name
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty", "wait_event",
              "event_record", "ext_semaphore_signal", "ext_semaphore_wait",
              "mem_alloc", "mem_free", "batch_mem_op", "conditional")
#: node types a conditional body may not hold
NOT_IN_A_BODY = ("host", "wait_event", "event_record", "ext_semaphore_signal",
                 "ext_semaphore_wait", "mem_alloc", "mem_free", "batch_mem_op")


def step_plain(reductions: torch.Tensor, n_done: torch.Tensor, red: torch.Tensor,
               keep, max_iters: int) -> torch.Tensor:
    """The step kernel's plain version: ``reductions[n_done] = red``,
    ``n_done += 1`` (both in place), and the 0-d bool ``keep and n_done
    < max_iters``: whether the loop runs again."""
    reductions.index_copy_(0, n_done.reshape(1).long(), red.reshape(1).to(reductions.dtype))
    n_done.add_(1)
    keep = torch.as_tensor(keep, dtype=torch.bool, device=n_done.device)
    return torch.logical_and(keep.reshape(()), n_done < max_iters)


def _lib():
    return load_library("graph_loop", SIGNATURES)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _raw(graph: torch.cuda.CUDAGraph) -> ctypes.c_void_p:
    return ctypes.c_void_p(graph.raw_cuda_graph())


class GraphLoop:
    """One instantiated loop graph (see the module docstring).

    ``pass_a`` and ``pass_b`` (and the optional ``select_even``,
    ``select_odd``) are captured ``torch.cuda.CUDAGraph(keep_graph=True)``
    objects: each pass must leave its reduction in ``red`` (float32, 0-d)
    and its predicate in ``keep`` (bool, 0-d).  The loop writes
    ``reductions`` (float32, ``max_iters``) and ``n_done`` (int32, 0-d).
    The object keeps every graph and tensor it was given alive for as
    long as the instantiated graph exists.
    """

    launches = 0

    def __init__(self, pass_a, pass_b, red: torch.Tensor, keep: torch.Tensor,
                 reductions: torch.Tensor, n_done: torch.Tensor, max_iters: int,
                 select_even=None, select_odd=None):
        if max_iters < 1:
            raise ValueError(f"max_iters must be >= 1, got {max_iters}")
        device = n_done.device
        if device.type != "cuda":
            raise ValueError(f"the loop graph runs on a CUDA device, got {device}")
        _check(red, "red", torch.float32, (), device)
        _check(keep, "keep", torch.bool, (), device)
        _check(reductions, "reductions", torch.float32, (max_iters,), device)
        _check(n_done, "n_done", torch.int32, (), device)
        self.device = device
        self.max_iters = int(max_iters)
        self._flag = torch.zeros((), dtype=torch.int32, device=device)
        self.passes = tuple(g for g in (pass_a, pass_b, select_even, select_odd)
                            if g is not None)
        self._held = (red, keep, reductions, n_done)
        out = (ctypes.c_void_p * 2)()
        raw = [ctypes.c_void_p(None) if g is None else _raw(g)
               for g in (pass_a, pass_b, select_even, select_odd)]
        check_launch("graph_loop", _lib().rt_graph_loop_build(
            *raw, ctypes.c_void_p(red.data_ptr()), ctypes.c_void_p(keep.data_ptr()),
            ctypes.c_void_p(reductions.data_ptr()), ctypes.c_void_p(n_done.data_ptr()),
            ctypes.c_void_p(self._flag.data_ptr()), self.max_iters, out))
        self._graph, self._exec = out[0], out[1]
        GraphLoop.launches += 2
        self.graph_launches = 0

    def launch(self) -> None:
        """Launch the loop once on the current stream (no host sync)."""
        check_launch("graph_loop", _lib().rt_graph_loop_launch(
            ctypes.c_void_p(self._exec), stream_arg(self._flag)))
        self.graph_launches += 1

    def __del__(self):
        graph, exec_ = getattr(self, "_graph", None), getattr(self, "_exec", None)
        if graph is not None or exec_ is not None:
            try:
                _lib().rt_graph_loop_destroy(ctypes.c_void_p(graph), ctypes.c_void_p(exec_))
            except Exception:
                pass  # interpreter shutdown: CUDA frees it with the context


def node_types(graph: torch.cuda.CUDAGraph) -> Dict[str, int]:
    """Nodes of a captured graph (``keep_graph=True``) by type, child
    graphs included: what a conditional body would hold."""
    counts = (ctypes.c_int * 32)()
    check_launch("graph_loop", _lib().rt_graph_node_types(_raw(graph), counts, 32))
    return {NODE_TYPES[t] if t < len(NODE_TYPES) else f"type{t}": counts[t]
            for t in range(32) if counts[t]}


def graph_edges(graph: torch.cuda.CUDAGraph) -> Tuple[List[str], List[Tuple[int, int]]]:
    """The top-level nodes of a captured graph (``keep_graph=True``) by
    type, and its dependency edges as ``(from, to)`` node indices."""
    lib = _lib()
    sizes = (ctypes.c_int * 2)()
    code = lib.rt_graph_edges(_raw(graph), None, 0, None, None, 0, sizes)
    if code and code != _INVALID_VALUE:
        check_launch("graph_loop", code)
    n, m = max(sizes[0], 1), max(sizes[1], 1)
    types, a, b = (ctypes.c_int * n)(), (ctypes.c_int * m)(), (ctypes.c_int * m)()
    check_launch("graph_loop", lib.rt_graph_edges(_raw(graph), types, n, a, b, m, sizes))
    names = [NODE_TYPES[t] if t < len(NODE_TYPES) else f"type{t}"
             for t in types[:sizes[0]]]
    return names, list(zip(a[:sizes[1]], b[:sizes[1]]))


def dag_width(n_nodes: int, edges: Sequence[Tuple[int, int]], keep: Sequence[int]) -> int:
    """The most nodes of ``keep`` that no path of the DAG orders pairwise
    (a largest antichain): by Dilworth's theorem, ``len(keep)`` less a
    maximum matching of the reachability relation among them.  A graph
    captured from one stream has width 1; from N streams, at most N."""
    succ: List[List[int]] = [[] for _ in range(n_nodes)]
    indeg = [0] * n_nodes
    for a, b in edges:
        succ[a].append(b)
        indeg[b] += 1
    order = [v for v in range(n_nodes) if indeg[v] == 0]
    for v in order:
        for w in succ[v]:
            indeg[w] -= 1
            if indeg[w] == 0:
                order.append(w)
    if len(order) != n_nodes:
        raise ValueError("the graph has a cycle")
    reach = [0] * n_nodes  # bit j set: a path leads from the node to node j
    for v in reversed(order):
        for w in succ[v]:
            reach[v] |= reach[w] | (1 << w)
    keep = list(keep)
    # adj[i] bit j: keep[i] reaches keep[j] (the bipartite graph to match)
    adj = [sum(1 << j for j, w in enumerate(keep) if (reach[v] >> w) & 1) for v in keep]
    return len(keep) - _max_matching(adj)


def _max_matching(adj: List[int]) -> int:
    """Size of a maximum matching of the bipartite graph whose left node i
    has the right nodes of bitset ``adj[i]``: augmenting paths found
    breadth first, one search per left node (Kuhn's algorithm)."""
    match_right: Dict[int, int] = {}  # right node -> its left node
    match_left: Dict[int, int] = {}  # and back
    size = 0
    for root in range(len(adj)):
        parent: Dict[int, int] = {}  # right node -> left node it was reached from
        seen, frontier, end = 0, [root], None
        while frontier and end is None:
            nxt = []
            for u in frontier:
                fresh = adj[u] & ~seen
                seen |= fresh
                while fresh:
                    j = (fresh & -fresh).bit_length() - 1
                    fresh &= fresh - 1
                    parent[j] = u
                    if j not in match_right:
                        end = j
                        break
                    nxt.append(match_right[j])
                if end is not None:
                    break
            frontier = nxt
        if end is None:
            continue
        while end is not None:  # flip the path: each left node takes its right node
            u = parent[end]
            prev = match_left.get(u)
            match_right[end], match_left[u] = u, end
            end = prev
        size += 1
    return size


def launch_counts() -> Dict[str, int]:
    """Step kernels built into loop graphs since the last reset."""
    return {"graph_loop_step": GraphLoop.launches}


def reset_launches() -> None:
    GraphLoop.launches = 0


def capture(fn):
    """Capture ``fn()`` into a ``CUDAGraph(keep_graph=True)``; returns
    ``(graph, fn's result)``.  The graph is never replayed by PyTorch:
    :class:`GraphLoop` clones it into its own."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        result = fn()
    return graph, result


def trace_loop(trace: torch.Tensor, tol: float, max_iters: int):
    """A loop whose passes replay a known reduction trace (CUDA, float32,
    at least ``max_iters`` long) instead of running a program: iteration
    i leaves ``trace[i]`` and ``trace[i] >= tol``.  Pass A also writes the
    iteration's index into a slot ``a``, pass B into ``b``, and the
    selects copy ``b`` (``n_done`` even) or ``a`` (odd) into ``last``, so
    after a launch ``last == n_done - 1`` whatever the parity.  Returns
    ``(loop, reductions, n_done, last)``; what the step kernel is held
    against :func:`trace_plain` with."""
    dev = trace.device
    red = torch.zeros((), dtype=torch.float32, device=dev)
    keep = torch.zeros((), dtype=torch.bool, device=dev)
    reductions = torch.zeros(max_iters, dtype=torch.float32, device=dev)
    n_done, a, b, last = (torch.zeros((), dtype=torch.int32, device=dev) for _ in range(4))

    def feed(slot):
        red.copy_(trace.index_select(0, n_done.reshape(1).long()).reshape(()))
        keep.copy_(red >= tol)
        slot.copy_(n_done)

    feed(a)
    torch.cuda.synchronize(dev)
    pass_a, _ = capture(lambda: feed(a))
    pass_b, _ = capture(lambda: feed(b))
    select_even, _ = capture(lambda: last.copy_(b))
    select_odd, _ = capture(lambda: last.copy_(a))
    loop = GraphLoop(pass_a, pass_b, red, keep, reductions, n_done, max_iters,
                     select_even=select_even, select_odd=select_odd)
    loop.inputs = (trace, a, b, last)  # the passes read and write them
    return loop, reductions, n_done, last


def trace_plain(trace: torch.Tensor, tol: float, max_iters: int):
    """:func:`trace_loop`'s loop with the plain step, eagerly on the CPU:
    ``(reductions, n_done)``."""
    trace = trace.cpu()
    reductions = torch.zeros(max_iters, dtype=torch.float32)
    n_done = torch.zeros((), dtype=torch.int32)
    keep = True
    while keep:
        r = trace[int(n_done)]
        keep = bool(step_plain(reductions, n_done, r, r >= tol, max_iters))
    return reductions, n_done
