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

:class:`ScheduleLoop` is the masked multi-queue loop of a composed
schedule (the reference's ``_run_schedule_while``): every trip runs
every program's pass, and the schedule step kernel (one warp, a thread
a program; :func:`schedule_step_plain` is its plain version) records
each active program's reduction, counts its pass, decides whether it
goes on, and sets two IF handles a program.  ``snapshot[k]`` fires on
the trip where program k stops, and its graph copies k's buffers aside;
``restore[k]`` fires on every later trip, and its graph copies them
back to where the next pass and the final select read them: what a pass
wrote into a frozen program's buffers is discarded, while its packs
still publish the frozen boundary.  ``ScheduleLoop.launches`` counts
its step kernels as ``GraphLoop.launches`` does.
"""

from __future__ import annotations

import ctypes
import gc
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .build import check_launch, load_library, stream_arg

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_INVALID_VALUE = 1  # cudaErrorInvalidValue
#: the C entry points of ``csrc/graph_loop.cu`` and their argument types
SIGNATURES = {
    "rt_graph_loop_build": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "rt_schedule_loop_build": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                               _I, _U, _U, _U, _P],
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
#: programs a schedule loop takes (a warp: a thread and a mask bit each)
MAX_PROGRAMS = 32


def step_plain(reductions: torch.Tensor, n_done: torch.Tensor, red: torch.Tensor,
               keep, max_iters: int) -> torch.Tensor:
    """The step kernel's plain version: ``reductions[n_done] = red``,
    ``n_done += 1`` (both in place), and the 0-d bool ``keep and n_done
    < max_iters``: whether the loop runs again."""
    reductions.index_copy_(0, n_done.reshape(1).long(), red.reshape(1).to(reductions.dtype))
    n_done.add_(1)
    keep = torch.as_tensor(keep, dtype=torch.bool, device=n_done.device)
    return torch.logical_and(keep.reshape(()), n_done < max_iters)


def schedule_step_plain(reductions: torch.Tensor, n_done: torch.Tensor,
                        active: torch.Tensor, i: torch.Tensor, red: torch.Tensor,
                        pred: torch.Tensor, n_iters: torch.Tensor, reduces: torch.Tensor,
                        untils: torch.Tensor, max_iters: int) -> torch.Tensor:
    """The schedule step kernel's plain version, after a pass of N
    programs, all in place: where ``active[k]`` and program k has a
    reduction (``reduces[k]``), ``reductions[k, i] = red[k]``;
    ``n_done += active``; ``active[k] = active[k] and n_done[k] <
    n_iters[k] and (pred[k] if untils[k])``; ``i += 1``.  Returns the 0-d
    bool ``any(active) and i < max_iters``: whether the loop runs again.
    ``reductions`` float32 (N, max_iters); ``n_done``, ``n_iters`` int32
    (N,); ``active``, ``pred``, ``reduces``, ``untils`` bool (N,); ``red``
    float32 (N,); ``i`` int32 0-d."""
    column = torch.arange(reductions.shape[1], device=reductions.device) == i
    write = column[None, :] & (active & reduces)[:, None]
    reductions.copy_(torch.where(write, red.to(reductions.dtype)[:, None], reductions))
    n_done.add_(active.to(n_done.dtype))
    active.logical_and_(n_done < n_iters).logical_and_(pred | ~untils)
    i.add_(1)
    return torch.logical_and(active.any(), i < max_iters)


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


class _LoopGraph:
    """An instantiated graph of ``csrc/graph_loop.cu``: one launch a call,
    freed with the object."""

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


class GraphLoop(_LoopGraph):
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


class ScheduleLoop(_LoopGraph):
    """One instantiated masked schedule loop (see the module docstring).

    ``pass_a`` and ``pass_b`` are captured passes of all N programs; each
    leaves program k's reduction in ``red[k]`` (float32, (N,)) and its
    predicate in ``pred[k]`` (bool, (N,)).  ``freeze[k]`` is None or the
    four graphs ``(restore_a, snapshot_a, restore_b, snapshot_b)`` of
    program k: after pass A (B), the restore graph runs if k was frozen
    during the pass and the snapshot graph if k stopped after it.  The
    loop writes ``active`` and ``n_done`` (int32, (N,)), ``reductions``
    (float32, (N, max_iters)) and :attr:`iter` (the passes it ran, 0-d
    int32), whose parity picks ``select_even`` or ``select_odd`` after
    the loop.  ``n_iters`` are the programs' counts, ``reduces`` and
    ``untils`` whether each has a reduction and a predicate.  A graph
    holding a node type that a conditional body may not hold raises
    ``ValueError`` before anything is built.
    """

    launches = 0

    def __init__(self, pass_a, pass_b, freeze, red: torch.Tensor, pred: torch.Tensor,
                 active: torch.Tensor, n_done: torch.Tensor, reductions: torch.Tensor,
                 n_iters: Sequence[int], reduces: Sequence[bool], untils: Sequence[bool],
                 max_iters: int, select_even=None, select_odd=None):
        n = len(n_iters)
        if not 1 <= n <= MAX_PROGRAMS:
            raise ValueError(f"a schedule loop takes 1 to {MAX_PROGRAMS} programs, got {n}")
        if not (len(freeze) == len(reduces) == len(untils) == n):
            raise ValueError("freeze, reduces and untils need one entry a program")
        if max_iters < max(n_iters) or min(n_iters) < 1:
            raise ValueError(f"counts {list(n_iters)} must lie in 1..max_iters ({max_iters})")
        device = n_done.device
        if device.type != "cuda":
            raise ValueError(f"the loop graph runs on a CUDA device, got {device}")
        _check(red, "red", torch.float32, (n,), device)
        _check(pred, "pred", torch.bool, (n,), device)
        _check(active, "active", torch.int32, (n,), device)
        _check(n_done, "n_done", torch.int32, (n,), device)
        _check(reductions, "reductions", torch.float32, (n, max_iters), device)
        graphs = [pass_a, pass_b, select_even, select_odd]
        for k, f in enumerate(freeze):
            if f is not None and (len(f) != 4 or any(g is None for g in f)):
                raise ValueError(f"freeze[{k}]: want None or four graphs")
            graphs += list(f or ())
        for g in graphs:
            if g is None:
                continue
            bad = set(node_types(g)) & set(NOT_IN_A_BODY)
            if bad:
                raise ValueError(f"a captured graph holds {sorted(bad)} nodes, which a "
                                 f"conditional body may not hold: {node_types(g)}")
        self.device = device
        self.max_iters = int(max_iters)
        self.iter = torch.zeros((), dtype=torch.int32, device=device)
        self._flag = torch.zeros((), dtype=torch.int32, device=device)
        self.passes = tuple(g for g in graphs if g is not None)
        self.freeze = tuple(freeze)
        self._held = (red, pred, active, n_done, reductions)
        mask = lambda bits: sum(1 << k for k, b in enumerate(bits) if b)
        raw_freeze = (ctypes.c_void_p * (4 * n))(
            *[None if f is None else _raw(g).value for f in freeze for g in (f or (None,) * 4)])
        counts = (ctypes.c_int * n)(*[int(c) for c in n_iters])
        out = (ctypes.c_void_p * 2)()
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())
        check_launch("graph_loop", _lib().rt_schedule_loop_build(
            _raw(pass_a), _raw(pass_b), raw_freeze,
            ctypes.c_void_p(None) if select_even is None else _raw(select_even),
            ctypes.c_void_p(None) if select_odd is None else _raw(select_odd),
            ptr(red), ptr(pred), ptr(active), ptr(n_done), ptr(reductions),
            ptr(self.iter), ptr(self._flag), counts, n, self.max_iters,
            mask(reduces), mask(untils), mask(f is not None for f in freeze), out))
        self._graph, self._exec = out[0], out[1]
        ScheduleLoop.launches += 2
        self.graph_launches = 0


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
    return {"graph_loop_step": GraphLoop.launches, "schedule_step": ScheduleLoop.launches}


def reset_launches() -> None:
    GraphLoop.launches = ScheduleLoop.launches = 0


def capture(fn, *, keep_graph: bool = True, pool=None):
    """Capture ``fn()`` into a ``CUDAGraph(keep_graph=keep_graph)`` on
    the memory ``pool`` (a new one by default); returns ``(graph, fn's
    result)``.  Every CUDA-graph capture of the port goes through here.
    With ``keep_graph`` (the loops' passes) the graph is never replayed by
    PyTorch: :class:`GraphLoop` clones it into its own.  Python's cyclic
    garbage collector is off during the capture: with it on, a full run of
    the card's tests saw a capture invalidated (error 901) at a point the
    earlier tests' garbage decided, as a collection that destroys a CUDA
    object inside a global-mode capture would do; with it off, none."""
    graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
    enabled = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool):
            result = fn()
    finally:
        if enabled:
            gc.enable()
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


def trace_schedule_loop(traces: torch.Tensor, tols: Sequence[Optional[float]],
                        n_iters: Sequence[int], max_iters: int):
    """A schedule loop of N programs whose passes replay known reduction
    traces (CUDA float32, (N, at least max_iters)): on pass i program k
    leaves ``traces[k, i]`` and ``traces[k, i] >= tols[k]`` (no predicate
    where ``tols[k]`` is None) and adds one to a counter ``v[k]``, which
    its freeze graphs keep once it stops: after a launch ``v[k] ==
    n_done[k]`` if the snapshots, restores and parity selects put each
    program's values where they belong.  Returns ``(loop, reductions,
    n_done, v)``; what the schedule step is held against
    :func:`trace_schedule_plain` with."""
    dev = traces.device
    n = len(n_iters)
    red = torch.zeros(n, dtype=torch.float32, device=dev)
    pred = torch.zeros(n, dtype=torch.bool, device=dev)
    active = torch.ones(n, dtype=torch.int32, device=dev)
    n_done = torch.zeros(n, dtype=torch.int32, device=dev)
    reductions = torch.zeros(n, max_iters, dtype=torch.float32, device=dev)
    tol = torch.tensor([float("-inf") if t is None else t for t in tols], device=dev)
    home = [torch.zeros((), dtype=torch.int32, device=dev) for _ in range(n)]
    snaps = [torch.zeros((), dtype=torch.int32, device=dev) for _ in range(n)]
    last = traces.shape[1] - 1

    def feed(values, back=None):
        # an active program has run n_done[k] passes before this one; the
        # step ignores what a frozen program leaves
        red.copy_(traces.gather(1, n_done.long().clamp(max=last)[:, None]).reshape(n))
        pred.copy_(red >= tol)
        out = [v + 1 for v in values]
        for h, o in zip(back or (), out):
            h.copy_(o)
        return out

    feed(home)
    torch.cuda.synchronize(dev)
    pass_a, out_a = capture(lambda: feed(home))
    pass_b, out_b = capture(lambda: feed(out_a, home))
    copies = lambda dst, src: capture(lambda: torch._foreach_copy_(dst, src))[0]
    freeze = [(copies([out_a[k]], [snaps[k]]), copies([snaps[k]], [out_a[k]]),
               copies([home[k]], [snaps[k]]), copies([snaps[k]], [home[k]]))
              for k in range(n)]
    select_odd = copies(home, out_a)
    loop = ScheduleLoop(pass_a, pass_b, freeze, red, pred, active, n_done, reductions,
                        n_iters, [True] * n, [t is not None for t in tols], max_iters,
                        select_odd=select_odd)
    loop.inputs = (traces, tol, home, snaps, out_a, out_b)
    return loop, reductions, n_done, home


def trace_schedule_plain(traces: torch.Tensor, tols: Sequence[Optional[float]],
                         n_iters: Sequence[int], max_iters: int):
    """:func:`trace_schedule_loop`'s loop with the plain step, eagerly on
    the CPU: ``(reductions, n_done)``."""
    traces = traces.cpu()
    n = len(n_iters)
    reductions = torch.zeros(n, max_iters, dtype=torch.float32)
    n_done = torch.zeros(n, dtype=torch.int32)
    active = torch.ones(n, dtype=torch.bool)
    i = torch.zeros((), dtype=torch.int32)
    tol = torch.tensor([float("-inf") if t is None else t for t in tols])
    untils = torch.tensor([t is not None for t in tols])
    keep = True
    while keep:
        red = traces[:, int(i)]
        keep = bool(schedule_step_plain(
            reductions, n_done, active, i, red, red >= tol,
            torch.tensor(list(n_iters), dtype=torch.int32), torch.ones(n, dtype=torch.bool),
            untils, max_iters))
    return reductions, n_done
