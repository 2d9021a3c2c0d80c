"""Persistent ST engine — N iterations, or a convergence loop, in ONE
CUDA-graph launch.

Port of ``repro.core.engine_persistent``.  :class:`~.engine_fused.
FusedEngine` launches one graph per iteration; here the host launches
once and the device runs trigger → exchange → wait → compute until the
iteration count, or a convergence predicate, says stop.

* Every buffer stays on the device across iterations, and the
  trigger/completion counter banks are threaded through the passes, so
  iteration i+1's counters sit above iteration i's (MPIX_Queue reuse).
* ``reduce_fn(mem) -> 0-d tensor`` is evaluated after every iteration
  inside the graph; a call then returns ``(mem, reductions)`` with one
  float32 value per iteration, and no host sync happens in the loop.
* ``double_buffer`` (default: on in ``dataflow`` mode) keeps two
  physical copies of every message slot (:func:`slot_buffers`) and
  rotates them ``(cur, alt)`` between iterations, as the reference's
  carry does; results are unchanged, since a slot's first access in a
  pass is a write.

Convergence (``cond_fn``, or ``STProgram.persistent(n, until=)``): the
loop runs while ``cond_fn(reduction)`` holds, at most ``max_iters``
passes, the first always; a call returns ``(mem, reductions, n_done)``.
On a CPU device that is an eager loop (:func:`_run_persistent_while`).
On the card :meth:`PersistentEngine.compile` captures two passes, A and
B, and builds a CUDA graph whose conditional WHILE node repeats them
(B under an IF node), set by the step kernel of
:mod:`repro_torch.kernels.graph_loop`: the device decides when to stop,
and the host reads nothing until the launch ends.  A pass's addresses
are fixed by its capture, and kernels rebind buffers (the Faces stencil
and damping rebind the field), so pass B reads what pass A left where
A left it and copies the buffers that carry into the next trip back
into the engine's own tensors: one field-sized copy every two passes.
With double buffering B's message slots are a second physical copy.
After the loop the last pass is A's or B's by the parity of
``n_done``, and the device moves that pass's results to where a call
returns them.

``stats.dispatches`` counts one per call, however many iterations it
runs.

A composed :class:`~.schedule.STSchedule` whose programs share one fixed
count runs here as N passes in one graph, each program on its own
stream (:mod:`.engine_fused`), with the streams forked once before the
first pass and joined after the last, so the programs pipeline across
iterations; double-buffered slots (:func:`slot_buffers`) are the
schedule's namespaced message buffers.  Different counts, predicates or
``reduce_fns`` need the reference's masked multi-queue loop, which is
not ported: the constructor raises ``NotImplementedError``.
``sanitize=True`` adds the runtime sanitizer, as in the fused engine.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Set, Tuple

import torch

from ..kernels import graph_loop
from .descriptors import KernelDesc, StartDesc
from .engine_fused import (FusedEngine, Lowering, PassStreams, _interpret_program,
                           fresh_token_banks)
from .queue import STProgram
from .schedule import STSchedule

MASKED_LOOP = ("the masked multi-queue loop (per-program counts, until "
               "predicates, reduce_fns) is not ported yet: see ROADMAP.md, "
               "'Masked schedule loop'")


def slot_buffers(prog: STProgram) -> Tuple[str, ...]:
    """Message-slot buffers safe to double-buffer: touched by a channel,
    and first accessed (in execution order) by a write — a replace
    deposit counts as a write, an add deposit as a read."""
    comm_bufs: Set[str] = set()
    for b in prog.batches:
        for ch in b.channels:
            comm_bufs.add(ch.src_buf)
            comm_bufs.add(ch.dst_buf)

    first_access: Dict[str, str] = {}
    batches = {b.index: b for b in prog.batches}
    for d in prog.descriptors:
        if isinstance(d, KernelDesc):
            for r in d.reads:
                first_access.setdefault(r, "read")
            for w in d.writes:
                first_access.setdefault(w, "write")
        elif isinstance(d, StartDesc):
            batch = batches[d.batch]
            for ch in batch.channels:
                first_access.setdefault(ch.src_buf, "read")
            for ch in batch.channels:
                first_access.setdefault(
                    ch.dst_buf, "read" if ch.mode == "add" else "write")
    return tuple(sorted(b for b in comm_bufs if first_access.get(b) == "write"))


class PersistentEngine(FusedEngine):
    """Run an STProgram for ``n_iters`` iterations, or until a predicate
    fails, as ONE graph launch.

    ``n_iters`` defaults to ``program.n_iters`` (see
    :meth:`~.queue.STProgram.persistent`, whose quiescence guard an
    explicit count or predicate passes too).  Buffers, ``donate=`` and
    ``compile()`` behave as in :class:`~.engine_fused.FusedEngine`.

    ``cond_fn(reduction) -> bool`` (default ``program.until``) makes the
    count dynamic: the loop runs while it holds on the pass's
    ``reduce_fn`` value (required), at most ``max_iters`` passes
    (default ``n_iters`` / ``program.n_iters``; meaningless without a
    predicate), and a call returns ``(mem, reductions, n_done)``:
    ``reductions`` float32 zero-padded to ``max_iters``, ``n_done`` a 0-d
    int32 tensor on the device.  On the card that loop is a graph
    conditional WHILE node; if it cannot be built (CUDA before 12.4),
    :meth:`compile` raises.

    ``unroll`` (>= 1) is checked as the reference checks it; there it
    groups passes of the fixed-count loop for XLA without changing
    numbers.  The fixed-count graph here already holds every pass, as a
    loop unrolled all the way would, and the convergence body holds two
    passes whatever its value, so it changes nothing.

    A composed :class:`~.schedule.STSchedule` takes its count from its
    programs (``program.persistent(n)`` on each before ``compose``):
    ``n_iters``, ``reduce_fn``, ``cond_fn`` and ``max_iters`` do not apply
    (``ValueError``, as in the reference), and ``reduce_fns`` is checked
    as the reference checks it; programs of different counts, with
    predicates, or with ``reduce_fns`` raise ``NotImplementedError``.
    """

    def __init__(self, program: STProgram, n_iters: Optional[int] = None,
                 mode: str = "stream", double_buffer: Optional[bool] = None,
                 reduce_fn: Optional[Callable[[Dict[str, torch.Tensor]], torch.Tensor]] = None,
                 cond_fn: Optional[Callable[[torch.Tensor], object]] = None,
                 max_iters: Optional[int] = None,
                 reduce_fns: Optional[Dict[str, Callable]] = None,
                 donate: bool = False, coalesce: bool = True,
                 sanitize: bool = False, unroll: Optional[int] = None):
        super().__init__(program, mode=mode, donate=donate, coalesce=coalesce,
                         sanitize=sanitize)
        self.reduce_fns = dict(reduce_fns or {})
        if isinstance(program, STSchedule):
            self._init_schedule(program, n_iters, reduce_fn, cond_fn, max_iters)
        else:
            if self.reduce_fns:
                raise ValueError("reduce_fns is for composed STSchedules; a plain "
                                 "program takes the single reduce_fn")
            self.cond_fn = cond_fn if cond_fn is not None else program.until
            if max_iters is not None and self.cond_fn is None:
                raise ValueError("max_iters is only meaningful with cond_fn/until")
            if max_iters is None:
                max_iters = program.n_iters if n_iters is None else n_iters
            self.n_iters = self.max_iters = int(max_iters)
            if self.n_iters < 1:
                raise ValueError(f"n_iters must be >= 1, got {self.n_iters}")
            if self.cond_fn is not None and reduce_fn is None:
                raise ValueError(
                    "cond_fn requires reduce_fn: the termination predicate "
                    "is evaluated on the per-iteration scalar reduction")
            program.persistent(self.n_iters, until=self.cond_fn)  # quiescence guard
            self.reduce_fn = reduce_fn
        self.double_buffer = (mode == "dataflow") if double_buffer is None \
            else bool(double_buffer)
        self._slots = slot_buffers(program) if self.double_buffer else ()
        self._local = frozenset(slot_buffers(program))
        if unroll is not None and int(unroll) < 1:
            raise ValueError(f"unroll must be >= 1, got {unroll}")
        self.unroll = None if unroll is None else int(unroll)
        self._reductions: Optional[torch.Tensor] = None
        self._n_done: Optional[torch.Tensor] = None
        self._loop: Optional[graph_loop.GraphLoop] = None
        self._loop_out: Dict[str, torch.Tensor] = {}
        self._alt: Dict[str, torch.Tensor] = {}

    def _init_schedule(self, sched: STSchedule, n_iters, reduce_fn, cond_fn,
                       max_iters) -> None:
        for arg, name in ((n_iters, "n_iters"), (reduce_fn, "reduce_fn"),
                          (cond_fn, "cond_fn"), (max_iters, "max_iters")):
            if arg is not None:
                raise ValueError(
                    f"{name} does not apply to a composed STSchedule: "
                    "iteration counts/predicates are per-program "
                    "(program.persistent(...) before compose) and "
                    "reductions go through reduce_fns={name: fn}")
        names = {s.name for s in sched.subs}
        for name in self.reduce_fns:
            if name not in names:
                raise ValueError(f"reduce_fns names unknown sub-program {name!r} "
                                 f"(have {sorted(names)})")
        for s in sched.subs:
            if s.until is not None and s.name not in self.reduce_fns:
                raise ValueError(
                    f"sub-program {s.name!r} has an until-predicate "
                    f"but no reduce_fns[{s.name!r}] to evaluate it on")
        if (self.reduce_fns or any(s.until is not None for s in sched.subs)
                or len({s.n_iters for s in sched.subs}) > 1):
            raise NotImplementedError(MASKED_LOOP)
        self.cond_fn = self.reduce_fn = None
        self.n_iters = self.max_iters = max(s.n_iters for s in sched.subs)

    def _allocate(self) -> None:
        super()._allocate()
        if self.reduce_fn is not None:
            self._reductions = torch.zeros(self.n_iters, dtype=torch.float32,
                                           device=self.device)
        if self.cond_fn is not None:
            self._n_done = torch.zeros((), dtype=torch.int32, device=self.device)

    def _pass(self, mem):
        return _run_persistent(mem, prog=self.program, mode=self.mode,
                               low=self._lowering, n_iters=self.n_iters,
                               slots=self._slots, reduce_fn=self.reduce_fn,
                               reductions=self._reductions, coalesce=self.coalesce,
                               lanes=self._lanes, sanitize=self.sanitize)

    def compile(self):
        """Allocate the buffers and, on a GPU, capture the graph: all
        ``n_iters`` passes, or the convergence loop (:meth:`_build_loop`)."""
        if self.cond_fn is None:
            return super().compile()
        if self._bufs is None:
            self._allocate()
        if self.device.type == "cuda" and self._loop is None:
            self._loop = self._build_loop()
        return self._loop

    def _loop_pass(self, bufs: Dict[str, torch.Tensor], red: torch.Tensor,
                   keep: torch.Tensor, home: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
        """One pass of the loop body on the tensors ``bufs``: the program,
        its reduction into ``red`` and its predicate into ``keep``.  With
        ``home``, every buffer the next pass reads is copied back into
        its ``home`` tensor; a slot buffer (:func:`slot_buffers`: first
        written in a pass) stays where the pass left it.  Returns where
        each buffer ended."""
        out = _interpret_program(bufs, prog=self.program, mode=self.mode,
                                 low=self._lowering, coalesce=self.coalesce,
                                 lanes=self._lanes, sanitize=self.sanitize)[0]
        val = self.reduce_fn(out).to(torch.float32).reshape(())
        red.copy_(val)
        go = self.cond_fn(val)
        if isinstance(go, torch.Tensor):
            keep.copy_(go.reshape(()))
        else:
            keep.fill_(bool(go))
        for name, t in (home or {}).items():
            if out[name] is not t:
                t.copy_(out[name])
                out[name] = t
        return out

    def _build_loop(self) -> graph_loop.GraphLoop:
        """Capture the loop's two passes and its selects, and build its
        graph.  Pass A reads the engine's tensors and leaves its results
        where it wrote them; pass B reads those and copies the carried
        buffers back into the engine's tensors, so the field is copied
        once a trip.  With double buffering B's slots are the second
        physical copies (``_alt``).  After the loop, the select of the
        last pass's parity puts its results where a call returns them:
        the carried buffers in the engine's tensors, the slots where
        pass A leaves them.  An eager pass on scratch copies first builds
        and loads every kernel; the graphs, and their memory pools, live
        as long as the :class:`~repro_torch.kernels.graph_loop.GraphLoop`."""
        dev = self.device
        red = torch.zeros((), dtype=torch.float32, device=dev)
        keep = torch.zeros((), dtype=torch.bool, device=dev)
        self._loop_pass({n: t.clone() for n, t in self._bufs.items()},
                        red.clone(), keep.clone())
        torch.cuda.synchronize(dev)
        carried = {n: t for n, t in self._bufs.items() if n not in self._local}
        a = dict(self._bufs)
        pass_a, out_a = graph_loop.capture(lambda: self._loop_pass(a, red, keep))
        self._alt = {n: self._bufs[n].clone() for n in self._slots}
        b = {**out_a, **self._alt}
        pass_b, out_b = graph_loop.capture(lambda: self._loop_pass(b, red, keep, carried))
        even = [(out_b[n], out_a[n]) for n in self._local if out_b[n] is not out_a[n]]
        odd = [(out_a[n], t) for n, t in carried.items() if out_a[n] is not t]
        selects = [graph_loop.capture(lambda pairs=pairs: [d.copy_(s) for s, d in pairs])[0]
                   if pairs else None for pairs in (even, odd)]
        self._pass_outs = (out_a, out_b)  # the graphs hold these tensors' addresses
        self._loop_out = {n: carried.get(n, out_a[n]) for n in self._bufs}
        return graph_loop.GraphLoop(pass_a, pass_b, red, keep, self._reductions,
                                    self._n_done, self.max_iters,
                                    select_even=selects[0], select_odd=selects[1])

    def _launch_loop(self, mem):
        """Copy the inputs in, run the loop, return ``(mem, reductions,
        n_done)``.  The copies go out as one multi-tensor launch each
        (``torch._foreach_copy_``): the host enqueues a few calls, not
        one a buffer."""
        self.compile()
        moved = [n for n, t in self._bufs.items() if mem[n] is not t]
        if moved:
            torch._foreach_copy_([self._bufs[n] for n in moved], [mem[n] for n in moved])
        if self._loop is not None:
            if self._alt:  # both slot copies start equal
                torch._foreach_copy_(list(self._alt.values()),
                                     [self._bufs[n] for n in self._alt])
            self._loop.launch()
            self.graph_launches += 1
            out = dict(self._loop_out)
        else:
            out = _run_persistent_while(
                dict(self._bufs), prog=self.program, mode=self.mode,
                low=self._lowering, max_iters=self.max_iters, slots=self._slots,
                reduce_fn=self.reduce_fn, cond_fn=self.cond_fn,
                reductions=self._reductions, n_done=self._n_done,
                coalesce=self.coalesce, lanes=self._lanes, sanitize=self.sanitize)
            for name, t in self._bufs.items():
                if out[name] is not t:
                    t.copy_(out[name])
            out = dict(self._bufs)
        self.stats.dispatches += 1
        red, n_done = self._reductions, self._n_done
        if not self.donate:
            out = {n: t.clone() for n, t in out.items()}
            red, n_done = red.clone(), n_done.clone()
        return out, red, n_done

    def __call__(self, mem):
        if self.cond_fn is not None:
            return self._launch_loop(mem)
        out = self._launch(mem)
        if self.reduce_fn is None:
            return out
        red = self._reductions
        return out, (red if self.donate else red.clone())


def _run_persistent(mem, *, prog: STProgram, mode: str, low: Lowering,
                    n_iters: int, slots: Tuple[str, ...], reduce_fn,
                    reductions: Optional[torch.Tensor], coalesce: bool = True,
                    lanes=None, sanitize: bool = False):
    """``n_iters`` passes with ``(cur, alt)`` slot rotation.

    Pass i writes its slots into ``cur`` and they become the next pass's
    ``alt``; both copies start equal (a replace deposit keeps a rank
    without a sender, so the copies must agree there).  After the loop
    the last pass's writes sit in ``alt``.  The programs' streams fork
    once before the first pass and join after the last.
    """
    mem = dict(mem)
    cur = {n: mem.pop(n) for n in slots}
    alt = {n: t.clone() for n, t in cur.items()}
    tokens, comps = fresh_token_banks(prog)
    streams = PassStreams(lanes, low.device)
    for i in range(n_iters):
        step = dict(mem)
        step.update(cur)
        step, tokens, comps = _interpret_program(
            step, prog=prog, mode=mode, low=low, tokens=tokens,
            comp_tokens=comps, coalesce=coalesce, streams=streams,
            sanitize=sanitize)
        if reduce_fn is not None:
            reductions[i].copy_(reduce_fn(step).reshape(()))
        written = {n: step.pop(n) for n in slots}
        mem = step
        cur, alt = alt, written
    streams.join()
    mem.update(alt)
    return mem


def _run_persistent_while(mem, *, prog: STProgram, mode: str, low: Lowering,
                          max_iters: int, slots: Tuple[str, ...], reduce_fn, cond_fn,
                          reductions: torch.Tensor, n_done: torch.Tensor,
                          coalesce: bool = True, lanes=None, sanitize: bool = False):
    """Eager loop of the reference's ``lax.while_loop``: passes while
    ``cond_fn(reduction)`` holds, at most ``max_iters``, the first always.

    ``reductions`` and ``n_done`` are zeroed, then written by the plain
    step (:func:`~repro_torch.kernels.graph_loop.step_plain`).  Slots
    rotate ``(cur, alt)`` as in :func:`_run_persistent`, so the last
    realized write sits in ``alt`` whatever the count.
    """
    mem = dict(mem)
    cur = {n: mem.pop(n) for n in slots}
    alt = {n: t.clone() for n, t in cur.items()}
    tokens, comps = fresh_token_banks(prog)
    reductions.zero_()
    n_done.zero_()
    keep = True
    while keep:
        step = dict(mem)
        step.update(cur)
        step, tokens, comps = _interpret_program(
            step, prog=prog, mode=mode, low=low, tokens=tokens,
            comp_tokens=comps, coalesce=coalesce, lanes=lanes, sanitize=sanitize)
        val = reduce_fn(step).to(torch.float32).reshape(())
        keep = bool(graph_loop.step_plain(reductions, n_done, val, cond_fn(val),
                                          max_iters))
        written = {n: step.pop(n) for n in slots}
        mem = step
        cur, alt = alt, written
    mem.update(alt)
    return mem
