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
schedule's namespaced message buffers.

Different counts, predicates or ``reduce_fns`` take the masked
multi-queue loop: each program runs to its own count or predicate, and
a call returns ``(mem, {name: reductions}, {name: n_done})``.  Every
pass runs every program, so a frozen program's packs keep publishing
its frozen boundary to its still-active neighbours; what the pass wrote
into the frozen program's own buffers, its neighbours' deposits
included, is discarded.  On a CPU device that is the eager loop
:func:`_run_schedule_while` (the reference's ``jnp.where`` masks as
``torch.where``, the ``(cur, alt)`` slot pairs rotating only while
their program is active).  On the card :meth:`PersistentEngine.compile`
builds a :class:`~repro_torch.kernels.graph_loop.ScheduleLoop`: the
two-pass body of the convergence loop with all N programs in each pass
(the streams fork and join inside a pass, so parts do not pipeline
across trips), set by the schedule step kernel, which also fires, per
program, a snapshot of its buffers on the trip where it stops and a
restore of them after every later pass (:meth:`_freeze_cells`).
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

    A composed :class:`~.schedule.STSchedule` takes its counts and
    predicates from its programs (``program.persistent(n, until=)`` on
    each before ``compose``): ``n_iters``, ``reduce_fn``, ``cond_fn`` and
    ``max_iters`` do not apply (``ValueError``, as in the reference), and
    ``reduce_fns={name: fn}`` gives program ``name`` its reduction (each
    fn sees every buffer and should read its own program's).  Programs of
    different counts, with predicates, or with ``reduce_fns`` run the
    masked loop (module docstring), at most the largest count of passes;
    a call returns ``(mem, reductions, n_done)``, ``reductions[name]``
    float32 zero-padded to that bound and ``n_done[name]`` a 0-d int32
    tensor on the device.
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
        self._masked = False
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
        self.cond_fn = self.reduce_fn = None
        self.n_iters = self.max_iters = max(s.n_iters for s in sched.subs)
        # the reference's _schedule_while: the programs diverge, or traces are wanted
        self._masked = bool(self.reduce_fns or any(s.until is not None for s in sched.subs)
                            or len({s.n_iters for s in sched.subs}) > 1)

    def _allocate(self) -> None:
        super()._allocate()
        if self._masked:
            n = len(self.program.subs)
            self._reductions = torch.zeros(n, self.max_iters, dtype=torch.float32,
                                           device=self.device)
            self._n_done = torch.zeros(n, dtype=torch.int32, device=self.device)
            return
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
        ``n_iters`` passes, the convergence loop (:meth:`_build_loop`) or
        the masked loop (:meth:`_build_schedule_loop`)."""
        if self.cond_fn is None and not self._masked:
            return super().compile()
        if self._bufs is None:
            self._allocate()
        if self.device.type == "cuda" and self._loop is None:
            self._loop = self._build_schedule_loop() if self._masked else self._build_loop()
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
        _reduce_into(out, self.reduce_fn, self.cond_fn, red, keep)
        return _copy_home(out, home)

    def _capture_two_passes(self, pass_fn):
        """Capture a loop body's two passes and the selects of the last
        pass's parity.  ``pass_fn(bufs, home)`` runs one pass on the
        tensors ``bufs`` (:meth:`_loop_pass`).  Pass A reads the engine's
        tensors and leaves its results where it wrote them; pass B reads
        those and copies the carried buffers back into the engine's
        tensors, so the field is copied once a trip.  With double
        buffering B's slots are the second physical copies (``_alt``).
        After the loop, the select of the last pass's parity puts its
        results where a call returns them: the carried buffers in the
        engine's tensors, the slots where pass A leaves them.  An eager
        pass on scratch copies first builds and loads every kernel; the
        graphs, and their memory pools, live as long as the loop graph
        built from them.  Returns ``(pass_a, pass_b, out_a, out_b,
        select_even, select_odd)``, ``out_a`` (``out_b``) where each
        buffer sits after pass A (B)."""
        pass_fn({n: t.clone() for n, t in self._bufs.items()}, None)
        torch.cuda.synchronize(self.device)
        carried = {n: t for n, t in self._bufs.items() if n not in self._local}
        a = dict(self._bufs)
        pass_a, out_a = graph_loop.capture(lambda: pass_fn(a, None))
        self._alt = {n: self._bufs[n].clone() for n in self._slots}
        b = {**out_a, **self._alt}
        pass_b, out_b = graph_loop.capture(lambda: pass_fn(b, carried))
        even = [(out_b[n], out_a[n]) for n in self._local if out_b[n] is not out_a[n]]
        odd = [(out_a[n], t) for n, t in carried.items() if out_a[n] is not t]
        selects = [_capture_copies([d for _, d in pairs], [s for s, _ in pairs])
                   for pairs in (even, odd)]
        self._pass_outs = (out_a, out_b)  # the graphs hold these tensors' addresses
        self._loop_out = {n: carried.get(n, out_a[n]) for n in self._bufs}
        return (pass_a, pass_b, out_a, out_b, *selects)

    def _build_loop(self) -> graph_loop.GraphLoop:
        """Capture the loop's two passes and its selects
        (:meth:`_capture_two_passes`), and build its graph."""
        red = torch.zeros((), dtype=torch.float32, device=self.device)
        keep = torch.zeros((), dtype=torch.bool, device=self.device)
        pass_a, pass_b, _, _, even, odd = self._capture_two_passes(
            lambda bufs, home: self._loop_pass(bufs, red, keep, home))
        return graph_loop.GraphLoop(pass_a, pass_b, red, keep, self._reductions,
                                    self._n_done, self.max_iters,
                                    select_even=even, select_odd=odd)

    def _schedule_pass(self, bufs: Dict[str, torch.Tensor], red: torch.Tensor,
                       pred: torch.Tensor, home: Optional[Dict[str, torch.Tensor]] = None
                       ) -> Dict[str, torch.Tensor]:
        """One pass of every program of the schedule on the tensors
        ``bufs``, each program's reduction into ``red[k]`` and predicate
        into ``pred[k]``; ``home`` as in :meth:`_loop_pass`."""
        out = _interpret_program(bufs, prog=self.program, mode=self.mode,
                                 low=self._lowering, coalesce=self.coalesce,
                                 lanes=self._lanes, sanitize=self.sanitize)[0]
        _reduce_programs(out, self.program.subs, self.reduce_fns, red, pred)
        return _copy_home(out, home)

    def _freeze_cells(self, names, out_a, out_b):
        """Where each of a program's buffers sits in the masked loop graph.

        Returns ``(cells_a, cells_b)``: after pass A (B), a list of
        ``(snapshot, source, targets)``.  Where the program stops after
        that pass, ``snapshot <- source`` keeps its values; after every
        later pass of that kind, ``target <- snapshot`` for each target
        puts them back where the next pass reads them and where the
        loop's output reads them if it ends there:

        * a carried buffer: pass A leaves it in ``out_a``, which pass B
          reads; pass B copies it home (``_bufs``), which pass A reads;
        * a slot without double buffering: the same, except that pass B
          leaves it in ``out_b``, which the even select copies out;
        * a double-buffered slot: two snapshots, the copy the next pass
          reads (``_alt`` after A, ``_bufs`` after B: the reference's
          ``cur``) and the pass's own write (``alt``, which the loop
          returns).
        """
        cells_a, cells_b = [], []
        for n in names:
            home = self._bufs[n]
            if n in self._slots:
                cur, last = torch.empty_like(home), torch.empty_like(home)
                cells_a += [(cur, self._alt[n], [self._alt[n]]), (last, out_a[n], [out_a[n]])]
                cells_b += [(cur, home, [home]), (last, out_b[n], [out_b[n]])]
                continue
            keep = torch.empty_like(home)
            cells_a.append((keep, out_a[n], [out_a[n]]))
            if n in self._local:
                back = [home] + ([out_b[n]] if out_b[n] is not home else [])
                cells_b.append((keep, out_b[n], back))
            else:
                cells_b.append((keep, home, [home]))
        return cells_a, cells_b

    def _build_schedule_loop(self) -> graph_loop.ScheduleLoop:
        """Capture the masked loop's two passes (every program each) and
        selects (:meth:`_capture_two_passes`) and each program's snapshot
        and restore copies (:meth:`_freeze_cells`), and build its graph.
        A program that cannot stop before the loop's bound (no predicate,
        the largest count) is never frozen during a pass: it gets no
        copies, and the step sets no IF handles for it."""
        dev, subs = self.device, self.program.subs
        red = torch.zeros(len(subs), dtype=torch.float32, device=dev)
        pred = torch.zeros(len(subs), dtype=torch.bool, device=dev)
        pass_a, pass_b, out_a, out_b, even, odd = self._capture_two_passes(
            lambda bufs, home: self._schedule_pass(bufs, red, pred, home))
        freeze, cells = [], []
        for sub in subs:
            if sub.until is None and sub.n_iters == self.max_iters:
                freeze.append(None)
                continue
            after = self._freeze_cells(sub.buffers, out_a, out_b)
            graphs = []
            for pass_cells in after:
                graphs.append(_capture_copies(
                    [t for _, _, targets in pass_cells for t in targets],
                    [s for s, _, targets in pass_cells for _ in targets]))
                graphs.append(_capture_copies([s for s, _, _ in pass_cells],
                                              [src for _, src, _ in pass_cells]))
            freeze.append(tuple(graphs) if all(graphs) else None)
            cells.append(after)
        self._pass_outs += (cells,)  # the freeze graphs hold these tensors' addresses
        return graph_loop.ScheduleLoop(
            pass_a, pass_b, freeze, red, pred,
            torch.ones(len(subs), dtype=torch.int32, device=dev), self._n_done,
            self._reductions, [s.n_iters for s in subs],
            [s.name in self.reduce_fns for s in subs], [s.until is not None for s in subs],
            self.max_iters, select_even=even, select_odd=odd)

    def _copy_in(self, mem) -> None:
        """Compile, and copy the inputs in; with a loop graph, both slot
        copies start equal.  The copies go out as one multi-tensor launch
        each (``torch._foreach_copy_``): the host enqueues a few calls,
        not one a buffer."""
        self.compile()
        moved = [n for n, t in self._bufs.items() if mem[n] is not t]
        if moved:
            torch._foreach_copy_([self._bufs[n] for n in moved], [mem[n] for n in moved])
        if self._loop is not None and self._alt:
            torch._foreach_copy_(list(self._alt.values()), [self._bufs[n] for n in self._alt])

    def _launch_loop(self, mem):
        """Copy the inputs in, run the convergence or masked loop, return
        ``(mem, reductions, n_done)`` (of the masked loop: one entry a
        program, by name, the reductions of those with ``reduce_fns``)."""
        self._copy_in(mem)
        if self._loop is not None:
            self._loop.launch()
            self.graph_launches += 1
            out = dict(self._loop_out)
        else:
            common = dict(mode=self.mode, low=self._lowering, slots=self._slots,
                          reductions=self._reductions, n_done=self._n_done,
                          coalesce=self.coalesce, lanes=self._lanes, sanitize=self.sanitize)
            if self._masked:
                out = _run_schedule_while(dict(self._bufs), sched=self.program,
                                          reduce_fns=self.reduce_fns, **common)
            else:
                out = _run_persistent_while(dict(self._bufs), prog=self.program,
                                            max_iters=self.max_iters, reduce_fn=self.reduce_fn,
                                            cond_fn=self.cond_fn, **common)
            for name, t in self._bufs.items():
                if out[name] is not t:
                    t.copy_(out[name])
            out = dict(self._bufs)
        self.stats.dispatches += 1
        red, n_done = self._reductions, self._n_done
        if not self.donate:
            out = {n: t.clone() for n, t in out.items()}
            red, n_done = red.clone(), n_done.clone()
        if not self._masked:
            return out, red, n_done
        subs = self.program.subs
        return (out, {s.name: red[k] for k, s in enumerate(subs) if s.name in self.reduce_fns},
                {s.name: n_done[k] for k, s in enumerate(subs)})

    def __call__(self, mem):
        if self.cond_fn is not None or self._masked:
            return self._launch_loop(mem)
        out = self._launch(mem)
        if self.reduce_fn is None:
            return out
        red = self._reductions
        return out, (red if self.donate else red.clone())


def _copy_home(out: Dict[str, torch.Tensor], home: Optional[Dict[str, torch.Tensor]]
               ) -> Dict[str, torch.Tensor]:
    """Copy each buffer of ``home`` that a pass left elsewhere back into
    its ``home`` tensor; returns where each buffer ended."""
    for name, t in (home or {}).items():
        if out[name] is not t:
            t.copy_(out[name])
            out[name] = t
    return out


def _capture_copies(dsts, srcs):
    """A captured graph of ``dst <- src`` for each pair (one multi-tensor
    copy), or None for no pairs."""
    if not dsts:
        return None
    return graph_loop.capture(lambda: torch._foreach_copy_(list(dsts), list(srcs)))[0]


def _reduce_into(out, reduce_fn, cond_fn, red: torch.Tensor, keep: torch.Tensor) -> None:
    """``reduce_fn`` of a pass's buffers into the 0-d ``red`` and, given
    ``cond_fn``, the predicate on it into the 0-d ``keep``."""
    val = reduce_fn(out).to(torch.float32).reshape(())
    red.copy_(val)
    if cond_fn is None:
        return
    go = cond_fn(val)
    if isinstance(go, torch.Tensor):
        keep.copy_(go.reshape(()))
    else:
        keep.fill_(bool(go))


def _reduce_programs(out, subs, reduce_fns, red: torch.Tensor, pred: torch.Tensor) -> None:
    """Each program's reduction of the pass's buffers into ``red[k]`` and,
    if it has one, its predicate on it into ``pred[k]``."""
    for k, sub in enumerate(subs):
        if sub.name in reduce_fns:
            _reduce_into(out, reduce_fns[sub.name], sub.until, red[k], pred[k])


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


def _run_schedule_while(mem, *, sched: STSchedule, mode: str, low: Lowering,
                        slots: Tuple[str, ...], reduce_fns: Dict[str, Callable],
                        reductions: torch.Tensor, n_done: torch.Tensor,
                        coalesce: bool = True, lanes=None, sanitize: bool = False):
    """Eager loop of the reference's masked multi-queue ``while_loop``:
    every pass runs the whole schedule, then each program's ``active``
    flag keeps or discards its results, so a program that stopped keeps
    the values of its last realized pass while its packs go on publishing
    them.  Slot pairs rotate ``(cur, alt)`` only while their program is
    active, so each program's last realized write ends in ``alt``.

    ``reductions`` (float32, (N, max count)) and ``n_done`` (int32, (N,))
    are zeroed, then written by the plain schedule step
    (:func:`~repro_torch.kernels.graph_loop.schedule_step_plain`).  The
    first pass runs for every program; the loop runs while any program
    is active.  Returns the final buffers.
    """
    subs = sched.subs
    max_iters = max(s.n_iters for s in subs)
    dev = reductions.device
    owner = {b: k for k, s in enumerate(subs) for b in s.buffers}
    flags = lambda keys: torch.tensor(keys, dtype=torch.bool, device=dev)
    n_iters = torch.tensor([s.n_iters for s in subs], dtype=torch.int32, device=dev)
    reduces = flags([s.name in reduce_fns for s in subs])
    untils = flags([s.until is not None for s in subs])
    red = torch.zeros(len(subs), dtype=torch.float32, device=dev)
    pred = torch.zeros(len(subs), dtype=torch.bool, device=dev)
    active = torch.ones(len(subs), dtype=torch.bool, device=dev)
    i = torch.zeros((), dtype=torch.int32, device=dev)

    mem = dict(mem)
    cur = {n: mem.pop(n) for n in slots}
    alt = {n: t.clone() for n, t in cur.items()}
    tokens, comps = fresh_token_banks(sched)
    reductions.zero_()
    n_done.zero_()
    go = True
    while go:
        step = dict(mem)
        step.update(cur)
        # the pass writes some buffers in place (deposits, unpack-adds): it
        # runs on copies, so that a stopped program's values survive it
        step = {n: t.clone() for n, t in step.items()}
        new, tokens, comps = _interpret_program(
            step, prog=sched, mode=mode, low=low, tokens=tokens, comp_tokens=comps,
            coalesce=coalesce, lanes=lanes, sanitize=sanitize)
        _reduce_programs(new, subs, reduce_fns, red, pred)
        act = active.clone()
        go = bool(graph_loop.schedule_step_plain(reductions, n_done, active, i, red, pred,
                                                 n_iters, reduces, untils, max_iters))
        new_cur, new_alt = {}, {}
        for n in slots:
            a = act[owner[n]]
            written = new.pop(n)
            new_cur[n] = torch.where(a, alt[n], cur[n])
            new_alt[n] = torch.where(a, written, alt[n])
        mem = {n: torch.where(act[owner[n]], new[n], t) for n, t in mem.items()}
        cur, alt = new_cur, new_alt
    mem.update(alt)
    return mem
