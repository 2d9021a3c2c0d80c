"""Persistent ST engine — N iterations in ONE CUDA-graph launch.

Port of ``repro.core.engine_persistent``.  :class:`~.engine_fused.
FusedEngine` launches one graph per iteration; here the host launches
once and the device runs trigger → exchange → wait → compute ``n_iters``
times: all N passes of the interpreter are captured into one graph.

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

``stats.dispatches`` counts one per call, however many iterations it
runs.  Convergence loops (``cond_fn``/``until``, a device-side flag
with a graph conditional node) and composed schedules wait for later
slices of the port.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Set, Tuple

import torch

from .descriptors import KernelDesc, StartDesc
from .engine_fused import FusedEngine, Lowering, _interpret_program, fresh_token_banks
from .queue import STProgram


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
    """Run an STProgram for ``n_iters`` iterations as ONE graph launch.

    ``n_iters`` defaults to ``program.n_iters`` (see
    :meth:`~.queue.STProgram.persistent`, whose quiescence guard an
    explicit count passes too).  Buffers, ``donate=`` and ``compile()``
    behave as in :class:`~.engine_fused.FusedEngine`; ``cond_fn`` and
    ``max_iters`` (convergence) are not ported yet and raise.
    """

    def __init__(self, program: STProgram, n_iters: Optional[int] = None,
                 mode: str = "stream", double_buffer: Optional[bool] = None,
                 reduce_fn: Optional[Callable[[Dict[str, torch.Tensor]], torch.Tensor]] = None,
                 cond_fn: Optional[Callable] = None,
                 max_iters: Optional[int] = None,
                 donate: bool = False, coalesce: bool = True):
        if cond_fn is not None or max_iters is not None:
            raise NotImplementedError(
                "cond_fn/max_iters (convergence loops) come with a later "
                "slice of the port")
        super().__init__(program, mode=mode, donate=donate, coalesce=coalesce)
        self.n_iters = program.n_iters if n_iters is None else int(n_iters)
        if self.n_iters < 1:
            raise ValueError(f"n_iters must be >= 1, got {self.n_iters}")
        program.persistent(self.n_iters)  # quiescence reuse-guard
        self.reduce_fn = reduce_fn
        self.double_buffer = (mode == "dataflow") if double_buffer is None \
            else bool(double_buffer)
        self._slots = slot_buffers(program) if self.double_buffer else ()
        self._reductions: Optional[torch.Tensor] = None

    def _allocate(self) -> None:
        super()._allocate()
        if self.reduce_fn is not None:
            self._reductions = torch.zeros(self.n_iters, dtype=torch.float32,
                                           device=self.device)

    def _pass(self, mem):
        return _run_persistent(mem, prog=self.program, mode=self.mode,
                               low=self._lowering, n_iters=self.n_iters,
                               slots=self._slots, reduce_fn=self.reduce_fn,
                               reductions=self._reductions,
                               coalesce=self.coalesce, comm=self._comm)

    def __call__(self, mem):
        out = self._launch(mem)
        if self.reduce_fn is None:
            return out
        red = self._reductions
        return out, (red if self.donate else red.clone())


def _run_persistent(mem, *, prog: STProgram, mode: str, low: Lowering,
                    n_iters: int, slots: Tuple[str, ...], reduce_fn,
                    reductions: Optional[torch.Tensor], coalesce: bool = True,
                    comm=None):
    """``n_iters`` passes with ``(cur, alt)`` slot rotation.

    Pass i writes its slots into ``cur`` and they become the next pass's
    ``alt``; both copies start equal (a replace deposit keeps a rank
    without a sender, so the copies must agree there).  After the loop
    the last pass's writes sit in ``alt``.
    """
    mem = dict(mem)
    cur = {n: mem.pop(n) for n in slots}
    alt = {n: t.clone() for n, t in cur.items()}
    tokens, comps = fresh_token_banks(prog)
    for i in range(n_iters):
        step = dict(mem)
        step.update(cur)
        step, tokens, comps = _interpret_program(
            step, prog=prog, mode=mode, low=low, tokens=tokens,
            comp_tokens=comps, coalesce=coalesce, comm=comm)
        if reduce_fn is not None:
            reductions[i].copy_(reduce_fn(step).reshape(()))
        written = {n: step.pop(n) for n in slots}
        mem = step
        cur, alt = alt, written
    mem.update(alt)
    return mem
