"""STQueue — the ``MPIX_Queue`` analogue and the ST enqueue API.

Port of ``repro.core.queue``:

=====================   ==============================================
Paper                   Here
=====================   ==============================================
MPIX_Create_queue       ``STQueue(mesh, ...)`` / ``create_queue(...)``
MPIX_Free_queue         ``queue.free()``
MPIX_Enqueue_send       ``queue.enqueue_send(buf, peer, tag)``
MPIX_Enqueue_recv       ``queue.enqueue_recv(buf, peer, tag)``
MPIX_Enqueue_start      ``queue.enqueue_start()``
MPIX_Enqueue_wait       ``queue.enqueue_wait()``
(kernel launch)         ``queue.enqueue_kernel(fn, reads, writes)``
(§V-A contiguous        ``build(coalesce=True)`` → one
 MPI buffer)            :class:`~.matching.CoalescedChannel` per
                        ``(axis, permutation)`` group
=====================   ==============================================

Enqueue calls append descriptors and touch no device; ``build()``
matches them into an immutable :class:`STProgram` that the engines
(:mod:`.engine_host`, :mod:`.engine_fused`, :mod:`.engine_persistent`)
run.  FIFO order per queue, one start per batch, stream-only waits, no
wildcards and queue reuse across iterations hold as in the reference.

``build`` runs the static verifier (:mod:`.verify`, ``verify="warn"``
by default).  Several queues in flight at once are built one program
each and fused with :func:`~.schedule.compose`; a send or recv enqueued
with ``remote=<program>`` stays open through this queue's build and
``compose`` matches it into a cross-program channel.
"""

from __future__ import annotations

import dataclasses
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .counters import CompletionCounter, TriggerCounter
from .descriptors import (
    BufferSpec,
    KernelDesc,
    RecvDesc,
    SendDesc,
    StartDesc,
    WaitDesc,
    as_torch_dtype,
)
from .effects import batch_effects, stamp_staging
from .matching import Batch, coalesce_batch, match_batch, validate_program_order


def _adapt_arity(fn: Callable, n_reads: int) -> Callable:
    """Pass a kernel written for fewer arguments only the prefix it takes
    when the queue widens an undeclared read set to every buffer."""
    import inspect

    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return fn
    if any(p.kind == inspect.Parameter.VAR_POSITIONAL for p in params):
        return fn
    arity = sum(p.kind in (inspect.Parameter.POSITIONAL_ONLY,
                           inspect.Parameter.POSITIONAL_OR_KEYWORD)
                for p in params)
    if arity >= n_reads:
        return fn
    return lambda *vals: fn(*vals[:arity])


def _call_site() -> Optional[str]:
    """``file:line`` of the enqueue call that created a descriptor."""
    for frame in reversed(traceback.extract_stack(limit=8)):
        if frame.filename == __file__:
            continue
        parts = frame.filename.replace("\\", "/").rsplit("/", 2)
        short = "/".join(parts[-2:]) if len(parts) > 1 else parts[-1]
        return f"{short}:{frame.lineno}"
    return None


class QueueError(RuntimeError):
    pass


@dataclasses.dataclass
class STProgram:
    """Immutable, matched ST program ready for an engine."""

    buffers: Dict[str, BufferSpec]
    descriptors: Tuple[Any, ...]
    batches: Tuple[Batch, ...]
    mesh: Any  # repro_torch.mesh.Mesh
    name: str = "st_program"
    # How many passes one PersistentEngine dispatch runs (see persistent).
    n_iters: int = 1
    # Optional termination predicate ``until(reduction) -> bool`` on the
    # per-iteration scalar reduction: the loop runs while it holds,
    # ``n_iters`` becoming the max-iteration bound (see persistent).
    until: Optional[Callable[[Any], Any]] = None

    @property
    def n_batches(self) -> int:
        return len(self.batches)

    @property
    def n_channels(self) -> int:
        return sum(len(b.channels) for b in self.batches)

    @property
    def is_coalesced(self) -> bool:
        return any(b.plan is not None for b in self.batches)

    def collective_counts(self) -> Dict[int, Tuple[int, int]]:
        """Per start gate: (uncoalesced, as-lowered) transfer counts."""
        return {
            b.index: (len(b.channels),
                      len(b.plan.transfers) if b.plan is not None
                      else len(b.channels))
            for b in self.batches
        }

    def max_collectives_per_start(self) -> Tuple[int, int]:
        """Max over start gates of (uncoalesced, as-lowered) counts."""
        counts = self.collective_counts()
        if not counts:
            return (0, 0)
        return (max(u for u, _ in counts.values()),
                max(c for _, c in counts.values()))

    @property
    def is_persistent(self) -> bool:
        return self.n_iters > 1 or self.until is not None

    @property
    def open_links(self) -> int:
        """Unresolved cross-program (``remote=``) descriptors: nonzero
        means the program must go through :func:`~.schedule.compose`
        before an engine may run it."""
        return sum(len(b.open_sends) + len(b.open_recvs) for b in self.batches)

    def require_closed(self) -> None:
        """Raise unless every cross-program descriptor is resolved (the
        engines call this: an open channel would hang)."""
        if self.open_links:
            raise ValueError(
                f"[ST012] program {self.name!r} has {self.open_links} unresolved "
                f"cross-program (remote=) descriptor(s): compose() it with "
                f"its peer program(s) before running — an open channel has "
                f"no matching side and would hang")

    def buffers_by_pid(self) -> Dict[int, Tuple[str, ...]]:
        """Buffer names per program id (one program: pid 0 owns all; a
        composed schedule has one entry a sub-program)."""
        return {0: tuple(self.buffers)}

    def concurrent_with(self, *others: "STProgram",
                        name: Optional[str] = None) -> "STProgram":
        """``compose(self, *others)`` (see :mod:`.schedule`)."""
        from .schedule import compose  # schedule imports this module
        return compose(self, *others, name=name)

    def persistent(self, n_iters: int,
                   until: Optional[Callable[[Any], Any]] = None) -> "STProgram":
        """A copy marked for ``n_iters`` device-resident passes.

        With ``until`` the count becomes dynamic: the engine re-runs the
        program while ``until(reduction)`` holds (e.g. ``lambda r: r >=
        tol``), ``n_iters`` being the max-iteration bound, and the device
        decides when to stop.

        Re-execution needs a *quiescent* queue: a wait must follow the
        final start, or iteration i+1 would trigger against iteration
        i's in-flight completions.  A predicate-terminated loop may
        always run more than one pass, so ``until`` triggers the guard
        even when the bound is 1.
        """
        if n_iters < 1:
            raise QueueError(f"persistent n_iters must be >= 1, got {n_iters}")
        last_start = last_wait = -1
        for i, d in enumerate(self.descriptors):
            if isinstance(d, StartDesc):
                last_start = i
            elif isinstance(d, WaitDesc):
                last_wait = i
        if ((n_iters > 1 or until is not None)
                and last_start >= 0 and last_wait < last_start):
            raise QueueError(
                "persistent reuse of a non-quiescent queue: the final "
                "enqueue_start has no following enqueue_wait; counters "
                "would not agree across iterations")
        return dataclasses.replace(self, n_iters=n_iters, until=until)

    def dispatch_count_host(self) -> int:
        """Separate dispatches of the host-orchestrated engine per pass:
        one per kernel and one per channel (paper Fig. 1)."""
        return (sum(isinstance(d, KernelDesc) for d in self.descriptors)
                + self.n_channels)

    def dispatch_count_fused(self) -> int:
        """The fused engine launches one graph per pass."""
        return 1

    def dispatch_count_persistent(self) -> int:
        """The persistent engine launches one graph for all passes."""
        return 1


class STQueue:
    """Records an ST program (the MPIX_Queue + GPU-stream pair) over a
    :class:`~repro_torch.mesh.Mesh`."""

    def __init__(self, mesh, name: str = "stq"):
        self.mesh = mesh
        self.name = name
        self._descs: List[Any] = []
        self._buffers: Dict[str, BufferSpec] = {}
        self._trigger = TriggerCounter(name=f"{name}.trigger")
        self._completion = CompletionCounter(name=f"{name}.completion")
        self._freed = False
        self._built: Optional[STProgram] = None
        self._built_key: Optional[Tuple[str, bool]] = None

    # -- buffer declaration -------------------------------------------------

    def buffer(self, name: str, shape: Sequence[int], dtype=torch.float32,
               pspec: Sequence[Any] = ()) -> str:
        """Declare a named global buffer (all ranks) the program uses."""
        self._check_live()
        if name in self._buffers:
            raise QueueError(f"buffer {name!r} already declared")
        self._buffers[name] = BufferSpec(name, tuple(shape),
                                         as_torch_dtype(dtype), tuple(pspec))
        self._built = None
        return name

    # -- enqueue API (paper Fig. 5) ------------------------------------------

    def enqueue_kernel(self, fn: Callable, reads: Sequence[str],
                       writes: Sequence[str], name: str = "kernel") -> None:
        """Enqueue a compute kernel on the stream (non-blocking)."""
        self._check_live()
        for b in tuple(reads) + tuple(writes):
            if b not in self._buffers:
                raise QueueError(f"kernel touches undeclared buffer {b!r}")
        self._descs.append(KernelDesc(fn, tuple(reads), tuple(writes), name,
                                      site=_call_site()))
        self._built = None

    def enqueue_compute(self, fn: Callable, *,
                        reads: Optional[Sequence[str]] = None,
                        writes: Sequence[str] = (),
                        name: str = "compute") -> None:
        """Keyword form of :meth:`enqueue_kernel`.  Without ``reads=`` the
        kernel is assumed to read every buffer declared so far and is
        flagged ``implicit_effects`` (the ST019 warning)."""
        implicit = reads is None
        if implicit:
            reads = tuple(self._buffers)
            fn = _adapt_arity(fn, len(reads))
        self.enqueue_kernel(fn, reads, writes, name=name)
        if implicit:
            self._descs[-1] = dataclasses.replace(self._descs[-1],
                                                  implicit_effects=True)

    def enqueue_send(self, buf: str, peer, tag: int, region=None,
                     remote: Optional[str] = None) -> None:
        """MPIX_Enqueue_send: deferred tagged send (returns immediately).
        With ``remote=<program>`` the matching receive lives in another
        queue's program and ``compose`` matches it."""
        self._check_live()
        self._check_buf(buf)
        self._descs.append(SendDesc(
            buf, peer, tag, threshold=self._trigger.next_threshold(),
            region=region, remote=remote, site=_call_site()))
        self._built = None

    def enqueue_recv(self, buf: str, peer, tag: int, region=None,
                     mode: str = "replace", remote: Optional[str] = None) -> None:
        """MPIX_Enqueue_recv: deferred tagged receive (returns immediately).
        With ``remote=<program>`` the wait covering this batch gates on
        the sending program's completion."""
        self._check_live()
        self._check_buf(buf)
        if mode not in ("replace", "add"):
            raise QueueError("recv mode must be 'replace' or 'add'")
        self._descs.append(RecvDesc(
            buf, peer, tag, threshold=self._trigger.next_threshold(),
            region=region, mode=mode, remote=remote, site=_call_site()))
        self._built = None

    def enqueue_start(self) -> None:
        """MPIX_Enqueue_start: one trigger for every comm op enqueued
        since the previous start."""
        self._check_live()
        batch = self._trigger.record_start()
        self._descs.append(StartDesc(batch=batch - 1, threshold=batch,
                                     site=_call_site()))
        self._built = None

    def enqueue_wait(self) -> None:
        """MPIX_Enqueue_wait: stream-blocking completion gate."""
        self._check_live()
        n_started = self._trigger.scheduled
        if n_started == 0:
            raise QueueError("enqueue_wait before any enqueue_start")
        self._descs.append(WaitDesc(batch=n_started - 1,
                                    expected=self._completion.record_op(),
                                    site=_call_site()))
        self._built = None

    def free(self) -> None:
        """MPIX_Free_queue; also drops the built-program cache."""
        self._check_live()
        self._freed = True
        self._built = None

    # -- build ---------------------------------------------------------------

    def build(self, name: Optional[str] = None, coalesce: bool = True,
              verify: str = "warn") -> STProgram:
        """Build-time matching + validation → immutable STProgram.

        ``coalesce=True`` records a :class:`~.matching.CoalescePlan` on
        every batch it can group.  ``verify`` runs the static pass of
        :mod:`.verify`: ``"warn"`` reports each diagnostic as an
        ``STLintWarning``, ``"error"`` raises ``VerifyError`` on
        error-severity ones, ``"off"`` skips it.  Open ``remote=``
        descriptors are checked by the single-queue rules here; compose
        re-verifies the whole schedule.
        """
        from .verify import run_verify  # verify imports this module

        self._check_live()
        resolved = name or self.name
        if self._built is not None and self._built_key == (resolved, coalesce):
            run_verify(self._built, verify)
            return self._built
        validate_program_order(self._descs)
        mesh_shape = dict(self.mesh.shape)

        batches: List[Batch] = []
        pending_sends: List[SendDesc] = []
        pending_recvs: List[RecvDesc] = []
        kernels_since_start: List[KernelDesc] = []
        for d in self._descs:
            if isinstance(d, KernelDesc):
                kernels_since_start.append(d)
            elif isinstance(d, SendDesc):
                pending_sends.append(d)
            elif isinstance(d, RecvDesc):
                pending_recvs.append(d)
            elif isinstance(d, StartDesc):
                # remote= sends/recvs pair with another program: compose
                # matches them
                open_sends = [x for x in pending_sends if x.remote is not None]
                open_recvs = [x for x in pending_recvs if x.remote is not None]
                for o in open_sends + open_recvs:
                    if o.remote == resolved:
                        raise QueueError(
                            f"remote={resolved!r} names this program itself: "
                            f"a channel to the own queue is a plain (local) "
                            f"send/recv pair, not a cross-program link")
                channels = match_batch(
                    [x for x in pending_sends if x.remote is None],
                    [x for x in pending_recvs if x.remote is None])
                plan = stamp_staging(
                    coalesce_batch(channels, self._buffers, mesh_shape)
                    if coalesce else None, d.batch)
                batch = Batch(index=d.batch,
                              kernels_before=list(kernels_since_start),
                              channels=channels, plan=plan, coalesce=coalesce,
                              open_sends=open_sends, open_recvs=open_recvs)
                batch.effects = batch_effects(batch)
                batches.append(batch)
                pending_sends, pending_recvs = [], []
                kernels_since_start = []
            elif isinstance(d, WaitDesc):
                # completion counters are cumulative: a wait on batch k
                # observes every batch <= k
                for b in batches[: d.batch + 1]:
                    b.waited = True

        self._built = STProgram(buffers=dict(self._buffers),
                                descriptors=tuple(self._descs),
                                batches=tuple(batches), mesh=self.mesh,
                                name=resolved)
        self._built_key = (resolved, coalesce)
        run_verify(self._built, verify)
        return self._built

    # -- helpers ---------------------------------------------------------------

    def _check_live(self):
        if self._freed:
            raise QueueError("operation on freed MPIX_Queue (use-after-free)")

    def _check_buf(self, buf: str):
        if buf not in self._buffers:
            raise QueueError(f"undeclared buffer {buf!r}")


def create_queue(mesh, name: str = "stq") -> STQueue:
    """MPIX_Create_queue analogue (local operation, no communication)."""
    return STQueue(mesh, name)
