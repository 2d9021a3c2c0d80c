"""STSchedule — compose concurrent STQueues into ONE device program.

Port of ``repro.core.schedule``.  On the card each composed program runs
on its own CUDA stream inside the engines' one graph launch
(:mod:`.engine_fused`).

The paper's ST model keeps one deferred-work queue per GPU stream.  Real
Nekbone-style solves want *several* queues in flight, so one queue's
communication overlaps another queue's compute — the multi-DWQ schedule
of "Understanding GPU Triggering APIs for MPI+X Communication"
(arXiv:2406.05594) and the fully offloaded follow-on (arXiv:2306.15773).
Running each queue's persistent loop as its own host dispatch pays one
dispatch per queue and gives the device no chance to interleave them.

:func:`compose` fuses N *matched* :class:`~.queue.STProgram`\\ s
into one :class:`STSchedule` (an ``STProgram`` subclass), with

* **namespaced buffers** — program ``p``'s buffer ``b`` becomes
  ``"p/b"``, so no memory is shared between sub-programs (static
  analysis rejects cross-program buffer aliasing: composing two
  programs with the same name — e.g. a program with itself — is an
  error);
* **program identity** — every descriptor, batch and buffer carries the
  sub-program's ``pid``, which the engines use to keep one
  trigger/completion counter bank *per program* (the multi-queue
  analogue of one counter pair per ``MPIX_Queue``) and to scope
  stream-FIFO ordering per program instead of serializing the whole
  composition;
* **round-robin batch interleaving** — each program's descriptor stream
  is split into *segments* at its trigger/wait gates (a segment ends
  after each ``start``, and after each ``wait`` that does not fall
  inside an open batch), and the segments are merged round-robin.
  Program B's packs and kernels therefore sit *between* program A's
  ``start`` and A's ``wait`` in the fused stream: software pipelining
  of the queues.  A batch's descriptors are never split across
  segments, and each program's internal FIFO order is preserved
  exactly (property-tested).

Per-program iteration counts and termination predicates ride along on
``subs``.  The port's persistent engine runs a schedule whose programs
share one fixed count; different counts or predicates need the masked
multi-queue loop, which the port does not have yet
(:class:`~.engine_persistent.PersistentEngine` raises).

Cross-program channels (links)
------------------------------
Sub-programs need not iterate independently: a send enqueued with
``remote="B"`` in program A is matched (at compose time, same static
rules) against a recv enqueued with ``remote="A"`` in program B, and
becomes a **cross-program channel** — A's trigger fires it, the
payload deposits into B's memory, and the completion is wired into
*B's* counter bank so B's wait gate observes A's completion.  That is
how triggered operations chain *across* concurrent streams (the
fully-offloaded follow-on of arXiv:2306.15773 / the MPI+X taxonomy of
arXiv:2406.05594): the composed halves of a split domain exchange their
shared faces each iteration instead of drifting apart.  The segment
interleaver becomes link-aware — a link's trigger (the sender's
``start``) is always emitted before the consumer's gating ``wait``; a
cycle of such constraints is a composition deadlock and raises
:class:`ScheduleError`.  ``compose(..., links=[("A", "B"), ...])``
optionally *declares* the expected program pairs, and the realized link
set must match the declaration exactly.  Matched links are recorded on
``STSchedule.links`` for introspection.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .descriptors import (
    KernelDesc,
    RecvDesc,
    SendDesc,
    StartDesc,
    WaitDesc,
)
from .effects import batch_effects, stamp_staging
from .matching import Batch, MatchError, coalesce_batch, match_cross_program
from .queue import STProgram


class ScheduleError(RuntimeError):
    pass


@dataclasses.dataclass(frozen=True)
class SubProgram:
    """Composition metadata for one fused program."""

    name: str
    pid: int
    buffers: Tuple[str, ...]     # namespaced buffer names owned by this pid
    n_iters: int                 # per-program iteration count / bound
    until: Optional[Any]         # per-program termination predicate
    batch_lo: int                # first (renumbered) batch index
    n_batches: int


@dataclasses.dataclass(frozen=True)
class Link:
    """One resolved cross-program channel (introspection metadata).

    ``src_batch``/``dst_batch`` are *global* (schedule) batch indices:
    the sender's trigger batch and the batch whose wait gates the
    deposit on the receiving side.  ``dst_buf`` is the namespaced
    destination buffer the sender deposits into.
    """

    src: str
    dst: str
    tag: int
    src_batch: int
    dst_batch: int
    dst_buf: str


@dataclasses.dataclass
class STSchedule(STProgram):
    """N concurrent STPrograms fused into one device-resident program.

    ``n_iters`` on the schedule is the max over the sub-programs (the
    global loop bound); per-program counts/predicates live in ``subs``.
    """

    subs: Tuple[SubProgram, ...] = ()
    # Resolved cross-program channels (empty when the sub-programs
    # iterate independently).
    links: Tuple[Link, ...] = ()

    def buffers_by_pid(self) -> Dict[int, Tuple[str, ...]]:
        return {s.pid: s.buffers for s in self.subs}

    def sub(self, name: str) -> SubProgram:
        for s in self.subs:
            if s.name == name:
                return s
        raise KeyError(name)

    def buffer_name(self, sub: str, buf: str) -> str:
        """The namespaced name of ``buf`` inside sub-program ``sub``."""
        ns = f"{sub}/{buf}"
        if ns not in self.buffers:
            raise KeyError(ns)
        return ns

    def persistent(self, n_iters, until=None) -> "STProgram":
        raise ScheduleError(
            "persistence is per-program under composition: call "
            ".persistent(...) on each program BEFORE compose(), so every "
            "queue keeps its own iteration count and predicate"
        )


def _segments(descs) -> List[List[Any]]:
    """Split one program's descriptor stream at its trigger/wait gates.

    A segment ends after each ``StartDesc``, and after each ``WaitDesc``
    that is not inside an open batch (i.e. no send/recv/coll enqueued
    since the last start) — so a batch's deferred ops and its trigger
    always land in the same segment and can never be interleaved with
    another program's descriptors.
    """
    segs: List[List[Any]] = []
    cur: List[Any] = []
    open_batch = False
    for d in descs:
        cur.append(d)
        if isinstance(d, (SendDesc, RecvDesc)):
            open_batch = True
        elif isinstance(d, StartDesc):
            open_batch = False
            segs.append(cur)
            cur = []
        elif isinstance(d, WaitDesc) and not open_batch:
            segs.append(cur)
            cur = []
    if cur:
        segs.append(cur)
    return segs


@dataclasses.dataclass(frozen=True)
class InterleavePolicy:
    """How :func:`_interleave` merges the programs' segment lists.

    ``order`` is the program visitation order per round (a permutation
    of pids; ``None`` means ``0..N-1``).  ``granularity`` is how many
    segments one program emits per turn before yielding — 1 is the
    classic fine-grained round-robin, larger values trade interleaving
    depth for fewer context switches in the fused stream, and a value
    >= every program's segment count degenerates to sequential
    concatenation (each program runs to completion, links permitting).
    """

    order: Optional[Tuple[int, ...]] = None
    granularity: int = 1

    def visit_order(self, n_programs: int) -> Tuple[int, ...]:
        if self.order is None:
            return tuple(range(n_programs))
        if sorted(self.order) != list(range(n_programs)):
            raise ScheduleError(
                f"interleave order {self.order} is not a permutation of "
                f"0..{n_programs - 1}")
        return self.order


#: Named policies accepted anywhere an :class:`InterleavePolicy` is
#: (``compose(interleave=...)``): ``"round_robin"`` is the historical
#: default; ``"sequential"`` concatenates programs whole.
INTERLEAVE_POLICIES: Dict[str, InterleavePolicy] = {
    "round_robin": InterleavePolicy(),
    "sequential": InterleavePolicy(granularity=1_000_000_000),
}


def _resolve_policy(policy) -> InterleavePolicy:
    if policy is None:
        return INTERLEAVE_POLICIES["round_robin"]
    if isinstance(policy, InterleavePolicy):
        if policy.granularity < 1:
            raise ScheduleError(
                f"interleave granularity must be >= 1, got "
                f"{policy.granularity}")
        return policy
    if isinstance(policy, str):
        try:
            return INTERLEAVE_POLICIES[policy]
        except KeyError:
            raise ScheduleError(
                f"unknown interleave policy {policy!r} (named policies: "
                f"{sorted(INTERLEAVE_POLICIES)}; or pass an "
                f"InterleavePolicy)") from None
    raise ScheduleError(
        f"interleave= takes a policy name or InterleavePolicy, got "
        f"{type(policy).__name__}")


def _interleave(
    per_prog_segments: List[List[List[Any]]],
    constraints: Optional[Dict[Tuple[int, int], set]] = None,
    policy: Optional[InterleavePolicy] = None,
) -> Tuple[Any, ...]:
    """Policy-driven merge of the programs' segment lists.

    The default policy is the classic fine-grained round-robin (each
    program emits one segment per turn, in pid order).  ``policy``
    varies the visitation ``order`` and per-turn ``granularity`` — see
    :class:`InterleavePolicy`.

    ``constraints`` maps a segment ``(pid, seg_idx)`` to the set of
    segments that must be emitted *before* it — used to keep every
    cross-program link's trigger (the sender's ``start`` segment) ahead
    of the consumer's gating ``wait`` segment.  A blocked segment is
    deferred to a later round (per-program FIFO order is never
    reordered — the program simply yields its turn); with no
    constraints this degenerates to the policy's plain merge.  An
    unsatisfiable cycle raises :class:`ScheduleError`.
    """
    constraints = constraints or {}
    policy = _resolve_policy(policy)
    order = policy.visit_order(len(per_prog_segments))
    out: List[Any] = []
    ptr = [0] * len(per_prog_segments)
    emitted: set = set()
    remaining = sum(len(s) for s in per_prog_segments)
    while remaining:
        progress = False
        for p in order:
            segs = per_prog_segments[p]
            for _ in range(policy.granularity):
                if ptr[p] >= len(segs):
                    break
                need = constraints.get((p, ptr[p]), ())
                if any(pre not in emitted for pre in need):
                    break  # blocked on a link's trigger — yield this round
                out.extend(segs[ptr[p]])
                emitted.add((p, ptr[p]))
                ptr[p] += 1
                remaining -= 1
                progress = True
        if not progress:
            stuck = [(p, ptr[p]) for p in range(len(per_prog_segments))
                     if ptr[p] < len(per_prog_segments[p])]
            raise ScheduleError(
                f"cross-program link cycle: segments {stuck} each wait on a "
                f"trigger that can only be emitted after them (two programs "
                f"may not each gate a wait on the other's *later* start)"
            )
    return tuple(out)


def compose(*programs: STProgram, name: Optional[str] = None,
            links: Optional[Sequence[Tuple[str, str]]] = None,
            interleave: Any = None,
            verify: str = "error") -> STSchedule:
    """Fuse N matched STPrograms into one :class:`STSchedule`.

    Buffers are namespaced ``"{program.name}/{buffer}"``; descriptors and
    batches are tagged with their program's ``pid``; batch indices are
    renumbered to be globally unique; and the programs' descriptor
    streams are interleaved round-robin at trigger/wait-gate granularity
    (see :func:`_segments`).  Every engine accepts the result: the fused
    engine runs one interleaved pass, the persistent engine the whole
    multi-queue loop of one shared count, each as ONE graph launch.

    Open (``remote=``) sends/recvs are matched *across* the composed
    programs into cross-program channels: the sender's trigger fires
    them, the deposit lands in the receiver's memory, and the
    completion bumps the receiver's counter bank (the receiver's wait
    gate observes the sender's completion).  Coalescing plans are
    re-derived per batch after cross channels join it, so fused
    transfers may carry cross payloads but never merge two *triggering*
    programs' batches (plans stay per-batch, batches stay per-pid).
    The interleaving keeps every link's trigger ahead of its consumer's
    gating wait.  ``links=[(src, dst), ...]`` optionally declares the
    expected program pairs; the realized pairs must match exactly.

    ``interleave`` selects the segment-merge policy: a name from
    :data:`INTERLEAVE_POLICIES` (``"round_robin"`` — the default —
    or ``"sequential"``) or an :class:`InterleavePolicy` with an
    explicit program visitation ``order`` and per-turn ``granularity``.
    Whatever the policy, link constraints and per-program FIFO order always hold,
    and the finished schedule still passes through ``verify`` below —
    an invalid interleaving can never leave this function silently.

    Raises :class:`ScheduleError` for programs on different meshes,
    duplicate program names (cross-program buffer aliasing — composing
    a program with itself is the canonical offender), nested schedules
    (compose all leaves in one call instead), unmatched or undeclared
    cross-program descriptors, and link cycles the interleaver cannot
    order.

    ``verify`` runs the :mod:`.verify` static pass on the
    finished schedule — default ``"error"`` (a composed schedule is
    engine-ready, so error-severity diagnostics raise
    :class:`~.verify.VerifyError` here rather than hang later);
    ``"warn"`` downgrades to :class:`~.verify.STLintWarning`, ``"off"``
    skips the pass.
    """
    if not programs:
        raise ScheduleError("compose() needs at least one program")
    mesh = programs[0].mesh
    names = [p.name for p in programs]
    if len(set(names)) != len(names):
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ScheduleError(
            f"cross-program buffer aliasing: duplicate program name(s) "
            f"{dupes} would map distinct programs onto the same buffer "
            f"namespace (build each queue with a distinct name)"
        )
    for p in programs:
        if isinstance(p, STSchedule):
            raise ScheduleError(
                f"nested composition: {p.name!r} is already a schedule — "
                f"compose all leaf programs in a single compose() call"
            )
        if p.mesh is not mesh and p.mesh != mesh:
            raise ScheduleError(
                f"program {p.name!r} lives on a different mesh than "
                f"{programs[0].name!r}; composed queues share one device grid"
            )

    buffers: Dict[str, Any] = {}
    batches: List[Batch] = []
    subs: List[SubProgram] = []
    per_prog_segments: List[List[List[Any]]] = []
    # open cross-program descriptors, pooled per (src_name, dst_name):
    # (renamed descriptor, global batch index) in enqueue order
    open_send_pool: Dict[Tuple[str, str], List[Tuple[Any, int]]] = \
        defaultdict(list)
    open_recv_pool: Dict[Tuple[str, str], List[Tuple[Any, int]]] = \
        defaultdict(list)
    batch_lo = 0
    mesh_shape = dict(mesh.shape)

    for pid, prog in enumerate(programs):
        ns = prog.name
        rename = {b: f"{ns}/{b}" for b in prog.buffers}
        for b, spec in prog.buffers.items():
            new = rename[b]
            if new in buffers:  # unreachable given the name check; belt+braces
                raise ScheduleError(f"buffer alias {new!r}")
            buffers[new] = dataclasses.replace(spec, name=new)

        memo: Dict[int, Any] = {}

        def rn(d, _rename=rename, _pid=pid, _lo=batch_lo, _memo=memo,
               _ns=ns):
            got = _memo.get(id(d))
            if got is not None:
                return got
            if isinstance(d, KernelDesc):
                new = dataclasses.replace(
                    d, reads=tuple(_rename[r] for r in d.reads),
                    writes=tuple(_rename[w] for w in d.writes), pid=_pid)
            elif isinstance(d, SendDesc):
                new = dataclasses.replace(d, buf=_rename[d.buf], pid=_pid)
            elif isinstance(d, RecvDesc):
                new = dataclasses.replace(d, buf=_rename[d.buf], pid=_pid)
            elif isinstance(d, StartDesc):
                new = dataclasses.replace(d, batch=d.batch + _lo, pid=_pid)
            elif isinstance(d, WaitDesc):
                new = dataclasses.replace(d, batch=d.batch + _lo, pid=_pid)
            else:
                raise ScheduleError(
                    f"program {_ns!r} holds an unknown descriptor {d!r}")
            _memo[id(d)] = new
            return new

        descs = [rn(d) for d in prog.descriptors]
        for b in prog.batches:
            renamed_channels = [dataclasses.replace(
                ch, src_buf=rename[ch.src_buf],
                dst_buf=rename[ch.dst_buf]) for ch in b.channels]
            gidx = b.index + batch_lo
            for s in b.open_sends:
                if s.remote not in names:
                    raise ScheduleError(
                        f"program {ns!r} sends to unknown program "
                        f"{s.remote!r} (composing {sorted(names)})")
                open_send_pool[(ns, s.remote)].append((rn(s), gidx))
            for r in b.open_recvs:
                if r.remote not in names:
                    raise ScheduleError(
                        f"program {ns!r} receives from unknown program "
                        f"{r.remote!r} (composing {sorted(names)})")
                open_recv_pool[(r.remote, ns)].append((rn(r), gidx))
            batches.append(Batch(
                index=gidx,
                kernels_before=[rn(k) for k in b.kernels_before],
                channels=renamed_channels,
                waited=b.waited,
                pid=pid,
                plan=None,          # (re)derived below, links included
                coalesce=b.coalesce or b.plan is not None,
            ))
        subs.append(SubProgram(
            name=ns, pid=pid, buffers=tuple(rename.values()),
            n_iters=prog.n_iters, until=prog.until,
            batch_lo=batch_lo, n_batches=prog.n_batches,
        ))
        per_prog_segments.append(_segments(descs))
        batch_lo += prog.n_batches

    # -- cross-program matching (links) ------------------------------------
    pid_of_name = {s.name: s.pid for s in subs}
    batch_by_index = {b.index: b for b in batches}
    links_meta: List[Link] = []
    link_sites: List[Optional[str]] = []  # recv-side provenance per link
    for pair in sorted(set(open_send_pool) | set(open_recv_pool)):
        src_name, dst_name = pair
        try:
            matched = match_cross_program(
                open_send_pool.get(pair, []), open_recv_pool.get(pair, []),
                dst_pid=pid_of_name[dst_name])
        except MatchError as e:
            raise ScheduleError(
                f"cross-program matching {src_name!r} -> {dst_name!r} "
                f"failed: {e}") from e
        for ch, src_batch, dst_batch in matched:
            # the channel executes at the *sender's* trigger: it joins
            # the sender's batch (after the batch's own channels); the
            # receiver's batch records the deposited buffer so its wait
            # gates it (per-pid boundary: trigger side vs wait side)
            batch_by_index[src_batch].channels.append(ch)
            db = batch_by_index[dst_batch]
            db.cross_recv_bufs = db.cross_recv_bufs + (ch.dst_buf,)
            links_meta.append(Link(
                src=src_name, dst=dst_name, tag=ch.tag,
                src_batch=src_batch, dst_batch=dst_batch,
                dst_buf=ch.dst_buf))
            link_sites.append(ch.recv_site)

    if links is not None:
        declared = {tuple(p) for p in links}
        realized = {(l.src, l.dst) for l in links_meta}
        if declared != realized:
            raise ScheduleError(
                f"links= declares {sorted(declared)} but the programs' "
                f"remote descriptors realize {sorted(realized)}")

    # coalescing plans — and declared effect sets — re-derived now that
    # cross channels joined their trigger batches (per-batch, so two
    # programs' *triggers* never merge); staging identities re-stamped
    # per (batch, transfer) so no two trigger→wait windows share one
    for b in batches:
        if b.coalesce:
            b.plan = stamp_staging(
                coalesce_batch(b.channels, buffers, mesh_shape), b.index)
        b.effects = batch_effects(b)

    # -- link-aware interleaving -------------------------------------------
    # a link's trigger (sender's start segment) must be emitted before
    # the consumer's gating wait segment (the first wait at-or-after the
    # receiving batch — completion counters are cumulative)
    start_seg: Dict[Tuple[int, int], int] = {}
    waits_of: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for p, segs in enumerate(per_prog_segments):
        for si, seg in enumerate(segs):
            for d in seg:
                if isinstance(d, StartDesc):
                    start_seg[(p, d.batch)] = si
                elif isinstance(d, WaitDesc):
                    waits_of[p].append((d.batch, si))
    constraints: Dict[Tuple[int, int], set] = defaultdict(set)
    for l, l_site in zip(links_meta, link_sites):
        src_pid, dst_pid = pid_of_name[l.src], pid_of_name[l.dst]
        gate_si = next((si for wb, si in waits_of[dst_pid]
                        if wb >= l.dst_batch), None)
        if gate_si is None:
            # with no covering wait there is nothing to order the
            # deposit against: a consumer kernel could be interleaved
            # ahead of the sender's trigger and silently read stale data
            raise ScheduleError(
                f"program {l.dst!r} posts a remote receive (tag {l.tag}, "
                f"from {l.src!r}) in a batch with no following "
                f"enqueue_wait: the cross-program deposit could never be "
                f"observed deterministically"
                + (f" [receive enqueued at {l_site}]" if l_site else ""))
        constraints[(dst_pid, gate_si)].add(
            (src_pid, start_seg[(src_pid, l.src_batch)]))

    sched = STSchedule(
        buffers=buffers,
        descriptors=_interleave(per_prog_segments, constraints,
                                policy=_resolve_policy(interleave)),
        batches=tuple(batches),
        mesh=mesh,
        name=name or "+".join(names),
        n_iters=max(p.n_iters for p in programs),
        until=None,
        subs=tuple(subs),
        links=tuple(links_meta),
    )
    from .verify import run_verify  # local import: verify imports queue
    run_verify(sched, verify)
    return sched
