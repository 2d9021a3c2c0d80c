"""Fused ST engine — one CUDA-graph launch per pass of the program.

Port of ``repro.core.engine_fused``.  The reference lowers a whole
:class:`~.queue.STProgram` into one XLA computation.  Here one pass is
captured into one ``torch.cuda.CUDAGraph``, so the host launches the
program once per call (vs once per descriptor in :mod:`.engine_host`):
after enqueue, the device walks kernels and transfers with no host
round-trip.  On a CPU device the same interpreter runs eagerly.

One GPU holds every rank.  A buffer keeps the reference's global layout
— leading rank dimensions in mesh order, then the per-rank block — and
a channel is an on-device copy that permutes along the rank dimensions,
zero-filling ranks with no sender as ``ppermute`` does.  Full-identity
permutations are elided (:func:`_is_full_identity`).

Descriptor lowering
-------------------
* ``KernelDesc`` — ``fn`` on the global tensors of its reads.
* ``StartDesc``  — the batch's transfers.  With a
  :class:`~.matching.CoalescePlan` each fused transfer is one
  ``pack_segments`` launch, one rank permutation and, per transfer, one
  ``unpack_segments`` launch that deposits straight into the receive
  buffers (the Hopper kernels of :mod:`repro_torch.kernels.halo_pack`);
  other deposits replay in channel order.  Each ``CollDesc`` of the
  batch then gathers, sums or moves every rank's block over its group
  along the collective's axis (:func:`_run_collective`, ``jax.lax``
  semantics, sums in group-rank order) into its output in place.
* ``WaitDesc``   — a join of the communication stream (``dataflow``).

Modes (triggers and waits as CUDA stream order)
-----------------------------------------------
``stream``   strict FIFO on one stream, the paper's literal semantics.
``dataflow`` transfers run on a communication stream: a start makes it
             wait on everything the compute stream enqueued so far (the
             writeValue), and a wait makes the compute stream wait on it
             (the waitValue), so the interior kernel between them
             overlaps the exchange.  On a CPU device it runs as
             ``stream``.

Both modes give the same bits: the ops and their order per buffer are
the same.  A kernel that updates a buffer in place (the halo unpack-add)
must not target a buffer that a pending batch sends from; Faces unpacks
after its wait.

Composed schedules: one CUDA stream per program
-----------------------------------------------
A composed :class:`~.schedule.STSchedule` runs each program on its own
stream (and, in ``dataflow`` mode, its own communication stream): every
side stream forks from the capture stream when the graph's work begins
and joins it at the end, so passes of a persistent loop pipeline across
programs.  Streams meet only where the schedule says:

* a cross-program channel completes on the *receiver's* bank: its
  transfer records an event, and the receiver's gating wait (resolved
  through :func:`~.effects.cross_gate_map`, as the verifier resolves
  it) makes the receiver's stream wait on it.  The interleave keeps
  every trigger ahead of its consumer's wait, so the event is always
  recorded before a wait on it is enqueued;
* a start makes its transfer stream wait on its own program's stream
  and on the stream of every program it deposits into, as far as each
  has been enqueued.  Receive slots are written in place, so without
  this a deposit of iteration i+1 could overwrite a slot the receiver
  is still reading in iteration i.

A plain program keeps one stream (and one comm stream): its graph is
the one it had before schedules existed.

Sanitizer (``sanitize=True``)
-----------------------------
:func:`~.verify.check_deposit_order` runs in the constructor, so a racy
program raises :class:`~.verify.SanitizeError` before any launch.  At
the start of every pass each :func:`~.verify.canary_buffers` buffer is
saved and filled with NaN (two multi-tensor launches a program); the
first replace deposit into it restores the saved copy on the deposit's
stream first, which equals the reference's ``where(is_receiver,
received, original)``.  Race-free programs give the same bits.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..kernels import graph_loop
from ..kernels.halo_pack import pack_segments, unpack_segments
from .descriptors import CollDesc, KernelDesc, StartDesc, WaitDesc
from .effects import cross_gate_map, resolve_gate
from .matching import Channel
from .queue import STProgram
from .state import init_buffers, is_rank_major, storage_shape, to_global, to_storage


def _axes_tuple(axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _is_full_identity(perm, axes: Tuple[str, ...],
                      mesh_shape: Dict[str, int]) -> bool:
    """True iff ``perm`` maps EVERY rank along ``axes`` to itself: the
    transfer returns its operand unchanged and can be elided.  A partial
    identity does not qualify (unmatched ranks receive zeros)."""
    n = 1
    for a in axes:
        n *= mesh_shape[a]
    return len(perm) == n and all(s == d for s, d in perm)


@dataclasses.dataclass
class Route:
    """One rank permutation on the device: ``out[r] = x[index[r]]``, then
    zeros at ``dead`` ranks (no sender).  ``receivers[r]`` is True where
    a sender exists (the ranks a replace deposit writes)."""

    identity: bool
    index: torch.Tensor
    dead: Optional[torch.Tensor]
    receivers: torch.Tensor
    n_receivers: int


@dataclasses.dataclass
class PlanConsts:
    """Device constants of one batch's coalescing plan."""

    routes: List[Route]                      # per transfer
    # per transfer: (channel indices, column offsets, receiver masks) of
    # the deposits one unpack_segments launch makes
    direct: Dict[int, Tuple[List[int], List[int], Optional[torch.Tensor]]]
    ordered: List[int]                       # other deposits, channel order
    # per destination program: the transfers carrying its final segments
    # (a cross channel completes on the receiver's bank)
    n_results: Dict[int, int]


class Lowering:
    """Device-side constants of one program on its mesh.

    Everything a pass needs from the host — permutation indices, zero
    fills, receiver masks, per-rank axis indices — is built here, once,
    before any CUDA-graph capture (a capture may not copy host data to
    the device).  ``storage[name]`` is the shape the engines hold buffer
    ``name`` in (:mod:`.state`: rank-major buffers as their global
    tensor, the others as the stack of their rank-local blocks).
    """

    def __init__(self, prog: STProgram):
        mesh = self.mesh = prog.mesh
        self.device = mesh.device
        self.mesh_shape = dict(mesh.shape)
        self.n_ranks = mesh.size
        self.n_rank_dims = len(mesh.axis_names)
        self.specs = prog.buffers
        self.storage = {n: storage_shape(s, mesh) for n, s in prog.buffers.items()}
        self._rank_major = {n: is_rank_major(s, mesh) for n, s in prog.buffers.items()}
        self._routes: Dict[Tuple, Route] = {}
        self._groups: Dict[Tuple[str, ...], Tuple] = {}
        self.plans: Dict[int, PlanConsts] = {}
        for b in prog.batches:
            for ch in b.channels:
                self.route(_axes_tuple(ch.axis), ch.perm(self.mesh_shape))
            for coll in b.colls:
                self.group(_axes_tuple(coll.axis))
                if coll.op == "ppermute":
                    self.group_route(_axes_tuple(coll.axis), coll.kwargs["perm"])
            if b.plan is not None:
                self.plans[b.index] = self._plan_consts(b.plan, prog, b.pid)

    def route(self, axes: Tuple[str, ...], perm) -> Route:
        key = (axes, tuple(map(tuple, perm)))
        if key not in self._routes:
            src = self.mesh.rank_sources(axes, perm)
            dead = np.flatnonzero(src < 0)
            as_dev = lambda a: torch.as_tensor(a, device=self.device)
            self._routes[key] = Route(
                identity=_is_full_identity(perm, axes, self.mesh_shape),
                index=as_dev(np.where(src < 0, 0, src)),
                dead=as_dev(dead) if dead.size else None,
                receivers=as_dev(src >= 0),
                n_receivers=int((src >= 0).sum()))
        return self._routes[key]

    def _plan_consts(self, plan, prog, pid: int) -> PlanConsts:
        routes = [self.route(_axes_tuple(t.axis), t.perm) for t in plan.transfers]
        dst_count: Dict[str, int] = {}
        for ch in plan.channels:
            dst_count[ch.dst_buf] = dst_count.get(ch.dst_buf, 0) + 1
        direct: Dict[int, Tuple[List[int], List[int], List[Route]]] = {}
        ordered: List[int] = []
        for ci, ch in enumerate(plan.channels):
            route = self.route(_axes_tuple(ch.axis), ch.perm(self.mesh_shape))
            hops = plan.routes[ci]
            if ch.mode == "replace" and route.n_receivers == 0:
                continue  # no rank has a sender: the deposit changes nothing
            spec = prog.buffers[ch.dst_buf]
            whole = (ch.mode == "replace" and ch.recv_region is None
                     and dst_count[ch.dst_buf] == 1 and hops
                     and spec.dtype == plan.transfers[hops[-1][0]].dtype
                     and int(np.prod(self.storage[ch.dst_buf])) // self.n_ranks
                     == int(np.prod(plan.shapes[ci])))
            if whole:
                ti, off = hops[-1]
                chans, offs, receivers = direct.setdefault(ti, ([], [], []))
                chans.append(ci)
                offs.append(off)
                receivers.append(route)
            else:
                ordered.append(ci)
        packed = {}
        for ti, (chans, offs, receivers) in direct.items():
            everyone = all(r.n_receivers == self.n_ranks for r in receivers)
            packed[ti] = (chans, offs, None if everyone else
                          torch.stack([r.receivers for r in receivers]))
        finals: Dict[int, set] = defaultdict(set)
        for ch, hops in zip(plan.channels, plan.routes):
            if hops:
                finals[pid if ch.dst_pid is None else ch.dst_pid].add(hops[-1][0])
        return PlanConsts(routes=routes, direct=packed, ordered=ordered,
                          n_results={q: len(ts) for q, ts in finals.items()})

    def lead(self, buf: Optional[str]) -> int:
        """Leading entries of the reference's per-rank view of ``buf`` that
        are unit rank dims here: a rank-major buffer's (also ``buf``
        None), none of a stacked one's."""
        return self.n_rank_dims if buf is None or self._rank_major[buf] else 0

    def ranks(self, t: torch.Tensor, buf: Optional[str] = None) -> torch.Tensor:
        """View a stored buffer as ``(R, *local)`` (``buf`` None:
        rank-major)."""
        return t.view(self.n_ranks, *t.shape[max(self.lead(buf), 1):])

    def local_region(self, region, buf: Optional[str] = None) -> Tuple[slice, ...]:
        """A region of the reference's per-rank view as a region of the
        ``(R, *local)`` view (rank dim first); for a rank-major buffer the
        reference's view starts with a unit dim a rank axis."""
        region = tuple(region)
        k = self.lead(buf)
        for s in region[:k]:
            if not (isinstance(s, slice) and s.indices(1) == (0, 1, 1)):
                raise NotImplementedError(
                    f"region {region!r}: a region must span the whole "
                    f"(unit) local extent of every rank axis")
        return (slice(None),) + region[k:]

    def group(self, axes: Tuple[str, ...]):
        """``(perm, inverse, (O, G))``: the rank dims reordered so that the
        ranks of one group along ``axes`` (linearized in ``axes`` order,
        as ``jax.lax`` collectives number them) are adjacent; O groups of
        G ranks."""
        if axes not in self._groups:
            names = self.mesh.axis_names
            for a in axes:
                if a not in names:
                    raise ValueError(f"mesh has no axis {a!r}")
            others = [i for i, a in enumerate(names) if a not in axes]
            perm = others + [names.index(a) for a in axes]
            inv = [perm.index(i) for i in range(len(names))]
            g = int(np.prod([self.mesh_shape[a] for a in axes], dtype=np.int64))
            self._groups[axes] = (perm, inv, (self.n_ranks // g, g))
        return self._groups[axes]

    def grouped(self, x: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
        """``(R, *local)`` as ``(O, G, *local)`` (:meth:`group`)."""
        perm, _, og = self.group(axes)
        k = len(perm)
        x = x.reshape(*self.mesh.axis_sizes, *x.shape[1:])
        x = x.permute(*perm, *range(k, x.dim()))
        return x.reshape(*og, *x.shape[k:])

    def ungrouped(self, x: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
        """Inverse of :meth:`grouped`: ``(O, G, *local)`` to ``(R, *local)``."""
        perm, inv, _ = self.group(axes)
        k = len(perm)
        x = x.reshape(*[self.mesh.axis_sizes[i] for i in perm], *x.shape[2:])
        x = x.permute(*inv, *range(k, x.dim()))
        return x.reshape(self.n_ranks, *x.shape[k:])

    def group_route(self, axes: Tuple[str, ...], perm) -> Route:
        """A ``ppermute`` collective's route, in group coordinates
        (``(O, G)`` flattened group-major)."""
        key = ("group", axes, tuple(map(tuple, perm)))
        if key not in self._routes:
            _, _, (o, g) = self.group(axes)
            src = np.full(g, -1, dtype=np.int64)
            for a, b in perm:
                src[int(b)] = int(a)
            full = np.array([q * g + s if s >= 0 else -1
                             for q in range(o) for s in src], dtype=np.int64)
            dead = np.flatnonzero(full < 0)
            as_dev = lambda a: torch.as_tensor(a, device=self.device)
            self._routes[key] = Route(
                identity=bool(len(perm) == g and all(a == b for a, b in perm)),
                index=as_dev(np.where(full < 0, 0, full)),
                dead=as_dev(dead) if dead.size else None,
                receivers=as_dev(full >= 0), n_receivers=int((full >= 0).sum()))
        return self._routes[key]

    def permute(self, x: torch.Tensor, route: Route) -> torch.Tensor:
        """Move ``x`` (rank-major) along a route; identity is elided."""
        if route.identity:
            return x
        out = x.index_select(0, route.index)
        if route.dead is not None:
            out.index_fill_(0, route.dead, 0)
        return out


def fresh_token_banks(prog: STProgram):
    """One (trigger, completion) counter pair per program id, as plain
    integers; a persistent loop threads them through every pass so they
    keep rising across iterations (MPIX_Queue reuse)."""
    pids = tuple(prog.buffers_by_pid())
    return {pid: 0 for pid in pids}, {pid: 0 for pid in pids}


@dataclasses.dataclass
class Lane:
    """The streams of one program on the card: ``stream`` runs its
    descriptors (None: the stream current when the work begins) and
    ``comm`` its transfers in ``dataflow`` mode (None: inline)."""

    stream: Optional[torch.cuda.Stream]
    comm: Optional[torch.cuda.Stream]


def _side_stream(device) -> torch.cuda.Stream:
    """A stream for a lane.  PyTorch hands streams out round-robin from a
    pool of 32 a priority, and ``torch.cuda.graph`` captures on one of the
    default-priority pool's: a default-priority lane stream is that very
    stream once the pool's counter comes round to it (what depends on how
    many streams the process made before), and then the fork is a no-op
    and the overlap serialises.  High-priority streams come from a pool of
    their own."""
    return torch.cuda.Stream(device, priority=-1)


def make_lanes(prog: STProgram, mode: str, device) -> Optional[Dict[int, Lane]]:
    """A lane per program on a CUDA device (None on a CPU device).  A
    plain program runs on the current stream; each program of a
    schedule gets a stream of its own."""
    if device.type != "cuda":
        return None
    pids = tuple(prog.buffers_by_pid())
    comm = (lambda: _side_stream(device)) if mode == "dataflow" else (lambda: None)
    if len(pids) == 1:
        return {pids[0]: Lane(None, comm())}
    return {pid: Lane(_side_stream(device), comm()) for pid in pids}


class PassStreams:
    """Stream order of the work between :meth:`__init__` (the side streams
    fork from the current stream) and :meth:`join` (it waits on all of
    them); one pass, or every pass of a persistent loop.  On a CPU
    device (``lanes`` None) everything runs inline and it orders nothing.

    ``held`` keeps tensors that another stream still reads or writes
    referenced until a join orders that stream's work before any reuse
    of their memory: sources of a comm stream until the program's wait
    joins it, cross-deposit destinations until the receiver's gating
    wait, canary copies until the end.
    """

    def __init__(self, lanes: Optional[Dict[int, Lane]], device):
        self.lanes = lanes
        if lanes is None:
            return
        self.home = torch.cuda.current_stream(device)
        self.own = {pid: lane.stream or self.home for pid, lane in lanes.items()}
        self.held: Dict[Any, List[torch.Tensor]] = defaultdict(list)
        self.signals: Dict[Tuple[int, int], List[torch.cuda.Event]] = defaultdict(list)
        self.fired: set = set()  # pids whose comm stream holds work
        for lane in lanes.values():
            if lane.stream is not None:
                lane.stream.wait_stream(self.home)

    def stream_of(self, pid: int):
        """The stream of program ``pid``'s kernels (None on a CPU)."""
        return None if self.lanes is None else self.own[pid]

    def trigger(self, pid: int, receivers, sources: List[torch.Tensor]):
        """The stream a start of ``pid`` fires its batch on, after it waits
        on ``pid``'s stream and on each receiver's stream."""
        if self.lanes is None:
            return None
        comm = self.lanes[pid].comm
        t = comm or self.own[pid]
        for q in sorted({pid, *receivers}):
            if self.own[q] is not t:
                t.wait_stream(self.own[q])
        if comm is not None:
            self.held[pid].extend(sources)
            self.fired.add(pid)
        return t

    def signal(self, t, gate: Tuple[int, int], held: List[torch.Tensor]) -> None:
        """A cross-program deposit fired on ``t``, observed by ``gate``'s wait."""
        if self.lanes is None:
            return
        event = torch.cuda.Event()
        event.record(t)
        self.signals[gate].append(event)
        self.held[gate].extend(held)

    def wait(self, pid: int, batch: int) -> None:
        """A wait of ``pid`` on ``batch``: join its comm stream and every
        cross deposit gated at or before ``batch`` (completion counters
        are cumulative)."""
        if self.lanes is None:
            return
        s, comm = self.own[pid], self.lanes[pid].comm
        if comm is not None:
            s.wait_stream(comm)
            self.held.pop(pid, None)
        for gate in [g for g in self.signals if g[0] == pid and g[1] <= batch]:
            for event in self.signals.pop(gate):
                s.wait_event(event)
            self.held.pop(gate, None)

    def join(self) -> None:
        """The current stream waits on every side stream (a capture must
        end with all of them joined)."""
        if self.lanes is None:
            return
        for pid, lane in self.lanes.items():
            # a comm stream no start forked (a program without a batch)
            # is not part of the work, nor of a capture
            comm = lane.comm if pid in self.fired else None
            for s in (lane.stream, comm):
                if s is not None:
                    self.home.wait_stream(s)
        self.held.clear()
        self.signals.clear()
        self.fired.clear()


def _on(stream):
    """Run what follows on ``stream`` (None: where it would run anyway)."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


def _as_buffer(o: torch.Tensor, spec, shape) -> torch.Tensor:
    """A kernel's output for buffer ``spec``, stored as ``shape``."""
    o = o.to(spec.dtype)
    if tuple(o.shape) != tuple(shape):
        raise ValueError(f"kernel wrote shape {tuple(o.shape)} into buffer "
                         f"{spec.name!r} stored as {tuple(shape)}")
    return o if o.is_contiguous() else o.contiguous()


def _plant_canaries(mem, prog: STProgram, streams: PassStreams) -> Dict[str, torch.Tensor]:
    """Save each canary buffer and fill it with NaN, a program's buffers
    on its own stream in two multi-tensor launches; returns the copies."""
    from .verify import canary_buffers

    names = set(canary_buffers(prog))
    saved: Dict[str, torch.Tensor] = {}
    for pid, owned in prog.buffers_by_pid().items():
        group = [n for n in owned if n in names and n in mem]
        if not group:
            continue
        with _on(streams.stream_of(pid)):
            copies = [torch.empty_like(mem[n]) for n in group]
            torch._foreach_copy_(copies, [mem[n] for n in group])
            torch._foreach_mul_([mem[n] for n in group], float("nan"))
        saved.update(zip(group, copies))
        if streams.lanes is not None:
            streams.held["canary"].extend(copies)
    return saved


def _interpret_program(
    mem: Dict[str, torch.Tensor],
    *,
    prog: STProgram,
    mode: str,
    low: Lowering,
    tokens: Optional[Dict[int, int]] = None,
    comp_tokens: Optional[Dict[int, int]] = None,
    coalesce: bool = True,
    lanes: Optional[Dict[int, Lane]] = None,
    streams: Optional[PassStreams] = None,
    sanitize: bool = False,
) -> Tuple[Dict[str, torch.Tensor], Dict[int, int], Dict[int, int]]:
    """Interpret one pass over ``prog``'s descriptors.

    Shared by :class:`FusedEngine` (one pass per call) and
    :class:`~.engine_persistent.PersistentEngine` (N passes per call).
    ``tokens``/``comp_tokens`` are the counter banks of a previous pass.
    ``streams`` orders the work on the card (see :class:`PassStreams`;
    the persistent loop keeps one across its passes); without it the
    pass makes its own from ``lanes`` and joins it at the end.  Receive
    buffers are written in place; kernels may rebind any buffer to a new
    tensor.  ``sanitize`` plants NaN canaries (module docstring).
    """
    mem = dict(mem)
    own_streams = streams is None
    if own_streams:
        streams = PassStreams(lanes, low.device)
    if tokens is None or comp_tokens is None:
        tokens, comp_tokens = fresh_token_banks(prog)
    tokens, comp_tokens = dict(tokens), dict(comp_tokens)
    batches = {b.index: b for b in prog.batches}
    gates, cursor = cross_gate_map(prog), defaultdict(int)
    saved = _plant_canaries(mem, prog, streams) if sanitize else {}

    for d in prog.descriptors:
        if isinstance(d, KernelDesc):
            with _on(streams.stream_of(d.pid)):
                outs = d.fn(*[mem[r] for r in d.reads])
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            if len(outs) != len(d.writes):
                raise ValueError(f"kernel {d.name!r} returned {len(outs)} "
                                 f"values for {len(d.writes)} write buffers")
            for w, o in zip(d.writes, outs):
                mem[w] = _as_buffer(o, prog.buffers[w], low.storage[w])
                saved.pop(w, None)  # a whole-buffer rewrite
        elif isinstance(d, StartDesc):
            batch = batches[d.batch]
            tokens[d.pid] += 1  # writeValue
            cross = [(ch, resolve_gate(gates, cursor, d.pid, d.batch, ch))
                     for ch in batch.channels if ch.dst_pid not in (None, d.pid)]
            t = streams.trigger(d.pid, {ch.dst_pid for ch, _ in cross},
                                [mem[ch.src_buf] for ch in batch.channels]
                                + [mem[c.buf] for c in batch.colls])
            with _on(t):
                restore = list(dict.fromkeys(
                    ch.dst_buf for ch in batch.channels
                    if ch.mode == "replace" and ch.dst_buf in saved))
                if restore:
                    torch._foreach_copy_([mem[n] for n in restore],
                                         [saved.pop(n) for n in restore])
                done = _run_batch(mem, batch, low, coalesce)
                for coll in batch.colls:
                    _run_collective(mem, coll, low)
                    saved.pop(coll.out, None)  # wholly overwritten
            if batch.colls:
                done = dict(done)
                done[d.pid] = done.get(d.pid, 0) + len(batch.colls)
            for ch, gate in cross:
                streams.signal(t, gate, [mem[ch.dst_buf]])
            for pid, n in done.items():
                comp_tokens[pid] += n
        elif isinstance(d, WaitDesc):
            streams.wait(d.pid, d.batch)  # waitValue
    if own_streams:
        streams.join()
    return mem, tokens, comp_tokens


def _run_batch(mem, batch, low: Lowering, coalesce: bool) -> Dict[int, int]:
    """Fire one batch; returns how many results complete it on each
    destination program's bank (a cross channel counts on the receiver's)."""
    if coalesce and batch.plan is not None:
        consts = low.plans[batch.index]
        _run_coalesced_batch(mem, batch.plan, consts, low)
        return consts.n_results
    done: Dict[int, int] = defaultdict(int)
    for ch in batch.channels:
        _run_channel(mem, ch, low)
        done[batch.pid if ch.dst_pid is None else ch.dst_pid] += 1
    return done


def _deposit_channel(mem, ch: Channel, received: torch.Tensor, low: Lowering):
    """Deposit one channel's received ``(R, *slab)`` into its destination,
    in place.  The receiver set always comes from the channel's own peer
    permutation, however the payload travelled."""
    dst = low.ranks(mem[ch.dst_buf], ch.dst_buf)
    region = (low.local_region(ch.recv_region, ch.dst_buf)
              if ch.recv_region is not None else (slice(None),))
    received = received.to(dst.dtype)
    if ch.mode == "add":
        # ranks without a sender received zeros: neutral for add
        dst[region] += received
        return
    route = low.route(_axes_tuple(ch.axis), ch.perm(low.mesh_shape))
    if route.n_receivers == low.n_ranks:
        dst[region] = received
    elif route.n_receivers:
        mask = route.receivers.view(-1, *([1] * (received.dim() - 1)))
        dst[region] = torch.where(mask, received, dst[region])


def _run_channel(mem, ch: Channel, low: Lowering) -> torch.Tensor:
    """One matched (send, recv) pair: slice, permute, deposit."""
    src = low.ranks(mem[ch.src_buf], ch.src_buf)
    if ch.send_region is not None:
        src = src[low.local_region(ch.send_region, ch.src_buf)]
    route = low.route(_axes_tuple(ch.axis), ch.perm(low.mesh_shape))
    received = low.permute(src, route)
    _deposit_channel(mem, ch, received, low)
    return received


def _run_coalesced_batch(mem, plan, consts: PlanConsts, low: Lowering):
    """Fire one batch's coalescing plan: fused by-axis transfers.

    Stage by stage, each transfer packs its members — first-hop slabs
    and verbatim relays of earlier hops — into one staging buffer with
    ONE ``pack_segments`` launch (the paper's contiguous MPI buffer) and
    moves it with one rank permutation.  Whole-buffer replace deposits
    then land with one ``unpack_segments`` launch per transfer; the
    others replay in channel order (bit-identical to per-channel).
    """
    n = low.n_ranks
    received: List[torch.Tensor] = []
    for t, route in zip(plan.transfers, consts.routes):
        sources = []
        for seg in t.segments:
            if seg.hop == 0:
                ch = plan.channels[seg.channel]
                src = low.ranks(mem[ch.src_buf], ch.src_buf)
                if ch.send_region is not None:
                    src = src[low.local_region(ch.send_region, ch.src_buf)]
                sources.append((src.reshape(n, -1), 0))
            else:  # relay: verbatim out of the previous hop's buffer
                pt, po = plan.routes[seg.channel][seg.hop - 1]
                sources.append((received[pt], po))
        staged = pack_segments(sources, [s.size for s in t.segments])
        received.append(low.permute(staged, route))

    for ti, (chans, offs, masks) in consts.direct.items():
        unpack_segments(received[ti],
                        [mem[plan.channels[ci].dst_buf] for ci in chans],
                        offs, masks)
    for ci in consts.ordered:
        ch, hops = plan.channels[ci], plan.routes[ci]
        shape = plan.shapes[ci][low.lead(ch.src_buf):]  # per-rank slab, rank dims dropped
        if hops:
            ti, off = hops[-1]
            size = int(np.prod(shape, dtype=np.int64))
            seg = received[ti][:, off:off + size].reshape(n, *shape)
        else:  # statically dead: its transfer would deliver zeros
            seg = torch.zeros((n, *shape), dtype=mem[ch.src_buf].dtype,
                              device=low.device)
        _deposit_channel(mem, ch, seg, low)
    return received


def _rank_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 1 in group-rank order (one add at a time)."""
    acc = x[:, 0]
    for j in range(1, x.shape[1]):
        acc = acc + x[:, j]
    return acc


def _collective_blocks(op: str, x: torch.Tensor, kwargs, low: Lowering,
                      axes: Tuple[str, ...]) -> torch.Tensor:
    """A ``jax.lax`` collective on grouped blocks: ``x`` is ``(O, G,
    *local)`` (:meth:`Lowering.grouped`, G ranks a group), and so is the
    result, one output block a rank.  Sums run in group-rank order."""
    o, g = x.shape[:2]
    loc = tuple(x.shape[2:])
    kw = dict(kwargs)

    def everyone(y):  # one result, every rank of the group
        return y.unsqueeze(1).expand(o, g, *y.shape[1:])

    if op == "all_gather":
        d = kw.get("dim", 0)
        parts = x.unbind(1)
        y = torch.cat(parts, dim=1 + d) if kw.get("tiled", True) \
            else torch.stack(parts, dim=1 + d)
        return everyone(y)
    if op == "all_reduce":
        return everyone(_rank_sum(x))
    if op == "reduce_scatter":
        d = kw.get("dim", 0)
        y = _rank_sum(x)
        if kw.get("tiled", True):
            if loc[d] % g:
                raise ValueError(f"reduce_scatter: dim {d} ({loc[d]}) does not "
                                 f"divide by the group size {g}")
            y = y.reshape(o, *loc[:d], g, loc[d] // g, *loc[d + 1:])
        elif loc[d] != g:
            raise ValueError(f"reduce_scatter(tiled=False): dim {d} must equal "
                             f"the group size {g}, got {loc[d]}")
        return y.movedim(1 + d, 1)
    if op == "all_to_all":
        sa, ca = kw.get("split_axis", 0), kw.get("concat_axis", 0)
        if kw.get("tiled", True):
            if loc[sa] % g:
                raise ValueError(f"all_to_all: split_axis {sa} ({loc[sa]}) does "
                                 f"not divide by the group size {g}")
            y = x.reshape(o, g, *loc[:sa], g, loc[sa] // g, *loc[sa + 1:])
            y = y.movedim(2 + sa, 1)  # (O, receiver, sender, *block)
            return torch.cat(y.unbind(2), dim=2 + ca)
        if loc[sa] != g:
            raise ValueError(f"all_to_all(tiled=False): split_axis {sa} must "
                             f"equal the group size {g}, got {loc[sa]}")
        y = x.movedim(2 + sa, 1)
        return torch.stack(y.unbind(2), dim=2 + ca)
    if op == "ppermute":
        route = low.group_route(axes, kw["perm"])
        return low.permute(x.reshape(o * g, *loc), route).reshape(o, g, *loc)
    raise ValueError(f"unknown collective {op!r}")  # validated at enqueue


def _run_collective(mem, coll: CollDesc, low: Lowering) -> None:
    """One deferred collective (reference ``engine_fused._run_collective``):
    every rank's block of ``coll.buf`` gathered, summed or moved over its
    group along ``coll.axis``, deposited into ``coll.out`` in place."""
    axes = _axes_tuple(coll.axis)
    x = low.grouped(low.ranks(mem[coll.buf], coll.buf), axes)
    y = low.ungrouped(_collective_blocks(coll.op, x, coll.kwargs, low, axes), axes)
    dst = low.ranks(mem[coll.out], coll.out)
    if tuple(y.shape) != tuple(dst.shape):
        raise ValueError(f"collective {coll.op} of {coll.buf!r} gives per-rank "
                         f"blocks {tuple(y.shape[1:])}, but {coll.out!r} holds "
                         f"{tuple(dst.shape[1:])}")
    dst.copy_(y)


class FusedEngine:
    """Run an STProgram as one CUDA-graph launch per call.

    Buffers: the engine owns one tensor per program buffer, in the
    layout of :mod:`.state` (a buffer that is not rank-major as the
    stack of its rank-local blocks).  A call takes each buffer in the
    reference's global layout, copies it into the engine's own (skipped
    for a tensor that already is the engine's), launches the pass, and
    returns the global layout: fresh copies, or with ``donate=True`` the
    engine's own tensors or views of them, which the next call
    overwrites (``m = eng(m)`` then chains without copies).  The
    caller's tensors are never written.

    On a GPU, :meth:`compile` runs one eager warm-up pass on scratch
    copies (it builds and loads every kernel before capture) and then
    captures one pass; on a CPU device every call runs the pass eagerly.
    ``stats.dispatches`` counts calls, ``graph_launches`` the graph
    replays among them (one a call on the card).  A composed
    :class:`~.schedule.STSchedule` runs each program on its own stream
    (module docstring).  ``sanitize=True`` adds the runtime sanitizer.
    """

    def __init__(self, program: STProgram, mode: str = "stream",
                 donate: bool = False, coalesce: bool = True,
                 sanitize: bool = False):
        if mode not in ("stream", "dataflow"):
            raise ValueError("mode must be 'stream' or 'dataflow'")
        program.require_closed()
        if sanitize:
            from .verify import check_deposit_order
            check_deposit_order(program)
        from .engine_host import HostStats
        self.program = program
        self.mode = mode
        self.donate = donate
        self.coalesce = coalesce
        self.sanitize = sanitize
        self.mesh = program.mesh
        self.device = self.mesh.device
        self.stats = HostStats()
        self._lowering = Lowering(program)
        self._lanes = make_lanes(program, mode, self.device)
        self._bufs: Optional[Dict[str, torch.Tensor]] = None
        self._views: Dict[str, torch.Tensor] = {}
        self._graph: Optional[Any] = None
        self.graph_launches = 0

    def init_buffers(self, init: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
        """Zeros (or ``init`` values) for every buffer, on the mesh device,
        in the reference's global layout."""
        return init_buffers(self.program, init)

    def _sources(self, mem: Dict[str, torch.Tensor]):
        """``(engine tensors, sources)`` to copy a call's buffers in, each
        source in its stored form; a tensor that is the engine's own (or a
        view it returned) is skipped."""
        dsts, srcs = [], []
        for name, t in self._bufs.items():
            src = mem[name]
            if src is t or src is self._views.get(name):
                continue
            dsts.append(t)
            srcs.append(to_storage(self.program.buffers[name], self.mesh, src))
        return dsts, srcs

    def _outputs(self, bufs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A call's result in the global layout: copies, or with
        ``donate`` the engine's own tensors (views where the layout
        allows)."""
        specs = self.program.buffers
        out = {n: to_global(specs[n], self.mesh, t) for n, t in bufs.items()}
        if self.donate:
            # a returned view of an engine tensor is that tensor to the
            # next call
            same = lambda a, b: a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
            self._views = {n: v for n, v in out.items()
                           if v is not bufs[n] and bufs[n] is self._bufs[n]
                           and same(v, bufs[n])}
            return out
        return {n: t.clone(memory_format=torch.contiguous_format)
                for n, t in out.items()}

    def _pass(self, mem: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return _interpret_program(mem, prog=self.program, mode=self.mode,
                                  low=self._lowering, coalesce=self.coalesce,
                                  lanes=self._lanes, sanitize=self.sanitize)[0]

    def _run_into(self, bufs: Dict[str, torch.Tensor]) -> None:
        out = self._pass(bufs)
        for name, t in bufs.items():
            if out[name] is not t:
                t.copy_(out[name])

    def _allocate(self) -> None:
        self._bufs = {n: torch.zeros(self._lowering.storage[n], dtype=spec.dtype,
                                     device=self.device)
                      for n, spec in self.program.buffers.items()}

    def compile(self):
        """Allocate the engine's buffers and, on a GPU, capture the graph."""
        if self._bufs is None:
            self._allocate()
        if self.device.type == "cuda" and self._graph is None:
            self._run_into({n: t.clone() for n, t in self._bufs.items()})
            torch.cuda.synchronize(self.device)
            self._graph = graph_loop.capture(lambda: self._run_into(self._bufs),
                                             keep_graph=False)[0]
        return self._graph

    def _launch(self, mem: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.compile()
        for t, src in zip(*self._sources(mem)):
            t.copy_(src)
        if self._graph is not None:
            self._graph.replay()
            self.graph_launches += 1
        else:
            self._run_into(self._bufs)
        self.stats.dispatches += 1
        return self._outputs(self._bufs)

    def __call__(self, mem: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self._launch(mem)
