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
  other deposits replay in channel order.
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

from ..kernels.halo_pack import pack_segments, unpack_segments
from .descriptors import KernelDesc, StartDesc, WaitDesc
from .effects import cross_gate_map, resolve_gate
from .matching import Channel
from .queue import STProgram
from .state import init_buffers


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
    fills, receiver masks — is built here, once, before any CUDA-graph
    capture (a capture may not copy host data to the device).
    """

    def __init__(self, prog: STProgram):
        mesh = prog.mesh
        self.mesh = mesh
        self.device = mesh.device
        self.mesh_shape = dict(mesh.shape)
        self.n_ranks = mesh.size
        self.n_rank_dims = len(mesh.axis_names)
        for spec in prog.buffers.values():
            k = self.n_rank_dims
            if (tuple(spec.pspec[:k]) != mesh.axis_names
                    or tuple(spec.shape[:k]) != mesh.axis_sizes
                    or any(p is not None for p in spec.pspec[k:])):
                raise NotImplementedError(
                    f"buffer {spec.name!r}: the port holds buffers in the "
                    f"global rank-major layout (leading dims = mesh axes "
                    f"{mesh.axis_names} of sizes {mesh.axis_sizes}), got "
                    f"shape {spec.shape} pspec {spec.pspec}")
        self._routes: Dict[Tuple, Route] = {}
        self.plans: Dict[int, PlanConsts] = {}
        for b in prog.batches:
            for ch in b.channels:
                self.route(_axes_tuple(ch.axis), ch.perm(self.mesh_shape))
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
                     and int(np.prod(spec.shape)) // self.n_ranks
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

    def ranks(self, t: torch.Tensor) -> torch.Tensor:
        """View a global buffer as ``(R, *local)``."""
        return t.view(self.n_ranks, *t.shape[self.n_rank_dims:])

    def local_region(self, region) -> Tuple[slice, ...]:
        """A region of the reference's per-rank view ``(1,..,1, *local)``
        as a region of the ``(R, *local)`` view (rank dim first)."""
        region = tuple(region)
        for s in region[:self.n_rank_dims]:
            if not (isinstance(s, slice) and s.indices(1) == (0, 1, 1)):
                raise NotImplementedError(
                    f"region {region!r}: a region must span the whole "
                    f"(unit) local extent of every rank axis")
        return (slice(None),) + region[self.n_rank_dims:]

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


def make_lanes(prog: STProgram, mode: str, device) -> Optional[Dict[int, Lane]]:
    """A lane per program on a CUDA device (None on a CPU device).  A
    plain program runs on the current stream; each program of a
    schedule gets a stream of its own."""
    if device.type != "cuda":
        return None
    pids = tuple(prog.buffers_by_pid())
    comm = (lambda: torch.cuda.Stream(device)) if mode == "dataflow" else (lambda: None)
    if len(pids) == 1:
        return {pids[0]: Lane(None, comm())}
    return {pid: Lane(torch.cuda.Stream(device), comm()) for pid in pids}


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
        for lane in self.lanes.values():
            for s in (lane.stream, lane.comm):
                if s is not None:
                    self.home.wait_stream(s)
        self.held.clear()
        self.signals.clear()


def _on(stream):
    """Run what follows on ``stream`` (None: where it would run anyway)."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


def _as_buffer(o: torch.Tensor, spec) -> torch.Tensor:
    o = o.to(spec.dtype)
    if tuple(o.shape) != tuple(spec.shape):
        raise ValueError(f"kernel wrote shape {tuple(o.shape)} into buffer "
                         f"{spec.name!r} of shape {spec.shape}")
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
                mem[w] = _as_buffer(o, prog.buffers[w])
                saved.pop(w, None)  # a whole-buffer rewrite
        elif isinstance(d, StartDesc):
            batch = batches[d.batch]
            tokens[d.pid] += 1  # writeValue
            cross = [(ch, resolve_gate(gates, cursor, d.pid, d.batch, ch))
                     for ch in batch.channels if ch.dst_pid not in (None, d.pid)]
            t = streams.trigger(d.pid, {ch.dst_pid for ch, _ in cross},
                                [mem[ch.src_buf] for ch in batch.channels])
            with _on(t):
                restore = list(dict.fromkeys(
                    ch.dst_buf for ch in batch.channels
                    if ch.mode == "replace" and ch.dst_buf in saved))
                if restore:
                    torch._foreach_copy_([mem[n] for n in restore],
                                         [saved.pop(n) for n in restore])
                done = _run_batch(mem, batch, low, coalesce)
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
    dst = low.ranks(mem[ch.dst_buf])
    region = (low.local_region(ch.recv_region) if ch.recv_region is not None
              else (slice(None),))
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
    src = low.ranks(mem[ch.src_buf])
    if ch.send_region is not None:
        src = src[low.local_region(ch.send_region)]
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
                src = low.ranks(mem[ch.src_buf])
                if ch.send_region is not None:
                    src = src[low.local_region(ch.send_region)]
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
        shape = plan.shapes[ci][low.n_rank_dims:]  # per-rank slab, rank dims dropped
        if hops:
            ti, off = hops[-1]
            size = int(np.prod(shape, dtype=np.int64))
            seg = received[ti][:, off:off + size].reshape(n, *shape)
        else:  # statically dead: its transfer would deliver zeros
            seg = torch.zeros((n, *shape), dtype=mem[ch.src_buf].dtype,
                              device=low.device)
        _deposit_channel(mem, ch, seg, low)
    return received


class FusedEngine:
    """Run an STProgram as one CUDA-graph launch per call.

    Buffers: the engine owns one tensor per program buffer.  A call
    copies each given tensor into the engine's own (skipped for a tensor
    that already is the engine's), launches the pass, and returns fresh
    copies — or, with ``donate=True``, the engine's own tensors, which
    the next call overwrites (``m = eng(m)`` then chains without copies).
    The caller's tensors are never written.

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
        self._graph: Optional[Any] = None
        self.graph_launches = 0

    def init_buffers(self, init: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
        """Zeros (or ``init`` values) for every buffer, on the mesh device."""
        return init_buffers(self.program, init)

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
        self._bufs = self.init_buffers()

    def compile(self):
        """Allocate the engine's buffers and, on a GPU, capture the graph."""
        if self._bufs is None:
            self._allocate()
        if self.device.type == "cuda" and self._graph is None:
            self._run_into({n: t.clone() for n, t in self._bufs.items()})
            torch.cuda.synchronize(self.device)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self._run_into(self._bufs)
            self._graph = graph
        return self._graph

    def _launch(self, mem: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        self.compile()
        for name, t in self._bufs.items():
            if mem[name] is not t:
                t.copy_(mem[name])
        if self._graph is not None:
            self._graph.replay()
            self.graph_launches += 1
        else:
            self._run_into(self._bufs)
        self.stats.dispatches += 1
        if self.donate:
            return dict(self._bufs)
        return {n: t.clone() for n, t in self._bufs.items()}

    def __call__(self, mem: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return self._launch(mem)
