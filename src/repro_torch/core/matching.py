"""Static two-sided message matching and channel coalescing.

Port of ``repro.core.matching``.  The ST interface forbids wildcards
(paper §III-D), so every send's peer and tag are known when the program
is built: matching happens at build time, and each matched (send, recv)
pair becomes one :class:`Channel` — on one GPU, a copy that permutes
along the rank axes.

* within one trigger batch, sends and recvs with equal tags match in
  FIFO order (non-overtaking);
* a send to ``OffsetPeer(axis, +d)`` matches a recv from
  ``OffsetPeer(axis, -d)`` (the receiver names where data comes from);
* ``PairListPeer`` sends and recvs match on identical pair sets;
* an unmatched descriptor is a build error (at run time it would hang);
* sends/recvs marked ``remote=<program>`` are cross-program: the queue's
  build leaves them open and :func:`~.schedule.compose` matches them
  across the composed programs (:func:`match_cross_program`) into
  channels whose deposit lands in the peer program's memory and
  completes on the peer's counter bank.

:func:`coalesce_batch` is the paper's §V-A contiguous-buffer step: each
channel's offset is split into single-axis hops, channels are grouped by
``(stage, axis, permutation, dtype)``, and each group becomes ONE fused
transfer (:class:`CoalescedChannel`) whose member slabs sit at static
offsets of one staging buffer.  Deposits replay in original channel
order, so results match the per-channel lowering bit for bit.  Direct26
goes from 26 transfers per start to 6.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .descriptors import (
    CollDesc,
    GridOffsetPeer,
    OffsetPeer,
    PairListPeer,
    RecvDesc,
    SendDesc,
    StartDesc,
    WaitDesc,
    as_torch_dtype,
    dtype_str,
    hop_decomposition,
    perm_for,
)


@dataclasses.dataclass
class Channel:
    """A matched (send, recv) pair: one rank-permuting transfer."""

    src_buf: str
    dst_buf: str
    axis: Any  # axis name or tuple of axis names
    peer: Any  # the *send-side* peer spec (canonical direction)
    tag: int
    send_region: Optional[Tuple[slice, ...]]
    recv_region: Optional[Tuple[slice, ...]]
    mode: str  # replace | add
    # Cross-program channel: the pid whose buffer the deposit lands in and
    # whose completion counter it bumps (None: the batch's own program).
    dst_pid: Optional[int] = None
    send_site: Optional[str] = None
    recv_site: Optional[str] = None

    def perm(self, mesh_shape: dict) -> Sequence[Tuple[int, int]]:
        return perm_for(self.peer, mesh_shape)[1]


class MatchError(RuntimeError):
    pass


def _site_of(d) -> str:
    """Enqueue-site suffix for error messages ('' when not captured)."""
    site = getattr(d, "site", None)
    return f" [enqueued at {site}]" if site else ""


def _peer_key(peer) -> Tuple:
    """Canonical direction key: send(+d) and recv(-d) share a key."""
    if isinstance(peer, OffsetPeer):
        return ("off", peer.axis, peer.delta, peer.periodic)
    if isinstance(peer, GridOffsetPeer):
        return ("grid", peer.axes, peer.deltas, peer.periodic)
    if isinstance(peer, PairListPeer):
        return ("pairs", peer.axis, tuple(sorted(peer.pairs)))
    raise TypeError(f"unknown peer: {peer!r}")


def _recv_key_as_send(peer) -> Tuple:
    """Key a recv descriptor under the *sender's* direction."""
    if isinstance(peer, (OffsetPeer, GridOffsetPeer)):
        return _peer_key(peer.inverse())
    return _peer_key(peer)


def _match_fifo(sends, recvs, make_channel, kind: str) -> List:
    """Pair each send with the first queued recv under its (direction,
    tag) key and build ``make_channel(send, recv)``; raise on leftovers.
    Elements are descriptors or ``(descriptor, extra)`` pairs."""
    desc = lambda x: x[0] if isinstance(x, tuple) else x
    recv_queues: dict = defaultdict(list)
    for r in recvs:
        recv_queues[(_recv_key_as_send(desc(r).peer), desc(r).tag)].append(r)
    out: List = []
    for s in sends:
        d = desc(s)
        q = recv_queues.get((_peer_key(d.peer), d.tag))
        if not q:
            raise MatchError(
                f"unmatched {kind} send: buf={d.buf!r} tag={d.tag} peer={d.peer}"
                + (f" remote={d.remote!r}" if d.remote else "")
                + " (no matching posted receive; ST forbids wildcards so "
                  "this would hang at runtime)" + _site_of(d))
        out.append(make_channel(s, q.pop(0)))
    leftovers = [desc(r) for q in recv_queues.values() for r in q]
    if leftovers:
        r = leftovers[0]
        raise MatchError(
            f"unmatched {kind} recv: buf={r.buf!r} tag={r.tag} peer={r.peer}"
            + (f" remote={r.remote!r}" if r.remote else "")
            + f" ({len(leftovers)} receive(s) never matched by a send)"
            + _site_of(r))
    return out


def _channel_for(s: SendDesc, r: RecvDesc,
                 dst_pid: Optional[int] = None) -> Channel:
    axis = (s.peer.axis if isinstance(s.peer, (OffsetPeer, PairListPeer))
            else s.peer.axes)
    return Channel(src_buf=s.buf, dst_buf=r.buf, axis=axis, peer=s.peer,
                   tag=s.tag, send_region=s.region, recv_region=r.region,
                   mode=r.mode, dst_pid=dst_pid, send_site=s.site,
                   recv_site=r.site)


def match_batch(sends: Sequence[SendDesc],
                recvs: Sequence[RecvDesc]) -> List[Channel]:
    """Match one trigger batch's sends against its recvs (FIFO per key)."""
    return _match_fifo(sends, recvs, _channel_for, "ST")


def match_cross_program(sends: Sequence[Tuple[SendDesc, int]],
                        recvs: Sequence[Tuple[RecvDesc, int]],
                        dst_pid: int) -> List[Tuple[Channel, int, int]]:
    """Match one program's open (``remote=``) sends against a peer
    program's open recvs, FIFO per key as :func:`match_batch`, pooled
    across the programs' batches.  Elements are ``(descriptor, global
    batch index)``; returns ``[(channel, src_batch, dst_batch), ...]``,
    each channel carrying ``dst_pid``.  Raises :class:`MatchError` on any
    unmatched open descriptor."""
    return _match_fifo(
        sends, recvs,
        lambda s, r: (_channel_for(s[0], r[0], dst_pid=dst_pid), s[1], r[1]),
        "cross-program")


@dataclasses.dataclass
class Batch:
    """Everything triggered by one start (paper: one writeValue)."""

    index: int
    kernels_before: List[Any]  # KernelDescs enqueued before this start
    channels: List[Channel]
    colls: List[CollDesc] = dataclasses.field(default_factory=list)
    waited: bool = False
    pid: int = 0
    # Build-time coalescing plan; None when coalescing is off or declined.
    plan: Optional["CoalescePlan"] = None
    # Whether coalescing was requested (compose re-derives plans once
    # cross channels join the batch; a None plan cannot tell "declined"
    # from "off").
    coalesce: bool = False
    # Unresolved remote= sends/recvs: recorded by the queue's build,
    # consumed by compose.  A program holding any cannot run.
    open_sends: List[Any] = dataclasses.field(default_factory=list)
    open_recvs: List[Any] = dataclasses.field(default_factory=list)
    # Buffers another program deposits into that this batch's wait gates
    # (filled by compose).
    cross_recv_bufs: Tuple[str, ...] = ()
    # Declared effect set (effects.batch_effects).
    effects: Tuple[Any, ...] = ()


# --------------------------------------------------------------------------
# Channel coalescing
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Segment:
    """One member channel's slab inside a fused transfer's staging buffer."""

    channel: int  # index into the batch's channel list
    hop: int      # hop index along the channel's route
    offset: int   # static element offset into the staging buffer (per rank)
    size: int     # flattened slab size (per rank)


@dataclasses.dataclass(frozen=True)
class CoalescedChannel:
    """One fused transfer: member slabs in one staging buffer, one permute."""

    axis: str
    perm: Tuple[Tuple[int, int], ...]
    dtype: torch.dtype
    stage: int  # execution stage (by-axis round) within the batch
    segments: Tuple[Segment, ...]
    # Declared staging-buffer identity (effects.stamp_staging).
    staging: Optional[str] = None

    @property
    def size(self) -> int:
        return sum(s.size for s in self.segments)


@dataclasses.dataclass(frozen=True)
class CoalescePlan:
    """A batch's coalescing plan.

    ``transfers`` run in order (later stages relay earlier stages'
    payloads); ``routes[ci][k] = (transfer_index, offset)`` locates
    channel ``ci``'s payload at hop ``k``; deposits replay in original
    channel order.
    """

    channels: Tuple[Channel, ...]
    transfers: Tuple[CoalescedChannel, ...]
    routes: Tuple[Tuple[Tuple[int, int], ...], ...]
    shapes: Tuple[Tuple[int, ...], ...]  # local slab shape per channel

    @property
    def n_collectives(self) -> int:
        return len(self.transfers)

    @property
    def dead_channels(self) -> Tuple[int, ...]:
        """Channels with a statically empty permutation: every rank
        receives zeros, so they ride no transfer."""
        return tuple(ci for ci, r in enumerate(self.routes) if not r)


class _NoCoalesce(Exception):
    """Internal: this batch cannot be coalesced; keep it per-channel."""


def _local_shape(spec, mesh_shape: Dict[str, int]) -> Tuple[int, ...]:
    """Per-rank shape of a buffer (the reference's per-shard view)."""
    pspec = tuple(spec.pspec) + (None,) * (len(spec.shape) - len(spec.pspec))
    out = []
    for dim, entry in zip(spec.shape, pspec):
        if entry is None or entry == ():
            axes: Tuple[str, ...] = ()
        elif isinstance(entry, str):
            axes = (entry,)
        else:
            axes = tuple(entry)
        k = 1
        for a in axes:
            k *= mesh_shape[a]
        if k <= 0 or dim % k:
            raise _NoCoalesce(f"dim {dim} not divisible by mesh factor {k}")
        out.append(dim // k)
    return tuple(out)


def _send_shape(ch: Channel, buffers, mesh_shape) -> Tuple[int, ...]:
    """Static per-rank shape of the slab a channel sends."""
    local = _local_shape(buffers[ch.src_buf], mesh_shape)
    if ch.send_region is None:
        return local
    region = tuple(ch.send_region)
    if len(region) > len(local):
        raise _NoCoalesce("send_region ranks exceed buffer rank")
    region = region + tuple(slice(None) for _ in local[len(region):])
    shape = []
    for sl, dim in zip(region, local):
        if not isinstance(sl, slice):
            raise _NoCoalesce("non-slice region entries are not coalescable")
        start, stop, step = sl.indices(dim)
        if step != 1:
            raise _NoCoalesce("strided send regions are not coalescable")
        shape.append(max(0, stop - start))
    return tuple(shape)


def _channel_hops(ch: Channel, axis_order) -> List[Tuple]:
    hops = hop_decomposition(ch.peer, axis_order)
    if hops is not None:
        return [("off", axis, delta, periodic) for axis, delta, periodic in hops]
    if isinstance(ch.peer, PairListPeer):
        return [("pairs", ch.peer.axis, tuple(ch.peer.pairs), False)]
    raise _NoCoalesce(f"peer {ch.peer!r} has no hop decomposition")


def coalesce_batch(channels: Sequence[Channel], buffers,
                   mesh_shape: Dict[str, int]) -> Optional[CoalescePlan]:
    """Group one batch's channels into fused by-axis transfers.

    Returns ``None`` (batch stays per-channel) when the batch is empty,
    when a slab shape or route cannot be derived statically, or when a
    channel sends from a buffer another channel deposits into (a fused
    pack reads every source before any deposit).
    """
    if not channels:
        return None
    if {c.src_buf for c in channels} & {c.dst_buf for c in channels}:
        return None
    axis_order = tuple(mesh_shape)
    try:
        shapes = [_send_shape(ch, buffers, mesh_shape) for ch in channels]
        hops_per_channel = [_channel_hops(ch, axis_order) for ch in channels]
    except _NoCoalesce:
        return None
    axis_rank = {a: i for i, a in enumerate(axis_order)}

    # group hops into transfers; first-seen order breaks ties inside a stage
    order: Dict[Tuple, int] = {}
    groups: Dict[Tuple, List[Segment]] = {}
    sizes: Dict[Tuple, int] = {}
    route_keys: List[List[Tuple[Tuple, int]]] = []
    for ci, (ch, hops) in enumerate(zip(channels, hops_per_channel)):
        if not perm_for(ch.peer, mesh_shape)[1]:
            route_keys.append([])  # statically dead: deposits zeros only
            continue
        size = int(np.prod(shapes[ci], dtype=np.int64))
        dkey = dtype_str(buffers[ch.src_buf].dtype)
        route = []
        for k, hop in enumerate(hops):
            key = (axis_rank.get(hop[1], 0),) + hop + (dkey,)
            if key not in order:
                order[key] = len(order)
                groups[key] = []
                sizes[key] = 0
            off = sizes[key]
            groups[key].append(Segment(channel=ci, hop=k, offset=off, size=size))
            sizes[key] += size
            route.append((key, off))
        route_keys.append(route)

    dtype_of = {dtype_str(b.dtype): as_torch_dtype(b.dtype)
                for b in buffers.values()}
    keys = sorted(order, key=lambda k: (k[0], order[k]))
    index_of = {k: i for i, k in enumerate(keys)}
    transfers = []
    for key in keys:
        stage, kind, axis, payload, periodic, dkey = key
        if kind == "off":
            perm = perm_for(OffsetPeer(axis, payload, periodic), mesh_shape)[1]
        else:
            perm = list(payload)
        transfers.append(CoalescedChannel(
            axis=axis, perm=tuple(perm), dtype=dtype_of[dkey],
            stage=stage, segments=tuple(groups[key])))
    routes = tuple(tuple((index_of[key], off) for key, off in route)
                   for route in route_keys)
    return CoalescePlan(channels=tuple(channels), transfers=tuple(transfers),
                        routes=routes, shapes=tuple(shapes))


def validate_program_order(descs: Sequence[Any]) -> None:
    """Queue-level FIFO invariants, raised at build:

    * every send/recv/collective must be covered by a later start;
    * a wait must follow a start;
    * thresholds are monotonically non-decreasing (DWQ contract).
    """
    open_comm = 0
    open_site = None
    started = 0
    waits_seen = 0
    last_threshold = 0
    for d in descs:
        if isinstance(d, (SendDesc, RecvDesc, CollDesc)):
            open_comm += 1
            open_site = d.site or open_site
            if 0 <= d.threshold < last_threshold:
                raise MatchError("[ST003] descriptor thresholds must be "
                                 "monotone" + _site_of(d))
            last_threshold = max(last_threshold, d.threshold)
        elif isinstance(d, StartDesc):
            started += 1
            open_comm = 0
            open_site = None
        elif isinstance(d, WaitDesc):
            waits_seen += 1
            if waits_seen > started:
                raise MatchError("[ST002] MPIX_Enqueue_wait before any "
                                 "matching MPIX_Enqueue_start" + _site_of(d))
    if open_comm:
        raise MatchError(
            f"[ST004] {open_comm} enqueued communication op(s) not covered "
            f"by an MPIX_Enqueue_start — they would never trigger"
            + (f" [last enqueued at {open_site}]" if open_site else ""))
