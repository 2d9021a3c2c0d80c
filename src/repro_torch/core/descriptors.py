"""Deferred-execution descriptors — the ST command-queue entries.

Port of ``repro.core.descriptors``.  An :class:`~.queue.STQueue`
records an ordered list of these; nothing runs at enqueue time, and an
engine executes the built program later.

``KernelDesc``  a compute kernel on the stream, over named buffers.
``SendDesc``    MPIX_Enqueue_send: deferred tagged send to a peer.
``RecvDesc``    MPIX_Enqueue_recv: deferred tagged receive.
``StartDesc``   MPIX_Enqueue_start: trigger the batch enqueued since the
                previous start (one writeValue).
``WaitDesc``    MPIX_Enqueue_wait: stream-blocking completion wait.

Peers are relational, as in the reference: ``OffsetPeer(axis, delta)``,
``GridOffsetPeer(axes, deltas)`` (the 26-neighbour Faces pattern) and
``PairListPeer(axis, pairs)``.

``CollDesc`` is a deferred whole collective (``all_gather``,
``reduce_scatter``, ``all_reduce``, ``all_to_all``, ``ppermute``) over a
mesh axis; it fires with its batch's start like a channel, and on one
GPU it is a gather or a sum over the rank axis.

Every descriptor carries a ``pid`` (program id): 0 in a program built by
one :class:`~.queue.STQueue`; :func:`~.schedule.compose` gives each
composed program its own, and the engines keep one counter bank, and
on the card one CUDA stream, per pid.

``SendDesc`` / ``RecvDesc`` may name a peer *program* in ``remote``:
the matching side lives in another queue, the queue's build leaves the
descriptor open, and ``compose`` matches it into a cross-program
channel — triggered by the sender, deposited into the receiver's
memory, completed on the receiver's counter bank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

# --------------------------------------------------------------------------
# dtypes
# --------------------------------------------------------------------------

_TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
}
# numpy's ``dtype.str`` of each, as the JAX package's digests spell them
# (bfloat16 is ml_dtypes' two-byte void type there).
_DTYPE_STR = {
    torch.float32: "<f4",
    torch.float64: "<f8",
    torch.float16: "<f2",
    torch.bfloat16: "<V2",
}


def as_torch_dtype(dtype) -> torch.dtype:
    """``"float32"``, ``np.float32`` or ``torch.float32`` -> torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise TypeError(f"unsupported buffer dtype {dtype!r}") from None


def dtype_str(dtype) -> str:
    """numpy ``dtype.str`` spelling of a buffer dtype (digest key)."""
    return _DTYPE_STR[as_torch_dtype(dtype)]


# --------------------------------------------------------------------------
# Peer specifications
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OffsetPeer:
    axis: str
    delta: int
    periodic: bool = False

    def inverse(self) -> "OffsetPeer":
        return OffsetPeer(self.axis, -self.delta, self.periodic)


@dataclasses.dataclass(frozen=True)
class GridOffsetPeer:
    axes: Tuple[str, ...]
    deltas: Tuple[int, ...]
    periodic: bool = False

    def __post_init__(self):
        if len(self.axes) != len(self.deltas):
            raise ValueError("axes and deltas must align")

    def inverse(self) -> "GridOffsetPeer":
        return GridOffsetPeer(self.axes, tuple(-d for d in self.deltas), self.periodic)


@dataclasses.dataclass(frozen=True)
class PairListPeer:
    axis: str
    pairs: Tuple[Tuple[int, int], ...]  # (src_rank, dst_rank)

    def inverse(self) -> "PairListPeer":
        # the receiver names the same (src, dst) pairs
        return PairListPeer(self.axis, self.pairs)


Peer = Any  # OffsetPeer | GridOffsetPeer | PairListPeer


def perm_for(peer: Peer, mesh_shape: dict) -> Tuple[Any, Sequence[Tuple[int, int]]]:
    """Resolve a peer into ``(axis or axes, [(src, dst), ...])``.

    Grid offsets are linearized over the *flattened* multi-axis grid in
    the peer's axis order; non-periodic offsets drop at the boundary.
    """
    if isinstance(peer, PairListPeer):
        return peer.axis, list(peer.pairs)

    if isinstance(peer, OffsetPeer):
        n = mesh_shape[peer.axis]
        pairs = []
        for src in range(n):
            dst = src + peer.delta
            if peer.periodic:
                dst %= n
            elif not (0 <= dst < n):
                continue
            pairs.append((src, dst))
        return peer.axis, pairs

    if isinstance(peer, GridOffsetPeer):
        dims = [mesh_shape[a] for a in peer.axes]
        pairs = []
        for src_multi in np.ndindex(*dims):
            dst_multi = []
            for c, d, n in zip(src_multi, peer.deltas, dims):
                t = c + d
                if peer.periodic:
                    t %= n
                elif not (0 <= t < n):
                    break
                dst_multi.append(t)
            else:
                src = int(np.ravel_multi_index(src_multi, dims))
                dst = int(np.ravel_multi_index(tuple(dst_multi), dims))
                pairs.append((src, dst))
        return tuple(peer.axes), pairs

    raise TypeError(f"unknown peer spec: {peer!r}")


def hop_decomposition(peer: Peer, axis_order: Sequence[str]):
    """Decompose a peer into ordered single-axis hops.

    A grid offset ``(dx, dy, dz)`` is one shift per nonzero component;
    relaying a payload verbatim through those shifts, one mesh axis at a
    time, delivers what the direct multi-axis permutation delivers.
    Hops follow ``axis_order`` so all channels agree on stage numbers.
    Returns ``[(axis, delta, periodic), ...]``, or ``None`` for a
    ``PairListPeer``.
    """
    if isinstance(peer, OffsetPeer):
        return [(peer.axis, peer.delta, peer.periodic)]
    if isinstance(peer, GridOffsetPeer):
        order = {a: i for i, a in enumerate(axis_order)}
        if any(a not in order for a in peer.axes):
            return None
        hops = sorted(
            ((a, d, peer.periodic) for a, d in zip(peer.axes, peer.deltas)
             if d != 0),
            key=lambda h: order[h[0]],
        )
        # degenerate all-zero offset: a self-send, one identity hop
        return hops or [(peer.axes[0], 0, peer.periodic)]
    return None


# --------------------------------------------------------------------------
# Descriptors
# --------------------------------------------------------------------------


@dataclasses.dataclass
class KernelDesc:
    """A compute kernel enqueued on the stream.

    ``fn(*reads) -> writes`` runs on the *global* tensors of the named
    buffers — every rank at once, shape ``(gx, gy, gz, *local)`` — and
    returns one tensor per write buffer.  A kernel may update a read
    buffer in place and return it (the halo unpack-add does).
    """

    fn: Callable
    reads: Tuple[str, ...]
    writes: Tuple[str, ...]
    name: str = "kernel"
    pid: int = 0
    # Enqueue-site provenance ("file:line").
    site: Optional[str] = None
    # True when the caller declared no effects and the queue assumed the
    # kernel reads every buffer (``enqueue_compute`` without ``reads=``):
    # the ST019 warning.
    implicit_effects: bool = False


@dataclasses.dataclass
class SendDesc:
    buf: str
    peer: Peer
    tag: int
    # Trigger threshold (SS11 DWQ field); filled in by the queue.
    threshold: int = -1
    # Optional slice of the buffer's local view to send.
    region: Optional[Tuple[slice, ...]] = None
    pid: int = 0
    # Cross-program channel: the peer program holding the matching
    # receive (None: matched within this program's own batch).
    remote: Optional[str] = None
    site: Optional[str] = None


@dataclasses.dataclass
class RecvDesc:
    buf: str
    peer: Peer
    tag: int
    threshold: int = -1
    region: Optional[Tuple[slice, ...]] = None
    # "replace" or "add" (the Faces gather-scatter sum deposit).
    mode: str = "replace"
    pid: int = 0
    # Cross-program channel: the peer program holding the matching send.
    remote: Optional[str] = None
    site: Optional[str] = None


@dataclasses.dataclass
class CollDesc:
    """A deferred collective (beyond-paper extension)."""

    op: str  # all_gather | reduce_scatter | all_reduce | all_to_all | ppermute
    buf: str
    out: str
    axis: Any  # mesh axis name or tuple
    kwargs: dict = dataclasses.field(default_factory=dict)
    threshold: int = -1
    pid: int = 0
    site: Optional[str] = None


@dataclasses.dataclass
class StartDesc:
    batch: int  # index of the batch this start triggers
    threshold: int = -1
    pid: int = 0
    site: Optional[str] = None


@dataclasses.dataclass
class WaitDesc:
    batch: int
    expected: int = -1  # completion-counter target
    pid: int = 0
    site: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class BufferSpec:
    """Global-view buffer declaration (all ranks) of a queue program; see
    :mod:`.state` for how an engine stores it."""

    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype
    # Partition entries (mesh axis names / None), as the reference's
    # PartitionSpec: the leading entries name the rank axes.
    pspec: Tuple[Any, ...] = ()
