"""Dot and collective accounting of the port's traced steps and ST
programs — the counterpart of ``repro.launch.hlo_analysis``.

The reference parses XLA's compiled HLO text: every ``dot`` op's FLOPs,
and every collective's wire bytes.  The port has no compiler IR, so it
counts what it runs:

* :func:`trace_dots` runs a step under :class:`DotCounter`, a
  ``TorchDispatchMode`` that adds ``2 · (result elements) · (contraction
  size)`` for every ``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv`` and
  ``dot`` the step reaches, the backward's and a checkpoint's recompute
  included, into the reference's :class:`DotStats` (total, count,
  largest).  On ``meta`` tensors nothing is computed, so a full-size step
  traces in seconds.  The count is the whole step's: the port has no
  SPMD partitioner, and so no per-device program (where the reference's
  ``analyze_dots`` reads shard shapes).  A dot inside a loop counts once
  an iteration, where the reference's static HLO counts a loop body once.
* :func:`analyze_program_collectives` applies the reference's wire-byte
  conventions (per device; ``n`` the group size) to the collectives of a
  built ST program (:mod:`repro_torch.core.collectives` rings, the MoE
  dispatch, :func:`repro_torch.launch.steps.tp_block_schedule`):

  - all-gather          — result bytes × (n−1)/n   (data received)
  - all-reduce          — 2 × operand bytes × (n−1)/n (ring RS+AG)
  - reduce-scatter      — operand bytes × (n−1)/n
  - all-to-all          — operand bytes × (n−1)/n
  - collective-permute  — operand bytes (one hop)

  A ring program's channels are collective-permutes, one hop each, so
  an all-gather ring of ``n`` ranks moves ``n − 1`` chunks a device: the
  all-gather's own convention.  Full-identity permutations are elided,
  as the engines elide them.

What the reference's partitioner would insert into a model's step (the
gradient all-reduces, the FSDP all-gathers) cannot be derived without a
partitioner; the dry run records it as not derived (:mod:`.dryrun`).
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

_aten = torch.ops.aten
#: the contraction ops, by overload packet: (result, contraction) of the args
_DOTS = {
    _aten.mm: lambda a, b, *_: (a.shape[0] * b.shape[1], a.shape[1]),
    _aten.addmm: lambda c, a, b, *_: (a.shape[0] * b.shape[1], a.shape[1]),
    _aten.bmm: lambda a, b, *_: (a.shape[0] * a.shape[1] * b.shape[2], a.shape[2]),
    _aten.baddbmm: lambda c, a, b, *_: (a.shape[0] * a.shape[1] * b.shape[2], a.shape[2]),
    _aten.mv: lambda a, v, *_: (a.shape[0], a.shape[1]),
    _aten.dot: lambda a, b, *_: (1, a.shape[0]),
}


@dataclasses.dataclass
class DotStats:
    total_flops: float
    n_dots: int
    largest: List[Tuple[float, str]]  # (flops, descriptor) top entries


class DotCounter(TorchDispatchMode):
    """Counts the FLOPs of every contraction dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.entries: List[Tuple[float, str]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        shape_of = _DOTS.get(func.overloadpacket)
        if shape_of is not None:
            res, k = shape_of(*args)
            self.entries.append((2.0 * res * k, f"{func.overloadpacket.__name__}"
                                 f"{list(out.shape)} k={k} {str(out.dtype)[6:]}"))
        return out

    def stats(self, top_k: int = 12) -> DotStats:
        largest = sorted(self.entries, key=lambda e: e[0], reverse=True)[:top_k]
        return DotStats(float(sum(f for f, _ in self.entries)), len(self.entries), largest)


def trace_dots(fn: Callable, *args, top_k: int = 12) -> Tuple[Any, DotStats, float]:
    """``(fn(*args), its DotStats, seconds)``: ``fn`` run once with every
    contraction counted (on ``meta`` inputs, a trace of shapes only)."""
    t0 = time.perf_counter()
    with DotCounter() as counter:
        out = fn(*args)
    return out, counter.stats(top_k), time.perf_counter() - t0


# --------------------------------------------------------------------------
# collectives of built ST programs
# --------------------------------------------------------------------------


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())

    def as_dict(self) -> Dict:
        return {
            "bytes_by_kind": dict(self.bytes_by_kind),
            "count_by_kind": dict(self.count_by_kind),
            "total_bytes": self.total_bytes,
        }


_COLL_KIND = {"all_gather": "all-gather", "all_reduce": "all-reduce",
              "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
              "ppermute": "collective-permute"}


def analyze_program_collectives(prog) -> CollectiveStats:
    """Per-device wire bytes and counts, by kind, of one pass of a built
    ST program or schedule: each channel a collective-permute of its
    message (full-identity permutations elided), each deferred collective
    by its kind, under the reference's conventions (module docstring)."""
    from .costing import _axes_of, _buf_bytes, _identity_perm, _send_bytes
    mesh_shape = dict(prog.mesh.shape)
    bytes_by: Dict[str, float] = defaultdict(float)
    count_by: Dict[str, int] = defaultdict(int)
    for batch in prog.batches:
        for ch in batch.channels:
            if _identity_perm(ch.perm(mesh_shape), _axes_of(ch.axis), mesh_shape):
                continue
            bytes_by["collective-permute"] += float(_send_bytes(ch, prog.buffers, mesh_shape))
            count_by["collective-permute"] += 1
        for coll in batch.colls:
            kind = _COLL_KIND[coll.op]
            n = int(np.prod([mesh_shape[a] for a in _axes_of(coll.axis)]))
            frac = (n - 1) / max(n, 1)
            if kind == "all-gather":
                wire = _buf_bytes(prog.buffers[coll.out], mesh_shape) * frac
            elif kind == "all-reduce":
                wire = 2.0 * _buf_bytes(prog.buffers[coll.buf], mesh_shape) * frac
            elif kind == "collective-permute":
                wire = float(_buf_bytes(prog.buffers[coll.buf], mesh_shape))
            else:
                wire = _buf_bytes(prog.buffers[coll.buf], mesh_shape) * frac
            bytes_by[kind] += wire
            count_by[kind] += 1
    return CollectiveStats(dict(bytes_by), dict(count_by))
