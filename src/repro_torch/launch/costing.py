"""Analytic cost model of ST schedules (the ST half of the reference's
``repro.launch.costing``).

:func:`schedule_cost` prices a built :class:`~repro_torch.core.queue.
STProgram` / :class:`~repro_torch.core.schedule.STSchedule` under one
execution configuration (engine, mode, coalesce, double buffering).  It
walks the descriptor stream in symbolic stream order, as the verifier
does, accumulating microseconds instead of diagnostics:

* **bytes moved × hops** per fired collective — coalesced batches price
  their plan's transfers (full-identity transfers elided as the engines
  elide them), per-channel batches one permute per channel scaled by its
  hop count, and each deferred collective its whole buffer;
* **collectives per start gate** — a fixed launch cost per fired
  collective;
* **staging/slot pressure** — pack/deposit copy bytes, plus the
  message-slot footprint the persistent engine double-buffers;
* **trigger→wait overlap** — compute between a trigger and its gating
  wait credits against that window's in-flight communication; what the
  credit cannot hide is exposed wait time;
* **stream switches** — consecutive descriptors of different programs,
  which is what makes the interleave policy a priceable knob;
* **host dispatches** — per engine (persistent < fused < host).

Costs depend only on program structure, never on buffer or program
names, and equal the reference's for the same build field for field:
the constants (:data:`DEFAULT_PARAMS`) are the reference's, fitted to
its CPU host grid, so only *orderings* are trusted — the tuner
(:mod:`.tune`) prunes with them and medians decide.  The reference's
model-architecture half (``run_one``, XLA compile costs) is not ported.
"""

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.descriptors import KernelDesc, StartDesc, WaitDesc, hop_decomposition
from ..core.matching import _local_shape, _NoCoalesce, _send_shape


# =========================================================================
# ST schedule cost model
# =========================================================================


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Unit costs (µs): the reference's constants, calibrated for the
    JAX package's CPU host-device grid.

    They are kept as they are so that the two packages price and rank a
    program alike; they are not the card's.  On the H100 a synchronized
    fused dispatch measured 115–200 µs against ``dispatch_us`` 1000, and
    a halo kernel launch ~1.6–2.3 µs against ``kernel_us`` 3.0
    (``PERF.md``).  The model is used for *ordering* and pruning;
    measurements decide winners.
    """

    dispatch_us: float = 1000.0    # host round-trip per dispatch
    collective_us: float = 20.0    # fixed launch cost per fired collective
    kernel_us: float = 3.0         # fixed cost per lowered kernel op
    byte_us: float = 1e-4          # per byte through a collective, per hop
    compute_byte_us: float = 2e-5  # per byte a kernel touches
    stage_byte_us: float = 3e-5    # per byte packed/deposited (staging copy)
    slot_byte_us: float = 1e-5     # per slot-resident byte, per iteration
    switch_us: float = 7.0         # per adjacent-descriptor pid switch
    overlap_eff: float = 0.6       # fraction of in-window compute hiding comm


DEFAULT_PARAMS = CostParams()

_ENGINE_ORDER = ("host", "fused", "persistent")


@dataclasses.dataclass
class ScheduleCost:
    """Itemized analytic cost of one execution configuration.

    All time components are µs for the whole ``n_iters`` run;
    ``total_us`` is their sum.  Counts are per iteration.
    """

    engine: str
    mode: str
    coalesce: bool
    n_iters: int
    dispatch_us: float = 0.0
    collective_us: float = 0.0
    bytes_us: float = 0.0
    kernel_us: float = 0.0
    staging_us: float = 0.0
    slot_us: float = 0.0
    exposed_us: float = 0.0
    switch_us: float = 0.0
    n_dispatches: int = 0
    n_collectives: int = 0      # fired per iteration (post-elision)
    n_elided: int = 0           # full-identity transfers skipped
    n_kernels: int = 0
    bytes_moved: int = 0        # through collectives, per iteration
    staged_bytes: int = 0       # packed+deposited, per iteration
    slot_bytes: int = 0         # message-slot footprint (double-buffered)

    @property
    def total_us(self) -> float:
        return (self.dispatch_us + self.collective_us + self.bytes_us
                + self.kernel_us + self.staging_us + self.slot_us
                + self.exposed_us + self.switch_us)

    def row(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["total_us"] = self.total_us
        return d


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _buf_bytes(spec, mesh_shape) -> int:
    shape = _local_shape(spec, mesh_shape)
    return int(np.prod(shape, dtype=np.int64)) * _itemsize(spec.dtype)


def _send_bytes(ch, buffers, mesh_shape) -> int:
    try:
        shape = _send_shape(ch, buffers, mesh_shape)
    except _NoCoalesce:
        shape = _local_shape(buffers[ch.src_buf], mesh_shape)
    itemsize = _itemsize(buffers[ch.src_buf].dtype)
    return int(np.prod(shape, dtype=np.int64)) * itemsize


def _identity_perm(perm, axes, mesh_shape) -> bool:
    n = 1
    for a in axes:
        n *= mesh_shape[a]
    return len(perm) == n and all(s == d for s, d in perm)


def _axes_of(axis) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _price_batch(batch, buffers, mesh_shape, axis_order, coalesce,
                 params: CostParams):
    """Price one start gate: (comm_us, cost-component deltas).

    Mirrors the fused engine's lowering choice: a plan-carrying batch
    fires its fused transfers (identity transfers elided), otherwise one
    ppermute per channel (identity channels elided), plus whole-buffer
    collectives either way.
    """
    comm_us = coll_us = byte_us = stage_us = 0.0
    n_coll = n_elided = 0
    bytes_moved = staged = 0
    if coalesce and batch.plan is not None:
        plan = batch.plan
        for t in plan.transfers:
            itemsize = _itemsize(t.dtype)
            nbytes = sum(s.size for s in t.segments) * itemsize
            stage_us += nbytes * params.stage_byte_us  # pack copy
            staged += nbytes
            if _identity_perm(t.perm, _axes_of(t.axis), mesh_shape):
                n_elided += 1
                continue
            n_coll += 1
            coll_us += params.collective_us
            byte_us += nbytes * params.byte_us
            bytes_moved += nbytes
        for ci, ch in enumerate(plan.channels):
            itemsize = _itemsize(buffers[ch.dst_buf].dtype)
            nbytes = int(np.prod(plan.shapes[ci], dtype=np.int64)) * itemsize
            stage_us += nbytes * params.stage_byte_us  # deposit copy
            staged += nbytes
    else:
        for ch in batch.channels:
            nbytes = _send_bytes(ch, buffers, mesh_shape)
            axes = _axes_of(ch.axis)
            if _identity_perm(ch.perm(mesh_shape), axes, mesh_shape):
                n_elided += 1
                stage_us += nbytes * params.stage_byte_us
                staged += nbytes
                continue
            hops = hop_decomposition(ch.peer, axis_order)
            n_hops = len(hops) if hops else max(1, len(axes))
            n_coll += 1
            coll_us += params.collective_us
            byte_us += nbytes * params.byte_us * n_hops
            bytes_moved += nbytes
    for coll in batch.colls:
        nbytes = _buf_bytes(buffers[coll.buf], mesh_shape)
        n_coll += 1
        coll_us += params.collective_us
        byte_us += nbytes * params.byte_us
        bytes_moved += nbytes
    comm_us = coll_us + byte_us
    return comm_us, coll_us, byte_us, stage_us, n_coll, n_elided, \
        bytes_moved, staged


def schedule_cost(
    prog,
    *,
    engine: str = "persistent",
    mode: str = "dataflow",
    coalesce: bool = True,
    double_buffer: Optional[bool] = None,
    n_iters: Optional[int] = None,
    params: CostParams = DEFAULT_PARAMS,
) -> ScheduleCost:
    """Analytically price one execution configuration of ``prog``.

    The walk is the verifier's symbolic stream-order execution: every
    descriptor is visited once, per-pid in-flight communication is
    registered at each ``StartDesc`` and settled at the gating
    ``WaitDesc``, and compute priced between the two credits against
    the window (``overlap_eff``); the remainder is exposed wait time.
    ``engine`` picks the dispatch model (``"host"`` per-op, ``"fused"``
    one dispatch per iteration, ``"persistent"`` one dispatch total);
    host-engine runs are synchronous per op, so they earn no overlap
    credit.  Returns an itemized :class:`ScheduleCost`.
    """
    if engine not in _ENGINE_ORDER:
        raise ValueError(f"engine must be one of {_ENGINE_ORDER}, "
                         f"got {engine!r}")
    if mode not in ("stream", "dataflow"):
        raise ValueError(f"mode must be 'stream' or 'dataflow', got {mode!r}")
    mesh_shape = dict(prog.mesh.shape)
    axis_order = list(mesh_shape)
    buffers = prog.buffers
    iters = int(n_iters if n_iters is not None
                else max(1, getattr(prog, "n_iters", 1) or 1))
    if double_buffer is None:
        double_buffer = (mode == "dataflow")

    cost = ScheduleCost(engine=engine, mode=mode, coalesce=coalesce,
                        n_iters=iters)
    batches_by_index = {b.index: b for b in prog.batches}
    overlap_eff = 0.0 if engine == "host" else params.overlap_eff

    in_flight: Dict[int, float] = {}
    credit: Dict[int, float] = {}
    pending_recv: Dict[int, set] = {}
    last_pid = None
    n_switches = 0
    per_iter_kernel_us = per_iter_coll_us = per_iter_byte_us = 0.0
    per_iter_stage_us = per_iter_exposed_us = 0.0

    for d in prog.descriptors:
        pid = d.pid
        if last_pid is not None and pid != last_pid:
            n_switches += 1
        last_pid = pid
        if isinstance(d, KernelDesc):
            nbytes = sum(_buf_bytes(buffers[b], mesh_shape)
                         for b in tuple(d.reads) + tuple(d.writes))
            k_us = params.kernel_us + nbytes * params.compute_byte_us
            per_iter_kernel_us += k_us
            cost.n_kernels += 1
            for q, fl in in_flight.items():
                if fl <= 0.0:
                    continue
                if q != pid:
                    credit[q] = credit.get(q, 0.0) + k_us
                elif mode == "dataflow" and not (
                        set(d.reads) & pending_recv.get(pid, set())):
                    # XLA may run a kernel that doesn't consume the
                    # in-flight deposits concurrently with them
                    credit[q] = credit.get(q, 0.0) + k_us
        elif isinstance(d, StartDesc):
            batch = batches_by_index[d.batch]
            comm, coll_us, byte_us, stage_us, n_coll, n_elided, moved, \
                staged = _price_batch(batch, buffers, mesh_shape, axis_order,
                                      coalesce, params)
            per_iter_coll_us += coll_us
            per_iter_byte_us += byte_us
            per_iter_stage_us += stage_us
            cost.n_collectives += n_coll
            cost.n_elided += n_elided
            cost.bytes_moved += moved
            cost.staged_bytes += staged
            in_flight[pid] = in_flight.get(pid, 0.0) + comm
            credit.setdefault(pid, 0.0)
            recvs = {c.dst_buf for c in batch.channels} | \
                    {c.out for c in batch.colls} | set(batch.cross_recv_bufs)
            pending_recv.setdefault(pid, set()).update(recvs)
        elif isinstance(d, WaitDesc):
            fl = in_flight.pop(pid, 0.0)
            cr = credit.pop(pid, 0.0)
            per_iter_exposed_us += max(0.0, fl - overlap_eff * cr)
            pending_recv.pop(pid, None)

    # communication never waited inside the pass is exposed at pass end
    for pid, fl in in_flight.items():
        per_iter_exposed_us += max(
            0.0, fl - overlap_eff * credit.get(pid, 0.0))

    if engine == "host":
        n_disp = prog.dispatch_count_host() * iters
    elif engine == "fused":
        n_disp = iters
    else:
        n_disp = 1
    cost.n_dispatches = n_disp
    cost.dispatch_us = n_disp * params.dispatch_us
    cost.kernel_us = per_iter_kernel_us * iters
    cost.collective_us = per_iter_coll_us * iters
    cost.bytes_us = per_iter_byte_us * iters
    cost.staging_us = per_iter_stage_us * iters
    cost.exposed_us = per_iter_exposed_us * iters
    cost.switch_us = n_switches * params.switch_us * iters

    if engine == "persistent":
        from ..core.engine_persistent import slot_buffers
        slots = slot_buffers(prog)
        slot_bytes = sum(_buf_bytes(buffers[s], mesh_shape) for s in slots)
        if double_buffer:
            slot_bytes *= 2
        cost.slot_bytes = slot_bytes
        cost.slot_us = slot_bytes * params.slot_byte_us * iters
    return cost


def predict_ranking(progs, **kw) -> List[Tuple[str, float]]:
    """``[(name, total_us)]`` sorted cheapest-first for built programs.

    ``progs`` is an iterable of ``(name, program)`` pairs; ``kw``
    forwards to :func:`schedule_cost` (same configuration for every
    program, so the ranking isolates program structure).
    """
    out = [(name, schedule_cost(p, **kw).total_us) for name, p in progs]
    return sorted(out, key=lambda t: t[1])
