"""Host-orchestrated engine — the paper's baseline control path (Fig. 1).

Port of ``repro.core.engine_host``.  It runs the same
:class:`~.queue.STProgram` as the fused engine, the way a conventional
GPU-aware MPI application does:

* every compute kernel is its own dispatch;
* every matched channel is its own dispatch (slice, permute, deposit),
  walked one at a time like a CPU progress thread (paper §IV-B);
* the host synchronizes with the device by its policy:

``every_op``  ``torch.cuda.synchronize()`` after every dispatch;
``batch``     once per communication batch.

Each wait is a host block too.  ``stats`` counts dispatches and sync
points: ``program.dispatch_count_host()`` per pass (79 for the direct26
Faces program; one more with damping).  Results equal the fused
engine's bit for bit (same ops, same order per buffer).  A call copies
the given buffers first, so the caller's tensors are never written.

A composed :class:`~.schedule.STSchedule` runs in its interleaved
descriptor order, each cross-program channel deposited when its sender
triggers.  ``sanitize=True`` is the static deposit-before-wait check of
:func:`~.verify.check_deposit_order` in the constructor: the host syncs
at descriptor boundaries, so there is no canary to plant.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from .descriptors import KernelDesc, StartDesc, WaitDesc
from .engine_fused import Lowering, _as_buffer, _run_channel
from .queue import STProgram
from .state import init_buffers


@dataclasses.dataclass
class HostStats:
    dispatches: int = 0
    sync_points: int = 0


class HostEngine:
    """Per-descriptor, host-driven execution of an STProgram."""

    def __init__(self, program: STProgram, sync: str = "every_op",
                 sanitize: bool = False):
        if sync not in ("every_op", "batch"):
            raise ValueError("sync must be 'every_op' or 'batch'")
        program.require_closed()
        if sanitize:
            from .verify import check_deposit_order
            check_deposit_order(program)
        self.program = program
        self.sync = sync
        self.mesh = program.mesh
        self.device = self.mesh.device
        self.stats = HostStats()
        self._lowering = Lowering(program)

    def init_buffers(self, init: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
        return init_buffers(self.program, init)

    def __call__(self, mem: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        prog = self.program
        mem = {n: mem[n].clone() for n in prog.buffers}
        batches = {b.index: b for b in prog.batches}
        for d in prog.descriptors:
            if isinstance(d, KernelDesc):
                outs = d.fn(*[mem[r] for r in d.reads])
                if not isinstance(outs, (tuple, list)):
                    outs = (outs,)
                for w, o in zip(d.writes, outs):
                    mem[w] = _as_buffer(o, prog.buffers[w])
                self._dispatched()
            elif isinstance(d, StartDesc):
                # the "progress thread" posts each channel on its own
                batch = batches[d.batch]
                for ch in batch.channels:
                    _run_channel(mem, ch, self._lowering)
                    self._dispatched()
                if self.sync == "batch" and batch.channels:
                    self._block()
            elif isinstance(d, WaitDesc):
                self._block()  # host-level MPI_Waitall
        return mem

    def _dispatched(self) -> None:
        self.stats.dispatches += 1
        if self.sync == "every_op":
            self._block()

    def _block(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats.sync_points += 1
