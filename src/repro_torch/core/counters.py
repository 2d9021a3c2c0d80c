"""Trigger / completion counters — build-time bookkeeping of a queue.

Port of the host-side half of ``repro.core.counters``.  The paper's ST
design synchronizes GPU and NIC through two counters per
``MPIX_Queue``: a start bumps the trigger counter (writeValue) and the
stream blocks on the completion counter (waitValue).  The queue uses the
classes below to stamp DWQ thresholds at enqueue time.

At run time the JAX package expresses the counters as data dependencies
(``tie``/``gate``/``bump`` over optimization barriers).  On the GPU the
same contract is CUDA stream order: in ``dataflow`` mode a start makes
the communication stream wait on the compute stream, and a wait makes
the compute stream wait on the communication stream (see
:mod:`.engine_fused`).  The engines still advance integer counter banks
per program (:func:`~.engine_fused.fresh_token_banks`) so a persistent
loop's counters keep rising across iterations, as in the reference.
"""

from __future__ import annotations

import dataclasses
import itertools

_counter_ids = itertools.count()


@dataclasses.dataclass
class TriggerCounter:
    """Host-side handle for a queue's trigger counter.

    A descriptor enqueued when the counter's *scheduled* value is ``v``
    gets threshold ``v + 1`` and fires on the matching start.
    """

    name: str = ""
    scheduled: int = 0  # value reached once every enqueued start ran

    def __post_init__(self):
        if not self.name:
            self.name = f"trig{next(_counter_ids)}"

    def next_threshold(self) -> int:
        return self.scheduled + 1

    def record_start(self) -> int:
        """A start was enqueued: the counter will be bumped once."""
        self.scheduled += 1
        return self.scheduled


@dataclasses.dataclass
class CompletionCounter:
    """Host-side handle for a queue's completion counter; ``expected``
    is the waitValue threshold the next wait must observe."""

    name: str = ""
    expected: int = 0

    def __post_init__(self):
        if not self.name:
            self.name = f"comp{next(_counter_ids)}"

    def record_op(self, n: int = 1) -> int:
        self.expected += n
        return self.expected
