"""Effect sets and the program digest.

Port of the build-time half of ``repro.core.effects``:

* :func:`batch_effects` — one :class:`Effect` per memory access a
  trigger batch performs (pack reads, staging traffic, deposits), in the
  engines' lowering order; recorded on ``Batch.effects`` by the queue;
* :func:`stamp_staging` — a declared, unique staging-buffer identity per
  fused transfer of a :class:`~.matching.CoalescePlan`;
* :func:`effect_trace` / :func:`program_digest` — per-buffer effect
  sequences in program order and their hash.  The digest spells dtypes
  and partition entries as the JAX package does, so one Faces config
  gives the same digest in both packages.

``certify_equivalence`` and ``program_certificate`` need the
happens-before analysis of the verifier and come with the verifier
slice, as do cross-program deposits (composition slice).
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from .descriptors import KernelDesc, StartDesc, dtype_str
from .matching import _peer_key


@dataclasses.dataclass(frozen=True)
class Effect:
    """One declared memory access of a batch: ``kind`` is ``read``,
    ``write`` or ``accum`` (add-mode deposit); ``source`` is ``pack``,
    ``deposit`` or ``stage``."""

    buf: str
    kind: str
    source: str
    pid: int
    region: Optional[Tuple] = None
    site: Optional[str] = None


def region_key(region) -> Optional[Tuple]:
    """Canonical, hashable key for a send/recv region."""
    if region is None:
        return None
    try:
        return tuple(
            (s.start, s.stop, s.step) if isinstance(s, slice)
            else ("ix", repr(s))
            for s in tuple(region))
    except TypeError:
        return ("opaque", repr(region))


def stamp_staging(plan, batch_index: int):
    """Give each fused transfer a staging identity unique per
    (batch, transfer); an already declared name is kept."""
    if plan is None:
        return None
    transfers = tuple(
        t if t.staging is not None
        else dataclasses.replace(t, staging=f"~stage/b{batch_index}.t{ti}")
        for ti, t in enumerate(plan.transfers))
    return dataclasses.replace(plan, transfers=transfers)


def batch_effects(batch) -> Tuple[Effect, ...]:
    """One batch's declared effect set, in execution order: pack reads,
    staging write then read, deposits."""
    pid = batch.pid
    effs: List[Effect] = [
        Effect(buf=ch.src_buf, kind="read", source="pack", pid=pid,
               region=region_key(ch.send_region), site=ch.send_site)
        for ch in batch.channels]
    if batch.plan is not None:
        for t in batch.plan.transfers:
            if t.staging is not None:
                effs.append(Effect(buf=t.staging, kind="write",
                                   source="stage", pid=pid))
                effs.append(Effect(buf=t.staging, kind="read",
                                   source="stage", pid=pid))
    for ch in batch.channels:
        effs.append(Effect(
            buf=ch.dst_buf, kind="accum" if ch.mode == "add" else "write",
            source="deposit", pid=pid, region=region_key(ch.recv_region),
            site=ch.recv_site))
    return tuple(effs)


def effect_trace(prog) -> Dict[str, Tuple[Tuple, ...]]:
    """Per-buffer effect sequences in per-pid program order."""
    batches = {b.index: b for b in prog.batches}
    trace: Dict[str, List[Tuple]] = defaultdict(list)
    pids = sorted({d.pid for d in prog.descriptors}) or [0]
    for pid in pids:
        for d in prog.descriptors:
            if d.pid != pid:
                continue
            if isinstance(d, KernelDesc):
                for r in d.reads:
                    trace[r].append(("kread", d.name, d.reads, d.writes))
                for w in d.writes:
                    trace[w].append(("kwrite", d.name, d.reads, d.writes))
            elif isinstance(d, StartDesc):
                batch = batches.get(d.batch)
                if batch is None:
                    continue
                for ch in batch.channels:
                    trace[ch.src_buf].append((
                        "send", ch.tag, _peer_key(ch.peer),
                        region_key(ch.send_region)))
                for ch in batch.channels:
                    trace[ch.dst_buf].append((
                        "deposit", ch.tag, ch.mode,
                        region_key(ch.recv_region)))
    return {buf: tuple(recs) for buf, recs in trace.items()}


def _buffer_specs(prog) -> Dict[str, Tuple]:
    return {
        name: (tuple(spec.shape), dtype_str(spec.dtype),
               tuple(repr(p) for p in spec.pspec))
        for name, spec in prog.buffers.items()
    }


def program_digest(prog) -> str:
    """Stable hash of a program's effect trace + buffer specs."""
    h = hashlib.sha256()
    for name, spec in sorted(_buffer_specs(prog).items()):
        h.update(repr((name, spec)).encode())
    for buf, recs in sorted(effect_trace(prog).items()):
        h.update(repr((buf, recs)).encode())
    return h.hexdigest()[:16]
