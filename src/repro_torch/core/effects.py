"""Effect sets and the program digest.

Port of the build-time half of ``repro.core.effects``:

* :func:`batch_effects` — one :class:`Effect` per memory access a
  trigger batch performs (pack reads, staging traffic, deposits), in the
  engines' lowering order; recorded on ``Batch.effects`` by the queue;
* :func:`stamp_staging` — a declared, unique staging-buffer identity per
  fused transfer of a :class:`~.matching.CoalescePlan`;
* :func:`cross_gate_map` — which wait observes each cross-program
  deposit of a composed schedule (shared by the verifier, the sanitizer
  and the engines' cross-stream waits);
* :func:`effect_trace` / :func:`program_digest` — per-buffer effect
  sequences in per-pid program order (a cross-program deposit recorded
  at the receiver's gating wait) and their hash.  The digest spells
  dtypes and partition entries as the JAX package does, so one program
  gives the same digest in both packages;
* :func:`certify_equivalence` / :func:`program_certificate` — equal
  traces and buffer specs, and race-freedom under the happens-before
  analysis of :mod:`.verify`.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from .descriptors import KernelDesc, StartDesc, WaitDesc, dtype_str
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
    """One batch's declared effect set, in execution order: pack reads
    (send sources, collective inputs), staging write then read, deposits
    (recv destinations, collective outputs)."""
    pid = batch.pid
    effs: List[Effect] = [
        Effect(buf=ch.src_buf, kind="read", source="pack", pid=pid,
               region=region_key(ch.send_region), site=ch.send_site)
        for ch in batch.channels]
    for coll in batch.colls:
        effs.append(Effect(buf=coll.buf, kind="read", source="pack",
                           pid=pid, site=coll.site))
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
    for coll in batch.colls:
        effs.append(Effect(buf=coll.out, kind="write", source="deposit",
                           pid=pid, site=coll.site))
    return tuple(effs)


def cross_gate_map(prog) -> Dict[Tuple[int, str], List[Tuple[int, int]]]:
    """``(src_batch, dst_buf) -> [(dst_pid, dst_batch), ...]`` for every
    resolved cross-program channel (from ``STSchedule.links``; a
    hand-built schedule without links is scanned through
    ``cross_recv_bufs``)."""
    gates: Dict[Tuple[int, str], List[Tuple[int, int]]] = defaultdict(list)
    links = getattr(prog, "links", ()) or ()
    if links:
        pid_of = {s.name: s.pid for s in getattr(prog, "subs", ())}
        for l in links:
            gates[(l.src_batch, l.dst_buf)].append((pid_of.get(l.dst, 0), l.dst_batch))
        return gates
    for b in prog.batches:
        for buf in b.cross_recv_bufs:
            for src in prog.batches:
                for ch in src.channels:
                    if ch.dst_pid == b.pid and ch.dst_buf == buf:
                        gates[(src.index, buf)].append((b.pid, b.index))
    return gates


def resolve_gate(gates, cursor, pid: int, batch: int, ch) -> Tuple[int, int]:
    """The ``(pid, batch)`` whose wait observes ``ch``'s deposit when
    batch ``batch`` of program ``pid`` fires it: the batch itself for a
    domestic channel, else the next entry of :func:`cross_gate_map` for
    ``(batch, dst_buf)`` (``cursor`` counts the entries used, in stream
    order)."""
    dpid = pid if ch.dst_pid is None else ch.dst_pid
    if dpid == pid:
        return (pid, batch)
    key = (batch, ch.dst_buf)
    opts = gates.get(key, [])
    cur = cursor[key]
    cursor[key] = cur + 1
    return opts[min(cur, len(opts) - 1)] if opts else (dpid, batch)


def effect_trace(prog) -> Dict[str, Tuple[Tuple, ...]]:
    """Per-buffer effect sequences in per-pid program order; a
    cross-program deposit is recorded at the receiver's gating wait, the
    first point the receiving stream may observe it."""
    batches = {b.index: b for b in prog.batches}
    gates = cross_gate_map(prog)
    cursor: Dict[Tuple[int, str], int] = defaultdict(int)
    pending_cross: Dict[Tuple[int, int], List[Tuple[str, Tuple]]] = defaultdict(list)
    for d in prog.descriptors:
        batch = batches.get(d.batch) if isinstance(d, StartDesc) else None
        if batch is None:
            continue
        for ch in batch.channels:
            if ch.dst_pid in (None, d.pid):
                continue
            pending_cross[resolve_gate(gates, cursor, d.pid, d.batch, ch)].append(
                (ch.dst_buf, ("deposit", ch.tag, ch.mode, region_key(ch.recv_region),
                              "from_pid", d.pid)))

    trace: Dict[str, List[Tuple]] = defaultdict(list)
    pids = sorted({d.pid for d in prog.descriptors}) or [0]
    for pid in pids:
        flushed: set = set()
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
                for coll in batch.colls:
                    trace[coll.buf].append(("collread", coll.op, repr(coll.axis)))
                for ch in batch.channels:
                    if ch.dst_pid not in (None, pid):
                        continue  # cross deposit: the receiver's wait records it
                    trace[ch.dst_buf].append((
                        "deposit", ch.tag, ch.mode,
                        region_key(ch.recv_region)))
                for coll in batch.colls:
                    trace[coll.out].append(("collout", coll.op, repr(coll.axis)))
            elif isinstance(d, WaitDesc):
                for gate, recs in pending_cross.items():
                    if gate[0] != pid or gate[1] > d.batch or gate in flushed:
                        continue
                    flushed.add(gate)
                    for buf, rec in recs:
                        trace[buf].append(rec)
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


@dataclasses.dataclass(frozen=True)
class EquivalenceCertificate:
    """Proof record that a transformed program keeps its baseline's effect
    semantics: equal buffer specs and per-buffer traces, and the candidate
    race-free under happens-before.  ``reason`` names the first mismatch
    when ``equivalent`` is False."""

    equivalent: bool
    baseline: str
    candidate: str
    baseline_digest: str
    candidate_digest: str
    race_free: bool
    n_buffers: int
    reason: Optional[str] = None


def certify_equivalence(baseline, candidate) -> EquivalenceCertificate:
    """Certify that ``candidate`` touches memory as ``baseline`` does:
    identical buffer specs, identical effect traces, and no ST015–ST018
    finding on the candidate."""
    from .verify import hb_race_diagnostics  # verify imports this module

    base_digest = program_digest(baseline)
    cand_digest = program_digest(candidate)
    races = hb_race_diagnostics(candidate)
    race_free = not races

    def cert(equivalent: bool, reason: Optional[str] = None):
        return EquivalenceCertificate(
            equivalent=equivalent, baseline=baseline.name,
            candidate=candidate.name, baseline_digest=base_digest,
            candidate_digest=cand_digest, race_free=race_free,
            n_buffers=len(candidate.buffers), reason=reason)

    sb, sc = _buffer_specs(baseline), _buffer_specs(candidate)
    if sb != sc:
        changed = sorted(set(sb) ^ set(sc)) or sorted(
            n for n in sb if sb[n] != sc.get(n))
        return cert(False, f"buffer specs differ: {changed[:4]}")
    tb, tc = effect_trace(baseline), effect_trace(candidate)
    if set(tb) != set(tc):
        return cert(False, "touched-buffer sets differ: "
                           f"{sorted(set(tb) ^ set(tc))[:4]}")
    for buf in sorted(tb):
        if tb[buf] != tc[buf]:
            return cert(False, f"effect trace diverges on {buf!r} "
                               f"({len(tb[buf])} vs {len(tc[buf])} records)")
    if not race_free:
        return cert(False, "candidate is not race-free under "
                           "happens-before: "
                    + "; ".join(d.rule for d in races[:4]))
    return cert(True)


@dataclasses.dataclass(frozen=True)
class ProgramCertificate:
    """A program's effect-trace digest and happens-before race verdict."""

    name: str
    digest: str
    race_free: bool
    n_races: int
    n_effects: int


def program_certificate(prog) -> ProgramCertificate:
    """Digest + race-free-under-all-interleavings verdict for ``prog``."""
    from .verify import hb_race_diagnostics  # verify imports this module

    races = hb_race_diagnostics(prog)
    trace = effect_trace(prog)
    return ProgramCertificate(
        name=prog.name, digest=program_digest(prog),
        race_free=not races, n_races=len(races),
        n_effects=sum(len(r) for r in trace.values()))
