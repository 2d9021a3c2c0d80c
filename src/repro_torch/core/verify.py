"""STLint — static verification of triggered-op programs.

Port of ``repro.core.verify``: the same rules, severities, messages and
descriptor indices.  Once a DWQ of triggered operations is handed to the NIC nobody is
watching: a wait whose threshold is never reached hangs, a deposit
racing a not-yet-waited slot corrupts silently.  Our programs are
statically known at build time, so the checks the NIC cannot do at
runtime we can do *before* runtime: :func:`verify_program` symbolically
executes the per-program trigger/completion counter banks in stream
order — the order :func:`~.engine_fused._interpret_program` executes —
and emits structured :class:`Diagnostic` records.

Wired in two places:

* ``STQueue.build(verify="warn")`` (default) and
  ``compose(..., verify="error")`` (default) run :func:`run_verify` on
  every built program;
* ``FusedEngine/PersistentEngine/HostEngine(..., sanitize=True)`` add
  the *runtime* sanitizer: :func:`check_deposit_order` runs in the
  constructor (a racy program raises :class:`SanitizeError` before any
  launch), and the fused and persistent engines poison unwritten
  message slots with NaN canaries at the start of every pass (a
  read-before-deposit turns into NaNs instead of silently-stale data).

Diagnostics catalog
-------------------
ST001  deadlocked wait (error)
    *Meaning*: a ``WaitDesc`` gates a completion whose trigger is not
    emitted before it in stream order — the wait's threshold can never
    be reached.  Checks the program's own batches AND cross-program
    ``links`` (whole-schedule reachability, strictly stronger than the
    interleaver's local cycle test).
    *Example*: reordering a composed schedule so the receiver's gating
    wait precedes the sender's start.
    *Fix*: keep every trigger (start) ahead of the waits that observe
    it; let ``compose`` order linked segments.
ST002  wait before start (error)
    *Meaning*: more waits than starts have been emitted on a program's
    stream — the wait references a batch that was never triggered.
    *Example*: ``enqueue_wait()`` before any ``enqueue_start()``.
    *Fix*: trigger the batch first (also raised early as MatchError at
    enqueue/build time).
ST003  non-monotone thresholds (error)
    *Meaning*: a descriptor's trigger threshold is lower than one
    already enqueued — the DWQ counter contract (thresholds ride a
    monotonically increasing counter) is broken.
    *Example*: hand-mutating descriptors with swapped thresholds.
    *Fix*: let the queue assign thresholds; never renumber by hand.
ST004  untriggered communication (error)
    *Meaning*: a send/recv/collective appears after its program's last
    start gate — no trigger covers it, it can never fire.
    *Example*: ``enqueue_send`` with no following ``enqueue_start``.
    *Fix*: close the batch with ``enqueue_start()``.
ST005  unwaited completions at quiescence (warning; error if persistent)
    *Meaning*: a started batch's completions are never observed by a
    wait of the destination program.  One-shot programs merely leak an
    unobserved completion; persistent reuse of a non-quiescent queue
    drifts its counters across iterations (iteration i+1's thresholds
    race iteration i's in-flight completions — the fixed per-iteration
    counter offset the persistent engine relies on is lost).
    *Example*: a trailing ``enqueue_start`` with no ``enqueue_wait``.
    *Fix*: wait the final batch (completion counters are cumulative:
    one trailing wait covers every earlier batch).
ST006  deposited slot overwritten (warning)
    *Meaning*: a deposit lands in a buffer that still holds a pending
    *unwaited* deposit (replace-mode on either side, overlapping
    regions) — the first message is lost before anything could have
    observed it; a kernel write over a pending deposit is the same
    hazard.
    *Example*: two recvs into one buffer across two batches with no
    wait between them.
    *Fix*: wait the earlier batch, or deposit into distinct buffers /
    disjoint regions (add-mode deposits accumulate and are exempt).
ST007  slot read before wait (error)
    *Meaning*: a kernel (or a later batch's send/collective) reads a
    buffer with a pending unwaited deposit — the stream has not gated
    on the completion, so on real hardware the read races the NIC's
    deposit.  Reads inside the *same* batch as the deposit are exempt
    (the per-channel interpreter defines that order; coalescing
    declines such batches).
    *Example*: moving the unpack kernel ahead of the wait.
    *Fix*: wait the depositing batch before reading the slot.
ST008  coalesced staging-buffer aliasing (error)
    *Meaning*: a batch's :class:`~.matching.CoalescePlan` is
    internally inconsistent — segments overlap or leave gaps in a
    fused transfer's staging buffer, or a channel's route points at a
    segment of the wrong size/offset — so member payloads would alias.
    *Example*: hand-editing a plan's segment offsets.
    *Fix*: let ``coalesce_batch`` derive plans; never edit them.
ST009  cross-program buffer aliasing (error)
    *Meaning*: a descriptor of program A touches a buffer owned by
    program B without being a resolved cross-program channel — under
    composition no memory is shared, and slot rotation/donation of
    B's buffers would invalidate A's reference.
    *Example*: a hand-built schedule whose kernel reads another
    sub-program's buffer.
    *Fix*: exchange data through ``remote=`` channels, not shared
    buffers.
ST010  persistent accumulator drift (warning)
    *Meaning*: in a persistent (device-resident loop) program, an
    add-mode deposit targets a buffer no kernel ever rewrites — the
    accumulator grows across iterations, which also disqualifies the
    buffer from slot rotation.
    *Example*: ``enqueue_recv(buf, ..., mode="add")`` with no kernel
    resetting ``buf`` each pass.
    *Fix*: rewrite the buffer from fresh state each iteration, or make
    the accumulation intentional and document it.
ST011  dead channels not pruned (warning)
    *Meaning*: a batch that requested coalescing fell back to the
    per-channel path while holding statically-dead channels (empty
    permutation on this mesh) — every rank pays a collective that
    delivers zeros.
    *Example*: a 26-neighbor exchange on a collapsed mesh axis where
    coalescing declined the batch.
    *Fix*: restructure the batch so the coalescer accepts it (the plan
    prunes dead channels), or drop the dead descriptors.
ST012  open cross-program descriptors (error, engine time)
    *Meaning*: a program with unresolved ``remote=`` sends/recvs
    reached an engine — an open channel has no matching side and would
    hang.  Raised by ``STProgram.require_closed()`` (every engine
    calls it); at build time open descriptors are legal (compose
    resolves them) and are therefore not a build diagnostic.
    *Fix*: ``compose()`` the program with its peer(s) before running.
ST013  ring rotation hazard (error)
    *Meaning*: an in-place ring rotation (send and recv on the SAME
    buffer, replace mode — the descriptor spelling of
    ``buf = ppermute(buf, delta)`` used by the collective-matmul
    programs of the reference's ``core/collectives.py``) appears more than once
    for one buffer inside a single start gate.  Every channel of a gate
    reads the same pre-trigger value, so the second rotation does not
    see the first's deposit: the buffer advances one hop, not two, and
    a ring step is silently lost.
    *Example*: enqueueing two +1 rotations of the accumulator between
    one start/wait pair to "skip ahead" two ranks.
    *Fix*: one rotation per gate — give each ring step its own
    start/wait (or rotate by ``delta=2`` in one channel).
ST014  chunk-accumulator clobber (error)
    *Meaning*: a buffer is a ring accumulator — it receives add-mode
    deposits, or kernels that read AND write it (the
    ``acc = acc + piece(...)`` pattern of the ST reduce-scatter) — and
    a kernel REWRITES it without reading it strictly between the first
    and last accumulate events: the partial sum accumulated so far is
    discarded mid-ring.  Seed kernels before the first accumulate are
    the legitimate initialization and are exempt.
    *Example*: re-running the reduce-scatter seed kernel between two
    ring steps.
    *Fix*: seed once before the ring; mid-ring kernels must read the
    accumulator they update.

Happens-before rules (STProve)
------------------------------
Rules ST015-ST018 come from a different engine than the walk above:
:func:`build_happens_before` builds the partial order every legal
interleave policy must respect — per-pid program order, trigger →
deposit-window → gating-wait edges resolved through the counter banks,
cross-program link edges — and flags conflicting declared effects
(:mod:`.effects`) that the order leaves UNORDERED.  They
catch races the emitted-order walk cannot: a program whose emitted
stream happens to serialize two accesses still fails here if some
other legal merge of the same per-pid streams would not.

ST015  kernel/deposit race across pids (error)
    *Meaning*: a kernel's declared effect on a buffer has no
    happens-before ordering against another program's deposit into the
    same (overlapping) region — under some legal interleaving the
    kernel runs while the NIC owns the slot, even if the emitted order
    is safe.  Same-pid windows stay with ST006/ST007 (stream order
    within one pid is invariant under every policy).
    *Example*: reordering a composed schedule so a consumer kernel
    sits between the producer's start and the consumer's gating wait.
    *Fix*: order the kernel after the wait that observes the deposit.
ST016  WAR on a rotated slot (error)
    *Meaning*: in a persistent program, a read of a double-buffered
    message slot has NO write ordered before it in the pass while a
    cross-stream write races it: under ``(cur, alt)`` slot rotation
    the read may execute first and observe the stale alternate copy
    (iteration i-2's data), under any policy that merges the streams
    differently.
    *Example*: moving a kernel that reads a cross-deposited slot ahead
    of the slot's gating wait in a persistent composition.
    *Fix*: gate every slot read behind the wait observing the pass's
    depositing trigger.
ST017  staging-buffer reuse across overlapping windows (error)
    *Meaning*: two fused transfers *declare* the same staging-buffer
    identity (``CoalescedChannel.staging``) while their trigger→wait
    windows are unordered under happens-before — one pack may
    overwrite payloads the other transfer has not deposited yet.
    Build-time stamps (:func:`.effects.stamp_staging`) are
    unique per (batch, transfer), so this fires only on hand-built or
    mutated plans.
    *Example*: editing two batches' plans to share one staging name
    with no wait ordering the batches.
    *Fix*: let ``stamp_staging`` assign identities, or wait the first
    batch's completions before triggering the second.
ST018  donated-buffer read after rotation (error)
    *Meaning*: in a persistent program, a read of a rotated/donated
    slot is ordered after one of the pass's writes but races ANOTHER
    write of the same slot — after slot rotation/donation the read may
    observe either generation's copy depending on the interleaving.
    *Example*: two cross-program deposits into one slot with the
    consumer kernel gated on only the first.
    *Fix*: give each deposit generation its own slot, or gate the read
    on the wait observing the last write.
ST019  implicit kernel effects (warning)
    *Meaning*: ``enqueue_compute`` was called without ``reads=`` — the
    conservative reads-everything fallback is in force, which
    over-serializes the happens-before graph (every pending deposit
    looks like a race with this kernel) and hides the kernel's true
    footprint from the equivalence certifier.
    *Example*: ``queue.enqueue_compute(fn)`` with no effect keywords.
    *Fix*: declare ``reads=``/``writes=`` explicitly.
"""

from __future__ import annotations

import dataclasses
import warnings
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .descriptors import (
    KernelDesc,
    RecvDesc,
    SendDesc,
    StartDesc,
    WaitDesc,
    as_torch_dtype,
    perm_for,
)
from .effects import cross_gate_map, resolve_gate

RULES: Dict[str, Tuple[str, str]] = {
    # rule id -> (default severity, one-line title)
    "ST001": ("error", "deadlocked wait: threshold unreachable from "
                       "triggers emitted before it"),
    "ST002": ("error", "wait before any matching start"),
    "ST003": ("error", "non-monotone trigger thresholds"),
    "ST004": ("error", "communication op not covered by a start gate"),
    "ST005": ("warning", "unwaited completions at quiescence"),
    "ST006": ("warning", "pending unwaited deposit overwritten"),
    "ST007": ("error", "slot read before its deposit is waited"),
    "ST008": ("error", "coalesced staging-buffer aliasing"),
    "ST009": ("error", "cross-program buffer aliasing"),
    "ST010": ("warning", "persistent accumulator drift"),
    "ST011": ("warning", "dead channels not pruned"),
    "ST012": ("error", "open cross-program descriptors at engine time"),
    "ST013": ("error", "ring rotation hazard: one buffer rotated twice "
                       "in a single start gate"),
    "ST014": ("error", "chunk-accumulator clobber: accumulator rewritten "
                       "without read mid-ring"),
    "ST015": ("error", "kernel/deposit race across pids: unordered under "
                       "happens-before"),
    "ST016": ("error", "WAR on a rotated slot: read may precede the "
                       "pass's first write under some interleaving"),
    "ST017": ("error", "staging-buffer reuse across overlapping "
                       "trigger-to-wait windows"),
    "ST018": ("error", "donated-buffer read after rotation races a "
                       "same-pass write"),
    "ST019": ("warning", "kernel enqueued with implicit (undeclared) "
                         "effects"),
}


class STLintWarning(UserWarning):
    """A warning-severity STLint diagnostic surfaced via ``warnings``."""


class VerifyError(RuntimeError):
    """Error-severity diagnostics under ``verify='error'`` policy."""

    def __init__(self, diagnostics):
        self.diagnostics = tuple(diagnostics)
        lines = "\n".join(f"  {d}" for d in self.diagnostics)
        super().__init__(
            f"STLint found {len(self.diagnostics)} error(s):\n{lines}")


class SanitizeError(RuntimeError):
    """Runtime-sanitizer ordering violation (``sanitize=True``)."""


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One STLint finding.

    ``index`` is the offending descriptor's position in
    ``program.descriptors`` (None for program-level findings such as a
    plan inconsistency); ``site`` is the enqueue-site provenance
    (``file:line``) captured on the descriptor, when available.
    """

    rule: str
    severity: str  # "error" | "warning"
    pid: int
    message: str
    index: Optional[int] = None
    site: Optional[str] = None
    program: str = ""

    def __str__(self) -> str:
        where = f" [enqueued at {self.site}]" if self.site else ""
        at = f" desc#{self.index}" if self.index is not None else ""
        return (f"[{self.rule}] {self.severity} pid={self.pid}{at}: "
                f"{self.message}{where}")


def run_verify(prog, policy: str = "warn") -> List[Diagnostic]:
    """Run the static pass under a policy: ``warn`` | ``error`` | ``off``.

    ``warn`` reports every diagnostic as an :class:`STLintWarning`;
    ``error`` raises :class:`VerifyError` if any error-severity
    diagnostic is found (warning-severity ones still warn); ``off``
    skips the pass entirely.  Returns the diagnostics found.
    """
    if policy == "off":
        return []
    if policy not in ("warn", "error"):
        raise ValueError(
            f"verify must be 'warn', 'error' or 'off', got {policy!r}")
    diags = verify_program(prog)
    if policy == "error":
        errors = [d for d in diags if d.severity == "error"]
        if errors:
            raise VerifyError(errors)
    for d in diags:
        warnings.warn(str(d), STLintWarning, stacklevel=3)
    return diags


def format_diagnostics(diags: List[Diagnostic]) -> str:
    """Plain-text table of diagnostics."""
    if not diags:
        return "  (clean: 0 diagnostics)"
    rows = [("rule", "severity", "pid", "site", "message")]
    for d in diags:
        rows.append((d.rule, d.severity, str(d.pid), d.site or "-",
                     d.message))
    widths = [max(len(r[i]) for r in rows) for i in range(4)]
    out = []
    for r in rows:
        head = "  ".join(c.ljust(w) for c, w in zip(r[:4], widths))
        out.append(f"  {head}  {r[4]}")
    return "\n".join(out)


# --------------------------------------------------------------------------
# The symbolic counter-bank walk
# --------------------------------------------------------------------------


@dataclasses.dataclass
class _Pending:
    """One deposit whose completion has not been waited yet."""

    mode: str                       # replace | add
    gate_pid: int                   # whose wait observes it
    gate_batch: int                 # ...at-or-after this batch index
    region: Optional[Tuple]         # recv region (None = whole buffer)
    site: Optional[str]             # provenance of the depositing side
    index: Optional[int]            # stream position of the trigger


def _regions_overlap(a, b) -> bool:
    """Whether two recv regions may overlap (None = whole buffer)."""
    if a is None or b is None or a == b:
        return True
    try:
        for sa, sb in zip(tuple(a), tuple(b)):
            if not (isinstance(sa, slice) and isinstance(sb, slice)):
                return True  # fancy indexing: assume overlap
            a0, a1 = sa.start or 0, sa.stop
            b0, b1 = sb.start or 0, sb.stop
            if a1 is not None and b1 is not None and (a1 <= b0 or b1 <= a0):
                return False  # provably disjoint along this dim
    except TypeError:
        return True
    return True


def _buffer_owner(prog) -> Dict[str, int]:
    return {buf: pid
            for pid, bufs in prog.buffers_by_pid().items() for buf in bufs}


def verify_program(prog) -> List[Diagnostic]:
    """Symbolically execute ``prog`` in stream order; return diagnostics.

    Mirrors the fused interpreter: per-pid trigger/completion counter
    banks advance at starts and waits while a pending-deposit table
    tracks every slot the NIC would still own.  See the module
    docstring for the rule catalog.
    """
    diags: List[Diagnostic] = []
    seen_keys = set()

    def diag(rule, pid, message, index=None, site=None, severity=None):
        key = (rule, pid, index, message)
        if key in seen_keys:
            return
        seen_keys.add(key)
        diags.append(Diagnostic(
            rule=rule, severity=severity or RULES[rule][0], pid=pid,
            message=message, index=index, site=site, program=prog.name))

    mesh_shape = dict(prog.mesh.shape)
    owner = _buffer_owner(prog)
    batches = {b.index: b for b in prog.batches}
    links = tuple(getattr(prog, "links", ()) or ())
    subs = getattr(prog, "subs", ())
    pid_of_name = {s.name: s.pid for s in subs}
    cross_gates = cross_gate_map(prog)
    gate_cursor: Dict[Tuple[int, str], int] = defaultdict(int)

    def own_completions(b) -> bool:
        """Does batch ``b`` produce completions on its OWN counter bank?"""
        return any(ch.dst_pid is None or ch.dst_pid == b.pid for ch in b.channels)

    # last start position per pid (ST004: comm descs after it are dead)
    last_start_pos: Dict[int, int] = {}
    for i, d in enumerate(prog.descriptors):
        if isinstance(d, StartDesc):
            last_start_pos[d.pid] = i

    starts_count: Dict[int, int] = defaultdict(int)
    waits_count: Dict[int, int] = defaultdict(int)
    last_thr: Dict[int, int] = defaultdict(int)
    started: set = set()            # global batch indices already triggered
    waited_upto: Dict[int, int] = defaultdict(lambda: -1)
    pending: Dict[str, List[_Pending]] = defaultdict(list)

    def check_read(buf, pid, index, site, what):
        for p in pending.get(buf, ()):
            diag("ST007", pid,
                 f"{what} reads {buf!r} while it holds a pending unwaited "
                 f"deposit (gated by pid {p.gate_pid}'s wait on batch "
                 f"{p.gate_batch})", index=index, site=site)

    def register_deposit(buf, mode, region, gate_pid, gate_batch, pid,
                         index, site):
        for p in pending.get(buf, ()):
            if (("replace" in (p.mode, mode))
                    and _regions_overlap(p.region, region)):
                diag("ST006", pid,
                     f"deposit into {buf!r} overwrites a pending unwaited "
                     f"deposit (message lost before pid {p.gate_pid} waits "
                     f"batch {p.gate_batch})", index=index, site=site)
        pending[buf].append(_Pending(mode=mode, gate_pid=gate_pid,
                                     gate_batch=gate_batch, region=region,
                                     site=site, index=index))

    for i, d in enumerate(prog.descriptors):
        pid = d.pid
        if isinstance(d, (SendDesc, RecvDesc)):
            if d.threshold >= 0 and d.threshold < last_thr[pid]:
                diag("ST003", pid,
                     f"threshold {d.threshold} below the program's already-"
                     f"enqueued maximum {last_thr[pid]} (DWQ counters are "
                     f"monotone)", index=i, site=d.site)
            last_thr[pid] = max(last_thr[pid], d.threshold)
            if i > last_start_pos.get(pid, -1):
                diag("ST004", pid,
                     f"{type(d).__name__} after the program's last start "
                     f"gate: no trigger covers it, it can never fire",
                     index=i, site=d.site)
            if owner.get(d.buf, pid) != pid:
                diag("ST009", pid,
                     f"{type(d).__name__} touches {d.buf!r}, owned by pid "
                     f"{owner[d.buf]} (no shared memory under "
                     f"composition)", index=i, site=d.site)

        elif isinstance(d, KernelDesc):
            if getattr(d, "implicit_effects", False):
                diag("ST019", pid,
                     f"kernel {d.name!r} was enqueued without declared "
                     f"effects (enqueue_compute with no reads=): the "
                     f"conservative reads-everything fallback is in force, "
                     f"which over-serializes the happens-before analysis — "
                     f"declare reads=/writes= explicitly",
                     index=i, site=d.site)
            for r in d.reads:
                check_read(r, pid, i, d.site, f"kernel {d.name!r}")
            for w in list(d.reads) + list(d.writes):
                if owner.get(w, pid) != pid:
                    diag("ST009", pid,
                         f"kernel {d.name!r} touches {w!r}, owned by pid "
                         f"{owner[w]} (no shared memory under composition)",
                         index=i, site=d.site)
            for w in d.writes:
                for p in pending.get(w, ()):
                    diag("ST006", pid,
                         f"kernel {d.name!r} writes {w!r} over a pending "
                         f"unwaited deposit (message lost before pid "
                         f"{p.gate_pid} waits batch {p.gate_batch})",
                         index=i, site=d.site)

        elif isinstance(d, StartDesc):
            starts_count[pid] += 1
            batch = batches.get(d.batch)
            started.add(d.batch)
            if batch is None:
                continue
            # ST013: every channel of a gate reads the same pre-trigger
            # value, so a second in-place rotation of one buffer in the
            # same gate overwrites (not chains) the first — a ring hop
            # is silently lost
            rotations: Dict[str, int] = defaultdict(int)
            for ch in batch.channels:
                if ch.src_buf == ch.dst_buf and ch.mode == "replace":
                    rotations[ch.src_buf] += 1
            for rbuf, cnt in rotations.items():
                if cnt > 1:
                    diag("ST013", pid,
                         f"batch {d.batch} rotates {rbuf!r} in place {cnt} "
                         f"times under one start gate: rotations read the "
                         f"pre-trigger value, so only one hop survives — "
                         f"give each ring step its own start/wait",
                         index=i, site=d.site)
            # reads (packs) happen before this batch's own deposits land
            for ch in batch.channels:
                check_read(ch.src_buf, pid, i,
                           getattr(ch, "send_site", None) or d.site,
                           f"batch {d.batch}'s send")
                if owner.get(ch.src_buf, pid) != pid:
                    diag("ST009", pid,
                         f"channel sends {ch.src_buf!r}, owned by pid "
                         f"{owner[ch.src_buf]}", index=i, site=d.site)
                dpid = pid if ch.dst_pid is None else ch.dst_pid
                if owner.get(ch.dst_buf, dpid) != dpid:
                    diag("ST009", pid,
                         f"channel deposits into {ch.dst_buf!r}, owned by "
                         f"pid {owner[ch.dst_buf]} but completed on pid "
                         f"{dpid}'s bank", index=i, site=d.site)
            for ch in batch.channels:
                gate = resolve_gate(cross_gates, gate_cursor, pid, d.batch, ch)
                register_deposit(
                    ch.dst_buf, ch.mode, ch.recv_region, gate[0], gate[1],
                    pid, i, getattr(ch, "recv_site", None) or d.site)

        elif isinstance(d, WaitDesc):
            waits_count[pid] += 1
            if waits_count[pid] > starts_count[pid]:
                diag("ST002", pid,
                     "wait before any matching start on this program's "
                     "stream", index=i, site=d.site)
                continue
            # ST001: every completion this wait gates must have its
            # trigger already emitted in stream order
            for b in prog.batches:
                if (b.pid == pid and b.index <= d.batch
                        and own_completions(b) and b.index not in started):
                    diag("ST001", pid,
                         f"wait on batch {d.batch} gates batch {b.index}'s "
                         f"completions, but batch {b.index}'s start is not "
                         f"emitted before it in stream order (threshold "
                         f"never reached: deadlock)", index=i, site=d.site)
            for l in links:
                if (pid_of_name.get(l.dst, -1) == pid
                        and l.dst_batch <= d.batch
                        and l.src_batch not in started):
                    diag("ST001", pid,
                         f"wait on batch {d.batch} gates the cross-program "
                         f"deposit from {l.src!r} (tag {l.tag}, trigger "
                         f"batch {l.src_batch}), whose start is not emitted "
                         f"before it in stream order (threshold never "
                         f"reached: deadlock)", index=i, site=d.site)
            waited_upto[pid] = max(waited_upto[pid], d.batch)
            for buf in list(pending):
                pending[buf] = [p for p in pending[buf]
                                if not (p.gate_pid == pid
                                        and p.gate_batch <= d.batch)]
                if not pending[buf]:
                    del pending[buf]

    # -- quiescence (ST005) -------------------------------------------------
    persistent = bool(getattr(prog, "is_persistent", False))
    sev5 = "error" if persistent else None
    why5 = ("persistent reuse of a non-quiescent queue: counters would "
            "not agree across iterations" if persistent
            else "its completion is never observed")
    for b in prog.batches:
        if b.index not in started:
            continue
        if own_completions(b) and waited_upto[b.pid] < b.index:
            diag("ST005", b.pid,
                 f"batch {b.index} is started but never waited — {why5}",
                 severity=sev5)
    for l in links:
        dpid = pid_of_name.get(l.dst, -1)
        if l.src_batch in started and waited_upto[dpid] < l.dst_batch:
            diag("ST005", dpid,
                 f"cross-program deposit from {l.src!r} into batch "
                 f"{l.dst_batch} is never waited by {l.dst!r} — {why5}",
                 severity=sev5)

    # -- persistent accumulator drift (ST010) --------------------------------
    if persistent:
        kernel_written = {w for d in prog.descriptors
                          if isinstance(d, KernelDesc) for w in d.writes}
        for b in prog.batches:
            for ch in b.channels:
                if ch.mode == "add" and ch.dst_buf not in kernel_written:
                    diag("ST010", b.pid,
                         f"add-mode deposit into {ch.dst_buf!r} with no "
                         f"kernel rewriting it: the accumulator grows "
                         f"across persistent iterations",
                         site=getattr(ch, "recv_site", None))

    # -- chunk-accumulator clobber (ST014) -----------------------------------
    # accumulate events per buffer, in descriptor order: add-mode
    # deposits (the start gate's position) and read+write kernels (the
    # ring accumulate pattern).  A kernel that REWRITES the buffer
    # without reading it strictly inside that span discards the partial
    # sum; the seed kernel before the first accumulate is exempt.
    acc_pos: Dict[Tuple[int, str], List[int]] = defaultdict(list)
    for i, d in enumerate(prog.descriptors):
        if isinstance(d, StartDesc):
            batch = batches.get(d.batch)
            if batch is None:
                continue
            for ch in batch.channels:
                if ch.mode == "add":
                    dpid = d.pid if ch.dst_pid is None else ch.dst_pid
                    acc_pos[(dpid, ch.dst_buf)].append(i)
        elif isinstance(d, KernelDesc):
            for w in d.writes:
                if w in d.reads:
                    acc_pos[(d.pid, w)].append(i)
    for (apid, buf), positions in acc_pos.items():
        if len(positions) < 2:
            continue
        lo, hi = positions[0], positions[-1]
        for i, d in enumerate(prog.descriptors):
            if (lo < i < hi and isinstance(d, KernelDesc) and d.pid == apid
                    and buf in d.writes and buf not in d.reads):
                diag("ST014", apid,
                     f"kernel {d.name!r} rewrites accumulator {buf!r} "
                     f"without reading it, between its accumulate steps "
                     f"(descriptor positions {lo}..{hi}): the partial sum "
                     f"is discarded mid-ring", index=i, site=d.site)

    # -- structural: dead channels (ST011) and plan consistency (ST008) -----
    for b in prog.batches:
        if b.coalesce and b.plan is None:
            for ch in b.channels:
                if not perm_for(ch.peer, mesh_shape)[1]:
                    diag("ST011", b.pid,
                         f"batch {b.index} declined coalescing while "
                         f"holding statically-dead channel "
                         f"{ch.src_buf!r}->{ch.dst_buf!r} (empty "
                         f"permutation: every rank pays a collective that "
                         f"delivers zeros)",
                         site=getattr(ch, "send_site", None))
        if b.plan is not None:
            _check_plan(b, diag)

    # -- happens-before race rules (ST015-ST018) ----------------------------
    _hb_rules(prog, diag)

    return diags


def _check_plan(b, diag) -> None:
    """ST008: a CoalescePlan's segments must tile each staging buffer
    exactly and every route must land on a segment of the right size."""
    plan = b.plan
    for ti, t in enumerate(plan.transfers):
        run = 0
        for seg in sorted(t.segments, key=lambda s: s.offset):
            if seg.offset != run:
                diag("ST008", b.pid,
                     f"batch {b.index} transfer {ti}: segment for channel "
                     f"{seg.channel} at offset {seg.offset} expected "
                     f"{run} (staging-buffer "
                     f"{'overlap' if seg.offset < run else 'gap'})")
                break
            run += seg.size
    for ci, route in enumerate(plan.routes):
        if not route:
            continue  # statically dead: deposits zeros, rides no transfer
        size = int(np.prod(plan.shapes[ci], dtype=np.int64))
        for hop, (ti, off) in enumerate(route):
            if not (0 <= ti < len(plan.transfers)):
                diag("ST008", b.pid,
                     f"batch {b.index} channel {ci} hop {hop} routes "
                     f"through nonexistent transfer {ti}")
                continue
            seg = next((s for s in plan.transfers[ti].segments
                        if s.channel == ci and s.hop == hop), None)
            if seg is None or seg.offset != off or seg.size != size:
                diag("ST008", b.pid,
                     f"batch {b.index} channel {ci} hop {hop}: route "
                     f"({ti}, {off}) does not match its segment "
                     f"(payload would alias a neighbor's slab)")


# --------------------------------------------------------------------------
# STProve: the happens-before analysis (rules ST015-ST018)
# --------------------------------------------------------------------------
#
# The symbolic walk above checks the *emitted* stream order — one
# particular merge of the per-program streams.  The happens-before
# graph checks every merge at once: its only ordering edges are the
# ones NO legal interleave policy may break —
#
#   * per-pid program order (each queue is FIFO by contract);
#   * trigger -> deposit -> completion -> gating-wait: a deposit is
#     modeled as a *window* node reachable from its StartDesc and
#     reaching the wait that observes its completion (resolved through
#     the same cross-gate map as the walk/sanitizer), nothing else —
#     between those two points the NIC owns the slot;
#   * cross-program links, which are exactly the window edges whose
#     gating wait lives on another pid's stream.
#
# Pack reads (send sources, collective inputs) attach to the StartDesc
# node itself: the engines pack at trigger, in stream order, under
# every policy.  Two conflicting effects with no happens-before path
# either way can race under SOME legal interleaving even if the
# emitted order happens to serialize them — that is what ST015-ST018
# report, and what "race-free under all interleavings" certifies.


@dataclasses.dataclass(frozen=True)
class _HBEffect:
    """One effect placed on a happens-before node."""

    node: int
    buf: str
    kind: str       # read | write | accum
    source: str     # kernel | pack | deposit
    pid: int        # triggering stream's pid
    region: Optional[Tuple]   # raw region (slices), None = whole buffer
    index: Optional[int]      # descriptor index for diagnostics
    site: Optional[str]


@dataclasses.dataclass(frozen=True)
class _HBTransfer:
    """One fused transfer's staging window (for ST017)."""

    staging: Optional[str]
    pid: int
    batch: int
    ti: int
    start_node: int
    gate_nodes: Tuple[Optional[int], ...]  # per member channel
    site: Optional[str]


class HappensBefore:
    """Reachability over the happens-before graph of one program.

    ``effects`` carries every declared memory access placed on a node;
    ``transfers`` the staging windows.  ``reaches(a, b)`` is transitive
    reachability (reflexive); ``ordered`` is reachability either way —
    two conflicting effects that are NOT ordered race under some legal
    interleaving.
    """

    def __init__(self, n_nodes: int, succ: Dict[int, List[int]],
                 effects: List[_HBEffect],
                 transfers: List[_HBTransfer]):
        self.n_nodes = n_nodes
        self.effects = effects
        self.transfers = transfers
        # bitmask fixpoint: reach[i] has bit j set iff i ->* j.  The
        # graph is a DAG whose edges mostly point forward in node id
        # (chains, start->window) with only window->gate-wait pointing
        # back, so a reverse-id sweep converges in a couple of rounds;
        # masks only grow, so the loop terminates regardless.
        reach = [1 << i for i in range(n_nodes)]
        changed = True
        while changed:
            changed = False
            for i in reversed(range(n_nodes)):
                r = reach[i]
                for j in succ.get(i, ()):
                    r |= reach[j]
                if r != reach[i]:
                    reach[i] = r
                    changed = True
        self._reach = reach

    def reaches(self, a: int, b: int) -> bool:
        return bool((self._reach[a] >> b) & 1)

    def ordered(self, a: int, b: int) -> bool:
        return self.reaches(a, b) or self.reaches(b, a)


def build_happens_before(prog) -> HappensBefore:
    """Build the happens-before graph + effect placement for ``prog``.

    Nodes are descriptor indices plus one virtual *window* node per
    (start, deposit) — see the section comment above for the edge set.
    """
    descs = prog.descriptors
    batches = {b.index: b for b in prog.batches}
    succ: Dict[int, List[int]] = defaultdict(list)

    last_by_pid: Dict[int, int] = {}
    for i, d in enumerate(descs):
        prev = last_by_pid.get(d.pid)
        if prev is not None:
            succ[prev].append(i)
        last_by_pid[d.pid] = i

    waits_by_pid: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for i, d in enumerate(descs):
        if isinstance(d, WaitDesc):
            waits_by_pid[d.pid].append((d.batch, i))

    def gate_wait_node(gpid: int, gbatch: int) -> Optional[int]:
        # completion counters are cumulative: the FIRST wait of the
        # gating pid at-or-after the gating batch observes the deposit
        for wb, wi in waits_by_pid.get(gpid, ()):
            if wb >= gbatch:
                return wi
        return None

    gates = cross_gate_map(prog)
    cursor: Dict[Tuple[int, str], int] = defaultdict(int)
    next_node = len(descs)
    effects: List[_HBEffect] = []
    transfers: List[_HBTransfer] = []

    for i, d in enumerate(descs):
        if isinstance(d, KernelDesc):
            for r in d.reads:
                effects.append(_HBEffect(i, r, "read", "kernel", d.pid,
                                         None, i, d.site))
            for w in d.writes:
                effects.append(_HBEffect(i, w, "write", "kernel", d.pid,
                                         None, i, d.site))
        elif isinstance(d, StartDesc):
            batch = batches.get(d.batch)
            if batch is None:
                continue
            # pack reads execute AT the trigger, in stream order
            for ch in batch.channels:
                effects.append(_HBEffect(
                    i, ch.src_buf, "read", "pack", d.pid, ch.send_region,
                    i, getattr(ch, "send_site", None) or d.site))
            # deposits live on window nodes: start -> window -> gating wait
            ch_gate: Dict[int, Optional[int]] = {}
            for ci, ch in enumerate(batch.channels):
                gate = resolve_gate(gates, cursor, d.pid, d.batch, ch)
                w = next_node
                next_node += 1
                succ[i].append(w)
                gw = gate_wait_node(*gate)
                if gw is not None:
                    succ[w].append(gw)
                ch_gate[ci] = gw
                effects.append(_HBEffect(
                    w, ch.dst_buf,
                    "accum" if ch.mode == "add" else "write", "deposit",
                    d.pid, ch.recv_region, i,
                    getattr(ch, "recv_site", None) or d.site))
            if batch.plan is not None:
                for ti, t in enumerate(batch.plan.transfers):
                    transfers.append(_HBTransfer(
                        staging=getattr(t, "staging", None), pid=d.pid,
                        batch=d.batch, ti=ti, start_node=i,
                        gate_nodes=tuple(ch_gate.get(s.channel)
                                         for s in t.segments),
                        site=d.site))

    return HappensBefore(next_node, succ, effects, transfers)


def _hb_rules(prog, diag) -> None:
    """Run the happens-before race rules, reporting through ``diag``."""
    hb = build_happens_before(prog)
    descs = prog.descriptors
    by_buf: Dict[str, List[_HBEffect]] = defaultdict(list)
    for e in hb.effects:
        by_buf[e.buf].append(e)

    def kname(e: _HBEffect) -> str:
        d = descs[e.index] if e.index is not None else None
        return getattr(d, "name", "?") if isinstance(d, KernelDesc) else "?"

    # -- ST015: kernel effect vs another pid's deposit, unordered ----------
    for buf, effs in by_buf.items():
        kernels = [e for e in effs if e.source == "kernel"]
        deposits = [e for e in effs if e.source == "deposit"]
        for ek in kernels:
            for ed in deposits:
                if ed.pid == ek.pid:
                    continue  # same-pid windows: ST006/ST007's walk owns it
                if not _regions_overlap(ek.region, ed.region):
                    continue
                if hb.ordered(ek.node, ed.node):
                    continue
                diag("ST015", ek.pid,
                     f"kernel {kname(ek)!r} {ek.kind}s {buf!r} with no "
                     f"happens-before ordering against pid {ed.pid}'s "
                     f"deposit into it: some legal interleaving runs the "
                     f"kernel while the NIC owns the slot",
                     index=ek.index, site=ek.site)

    # -- ST016 / ST018: rotated-slot hazards (persistent programs) ---------
    if getattr(prog, "is_persistent", False):
        from .engine_persistent import slot_buffers  # lazy: imports us back
        slots = set(slot_buffers(prog))
        for buf in slots:
            effs = by_buf.get(buf, [])
            writes = [e for e in effs if e.kind in ("write", "accum")]
            for r in (e for e in effs if e.kind == "read"):
                racing = [w for w in writes
                          if w.pid != r.pid and w.node != r.node
                          and _regions_overlap(w.region, r.region)
                          and not hb.ordered(w.node, r.node)]
                if not racing:
                    continue
                preceded = any(w.node != r.node
                               and hb.reaches(w.node, r.node)
                               for w in writes)
                w0 = racing[0]
                if not preceded:
                    diag("ST016", r.pid,
                         f"read of rotated slot {buf!r} has no write "
                         f"ordered before it this pass and races pid "
                         f"{w0.pid}'s write: under (cur, alt) slot "
                         f"rotation the read may observe the stale "
                         f"alternate copy", index=r.index, site=r.site)
                else:
                    diag("ST018", r.pid,
                         f"read of rotated slot {buf!r} is ordered after "
                         f"one write but races pid {w0.pid}'s later "
                         f"write of the same pass: after rotation/"
                         f"donation the read may observe either "
                         f"generation's copy", index=r.index, site=r.site)

    # -- ST017: declared staging identity shared across unordered windows --
    groups: Dict[str, List[_HBTransfer]] = defaultdict(list)
    for t in hb.transfers:
        if t.staging is not None:
            groups[t.staging].append(t)

    def retired_before(a: _HBTransfer, b: _HBTransfer) -> bool:
        """Every deposit of ``a`` is gated by a wait that happens-before
        ``b``'s trigger (so ``a``'s staging window is provably closed)."""
        return bool(a.gate_nodes) and all(
            g is not None and hb.reaches(g, b.start_node)
            for g in a.gate_nodes)

    for staging, ts in groups.items():
        for x in range(len(ts)):
            for y in range(x + 1, len(ts)):
                t1, t2 = ts[x], ts[y]
                if retired_before(t1, t2) or retired_before(t2, t1):
                    continue
                diag("ST017", t2.pid,
                     f"staging buffer {staging!r} is shared by transfers "
                     f"of batches {t1.batch} and {t2.batch} whose "
                     f"trigger-to-wait windows are unordered under "
                     f"happens-before: one pack may overwrite payloads "
                     f"the other transfer has not deposited yet",
                     index=t2.start_node, site=t2.site)


def hb_race_diagnostics(prog) -> List[Diagnostic]:
    """Just the happens-before race rules (ST015-ST018) over ``prog``.

    The equivalence certifier (:func:`.effects.certify_equivalence`)
    and :func:`.effects.program_certificate` call this directly — a certified-equivalent candidate must
    also be race-free under every interleaving.
    """
    diags: List[Diagnostic] = []
    seen = set()

    def diag(rule, pid, message, index=None, site=None, severity=None):
        key = (rule, pid, index, message)
        if key in seen:
            return
        seen.add(key)
        diags.append(Diagnostic(
            rule=rule, severity=severity or RULES[rule][0], pid=pid,
            message=message, index=index, site=site, program=prog.name))

    _hb_rules(prog, diag)
    return diags


# --------------------------------------------------------------------------
# Runtime sanitizer support (engines, sanitize=True)
# --------------------------------------------------------------------------


def canary_buffers(prog) -> Tuple[str, ...]:
    """Buffers safe to poison with NaN at pass start.

    A buffer qualifies when it is float-dtype, every deposit into it is
    a whole-buffer replace (add-mode reads the accumulator; a region
    deposit leaves lanes the canary would corrupt), and its first
    access in execution order is such a deposit — so in a race-free
    program the canary is fully overwritten (receiver lanes) or
    restored from the saved original (non-receiver lanes) before
    anything reads it.
    """
    deposit_kinds: Dict[str, set] = defaultdict(set)
    for b in prog.batches:
        for ch in b.channels:
            deposit_kinds[ch.dst_buf].add(
                (ch.mode, ch.recv_region is None))

    first: Dict[str, str] = {}

    def see(buf, kind):
        first.setdefault(buf, kind)

    batches = {b.index: b for b in prog.batches}
    for d in prog.descriptors:
        if isinstance(d, KernelDesc):
            for r in d.reads:
                see(r, "read")
            for w in d.writes:
                see(w, "kwrite")
        elif isinstance(d, StartDesc):
            b = batches.get(d.batch)
            if b is None:
                continue
            for ch in b.channels:
                see(ch.src_buf, "read")
            for ch in b.channels:
                see(ch.dst_buf,
                    "deposit" if ch.mode == "replace" else "read")

    out = []
    for buf, kinds in deposit_kinds.items():
        if kinds != {("replace", True)}:
            continue
        if first.get(buf) != "deposit":
            continue
        spec = prog.buffers.get(buf)
        if spec is None or not as_torch_dtype(spec.dtype).is_floating_point:
            continue
        out.append(buf)
    return tuple(sorted(out))


class DepositTracker:
    """Deposit-before-wait assertion state for the sanitizer.

    Fed every descriptor in stream order (:func:`check_deposit_order`,
    which every engine runs in its constructor under ``sanitize=True``):
    a read of (or overlapping deposit into) a slot whose completion has
    not been waited raises :class:`SanitizeError` before any launch.
    """

    def __init__(self, prog):
        self._batches = {b.index: b for b in prog.batches}
        self._gates = cross_gate_map(prog)
        self._cursor: Dict[Tuple[int, str], int] = defaultdict(int)
        self._pending: Dict[str, List[_Pending]] = defaultdict(list)
        self._name = prog.name

    def _fail(self, msg: str):
        raise SanitizeError(f"[sanitize] {self._name}: {msg}")

    def _check_read(self, buf, what, site):
        for p in self._pending.get(buf, ()):
            self._fail(
                f"{what} reads {buf!r} while it holds a pending unwaited "
                f"deposit (gated by pid {p.gate_pid}'s wait on batch "
                f"{p.gate_batch})"
                + (f" [enqueued at {site}]" if site else ""))

    def kernel(self, d: KernelDesc):
        for r in d.reads:
            self._check_read(r, f"kernel {d.name!r}", d.site)
        for w in d.writes:
            for p in self._pending.get(w, ()):
                self._fail(
                    f"kernel {d.name!r} writes {w!r} over a pending "
                    f"unwaited deposit (gated by pid {p.gate_pid}'s wait "
                    f"on batch {p.gate_batch})")

    def start(self, d: StartDesc):
        batch = self._batches.get(d.batch)
        if batch is None:
            return
        for ch in batch.channels:
            self._check_read(ch.src_buf, f"batch {d.batch}'s send",
                             getattr(ch, "send_site", None))
        for ch in batch.channels:
            gate = resolve_gate(self._gates, self._cursor, d.pid, d.batch, ch)
            for p in self._pending.get(ch.dst_buf, ()):
                if (("replace" in (p.mode, ch.mode))
                        and _regions_overlap(p.region, ch.recv_region)):
                    self._fail(
                        f"deposit into {ch.dst_buf!r} overwrites a pending "
                        f"unwaited deposit (message lost before pid "
                        f"{p.gate_pid} waits batch {p.gate_batch})")
            self._pending[ch.dst_buf].append(_Pending(
                mode=ch.mode, gate_pid=gate[0], gate_batch=gate[1],
                region=ch.recv_region,
                site=getattr(ch, "recv_site", None), index=None))

    def wait(self, d: WaitDesc):
        for buf in list(self._pending):
            self._pending[buf] = [
                p for p in self._pending[buf]
                if not (p.gate_pid == d.pid and p.gate_batch <= d.batch)]
            if not self._pending[buf]:
                del self._pending[buf]


def check_deposit_order(prog) -> None:
    """Run the sanitizer's deposit-before-wait assertion over the whole
    descriptor stream (every engine's ``sanitize=True``, before any
    launch)."""
    tracker = DepositTracker(prog)
    for d in prog.descriptors:
        if isinstance(d, KernelDesc):
            tracker.kernel(d)
        elif isinstance(d, StartDesc):
            tracker.start(d)
        elif isinstance(d, WaitDesc):
            tracker.wait(d)
