"""Schedule auto-tuner: predict with the cost model, prove with medians.

Port of ``repro.launch.tune``, whole.  A
built ST program has a *discrete knob space* — execution-configuration
choices that never change its numerics, only its lowering and schedule
— and this module searches it with the analytic model
(:func:`repro_torch.launch.costing.schedule_cost`) pruning candidates before
anything is compiled, the bench harness's median-of-repeats loop
deciding winners, and STLint re-verifying every candidate before it is
ever timed (an invalid program can never publish a number).

Knob catalog
------------
``mode``            ``"stream" | "dataflow"`` — trigger/wait ordering
                    strictness (:class:`~repro_torch.core.engine_fused
                    .FusedEngine`).  fig12's original single knob.
``coalesce``        execute the batches' build-time
                    :class:`~repro_torch.core.matching.CoalescePlan`\\ s
                    (fused by-axis transfers) or the per-channel
                    lowering.
``double_buffer``   alternate message-slot copies between persistent
                    iterations (``None`` = engine default: on in
                    dataflow mode).
``unroll``          persistent ``fori_loop`` unroll factor (``None`` =
                    engine default, derived from ``double_buffer``).
``interleave``      the :func:`~repro_torch.core.schedule.compose` segment
                    policy: a name from :data:`~repro_torch.core.schedule
                    .INTERLEAVE_POLICIES` (``"round_robin"`` /
                    ``"sequential"``) or an int granularity (segments
                    one program emits per turn).
``n_parts`` /       domain-decomposition shape for builders that split
``split_points``    (:func:`repro_torch.core.halo.part_points` convention);
                    carried on :class:`Knobs` for builders to consume —
                    the tuner itself never rebuilds domains.

Search strategy
---------------
:func:`tune` takes a ``build(knobs)`` callable returning ``(engine,
fresh)`` — engine wrapping the candidate program, ``fresh()`` a factory
for its input buffers — plus a ``space`` mapping knob names to value
lists.  The cartesian product is enumerated (these spaces are tiny:
tens, not thousands); each candidate is **built** (builder exceptions
— e.g. :class:`~repro_torch.core.schedule.ScheduleError` for an impossible
interleaving — mark it invalid rather than aborting the search),
**verified** (error-severity STLint diagnostics disqualify),
optionally **certified** (``certify=True`` proves each candidate's
per-buffer effect trace identical to the ``base``-knob program's via
:func:`repro_torch.core.effects.certify_equivalence` — non-equivalent
candidates are disqualified before they are ever priced or timed, and
equivalent ones skip the numeric ``check`` callback), and **priced**
analytically.  Only the ``measure_top`` cheapest predictions are
built (a CUDA-graph capture on the card) and timed (median of
``repeats``); the fastest measured median wins.  Ties in prediction are broken by knob order, so the
search is deterministic.

How to add a knob
-----------------
1. Add the field (with its engine-default value) to :class:`Knobs`.
2. Teach the relevant layer to accept it (an engine constructor
   parameter, a ``compose``/builder argument, …) and make your
   ``build(knobs)`` forward it.
3. If the knob changes the *schedule shape*, make sure
   :func:`~repro_torch.launch.costing.schedule_cost` can see the difference
   (e.g. the interleave policy shows up as stream switches) — a knob
   the model is blind to still works, it just can't be pruned on.
4. List its candidate values in the ``space`` you pass to :func:`tune`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union


@dataclasses.dataclass(frozen=True)
class Knobs:
    """One point in the discrete tuning space (numerics-preserving)."""

    mode: str = "dataflow"
    coalesce: bool = True
    double_buffer: Optional[bool] = None
    unroll: Optional[int] = None
    interleave: Union[str, int] = "round_robin"
    n_parts: Optional[int] = None
    split_points: Optional[Tuple[int, ...]] = None

    def interleave_policy(self):
        """Resolve the ``interleave`` knob to an ``InterleavePolicy``."""
        from ..core.schedule import INTERLEAVE_POLICIES, InterleavePolicy
        if isinstance(self.interleave, int):
            return InterleavePolicy(granularity=self.interleave)
        return INTERLEAVE_POLICIES[self.interleave]

    def engine_kwargs(self) -> Dict[str, Any]:
        """The knobs an engine constructor consumes, ready to splat."""
        return {"mode": self.mode, "coalesce": self.coalesce,
                "double_buffer": self.double_buffer, "unroll": self.unroll}

    def asdict(self) -> Dict[str, Any]:
        """JSON-ready dict, engine-default (``None``) knobs omitted."""
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}

    def label(self) -> str:
        return ",".join(f"{k}={v}" for k, v in self.asdict().items())


@dataclasses.dataclass
class Candidate:
    """One evaluated knob combination."""

    knobs: Knobs
    predicted_us: Optional[float] = None
    stats: Optional[Dict[str, float]] = None  # measure() dict once timed
    engine: Any = None
    fresh: Any = None
    error: Optional[str] = None
    # EquivalenceCertificate vs the base-knob program (tune(certify=True));
    # an equivalent certificate lets the candidate skip the numeric
    # ``check`` callback, a non-equivalent one disqualifies it pre-timing.
    certificate: Any = None

    @property
    def measured_ms(self) -> Optional[float]:
        return self.stats["med_s"] * 1e3 if self.stats else None


@dataclasses.dataclass
class TuneResult:
    """Search outcome: winner + the full (ordered) candidate record."""

    best: Candidate
    candidates: List[Candidate]

    @property
    def measured(self) -> List[Candidate]:
        return [c for c in self.candidates if c.stats is not None]

    def knobs_dict(self) -> Dict[str, Any]:
        return self.best.knobs.asdict()


def measure(engine, fresh, inner: int, repeats: int = 5,
            warm: bool = True) -> Dict[str, float]:
    """The bench harness's timing loop: ``inner`` chained engine calls,
    ``repeats`` times, re-materializing inputs outside the timed section
    (donating engines consume theirs).  ``warm`` runs one untimed call
    first so that the build (a CUDA-graph capture on the card) never lands
    in a timed repeat (pass ``False`` when the caller already warmed the
    engine).  On a CUDA engine each repeat is timed with CUDA events and
    the device is synchronized before and after it; on a CPU engine with
    the host clock.  Returns ``{avg_s, min_s, max_s, med_s}``.
    """
    import numpy as np
    import torch

    cuda = engine.device.type == "cuda"

    def chain(m):
        for _ in range(inner):
            m = engine(m)
            if isinstance(m, tuple):  # (mem, reductions, ...) regimes
                m = m[0]

    if warm:
        engine(fresh())
    times = []
    for _ in range(repeats):
        m = fresh()
        if cuda:
            torch.cuda.synchronize(engine.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            chain(m)
            end.record()
            torch.cuda.synchronize(engine.device)
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            chain(m)
            times.append(time.perf_counter() - t0)
    return {"avg_s": float(np.mean(times)), "min_s": float(np.min(times)),
            "max_s": float(np.max(times)), "med_s": float(np.median(times))}


def _expand_space(space: Dict[str, Sequence[Any]],
                  base: Knobs) -> List[Knobs]:
    import itertools
    names = list(space)
    for n in names:
        if n not in {f.name for f in dataclasses.fields(Knobs)}:
            raise ValueError(f"unknown knob {n!r} (have "
                             f"{[f.name for f in dataclasses.fields(Knobs)]})")
    out = []
    for combo in itertools.product(*(space[n] for n in names)):
        out.append(dataclasses.replace(base, **dict(zip(names, combo))))
    return out


def _lint(program) -> Optional[str]:
    """Error-severity STLint diagnostics, formatted — or None if clean."""
    from ..core.verify import verify_program
    errors = [d for d in verify_program(program) if d.severity == "error"]
    if errors:
        return "; ".join(str(d) for d in errors)
    return None


def tune(
    build: Callable[[Knobs], Tuple[Any, Callable[[], Any]]],
    space: Dict[str, Sequence[Any]],
    *,
    base: Knobs = Knobs(),
    inner: int = 1,
    repeats: int = 3,
    measure_top: int = 3,
    engine_kind: Optional[str] = None,
    certify: bool = False,
    check: Optional[Callable[[Candidate], None]] = None,
    verbose: bool = False,
) -> TuneResult:
    """Search ``space`` over ``build``; return the measured winner.

    See the module docstring for the strategy.  ``engine_kind``
    overrides the cost model's dispatch model (inferred from the built
    engine's class otherwise); ``inner``/``repeats`` shape the timing
    loop exactly like the bench harness.  Raises ``ValueError`` when
    no candidate survives build+lint.

    ``certify=True`` builds the ``base``-knob program once and issues an
    :class:`~repro_torch.core.effects.EquivalenceCertificate` for every
    candidate against it: a candidate whose per-buffer effect trace does
    not match the baseline's is disqualified *before* pricing or timing
    (``error="uncertified: ..."``), so a knob that silently changes
    numerics can never publish a number.  ``check`` is a numeric
    validator called with each measured candidate (raise to reject it);
    candidates holding an equivalent certificate **skip** it — the
    proof replaces the allclose.
    """
    import warnings

    from .costing import schedule_cost

    baseline_prog = None
    if certify:
        from ..core.effects import certify_equivalence
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            baseline_engine, _ = build(base)
        baseline_prog = baseline_engine.program

    candidates: List[Candidate] = []
    for knobs in _expand_space(space, base):
        cand = Candidate(knobs=knobs)
        candidates.append(cand)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # lint explicitly below
                engine, fresh = build(knobs)
        except Exception as e:  # invalid point (ScheduleError, ...): skip
            cand.error = f"build: {type(e).__name__}: {e}"
            continue
        lint = _lint(engine.program)
        if lint is not None:  # never time an invalid program
            cand.error = f"stlint: {lint}"
            continue
        if baseline_prog is not None:
            cand.certificate = certify_equivalence(
                baseline_prog, engine.program)
            if not cand.certificate.equivalent:
                cand.error = f"uncertified: {cand.certificate.reason}"
                continue
        kind = engine_kind or (
            "persistent" if type(engine).__name__ == "PersistentEngine"
            else "fused")
        cand.engine, cand.fresh = engine, fresh
        cand.predicted_us = schedule_cost(
            engine.program, engine=kind, mode=knobs.mode,
            coalesce=knobs.coalesce, double_buffer=knobs.double_buffer,
        ).total_us
        if verbose:
            print(f"  tune: predict {cand.predicted_us:10.0f}us  "
                  f"[{knobs.label()}]", flush=True)

    viable = [c for c in candidates if c.error is None]
    if not viable:
        reasons = "; ".join(f"[{c.knobs.label()}] {c.error}"
                            for c in candidates)
        raise ValueError(f"no viable tuning candidate: {reasons}")
    viable.sort(key=lambda c: c.predicted_us)
    for cand in viable[:max(1, measure_top)]:
        cand.stats = measure(cand.engine, cand.fresh, inner, repeats)
        certified = (cand.certificate is not None
                     and cand.certificate.equivalent)
        if check is not None and not certified:
            try:
                check(cand)
            except Exception as e:  # numeric validation failed: reject
                cand.error = f"check: {type(e).__name__}: {e}"
                cand.stats = None
                continue
        if verbose:
            print(f"  tune: measure {cand.measured_ms:9.2f}ms  "
                  f"[{cand.knobs.label()}]"
                  + ("  [certified]" if certified else ""), flush=True)

    survivors = [c for c in viable if c.stats is not None
                 and c.error is None]
    if not survivors:
        reasons = "; ".join(f"[{c.knobs.label()}] {c.error}"
                            for c in candidates if c.error)
        raise ValueError(f"no measured candidate survived: {reasons}")
    best = min(survivors, key=lambda c: c.stats["med_s"])
    if verbose:
        print(f"  tune: best [{best.knobs.label()}] "
              f"med={best.measured_ms:.2f}ms "
              f"(searched {len(candidates)}, measured "
              f"{sum(1 for c in viable if c.stats)})", flush=True)
    return TuneResult(best=best, candidates=candidates)
