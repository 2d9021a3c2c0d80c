"""Dry run of every (arch × shape × mesh) on the ``meta`` device — port of
``repro.launch.dryrun``.

For each combination this module builds the step bundle on a production
mesh (:func:`.mesh.make_production_mesh`: 16×16, or 2×16×16 across two
pods) and traces the step over its ``meta`` inputs (:meth:`.steps.
StepBundle.trace`): no tensor holds data, and nothing runs on a device.
The record of a combination holds:

* ``status`` (``ok``, ``skipped`` with the reference's reason, or
  ``error`` with the exception), ``n_devices``;
* ``argument_bytes_per_device`` and ``output_bytes_per_device``: the
  bytes one device holds of the step's arguments and results, from each
  leaf's shard shape under the rules (the reference reads them from
  XLA's memory analysis of the partitioned program);
* ``step_dot_flops``, ``n_dots`` and ``top_dots``: the dots of the WHOLE
  step, forward, backward and recompute (the reference's ``flops`` are a
  device's, from the partitioned HLO: the port has no partitioner);
* ``trace_s``: the seconds the trace took;
* ``collectives``: ``"not derived"``: what the reference's partitioner
  inserts (the gradient all-reduces, the FSDP gathers, the EP ``psum``)
  cannot be derived without one (``ROADMAP.md`` §3, known divergences).

Records go to ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``.

Usage (the CPU is enough)::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--multi-pod | --single-pod]   # all 80
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Iterable, List, Optional

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from .mesh import make_production_mesh, mesh_name
from .steps import build_bundle

ARTIFACTS = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts",
                         "dryrun_torch")

# (arch, shape) pairs skipped with a reason: the reference's
SKIPS = {
    ("whisper-large-v3", "long_500k"):
        "enc-dec with a 448-token decoder spec; 500k decode is architecture-"
        "inapplicable",
    ("qwen1.5-110b", "long_500k"):
        "pure full attention, no windowed variant in the source model",
    ("internvl2-76b", "long_500k"):
        "pure full attention, no windowed variant in the source model",
    ("grok-1-314b", "long_500k"):
        "pure full attention, no windowed variant in the source model",
}

COLLECTIVES_NOT_DERIVED = ("not derived: one card has no SPMD partitioner, and the "
                           "collectives it would insert are not imitated")


def run_one(arch: str, shape_name: str, multi_pod: bool, save: bool = True) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh), "status": "pending"}
    if (arch, shape_name) in SKIPS:
        rec.update(status="skipped", reason=SKIPS[(arch, shape_name)])
        _save(rec, save)
        return rec
    t0 = time.perf_counter()
    try:
        bundle = build_bundle(get_config(arch), SHAPES[shape_name], mesh)
        outputs, dots, trace_s = bundle.trace()
        rec.update(
            status="ok",
            n_devices=mesh.size,
            rules=bundle.rules.name,
            argument_bytes_per_device=bundle.argument_bytes(),
            output_bytes_per_device=bundle.output_bytes(outputs),
            step_dot_flops=dots.total_flops,
            n_dots=dots.n_dots,
            top_dots=dots.largest,
            trace_s=trace_s,
            wall_s=time.perf_counter() - t0,
            collectives=COLLECTIVES_NOT_DERIVED,
        )
    except Exception as e:  # a failure here is a fault of the port: recorded, counted
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    _save(rec, save)
    return rec


def _save(rec: dict, save: bool) -> None:
    if not save:
        return
    os.makedirs(ARTIFACTS, exist_ok=True)
    path = os.path.join(ARTIFACTS, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def run_all(archs: Iterable[str] = ARCH_IDS, shapes: Iterable[str] = tuple(SHAPES),
            meshes: Iterable[bool] = (False, True), save: bool = True,
            log=print) -> List[dict]:
    """Every record of ``archs`` × ``shapes`` × ``meshes`` (``True``: the
    two-pod mesh), each logged as it is made."""
    results = []
    for arch in archs:
        for shape in shapes:
            for multi_pod in meshes:
                rec = run_one(arch, shape, multi_pod, save=save)
                msg = ""
                if rec["status"] == "ok":
                    msg = (f" step_flops={rec['step_dot_flops']:.3e} "
                           f"arg={rec['argument_bytes_per_device'] / 1e9:.3f}GB/dev "
                           f"trace={rec['trace_s']:.2f}s")
                elif rec["status"] == "error":
                    msg = f" {rec['error'][:160]}"
                log(f"[{rec['status']:7s}] {arch} {shape} {rec['mesh']}{msg}")
                results.append(rec)
    return results


def summary(results: List[dict]) -> dict:
    return {k: sum(r["status"] == k for r in results) for k in ("ok", "skipped", "error")}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    args = ap.parse_args(argv)
    meshes = sorted({*([True] if args.multi_pod or not args.single_pod else []),
                     *([False] if args.single_pod or not args.multi_pod else [])})
    archs = [args.arch] if args.arch else list(ARCH_IDS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    results = run_all(archs, shapes, meshes, log=lambda m: print(m, flush=True))
    s = summary(results)
    print(f"\nDRY-RUN SUMMARY: {s['ok']} ok, {s['skipped']} skipped, {s['error']} errors "
          f"of {len(results)}")
    return 1 if s["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
