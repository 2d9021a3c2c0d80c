"""Launch layer of the port: serving on one GPU (continuous batching
included), the ST cost model (:mod:`.costing`) and the schedule tuner
(:mod:`.tune`)."""
from .serve import ServeEngine, build_admission_schedule, serve, serve_continuous
from .tune import Knobs, TuneResult, tune

__all__ = ["ServeEngine", "build_admission_schedule", "serve", "serve_continuous",
           "Knobs", "TuneResult", "tune"]
