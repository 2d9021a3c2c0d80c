"""Launch layer of the port: serving on one GPU (continuous batching
included), training and the prefill / decode step bundles (:mod:`.steps`,
:mod:`.train`), the ST cost model and the model costing (:mod:`.costing`),
the schedule tuner (:mod:`.tune`), and the meta-device dry run on the
production meshes (:mod:`.dryrun`, :mod:`.mesh`, :mod:`.trace_analysis`)."""
from .serve import ServeEngine, build_admission_schedule, serve, serve_continuous
from .steps import (
    StepBundle,
    build_persistent_train_step,
    build_pipelined_train_step,
    build_train_step,
    loss_plateau,
    persistent_steps,
    pipelined_steps,
)
from .tune import Knobs, TuneResult, tune

__all__ = ["ServeEngine", "build_admission_schedule", "serve", "serve_continuous",
           "StepBundle", "build_train_step", "build_persistent_train_step",
           "build_pipelined_train_step", "persistent_steps", "pipelined_steps",
           "loss_plateau", "Knobs", "TuneResult", "tune"]
