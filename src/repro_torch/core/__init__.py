"""Core ST runtime of the port: queue, matching, verifier, composition,
engines, Faces."""

from .descriptors import (
    BufferSpec,
    GridOffsetPeer,
    KernelDesc,
    OffsetPeer,
    PairListPeer,
    RecvDesc,
    SendDesc,
    StartDesc,
    WaitDesc,
    hop_decomposition,
    perm_for,
)
from .effects import (
    Effect,
    EquivalenceCertificate,
    ProgramCertificate,
    batch_effects,
    certify_equivalence,
    effect_trace,
    program_certificate,
    program_digest,
    stamp_staging,
)
from .engine_fused import FusedEngine
from .engine_host import HostEngine, HostStats
from .engine_persistent import PersistentEngine, slot_buffers
from .halo import (
    DIRECTIONS,
    FacesConfig,
    build_faces_part_program,
    build_faces_pipeline,
    build_faces_program,
    faces_oracle,
    faces_step_contiguous,
    global_residual_fn,
    half_config,
    merge_halves,
    merge_parts,
    part_configs,
    part_names,
    part_points,
    run_faces_persistent,
    run_faces_pipelined,
    run_faces_until_converged,
    split_halves,
    split_parts,
)
from .matching import (
    Batch,
    Channel,
    CoalescedChannel,
    CoalescePlan,
    MatchError,
    coalesce_batch,
    match_batch,
)
from .queue import QueueError, STProgram, STQueue, create_queue
from .schedule import (
    INTERLEAVE_POLICIES,
    InterleavePolicy,
    Link,
    ScheduleError,
    STSchedule,
    SubProgram,
    compose,
)
from .state import from_reference, init_buffers, to_numpy
from .verify import (
    Diagnostic,
    SanitizeError,
    STLintWarning,
    VerifyError,
    build_happens_before,
    format_diagnostics,
    hb_race_diagnostics,
    run_verify,
    verify_program,
)

__all__ = [
    "STQueue", "STProgram", "create_queue", "QueueError",
    "STSchedule", "SubProgram", "compose", "ScheduleError", "Link",
    "InterleavePolicy", "INTERLEAVE_POLICIES",
    "FusedEngine", "HostEngine", "HostStats", "PersistentEngine", "slot_buffers",
    "OffsetPeer", "GridOffsetPeer", "PairListPeer",
    "SendDesc", "RecvDesc", "KernelDesc", "StartDesc", "WaitDesc",
    "BufferSpec", "Batch", "Channel", "MatchError", "match_batch",
    "CoalescedChannel", "CoalescePlan", "coalesce_batch",
    "hop_decomposition", "perm_for",
    "FacesConfig", "build_faces_program", "build_faces_part_program",
    "build_faces_pipeline", "faces_oracle", "faces_step_contiguous",
    "run_faces_persistent", "run_faces_until_converged",
    "run_faces_pipelined", "half_config", "split_halves", "merge_halves",
    "part_configs", "part_names", "part_points", "split_parts",
    "merge_parts", "global_residual_fn", "DIRECTIONS",
    "Diagnostic", "STLintWarning", "VerifyError", "SanitizeError",
    "verify_program", "run_verify", "format_diagnostics",
    "build_happens_before", "hb_race_diagnostics",
    "Effect", "EquivalenceCertificate", "ProgramCertificate",
    "batch_effects", "certify_equivalence", "effect_trace",
    "program_certificate", "program_digest", "stamp_staging",
    "from_reference", "init_buffers", "to_numpy",
]
