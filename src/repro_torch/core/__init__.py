"""Core ST runtime of the port: queue, matching, engines, Faces."""

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
from .effects import program_digest
from .engine_fused import FusedEngine
from .engine_host import HostEngine, HostStats
from .engine_persistent import PersistentEngine, slot_buffers
from .halo import (
    DIRECTIONS,
    FacesConfig,
    build_faces_program,
    faces_oracle,
    faces_step_contiguous,
    global_residual_fn,
    run_faces_persistent,
    run_faces_until_converged,
)
from .matching import Batch, Channel, CoalescedChannel, CoalescePlan, MatchError
from .queue import QueueError, STProgram, STQueue, create_queue
from .state import from_reference, init_buffers, to_numpy

__all__ = [
    "BufferSpec", "GridOffsetPeer", "KernelDesc", "OffsetPeer", "PairListPeer",
    "RecvDesc", "SendDesc", "StartDesc", "WaitDesc", "hop_decomposition",
    "perm_for", "program_digest", "FusedEngine", "HostEngine", "HostStats",
    "PersistentEngine", "slot_buffers", "DIRECTIONS", "FacesConfig",
    "build_faces_program", "faces_oracle", "faces_step_contiguous",
    "global_residual_fn", "run_faces_persistent", "run_faces_until_converged",
    "Batch",
    "Channel", "CoalescedChannel", "CoalescePlan", "MatchError", "QueueError",
    "STProgram", "STQueue", "create_queue", "from_reference", "init_buffers",
    "to_numpy",
]
