"""Faces — the paper's microbenchmark pattern as an ST program.

Port of ``repro.core.halo``.  Faces (paper §V-A) is the nearest-neighbour
pattern of CORAL-2 Nekbone: each rank owns a 3-D block and exchanges the
faces (6), edges (12) and corners (8) of it with up to 26 neighbours,
then adds the received contributions into its own boundary.  One
iteration of the inner loop:

1. pre-post receives;            (enqueue_recv ×26)
2. pack boundary slabs;          (pack kernels)
3. initiate sends;               (enqueue_send ×26 + one enqueue_start)
4. interior compute (overlap);   (enqueue_kernel)
5. wait for messages;            (enqueue_wait)
6. unpack-and-add.               (unpack kernels)

Here every rank lives on one GPU in the global layout ``(gx, gy, gz,
px, py, pz)``, and each pack/unpack kernel handles all ranks in one
launch.  Variants: ``granularity`` (``direct26`` or ``staged3``),
``batched`` (one start for all messages or one per message) and
``pack``: ``"kernel"`` selects the hand-written Hopper kernels
(:mod:`repro_torch.kernels.halo_pack`, the reference's ``"pallas"``),
``"torch"`` the plain slicing (the reference's ``"jnp"``).

:func:`faces_step_contiguous` runs one iteration the paper's other way,
through ONE contiguous buffer per rank (``ops.pack_boundary`` and
``ops.unpack_boundary_add``, the Hopper kernels of the reference's
``pack_boundary_call`` / ``unpack_boundary_add_call``); it equals one
``direct26`` iteration of the engines bit for bit.
:func:`faces_oracle` is a copy of the reference's NumPy oracle.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels import halo_pack as hk
from ..kernels import ops
from ..kernels import ref as kref
from .descriptors import GridOffsetPeer
from .queue import STProgram, STQueue

AXES3 = ("gx", "gy", "gz")

# all 26 neighbour directions: faces, then edges, then corners
DIRECTIONS: Tuple[Tuple[int, int, int], ...] = tuple(
    sorted(
        (d for d in itertools.product((-1, 0, 1), repeat=3) if any(d)),
        key=lambda d: (sum(map(abs, d)), d),
    )
)
FACES = tuple(d for d in DIRECTIONS if sum(map(abs, d)) == 1)
PACK_MODES = ("torch", "kernel")


@dataclasses.dataclass(frozen=True)
class FacesConfig:
    grid: Tuple[int, int, int] = (2, 2, 2)       # rank grid (gx, gy, gz)
    points: Tuple[int, int, int] = (16, 16, 16)  # local block points
    dtype: str = "float32"
    granularity: str = "direct26"  # direct26 | staged3
    batched: bool = True           # one start per batch of sends
    pack: str = "torch"            # torch | kernel
    periodic: bool = False
    interior_compute: bool = True  # include the overlap kernel (step 4)
    # Factor applied to the whole field at the end of every iteration
    # (0 → off); 0 < damping < ~0.3 keeps the field from growing.
    damping: float = 0.0

    @property
    def n_ranks(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    @property
    def n_points(self) -> int:
        return self.n_ranks * int(np.prod(self.points))


def _slab_index(side: int, n: int) -> slice:
    """-1 → first plane, +1 → last plane, 0 → everything."""
    if side == -1:
        return slice(0, 1)
    if side == 1:
        return slice(n - 1, n)
    return slice(0, n)


def _region_for(direction: Tuple[int, int, int], points) -> Tuple[slice, ...]:
    return tuple(_slab_index(s, n) for s, n in zip(direction, points))


def _slab_shape(direction, points) -> Tuple[int, ...]:
    return tuple(1 if s else n for s, n in zip(direction, points))


def _make_pack_fn(region, pack_mode: str):
    pack = hk.halo_pack if pack_mode == "kernel" else kref.halo_pack
    return lambda u: pack(u, region)


def _make_unpack_fn(region, pack_mode: str):
    unpack = hk.halo_unpack_add if pack_mode == "kernel" else kref.halo_unpack_add
    return lambda u, msg: unpack(u, msg, region)


def _interior_fn(u: torch.Tensor) -> torch.Tensor:
    """Step-4 overlap kernel: a cheap local stencil on every rank's block
    (plain PyTorch; the reference's is jnp, not Pallas)."""
    return u + 0.125 * (
        torch.roll(u, 1, -3) + torch.roll(u, -1, -3)
        + torch.roll(u, 1, -2) + torch.roll(u, -1, -2)
        + torch.roll(u, 1, -1) + torch.roll(u, -1, -1)
        - 6.0 * u
    )


def build_faces_program(cfg: FacesConfig, mesh, name: Optional[str] = None,
                        coalesce: bool = True) -> STProgram:
    """Build the Faces inner loop as an ST program on a (gx,gy,gz) mesh.

    With ``coalesce`` (default) the direct26 messages are grouped into 6
    fused by-axis transfers per start (the paper's contiguous MPI
    buffer); ``name`` defaults to ``faces_{granularity}``.
    """
    if cfg.pack not in PACK_MODES:
        raise ValueError(f"pack must be one of {PACK_MODES}, got {cfg.pack!r}")
    if tuple(mesh.axis_names) != AXES3 or tuple(mesh.axis_sizes) != tuple(cfg.grid):
        raise ValueError(f"Faces needs a mesh over {AXES3} of shape "
                         f"{cfg.grid}, got {mesh.shape}")
    gx, gy, gz = cfg.grid
    q = STQueue(mesh, name="faces")
    q.buffer("u", (gx, gy, gz, *cfg.points), cfg.dtype, pspec=AXES3)

    dirs = DIRECTIONS if cfg.granularity == "direct26" else FACES
    msg_in, msg_out = {}, {}
    for i, d in enumerate(dirs):
        sshape = _slab_shape(d, cfg.points)
        msg_out[d] = q.buffer(f"out{i}", (gx, gy, gz, *sshape), cfg.dtype, pspec=AXES3)
        msg_in[d] = q.buffer(f"in{i}", (gx, gy, gz, *sshape), cfg.dtype, pspec=AXES3)

    if cfg.granularity == "direct26":
        _emit_direct26(q, cfg, msg_in, msg_out)
    elif cfg.granularity == "staged3":
        _emit_staged3(q, cfg, msg_in, msg_out)
    else:
        raise ValueError(cfg.granularity)
    return q.build(name=name or f"faces_{cfg.granularity}", coalesce=coalesce)


def _emit_direct26(q: STQueue, cfg: FacesConfig, msg_in, msg_out):
    dirs = DIRECTIONS
    # 2. pack kernels (packs precede sends in stream order)
    for i, d in enumerate(dirs):
        region = _region_for(d, cfg.points)
        q.enqueue_kernel(_make_pack_fn(region, cfg.pack), ["u"], [msg_out[d]],
                         name=f"pack{i}")
    if cfg.batched:
        # 1+3. all receives, then all sends, one trigger for the batch
        for i, d in enumerate(dirs):
            peer = GridOffsetPeer(AXES3, tuple(-x for x in d), cfg.periodic)
            q.enqueue_recv(msg_in[d], peer, tag=i)
        for i, d in enumerate(dirs):
            q.enqueue_send(msg_out[d], GridOffsetPeer(AXES3, d, cfg.periodic), tag=i)
        q.enqueue_start()
    else:
        # unbatched: one start per message
        for i, d in enumerate(dirs):
            peer = GridOffsetPeer(AXES3, tuple(-x for x in d), cfg.periodic)
            q.enqueue_recv(msg_in[d], peer, tag=i)
            q.enqueue_send(msg_out[d], GridOffsetPeer(AXES3, d, cfg.periodic), tag=i)
            q.enqueue_start()
    # 4. interior compute overlapping communication
    if cfg.interior_compute:
        q.enqueue_kernel(_interior_fn, ["u"], ["u"], name="interior")
    # 5. wait
    q.enqueue_wait()
    # 6. unpack-and-add
    for i, d in enumerate(dirs):
        region = _region_for(tuple(-x for x in d), cfg.points)
        q.enqueue_kernel(_make_unpack_fn(region, cfg.pack),
                         ["u", msg_in[d]], ["u"], name=f"unpack{i}")
    _emit_damping(q, cfg)


def _emit_staged3(q: STQueue, cfg: FacesConfig, msg_in, msg_out):
    """Three axis sweeps exchanging the two faces along one axis each;
    edge and corner data travel through the ghost-updated block."""
    for stage, axis in enumerate((0, 1, 2)):
        dirs = [d for d in FACES if d[axis] != 0]
        for d in dirs:
            i = FACES.index(d)
            peer = GridOffsetPeer(AXES3, tuple(-x for x in d), cfg.periodic)
            q.enqueue_recv(msg_in[d], peer, tag=100 * stage + i)
        for d in dirs:
            i = FACES.index(d)
            region = _region_for(d, cfg.points)
            q.enqueue_kernel(_make_pack_fn(region, cfg.pack), ["u"], [msg_out[d]],
                             name=f"pack_s{stage}_{i}")
        for d in dirs:
            i = FACES.index(d)
            q.enqueue_send(msg_out[d], GridOffsetPeer(AXES3, d, cfg.periodic),
                           tag=100 * stage + i)
        q.enqueue_start()
        if cfg.interior_compute and stage == 0:
            q.enqueue_kernel(_interior_fn, ["u"], ["u"], name="interior")
        q.enqueue_wait()
        for d in dirs:
            region = _region_for(tuple(-x for x in d), cfg.points)
            q.enqueue_kernel(_make_unpack_fn(region, cfg.pack),
                             ["u", msg_in[d]], ["u"], name=f"unpack_s{stage}")
    _emit_damping(q, cfg)


def _emit_damping(q: STQueue, cfg: FacesConfig):
    """End-of-iteration relaxation kernel (only when cfg.damping is on)."""
    if cfg.damping:
        scale = float(cfg.damping)
        q.enqueue_kernel(lambda u: u * scale, ["u"], ["u"], name="damp")


def faces_step_contiguous(u: torch.Tensor, cfg: FacesConfig) -> torch.Tensor:
    """One Faces iteration on the global field ``u (gx, gy, gz, px, py,
    pz)`` through one contiguous buffer per rank, the paper's "one MPI
    buffer" (steps 2 and 6), returning the new field (``u`` is kept).

    Every rank packs its 26 boundary regions, in DIRECTIONS order (faces,
    edges, corners), into one buffer (``ops.pack_boundary``: one launch
    for all ranks); the interior stencil runs; rank ``g`` receives, for
    each direction ``d``, segment ``d`` of rank ``g - d``'s buffer (zeros
    where there is no such rank); and ONE ``ops.unpack_boundary_add``
    adds the received buffer into the ``-d`` regions in DIRECTIONS order,
    rounding after each add — the engines' order of unpacks, so the
    result equals one ``direct26`` iteration bit for bit.
    """
    if tuple(u.shape[:3]) != tuple(cfg.grid) or tuple(u.shape[3:]) != tuple(cfg.points):
        raise ValueError(f"field of shape {tuple(u.shape)} does not match grid "
                         f"{cfg.grid} x points {cfg.points}")
    send = [_region_for(d, cfg.points) for d in DIRECTIONS]
    recv_regions = [_region_for(tuple(-x for x in d), cfg.points) for d in DIRECTIONS]
    sent = ops.pack_boundary(u, send)
    out = _interior_fn(u) if cfg.interior_compute else u.clone()
    recv = torch.zeros_like(sent)
    off = 0
    for d, region in zip(DIRECTIONS, send):
        n = kref.region_size(region)
        seg = sent[..., off:off + n]
        if cfg.periodic:
            recv[..., off:off + n] = torch.roll(seg, shifts=d, dims=(0, 1, 2))
        else:
            src, dst = [slice(None)] * 3, [slice(None)] * 3
            for ax, delta, g in zip(range(3), d, cfg.grid):
                if delta > 0:
                    src[ax], dst[ax] = slice(0, g - delta), slice(delta, g)
                elif delta < 0:
                    src[ax], dst[ax] = slice(-delta, g), slice(0, g + delta)
            recv[(*dst, slice(off, off + n))] = seg[(*src, slice(None))]
        off += n
    ops.unpack_boundary_add(out, recv, recv_regions)
    if cfg.damping:
        out = out * float(cfg.damping)
    return out


def global_residual_fn(cfg: FacesConfig, buf: str = "u"):
    """A ``reduce_fn(mem) -> 0-d tensor``: the global RMS norm of ``buf``,
    ``sqrt(sum(buf**2) / cfg.n_points)`` in float32.  Every rank lives in
    one tensor, so the reference's ``psum`` of per-rank sums is the sum
    over the whole tensor.  Inside the loop it is the convergence
    residual, computed with no host sync."""
    n_total = float(cfg.n_points)

    def residual(mem):
        return torch.sqrt(torch.sum(torch.square(mem[buf].float())) / n_total)

    return residual


def run_faces_until_converged(cfg: FacesConfig, mesh, u0, tol: float,
                              max_iters: int, mode: str = "dataflow",
                              double_buffer: Optional[bool] = None,
                              donate: bool = True):
    """Iterate Faces until the global residual falls below ``tol``, at
    most ``max_iters`` times, with the device deciding when to stop: ONE
    graph launch on the card, and the only host read is ``n_done``, after
    it.

    Returns ``(mem, residuals, n_done, stats)``: the final buffers, the
    residual trace cut to the realized length (a tensor on the mesh's
    device), the realized count and the engine's stats
    (``stats.dispatches == 1``, ``stats.sync_points == 0``).
    """
    from .engine_persistent import PersistentEngine

    prog = build_faces_program(cfg, mesh).persistent(
        max_iters, until=lambda r: r >= tol)
    eng = PersistentEngine(prog, mode=mode, double_buffer=double_buffer,
                           reduce_fn=global_residual_fn(cfg), donate=donate)
    mem, residuals, n_done = eng(eng.init_buffers({"u": u0}))
    n_done = int(n_done)
    return mem, residuals[:n_done], n_done, eng.stats


def run_faces_persistent(cfg: FacesConfig, mesh, u0, n_iters: int,
                         mode: str = "dataflow", reduce_fn=None,
                         double_buffer: Optional[bool] = None,
                         donate: bool = True):
    """Run ``n_iters`` Faces iterations as ONE graph launch.

    Returns ``(mem, stats)`` (``stats.dispatches == 1``), or
    ``((mem, reductions), stats)`` with ``reduce_fn``.
    """
    from .engine_persistent import PersistentEngine

    prog = build_faces_program(cfg, mesh).persistent(n_iters)
    eng = PersistentEngine(prog, mode=mode, reduce_fn=reduce_fn,
                           double_buffer=double_buffer, donate=donate)
    out = eng(eng.init_buffers({"u": u0}))
    return out, eng.stats


# --------------------------------------------------------------------------
# NumPy oracle (copy of the reference's)
# --------------------------------------------------------------------------


def faces_oracle(u: np.ndarray, cfg: FacesConfig) -> np.ndarray:
    """Reference update for one inner iteration, computed globally.

    ``u`` has shape (gx, gy, gz, px, py, pz).  Mirrors ``direct26``:
    interior stencil (if enabled), then the 26-direction boundary sum of
    the *pre-exchange* packed values, then damping.
    """
    u = np.asarray(u, dtype=np.dtype(cfg.dtype))
    gx, gy, gz = cfg.grid
    out = u.copy()
    packed = {
        d: u[(slice(None),) * 3 + _region_for(d, cfg.points)].copy()
        for d in DIRECTIONS
    }
    if cfg.interior_compute:
        core = out
        sm = core.copy()
        for ax in (3, 4, 5):
            sm += 0.125 * (np.roll(core, 1, ax) + np.roll(core, -1, ax))
        sm -= 0.125 * 6.0 * core
        out = sm
    for d in DIRECTIONS:
        # rank r receives, from neighbour r - d, that neighbour's +d
        # slab, deposited into r's -d region
        msg = packed[d]
        if cfg.periodic:
            shifted = np.roll(msg, shift=d, axis=(0, 1, 2))
        else:
            shifted = np.zeros_like(msg)
            src = [slice(None)] * 6
            dst = [slice(None)] * 6
            for ax, delta, n in zip(range(3), d, (gx, gy, gz)):
                if delta > 0:
                    src[ax], dst[ax] = slice(0, n - delta), slice(delta, n)
                elif delta < 0:
                    src[ax], dst[ax] = slice(-delta, n), slice(0, n + delta)
            shifted[tuple(dst)] = msg[tuple(src)]
        region = _region_for(tuple(-x for x in d), cfg.points)
        out[(slice(None),) * 3 + region] += shifted
    if cfg.damping:
        out *= np.asarray(cfg.damping, dtype=out.dtype)
    return out
