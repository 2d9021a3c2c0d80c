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

:func:`run_faces_pipelined` splits the domain into N x-parts on the same
mesh, one queue each, composed (:mod:`.schedule`) into one persistent
graph launch in which every part runs on its own CUDA stream.  Linked
(``exchange=True``, :func:`build_faces_part_program`), the parts trade
their x-crossing halo messages and the stencil's ghost planes through
cross-program channels every iteration, and the merged field equals the
full-domain run bit for bit in both trigger modes; with
``exchange=False`` the parts iterate independently.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import halo_pack as hk
from ..kernels import ops
from ..kernels import ref as kref
from .descriptors import GridOffsetPeer
from .queue import STProgram, STQueue
from .schedule import STSchedule, compose

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
# The domain split into N x-parts, one queue each
# --------------------------------------------------------------------------


def part_points(px: int, n: int) -> Tuple[int, ...]:
    """Sizes of an N-way split of ``px`` planes; the first ``px % n``
    parts take one extra (``numpy.array_split``'s convention)."""
    if not 1 <= n <= px:
        raise ValueError(
            f"cannot split {px} x-planes into {n} part(s): need "
            f"1 <= n_parts <= points[0]")
    base, extra = divmod(px, n)
    return tuple(base + (1 if k < extra else 0) for k in range(n))


def part_configs(cfg: FacesConfig, n: int) -> Tuple[FacesConfig, ...]:
    """The FacesConfig of each part of an N-way x-split (same grid)."""
    px, py, pz = cfg.points
    return tuple(dataclasses.replace(cfg, points=(p, py, pz))
                 for p in part_points(px, n))


def split_parts(u0, n: int):
    """Split a (gx,gy,gz,px,py,pz) field (array or tensor) into N x-parts."""
    offs = np.concatenate([[0], np.cumsum(part_points(u0.shape[3], n))])
    return [u0[:, :, :, offs[k]:offs[k + 1]] for k in range(n)]


def merge_parts(parts) -> torch.Tensor:
    """Inverse of :func:`split_parts`."""
    return torch.cat([torch.as_tensor(p) for p in parts], dim=3)


def half_config(cfg: FacesConfig, part: int = 0) -> FacesConfig:
    """A part's FacesConfig of a 2-way split (``part`` picks which when
    ``points[0]`` is odd)."""
    return part_configs(cfg, 2)[part]


def split_halves(u0):
    return tuple(split_parts(u0, 2))


def merge_halves(ua, ub) -> torch.Tensor:
    return merge_parts([ua, ub])


PIPELINE_NAMES = ("facesA", "facesB")


def part_names(n: int) -> Tuple[str, ...]:
    """Program names of an N-way split (2-way: ``PIPELINE_NAMES``)."""
    if n == 2:
        return PIPELINE_NAMES
    return tuple(f"faces{k}" for k in range(n))


# Ghost-plane tags (cross-program, peer offset (0,0,0)): _GHOST_TAG_LO
# carries part k's last plane into part k+1's "glo", _GHOST_TAG_HI its
# first plane into part k-1's "ghi" (a ring, as the block's own wrap).
_GHOST_TAG_LO, _GHOST_TAG_HI = 0, 1


def _part_interior_fn(u: torch.Tensor, glo: torch.Tensor, ghi: torch.Tensor) -> torch.Tensor:
    """:func:`_interior_fn` of one x-part, the neighbour parts' planes in
    place of the x-rolls' wrap: the same additions in the same order, so
    a split field equals the unsplit one bit for bit."""
    xm = torch.cat([glo, u[..., :-1, :, :]], dim=-3)  # == roll(full, 1, -3)
    xp = torch.cat([u[..., 1:, :, :], ghi], dim=-3)   # == roll(full, -1, -3)
    return u + 0.125 * (
        xm + xp
        + torch.roll(u, 1, -2) + torch.roll(u, -1, -2)
        + torch.roll(u, 1, -1) + torch.roll(u, -1, -1)
        - 6.0 * u
    )


def build_faces_part_program(cfg: FacesConfig, mesh, part: int, n_parts: int,
                             names: Optional[Tuple[str, ...]] = None,
                             coalesce: bool = True) -> STProgram:
    """Part ``part`` of an N-way x-split of the domain ``cfg`` describes,
    with the cross-program links that make the composed parts the
    full-domain iteration, bit for bit:

    * ghost planes: each part's stencil reads its ring neighbours'
      boundary planes, fetched in a start/wait batch of their own;
    * x-crossing halo messages: the 18 directions with an x component
      pack at one end of the split (part 0 for ``-x``, part N-1 for
      ``+x``) and deposit into the other end's in-slots; the 8
      x-neutral ones stay in each part.  Unpack-adds replay in global
      direction order.

    Compose it with its sibling parts; engines refuse the open program.
    Needs ``direct26`` and batched triggering.  The emission mirrors
    :func:`_emit_direct26` filtered by direction ownership, as the
    reference's does.
    """
    if cfg.granularity != "direct26":
        raise ValueError(
            f"linked domain split supports granularity='direct26' only "
            f"(got {cfg.granularity!r})")
    if not cfg.batched:
        raise ValueError("linked domain split requires batched triggering")
    if n_parts < 2:
        raise ValueError("a linked split needs n_parts >= 2 "
                         "(use build_faces_program for the unsplit domain)")
    names = tuple(names) if names is not None else part_names(n_parts)
    if len(names) != n_parts:
        raise ValueError(f"need {n_parts} names, got {len(names)}")
    cfgp = part_configs(cfg, n_parts)[part]
    gx, gy, gz = cfg.grid
    px, py, pz = cfgp.points
    prev_name = names[(part - 1) % n_parts]
    next_name = names[(part + 1) % n_parts]

    own = [d for d in DIRECTIONS if d[0] == 0]
    cross_out = [d for d in DIRECTIONS
                 if (d[0] == 1 and part == n_parts - 1) or (d[0] == -1 and part == 0)]
    cross_in = [d for d in DIRECTIONS
                if (d[0] == 1 and part == 0) or (d[0] == -1 and part == n_parts - 1)]
    out_dst = {d: (names[0] if d[0] == 1 else names[n_parts - 1]) for d in cross_out}
    in_src = {d: (names[n_parts - 1] if d[0] == 1 else names[0]) for d in cross_in}

    q = STQueue(mesh, name=names[part])
    q.buffer("u", (gx, gy, gz, px, py, pz), cfg.dtype, pspec=AXES3)
    msg_in, msg_out = {}, {}
    for i, d in enumerate(DIRECTIONS):
        sshape = _slab_shape(d, cfgp.points)
        if d in own or d in cross_out:
            msg_out[d] = q.buffer(f"out{i}", (gx, gy, gz, *sshape), cfg.dtype, pspec=AXES3)
        if d in own or d in cross_in:
            msg_in[d] = q.buffer(f"in{i}", (gx, gy, gz, *sshape), cfg.dtype, pspec=AXES3)

    here = GridOffsetPeer(AXES3, (0, 0, 0))  # same-rank hop between parts
    if cfg.interior_compute:
        # the stencil needs the planes before the overlap kernel: a batch
        # of their own, waited at once
        q.buffer("glo", (gx, gy, gz, 1, py, pz), cfg.dtype, pspec=AXES3)
        q.buffer("ghi", (gx, gy, gz, 1, py, pz), cfg.dtype, pspec=AXES3)
        q.enqueue_recv("glo", here, tag=_GHOST_TAG_LO, remote=prev_name)
        q.enqueue_recv("ghi", here, tag=_GHOST_TAG_HI, remote=next_name)
        q.enqueue_send("u", here, tag=_GHOST_TAG_LO, remote=next_name,
                       region=(slice(0, 1),) * 3
                       + (slice(px - 1, px), slice(0, py), slice(0, pz)))
        q.enqueue_send("u", here, tag=_GHOST_TAG_HI, remote=prev_name,
                       region=(slice(0, 1),) * 3
                       + (slice(0, 1), slice(0, py), slice(0, pz)))
        q.enqueue_start()
        q.enqueue_wait()

    for i, d in enumerate(DIRECTIONS):
        if d in msg_out:
            q.enqueue_kernel(_make_pack_fn(_region_for(d, cfgp.points), cfg.pack),
                             ["u"], [msg_out[d]], name=f"pack{i}")
    for i, d in enumerate(DIRECTIONS):
        if d in msg_in:
            peer = GridOffsetPeer(AXES3, tuple(-x for x in d), cfg.periodic)
            q.enqueue_recv(msg_in[d], peer, tag=i, remote=in_src.get(d))
    for i, d in enumerate(DIRECTIONS):
        if d in msg_out:
            q.enqueue_send(msg_out[d], GridOffsetPeer(AXES3, d, cfg.periodic),
                           tag=i, remote=out_dst.get(d))
    q.enqueue_start()
    if cfg.interior_compute:
        q.enqueue_kernel(_part_interior_fn, ["u", "glo", "ghi"], ["u"], name="interior")
    q.enqueue_wait()
    for i, d in enumerate(DIRECTIONS):
        if d in msg_in:
            region = _region_for(tuple(-x for x in d), cfgp.points)
            q.enqueue_kernel(_make_unpack_fn(region, cfg.pack),
                             ["u", msg_in[d]], ["u"], name=f"unpack{i}")
    _emit_damping(q, cfg)
    return q.build(name=names[part], coalesce=coalesce)


def build_faces_pipeline(cfg: FacesConfig, mesh, n_parts: int = 2, n_iters=1,
                         exchange: bool = True, coalesce: bool = True,
                         tols: Optional[Sequence[float]] = None) -> STSchedule:
    """The N x-parts of ``cfg``'s domain, each marked for ``n_iters``
    passes (one count, or one a part), composed into one schedule: linked
    (:func:`build_faces_part_program`: the x-crossing halo links tie the
    split's two ends, the ghost-plane ring every adjacent pair) or, with
    ``exchange=False``, independent (:func:`build_faces_program` of each
    part's config).  With ``tols``, part k runs while its residual is at
    least ``tols[k]`` (``until=lambda r: r >= tols[k]``), ``n_iters``
    being its bound."""
    names = part_names(n_parts)
    if exchange:
        links = [(names[0], names[-1]), (names[-1], names[0])]
        if cfg.interior_compute:
            ring = [(names[k], names[(k + 1) % n_parts]) for k in range(n_parts)]
            links += ring + [(b, a) for a, b in ring]
        progs = [build_faces_part_program(cfg, mesh, k, n_parts, names=names,
                                          coalesce=coalesce) for k in range(n_parts)]
        links = sorted(set(links))
    else:
        links = None
        progs = [build_faces_program(c, mesh, name=nm, coalesce=coalesce)
                 for c, nm in zip(part_configs(cfg, n_parts), names)]
    counts = [n_iters] * n_parts if isinstance(n_iters, int) else list(n_iters)
    tols = [None] * n_parts if tols is None else list(tols)
    if len(counts) != n_parts or len(tols) != n_parts:
        raise ValueError(f"n_iters and tols need one entry per part ({n_parts}), got "
                         f"{n_iters!r} and {tols!r}")
    return compose(*[p.persistent(n, until=None if tol is None else
                                  (lambda r, tol=tol: r >= tol))
                     for p, n, tol in zip(progs, counts, tols)], links=links)


def run_faces_pipelined(cfg: FacesConfig, mesh, u0, *, n_iters: Optional[int] = None,
                        tols: Optional[Sequence[float]] = None,
                        max_iters: Optional[int] = None,
                        mode: str = "dataflow", double_buffer: Optional[bool] = None,
                        donate: bool = True, n_parts: int = 2, exchange: bool = True,
                        tune: bool = False):
    """N x-split Faces queues, composed, in ONE graph launch, each part on
    its own CUDA stream.  Two regimes:

    * ``n_iters=N``: every part runs N iterations.  Returns ``(mem,
      stats)``; part k's field is ``mem[f"{part_names(n_parts)[k]}/u"]``
      (:func:`merge_parts` joins them).  Linked (default), the merged
      field is the full-domain :func:`run_faces_persistent` result bit
      for bit; with ``exchange=False`` each part is an independent solve.
    * ``tols=(tol0, ..., tol{n-1})`` and ``max_iters``: each part runs
      until its own residual (:func:`global_residual_fn` of its part
      config) falls below its own tolerance, the device deciding (the
      masked multi-queue loop).  Returns ``(mem, residuals, n_done,
      stats)``, ``residuals[name]`` cut to the realized length and
      ``n_done[name]`` ints.  With ``exchange=False`` each part equals
      its own :func:`run_faces_until_converged` bit for bit; linked, a
      part that stopped freezes while its neighbours go on reading its
      frozen boundary, so the merged field is a staged solve, not the
      full domain's.

    ``tune=`` (the cost model) is not ported yet and raises
    ``NotImplementedError``.
    """
    from .engine_persistent import PersistentEngine

    if tune:
        raise NotImplementedError("tune=: the cost model and tuner are not ported "
                                  "yet: see ROADMAP.md, 'Cost model and tuner'")
    if (n_iters is None) == (tols is None):
        raise ValueError("pass exactly one of n_iters= or tols=")
    if tols is not None:
        if max_iters is None:
            raise ValueError("tols= requires max_iters=")
        if len(tols) != n_parts:
            raise ValueError(f"tols needs one tolerance per part ({n_parts}), got {tols!r}")
    names = part_names(n_parts)
    sched = build_faces_pipeline(cfg, mesh, n_parts, n_iters if tols is None else max_iters,
                                 exchange, tols=tols)
    reduce_fns = None if tols is None else {
        nm: global_residual_fn(c, buf=f"{nm}/u")
        for nm, c in zip(names, part_configs(cfg, n_parts))}
    eng = PersistentEngine(sched, mode=mode, double_buffer=double_buffer, donate=donate,
                           reduce_fns=reduce_fns)
    init = {f"{nm}/u": p for nm, p in zip(names, split_parts(u0, n_parts))}
    if tols is None:
        return eng(eng.init_buffers(init)), eng.stats
    mem, reds, n_done = eng(eng.init_buffers(init))
    n_done = {nm: int(v) for nm, v in n_done.items()}
    reds = {nm: r[:n_done[nm]] for nm, r in reds.items()}
    return mem, reds, n_done, eng.stats


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
