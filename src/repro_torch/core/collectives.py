"""Collective-matmul unification — ring collectives as ST programs.

Port of ``repro.core.collectives``.  :mod:`.overlap` writes the
decomposed ("collective matmul") family as plain functions of stacked
rank blocks; this module expresses the same decompositions as ST
descriptors: each ring step is an ordinary trigger→wait channel
(``enqueue_send``/``enqueue_recv`` + ``enqueue_start``/``enqueue_wait``)
and each per-chunk matmul or copy an ``enqueue_compute`` kernel, so the
collectives are matched, linted (ST013/ST014), priced
(:func:`repro_torch.launch.costing.schedule_cost`), tuned, composed and
run persistent like any ST program.

Bit-identity contract: every builder issues the op sequence of its
:mod:`.overlap` oracle (same rotation direction, same deposit offsets,
same accumulate operand order) with the same torch calls on the same
shapes (a batched matmul ``(R, rows, k) @ (R, k, n)`` a chunk, one add
a ring step), so results equal the oracle bit for bit.  The in-place
ring rotation (send and recv on the SAME buffer, replace mode) is the
descriptor spelling of ``cur = ppermute(cur, +1)``: the engines read
the whole buffer for the send before the deposit overwrites it.

Kernels see stacked rank blocks: each buffer as ``(R, *local)``
(:mod:`.state`), whatever its stored layout, and per-rank offsets
(``jax.lax.axis_index`` in the reference) are index tensors built on
the mesh device when the kernel is enqueued, so a CUDA-graph capture
copies nothing from the host.  The matmuls are ``torch.matmul``, as the
reference computes them with ``@`` outside any Pallas kernel.

Layouts (the reference's):

``enqueue_all_gather``      buf global [n*m, ...] pspec (axis,); out
                            replicated () or axis-sharded.
``enqueue_reduce_scatter``  buf = per-rank full partials, global
                            [n*(n*c), ...] pspec (axis,); out global
                            [n*c, ...] pspec (axis,).
``enqueue_all_to_all``      buf/out global [n*(n*b), ...] pspec
                            (axis,): local block j goes to rank j.

The builders (:func:`build_all_gather_matmul`,
:func:`build_matmul_reduce_scatter`, :func:`build_all_to_all`,
:func:`build_tp_block`) return a :class:`CollectiveMatmul`: the program,
its decomposed oracle ``reference`` and the plain torch composition
``reference_stock``, both on the reference's global arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from . import overlap
from .descriptors import OffsetPeer
from .queue import QueueError, STProgram, STQueue
from .state import local_shape, storage_shape, to_global, to_storage


def _shares(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


class CollectiveQueue(STQueue):
    """STQueue + ring-collective enqueue verbs.

    Every verb appends ordinary kernel / send / recv / start / wait
    descriptors, one trigger→wait gate per ring step; nothing engine- or
    verifier-visible is new.
    """

    def _axis_n(self, axis: str) -> int:
        shape = dict(self.mesh.shape)
        if axis not in shape:
            raise QueueError(f"mesh has no axis {axis!r}")
        return shape[axis]

    def _ring_pair(self, buf: str, axis: str, delta: int, tag: int) -> None:
        """One in-place ring rotation channel: ``buf = ppermute(buf,
        delta)`` once the surrounding start fires."""
        self.enqueue_send(buf, OffsetPeer(axis, delta, periodic=True), tag)
        self.enqueue_recv(buf, OffsetPeer(axis, -delta, periodic=True), tag,
                          mode="replace")

    def _stage(self, base: str, shape: Sequence[int], dtype, pspec) -> str:
        """Declare an internal staging buffer with a non-colliding name."""
        name, i = base, 0
        while name in self._buffers:
            i += 1
            name = f"{base}_{i}"
        return self.buffer(name, shape, dtype, pspec)

    def _ranks(self) -> torch.Tensor:
        return torch.arange(self.mesh.size, device=self.mesh.device)

    def _index(self, axis: str) -> torch.Tensor:
        return overlap.axis_index(self.mesh, axis)

    def enqueue_blocks(self, fn: Callable, *, reads: Sequence[str],
                       writes: Sequence[str], name: str) -> None:
        """``enqueue_compute`` of ``fn`` on stacked rank blocks: each read
        as ``(R, *local)``, each result stored as its buffer's layout.  A
        result that is its own buffer's read, updated in place, stays that
        tensor; a result aliasing another buffer is copied."""
        mesh, specs = self.mesh, self._buffers
        views = [(mesh.size, *local_shape(specs[r], mesh)) for r in reads]
        stored = [storage_shape(specs[w], mesh) for w in writes]
        reads, writes = tuple(reads), tuple(writes)

        def k(*vals):
            outs = fn(*[v.reshape(s) for v, s in zip(vals, views)])
            if not isinstance(outs, (tuple, list)):
                outs = (outs,)
            done = []
            for w, o, shape in zip(writes, outs, stored):
                o = o.reshape(shape)
                for r, v in zip(reads, vals):
                    if _shares(o, v):
                        o = v if r == w and v.shape == o.shape else o.clone()
                        break
                done.append(o)
            return tuple(done)

        self.enqueue_compute(k, reads=reads, writes=writes, name=name)

    # -- the collective verbs ------------------------------------------------

    def enqueue_all_gather(self, buf: str, out: str, axis: str, *,
                           compute: Optional[Callable] = None,
                           reads: Sequence[str] = (),
                           bidirectional: bool = False,
                           tag_base: int = 0) -> None:
        """Ring all-gather of ``buf`` (sharded over ``axis``, dim 0) into
        ``out``, one trigger→wait gate per ring step.

        With ``compute`` each arriving chunk is transformed before its
        deposit — ``compute(chunk, *extra)`` on stacked blocks, ``extra``
        the blocks of ``reads`` — the ``all_gather_matmul`` pattern.
        ``bidirectional=True`` runs two counter-rotating rings
        (ceil((n-1)/2) gates instead of n-1).
        """
        n = self._axis_n(axis)
        spec = self._buffers[buf]
        if n > 1 and (not spec.pspec or spec.pspec[0] != axis):
            raise QueueError(
                f"all_gather buffer {buf!r} must shard dim 0 over {axis!r}, "
                f"got pspec {spec.pspec}")
        out_spec = self._buffers[out]
        # per-chunk deposit rows: the LOCAL out rows split n ways (out may
        # be replicated, or axis-sharded as when compute leaves a per-rank
        # column block)
        sharded_out = bool(out_spec.pspec) and out_spec.pspec[0] == axis
        local_rows = out_spec.shape[0] // n if sharded_out else out_spec.shape[0]
        if local_rows % n:
            raise QueueError(
                f"all_gather out {out!r}: local dim 0 ({local_rows}) must "
                f"divide by axis size {n}")
        m_out = local_rows // n
        extra = tuple(reads)
        ranks, idx = self._ranks(), self._index(axis)

        def deposit(step: int, delta: int, src_buf: str) -> None:
            src = (idx - delta * step) % n

            def k(cur, o, *xs):
                piece = compute(cur, *xs) if compute is not None else cur
                o.view(o.shape[0], n, m_out, *o.shape[2:])[ranks, src] = piece.to(o.dtype)
                return o
            self.enqueue_blocks(k, reads=(src_buf, out) + extra, writes=(out,),
                                name=f"ag_chunk{step:+d}" if delta > 0
                                else f"ag_chunk{-step:+d}")

        deposit(0, 1, buf)  # own chunk: no communication needed
        if n == 1:
            return
        if not bidirectional:
            for step in range(1, n):
                self._ring_pair(buf, axis, +1, tag_base + step)
                self.enqueue_start()
                self.enqueue_wait()
                deposit(step, +1, buf)
            return
        # two counter-rotating rings sharing each start gate
        bwd = self._stage(f"{buf}@bwd", spec.shape, spec.dtype, spec.pspec)
        self.enqueue_blocks(lambda v: v, reads=(buf,), writes=(bwd,),
                            name="ag_seed_bwd")
        steps_fwd = (n - 1 + 1) // 2
        steps_bwd = (n - 1) // 2
        for step in range(1, steps_fwd + 1):
            self._ring_pair(buf, axis, +1, tag_base + 2 * step)
            if step <= steps_bwd:
                self._ring_pair(bwd, axis, -1, tag_base + 2 * step + 1)
            self.enqueue_start()
            self.enqueue_wait()
            deposit(step, +1, buf)
            if step <= steps_bwd:
                deposit(step, -1, bwd)

    def enqueue_reduce_scatter(self, buf: str, out: str, axis: str, *,
                               tag_base: int = 0) -> None:
        """Ring reduce-scatter: ``buf`` holds per-rank full partial sums
        (local rows = n * chunk); ``out`` (local rows = chunk) receives
        the summed chunk owned by this rank.  The accumulator seeds with
        the own piece (idx-1), then n-1 gates each rotate it one hop (+1)
        and add the next local piece (``overlap.reduce_scatter_ring``)."""
        n = self._axis_n(axis)
        spec = self._buffers[buf]
        out_spec = self._buffers[out]
        if n > 1 and (not spec.pspec or spec.pspec[0] != axis):
            raise QueueError(
                f"reduce_scatter buffer {buf!r} must shard dim 0 over "
                f"{axis!r}, got pspec {spec.pspec}")
        m_local = spec.shape[0] // n  # local partial rows
        if m_local % n:
            raise QueueError(
                f"reduce_scatter {buf!r}: local rows ({m_local}) must "
                f"divide by axis size {n}")
        chunk = m_local // n
        if n > 1 and out_spec.shape[0] // n != chunk:
            raise QueueError(
                f"reduce_scatter out {out!r}: expected local rows {chunk}, "
                f"got {out_spec.shape[0] // n}")
        ranks, idx = self._ranks(), self._index(axis)

        def piece(y, i):
            return y.reshape(y.shape[0], n, chunk, *y.shape[2:])[ranks, i]

        seed_at = (idx - 1) % n
        self.enqueue_blocks(lambda y: piece(y, seed_at), reads=(buf,),
                            writes=(out,), name="rs_seed")
        for step in range(1, n):
            self._ring_pair(out, axis, +1, tag_base + step)
            self.enqueue_start()
            self.enqueue_wait()
            at = (idx - 1 - step) % n
            self.enqueue_blocks(lambda a, y, _at=at: a + piece(y, _at),
                                reads=(out, buf), writes=(out,),
                                name=f"rs_acc{step}")

    def enqueue_all_to_all(self, buf: str, out: str, axis: str, *,
                           tag_base: int = 0) -> None:
        """All-to-all: local block j of ``buf`` goes to rank j (tiled,
        ``split_axis=0``), as ONE start gate carrying n-1 staged channels
        — ``overlap.all_to_all_ppermute``'s n-1 permute rounds, batched."""
        n = self._axis_n(axis)
        spec = self._buffers[buf]
        if n > 1 and (not spec.pspec or spec.pspec[0] != axis):
            raise QueueError(
                f"all_to_all buffer {buf!r} must shard dim 0 over {axis!r}, "
                f"got pspec {spec.pspec}")
        rows_local = spec.shape[0] // n
        if rows_local % n:
            raise QueueError(
                f"all_to_all {buf!r}: local rows ({rows_local}) must divide "
                f"by axis size {n}")
        blk = rows_local // n
        ranks, idx = self._ranks(), self._index(axis)

        def blocks(x):
            return x.view(x.shape[0], n, blk, *x.shape[2:])

        def own(x, o):
            blocks(o)[ranks, idx] = blocks(x)[ranks, idx]
            return o

        self.enqueue_blocks(own, reads=(buf, out), writes=(out,), name="a2a_own")
        if n == 1:
            return
        stages = []
        for delta in range(1, n):
            st = self._stage(f"{buf}@a2a{delta}",
                             (n * blk,) + tuple(spec.shape[1:]),
                             spec.dtype, spec.pspec)
            stages.append(st)
            to = (idx + delta) % n
            self.enqueue_blocks(lambda x, _to=to: blocks(x)[ranks, _to],
                                reads=(buf,), writes=(st,), name=f"a2a_pack{delta}")
        for delta, st in enumerate(stages, start=1):
            self._ring_pair(st, axis, delta, tag_base + delta)
        self.enqueue_start()
        self.enqueue_wait()
        for delta, st in enumerate(stages, start=1):
            frm = (idx - delta) % n

            def drop(s, o, _frm=frm):
                blocks(o)[ranks, _frm] = s
                return o
            self.enqueue_blocks(drop, reads=(st, out), writes=(out,),
                                name=f"a2a_drop{delta}")


# --------------------------------------------------------------------------
# built-program builders (collective-matmul family + TP block)
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CollectiveMatmul:
    """A built collective-matmul ST program + its oracles.

    ``program`` is engine-ready; ``inputs`` names the buffers the caller
    seeds; ``output`` names the result buffer.  Both oracles take and
    return the reference's global arrays (tensors, or anything numpy
    reads, on the mesh device):

    ``reference`` is the BIT-IDENTITY oracle: the :mod:`.overlap`
    decomposition on stacked rank blocks, whose op sequence the program
    reproduces — results must be equal.  ``reference_stock`` is the
    plain torch composition on the global arrays (what one device
    computes without collectives); equal for the pure-copy all-to-all,
    close where a ring or a GEMM sums in another order.
    """

    program: STProgram
    inputs: Tuple[str, ...]
    output: str
    reference: Callable[..., Any]
    reference_stock: Optional[Callable[..., Any]] = None


def _tensor(x, spec, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=spec.dtype)
    return torch.as_tensor(np.asarray(x), device=device).to(spec.dtype)


def _oracle(prog: STProgram, inputs: Tuple[str, ...], output: str, fn: Callable):
    """``fn`` on the stacked blocks of ``inputs`` as a function of the
    global arrays, its stacked result returned as ``output``'s global
    layout."""
    mesh, specs = prog.mesh, prog.buffers

    def run(*args):
        blocks = [to_storage(specs[b], mesh, _tensor(a, specs[b], mesh.device))
                  for b, a in zip(inputs, args)]
        blocks = [b.reshape(mesh.size, *local_shape(specs[n], mesh))
                  for b, n in zip(blocks, inputs)]
        out = fn(*blocks)
        return to_global(specs[output], mesh, out.reshape(storage_shape(specs[output], mesh)))
    return run


def _stock(prog: STProgram, inputs: Tuple[str, ...], fn: Callable):
    specs, device = prog.buffers, prog.mesh.device
    return lambda *args: fn(*[_tensor(a, specs[b], device) for b, a in zip(inputs, args)])


def build_all_gather_matmul(mesh, axis: str, m: int, k: int, n_out: int,
                            dtype=np.float32, *, bidirectional: bool = False,
                            compute: Optional[Callable] = None,
                            verify: str = "warn",
                            name: str = "st_ag_matmul") -> CollectiveMatmul:
    """``all_gather(x) @ w`` as an ST program (x row-sharded, w and out
    replicated).  ``m`` is the GLOBAL gathered row count; ``compute``
    overrides the per-chunk op (default ``chunk @ w``, on stacked
    blocks) and must be row-wise for the oracle to stay bitwise."""
    n = dict(mesh.shape)[axis]
    if m % n:
        raise QueueError(f"m ({m}) must divide by axis size {n}")
    q = CollectiveQueue(mesh, name)
    q.buffer("x", (m, k), dtype, pspec=(axis,))
    q.buffer("w", (k, n_out), dtype, pspec=())
    q.buffer("out", (m, n_out), dtype, pspec=())
    q.enqueue_all_gather(
        "x", "out", axis,
        compute=compute or (lambda chunk, w: chunk @ w),
        reads=("w",), bidirectional=bidirectional)
    prog = q.build(verify=verify)

    def ref_body(x, w):
        if compute is None:
            return overlap.all_gather_matmul(x, w, mesh, axis)
        return compute(overlap.all_gather_ring(x, mesh, axis, bidirectional=False), w)

    reference = _oracle(prog, ("x", "w"), "out", ref_body)
    stock = reference if compute is not None else _stock(prog, ("x", "w"), lambda x, w: x @ w)
    return CollectiveMatmul(prog, ("x", "w"), "out", reference, stock)


def build_matmul_reduce_scatter(mesh, axis: str, m: int, k: int, n_out: int,
                                dtype=np.float32, *, verify: str = "warn",
                                name: str = "st_matmul_rs") -> CollectiveMatmul:
    """``reduce_scatter(x @ w)`` as an ST program (x column-sharded over
    k, w row-sharded over k, out row-sharded).  The partial matmul is one
    kernel; the accumulate kernels ride the ring gates."""
    n = dict(mesh.shape)[axis]
    if m % n:
        raise QueueError(f"m ({m}) must divide by axis size {n}")
    q = CollectiveQueue(mesh, name)
    q.buffer("x", (m, k), dtype, pspec=(None, axis))
    q.buffer("w", (k, n_out), dtype, pspec=(axis,))
    # per-rank full partials: local rows = m, so global rows = n*m
    q.buffer("y", (n * m, n_out), dtype, pspec=(axis,))
    q.buffer("out", (m, n_out), dtype, pspec=(axis,))
    q.enqueue_blocks(lambda x, w: x @ w, reads=("x", "w"), writes=("y",),
                     name="partial_matmul")
    q.enqueue_reduce_scatter("y", "out", axis)
    prog = q.build(verify=verify)
    reference = _oracle(prog, ("x", "w"), "out",
                        lambda x, w: overlap.matmul_reduce_scatter(x, w, mesh, axis))
    return CollectiveMatmul(prog, ("x", "w"), "out", reference,
                            _stock(prog, ("x", "w"), lambda x, w: x @ w))


def build_all_to_all(mesh, axis: str, rows: int, cols: int,
                     dtype=np.float32, *, verify: str = "warn",
                     name: str = "st_a2a") -> CollectiveMatmul:
    """Tiled all-to-all (MoE dispatch building block) as an ST program.
    ``rows`` is the GLOBAL row count (local rows = rows/n, split into n
    blocks of rows/n², the ``lax.all_to_all(tiled=True)`` layout)."""
    n = dict(mesh.shape)[axis]
    if rows % (n * n):
        raise QueueError(f"rows ({rows}) must divide by axis size² {n * n}")
    q = CollectiveQueue(mesh, name)
    q.buffer("x", (rows, cols), dtype, pspec=(axis,))
    q.buffer("out", (rows, cols), dtype, pspec=(axis,))
    q.enqueue_all_to_all("x", "out", axis)
    prog = q.build(verify=verify)
    blk = rows // (n * n)
    reference = _oracle(prog, ("x",), "out",
                        lambda x: overlap.all_to_all_ppermute(x, mesh, axis))
    # rank j's block i of the result is rank i's block j of x
    stock = lambda x: x.reshape(n, n, blk, cols).transpose(0, 1).reshape(rows, cols)
    return CollectiveMatmul(prog, ("x",), "out", reference, _stock(prog, ("x",), stock))


def build_tp_block(mesh, axis: str, m: int, k: int, f: int,
                   dtype=np.float32, *, bidirectional: bool = False,
                   chain: bool = False, verify: str = "warn",
                   name: str = "st_tp_block") -> CollectiveMatmul:
    """The "transformer block as ST schedule": a Megatron MLP with
    sequence parallelism as one ST program.

    ``x`` row-sharded [m, k] → all-gather-matmul with column-sharded
    ``w1`` [k, f] → relu → matmul-reduce-scatter with row-sharded ``w2``
    [f, k] → ``out`` row-sharded [m, k].  The relu rides inside the
    all-gather's per-chunk compute, and every ring step of both
    collectives is a trigger→wait channel.

    ``chain=True`` appends a feedback kernel (``x = out``, both
    row-sharded [m, k]) so ``program.persistent(N)`` computes the N-deep
    chain ``x_{i+1} = block(x_i)`` in ONE dispatch.
    """
    n = dict(mesh.shape)[axis]
    if m % n or f % n:
        raise QueueError(f"m ({m}) and f ({f}) must divide by axis size {n}")
    q = CollectiveQueue(mesh, name)
    q.buffer("x", (m, k), dtype, pspec=(axis,))
    q.buffer("w1", (k, f), dtype, pspec=(None, axis))
    q.buffer("w2", (f, k), dtype, pspec=(axis,))
    # h: full m rows of this rank's f/n hidden columns
    q.buffer("h", (n * m, f // n), dtype, pspec=(axis,))
    # y: per-rank full partials of the down-projection (rows = m each)
    q.buffer("y", (n * m, k), dtype, pspec=(axis,))
    q.buffer("out", (m, k), dtype, pspec=(axis,))
    q.enqueue_all_gather(
        "x", "h", axis,
        compute=lambda chunk, w1: torch.relu(chunk @ w1),
        reads=("w1",), bidirectional=bidirectional)
    q.enqueue_blocks(lambda h, w2: h @ w2, reads=("h", "w2"), writes=("y",),
                     name="down_proj")
    q.enqueue_reduce_scatter("y", "out", axis, tag_base=100)
    if chain:
        # persistent passes re-run the whole walk, but x has been rotated
        # n-1 hops in place by the gather ring: feeding out back in both
        # restores a defined x AND makes the program the N-layer chain
        q.enqueue_blocks(lambda o: o, reads=("out",), writes=("x",),
                         name="feedback")
    prog = q.build(verify=verify)

    def ref_decomposed(x, w1, w2):
        # relu commutes with the chunk deposits, and the ring
        # reduce-scatter repeats the ST accumulate order
        h = torch.relu(overlap.all_gather_matmul(x, w1, mesh, axis))
        return overlap.reduce_scatter_ring(h @ w2, mesh, axis)

    inputs = ("x", "w1", "w2")
    return CollectiveMatmul(
        prog, inputs, "out", _oracle(prog, inputs, "out", ref_decomposed),
        _stock(prog, inputs, lambda x, w1, w2: torch.relu(x @ w1) @ w2))
