"""Decomposed, overlap-friendly collectives: the decomposed oracles.

Port of ``repro.core.overlap``.  The reference writes each collective as
ppermute steps inside ``shard_map`` so that XLA can overlap a ring step's
transfer with the previous chunk's compute (the "collective matmul"
family).  One GPU holds every rank here, so each function takes the
*rank-stacked* tensor — ``(R, *local)``, rank ``r``'s block at
``x[r]`` (:mod:`.state`) — and the mesh axis, and returns the stacked
result.  A ``ppermute`` is a rank permutation of the leading dim
(zero-filled where no rank sends), and ``axis_index`` is a per-rank
index tensor.

Each function keeps the reference's op order — rotation direction,
deposit offsets, accumulate order — and the ST builders of
:mod:`.collectives` issue the same torch calls on the same shapes (a
batched matmul per chunk, one add per ring step), so an ST program
equals its decomposed oracle here bit for bit.

Provided:
* ``all_gather_ring``        — N-1 ppermute steps, uni/bidirectional;
* ``reduce_scatter_ring``    — ring reduce-scatter;
* ``all_gather_matmul``      — gather(x) @ w, a chunk matmul a ring step;
* ``matmul_reduce_scatter``  — reduce_scatter(x @ w) on the ring;
* ``all_to_all_ppermute``    — all-to-all as explicit ppermute rounds.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def axis_size(mesh, axis: str) -> int:
    shape = dict(mesh.shape)
    if axis not in shape:
        raise ValueError(f"mesh has no axis {axis!r}")
    return shape[axis]


def axis_index(mesh, axis: str, device=None) -> torch.Tensor:
    """Every rank's coordinate along ``axis`` (``jax.lax.axis_index``), an
    int64 tensor of shape ``(R,)`` on ``device`` (default: the mesh's)."""
    coord = np.unravel_index(np.arange(mesh.size), mesh.axis_sizes)[
        mesh.axis_names.index(axis)]
    return torch.as_tensor(coord, dtype=torch.int64,
                           device=mesh.device if device is None else device)


def _shift_perm(n: int, delta: int):
    return [(i, (i + delta) % n) for i in range(n)]


def ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """``jax.lax.ppermute`` of stacked blocks along ``axis``: rank ``dst``
    takes rank ``src``'s block for each ``(src, dst)``; zeros elsewhere."""
    src = mesh.rank_sources((axis,), perm)
    out = x.index_select(0, torch.as_tensor(src.clip(min=0), device=x.device))
    dead = (src < 0).nonzero()[0]
    if dead.size:
        out.index_fill_(0, torch.as_tensor(dead, device=x.device), 0)
    return out


def _ranks(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], device=x.device)


# --------------------------------------------------------------------------
# ring collectives
# --------------------------------------------------------------------------


def all_gather_ring(x: torch.Tensor, mesh, axis: str, *, bidirectional: bool = True,
                    tile_axis: int = 0) -> torch.Tensor:
    """All-gather the blocks ``x`` along ``axis`` by ring ppermutes (tiled
    layout).  Bidirectional halves the serial steps (ceil((n-1)/2)) by
    sending both ways."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    idx = axis_index(mesh, axis, x.device)
    chunks = [None] * n
    chunks[0] = x
    if not bidirectional:
        cur = x
        for step in range(1, n):
            cur = ppermute(cur, mesh, axis, _shift_perm(n, 1))
            chunks[step] = cur
    else:
        fwd = bwd = x
        for s in range(1, (n - 1 + 1) // 2 + 1):
            fwd = ppermute(fwd, mesh, axis, _shift_perm(n, 1))
            chunks[s] = fwd
        for s in range(1, (n - 1) // 2 + 1):
            bwd = ppermute(bwd, mesh, axis, _shift_perm(n, -1))
            chunks[n - s] = bwd
    # chunk i holds the data of rank (idx - i): roll into global order
    stacked = torch.stack(chunks, dim=1)  # [R, n, ...]
    order = (idx[:, None] - torch.arange(n, device=x.device)[None]) % n
    gathered = torch.zeros_like(stacked)
    gathered[_ranks(x)[:, None], order] = stacked
    return torch.cat(gathered.unbind(1), dim=1 + tile_axis)


def _pieces(x: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """Stacked blocks ``(R, ..., n*c, ...)`` as ``(R, n, ..., c, ...)``: the
    n pieces of local dim ``dim``."""
    size = x.shape[1 + dim]
    if size % n:
        raise ValueError("tile axis must divide by axis size")
    xr = x.reshape(*x.shape[:1 + dim], n, size // n, *x.shape[2 + dim:])
    return xr.movedim(1 + dim, 1)


def reduce_scatter_ring(x: torch.Tensor, mesh, axis: str, *,
                        tile_axis: int = 0) -> torch.Tensor:
    """Ring reduce-scatter of the full-size blocks ``x`` (1/n-size out).

    The classic ring: chunk k starts at rank k+1 and travels n-1 hops,
    accumulating each host's chunk k on arrival; at step s rank r holds
    chunk (r-1-s), starting from (r-1)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    idx = axis_index(mesh, axis, x.device)
    xr, ranks = _pieces(x, n, tile_axis), _ranks(x)
    own = lambda i: xr[ranks, i % n]
    acc = own(idx - 1)
    for step in range(1, n):
        acc = ppermute(acc, mesh, axis, _shift_perm(n, 1))
        acc = acc + own(idx - 1 - step)
    return acc


# --------------------------------------------------------------------------
# overlapped compute-communication (collective matmul)
# --------------------------------------------------------------------------


def all_gather_matmul(x: torch.Tensor, w: torch.Tensor, mesh, axis: str, *,
                      transpose_w: bool = False) -> torch.Tensor:
    """``all_gather(x, axis) @ w``, one chunk matmul a ring step.

    ``x``: ``(R, m_local, k)``, gathered along rows; ``w``: ``(R, k, n)``,
    each rank's (local or replicated) weight.  Returns ``(R, m_local *
    n_axis, n)``: at step s a rank multiplies the chunk of rank (idx - s)
    and deposits it at that rank's row offset, then passes the chunk on.
    """
    n_dev = axis_size(mesh, axis)
    if transpose_w:
        w = w.transpose(-1, -2)
    if n_dev == 1:
        return x @ w
    idx = axis_index(mesh, axis, x.device)
    ranks = _ranks(x)
    m_local = x.shape[1]
    out = torch.zeros((x.shape[0], m_local * n_dev, w.shape[-1]),
                      dtype=torch.result_type(x, w), device=x.device)
    rows = out.view(x.shape[0], n_dev, m_local, w.shape[-1])
    cur = x
    for step in range(n_dev):
        part = cur @ w
        rows[ranks, (idx - step) % n_dev] = part.to(out.dtype)
        if step != n_dev - 1:
            cur = ppermute(cur, mesh, axis, _shift_perm(n_dev, 1))
    return out


def matmul_reduce_scatter(x: torch.Tensor, w: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``reduce_scatter(x @ w, axis)`` on the ring.

    ``x``: ``(R, m, k_local)``; ``w``: ``(R, k_local, n)``.  The product
    needs a sum over the axis (k is sharded); each rank keeps m/n_dev
    rows.  Returns ``(R, m // n_axis, n)``."""
    n_dev = axis_size(mesh, axis)
    y_local = x @ w  # [R, m, n] partial sums
    if n_dev == 1:
        return y_local
    idx = axis_index(mesh, axis, x.device)
    yr, ranks = _pieces(y_local, n_dev, 0), _ranks(x)
    piece = lambda i: yr[ranks, i % n_dev]
    # same ring schedule as reduce_scatter_ring: chunk (r-1-s) at step s
    acc = piece(idx - 1)
    for step in range(1, n_dev):
        acc = ppermute(acc, mesh, axis, _shift_perm(n_dev, 1))
        acc = acc + piece(idx - 1 - step)
    return acc


def all_to_all_ppermute(x: torch.Tensor, mesh, axis: str, *,
                        split_axis: int = 0) -> torch.Tensor:
    """All-to-all as explicit ppermute rounds (MoE dispatch): local dim
    ``split_axis`` is cut into n blocks and block j goes to rank j, as
    ``jax.lax.all_to_all(tiled=True)`` does, in n-1 permutes."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    idx = axis_index(mesh, axis, x.device)
    move, ranks = _pieces(x, n, split_axis), _ranks(x)  # [R, n, ..., blk, ...]
    out = torch.zeros_like(move)
    out[ranks, idx] = move[ranks, idx]  # my own block stays
    for delta in range(1, n):
        # send the block destined for rank (idx + delta)
        send = move[ranks, (idx + delta) % n]
        recv = ppermute(send, mesh, axis, _shift_perm(n, delta))
        out[ranks, (idx - delta) % n] = recv
    return out.movedim(1, 1 + split_axis).reshape(x.shape)


# --------------------------------------------------------------------------
# ST-queue integration helpers
# --------------------------------------------------------------------------


def triggered(fn, token):
    """Wrap a decomposed collective so it runs after an ST trigger:
    ``token`` is a ``torch.cuda.Event`` recorded where the trigger fires
    (the current stream waits on it before the collective), or ``None``
    on a CPU device, where program order is the trigger."""
    @functools.wraps(fn)
    def wrapped(x, *args, **kwargs):
        if token is not None:
            token.wait()
        return fn(x, *args, **kwargs)
    return wrapped
