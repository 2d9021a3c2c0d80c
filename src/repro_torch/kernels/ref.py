"""Plain PyTorch versions of the hand-written kernels.

Port of ``repro.kernels.ref``.  Each function here is the semantic
ground truth of one hand-written CUDA kernel: the wrappers of
:mod:`.halo_pack`, :mod:`.rmsnorm`, :mod:`.flash_attention` and
:mod:`.ssd_scan` and :mod:`.embedding` call it for CPU tensors, and
``chip_smoke.py`` holds each kernel against it on the card (the halo
and boundary kernels and the embedding's backward bit for bit, the
others within a stated bound).  For the halo and boundary
kernels, tensors carry every rank: leading dimensions are rank axes,
the last three the local ``(px, py, pz)`` block.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def region3(region: Sequence[slice]) -> Tuple[slice, slice, slice]:
    """Validate a static 3-D region: three unit-step slices with
    explicit bounds (``core.halo._region_for`` gives such regions)."""
    region = tuple(region)
    if len(region) != 3 or not all(
            isinstance(s, slice) and isinstance(s.start, int)
            and isinstance(s.stop, int) and s.step in (None, 1)
            and 0 <= s.start <= s.stop for s in region):
        raise ValueError(f"halo region must be three unit-step slices with "
                         f"explicit bounds, got {region!r}")
    return region


def region_shape(region: Sequence[slice]) -> Tuple[int, ...]:
    return tuple(s.stop - s.start for s in region)


def halo_pack(u: torch.Tensor, region: Sequence[slice]) -> torch.Tensor:
    """Copy one static boundary region of every rank's block into a new
    contiguous slab ``(*ranks, *region)``."""
    return u[(..., *region3(region))].clone(memory_format=torch.contiguous_format)


def halo_unpack_add(u: torch.Tensor, msg: torch.Tensor,
                    region: Sequence[slice]) -> torch.Tensor:
    """Add ``msg`` into every rank's ``region`` of ``u``, in place, cast
    to ``u``'s dtype (one float add, rounded once); returns ``u``."""
    u[(..., *region3(region))] += msg.to(u.dtype)
    return u


def region_size(region: Sequence[slice]) -> int:
    n = 1
    for s in region:
        n *= s.stop - s.start
    return n


def pack_boundary(u: torch.Tensor, regions: Sequence[Sequence[slice]]) -> torch.Tensor:
    """Copy the static regions of every rank's block into ONE contiguous
    buffer ``(*ranks, total)``, region after region (the paper's step 2;
    ``regions`` in DIRECTIONS order gives faces, edges, corners)."""
    lead = tuple(u.shape[:-3])
    return torch.cat([u[(..., *region3(r))].reshape(*lead, -1) for r in regions],
                     dim=-1)


def unpack_boundary_add(u: torch.Tensor, buf: torch.Tensor,
                        regions: Sequence[Sequence[slice]]) -> torch.Tensor:
    """Add the segments of ``buf (*ranks, total)`` into their regions of
    ``u``, in place and in region order (the paper's step 6); regions
    overlap (a face holds its edges and corners), and every add is
    rounded to ``u``'s dtype before the next.  Returns ``u``."""
    off = 0
    for r in regions:
        r = region3(r)
        n = region_size(r)
        seg = buf[..., off:off + n].reshape(*u.shape[:-3], *region_shape(r))
        u[(..., *r)] += seg.to(u.dtype)
        off += n
    return u


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            weight_offset: float = 0.0) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · (w + weight_offset)`` over the last
    dimension, statistics in float32, returned in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (w.float() + weight_offset)).to(x.dtype)


def rmsnorm_vjp(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *,
                eps: float = 1e-6, weight_offset: float = 0.0):
    """``(dx, dw)`` of :func:`rmsnorm` at ``(x, w)`` for the cotangent
    ``dy``: ``torch.autograd.grad`` of the plain version, the oracle of the
    hand-written backward kernel (the reference has none: XLA
    differentiates ``src/repro/models/nn.py:78``)."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_()
        wg = w.detach().requires_grad_()
        y = rmsnorm(xg, wg, eps=eps, weight_offset=weight_offset)
        dx, dw = torch.autograd.grad(y, (xg, wg), dy.to(y.dtype))
    return dx, dw


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: Optional[float] = None,
              window: Optional[int] = None,
              logit_softcap: Optional[float] = None,
              q_offset: int = 0) -> torch.Tensor:
    """GQA attention in float32 (``repro.kernels.ref.attention``): q
    ``[B,Hq,Sq,D]``, k and v ``[B,Hkv,Skv,D]``, query ``i`` at global
    position ``q_offset + i``; causal and a sliding ``window`` (tokens
    of lookback) mask keys; a fully masked row gives zeros.  Returns
    q's dtype."""
    Hq, Sq, D = q.shape[1], q.shape[2], q.shape[3]
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not split into {Hkv} kv heads")
    group = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    kr = k.repeat_interleave(group, dim=1).float()
    vr = v.repeat_interleave(group, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * scale
    if logit_softcap is not None:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    # fully masked rows (possible with windows) give zeros, not NaNs
    probs = torch.where(mask.any(-1)[:, None], probs, 0.0)
    return torch.einsum("bhqk,bhkd->bhqd", probs, vr).to(q.dtype)


def attention_vjp(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor, *,
                  causal: bool = True, scale: Optional[float] = None,
                  window: Optional[int] = None, logit_softcap: Optional[float] = None,
                  q_offset: int = 0):
    """``(dq, dk, dv)`` of :func:`attention` at ``(q, k, v)`` for the
    output's cotangent ``dout``: ``torch.autograd.grad`` of the plain
    version, in the inputs' dtypes, the oracle of the hand-written
    backward kernels (the reference has none: XLA differentiates
    ``_sdpa``, ``src/repro/models/nn.py:258``).  A row that sees no key
    gives zero gradients."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (q, k, v)]
        out = attention(*ins, causal=causal, scale=scale, window=window,
                        logit_softcap=logit_softcap, q_offset=q_offset)
        grads = torch.autograd.grad(out, ins, dout.to(out.dtype))
    return tuple(grads)


def embedding_bwd(dy: torch.Tensor, ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """The table's gradient of a row lookup ``table[ids]``: ``[vocab, D]``
    in dy's dtype, ``out[v] = Σ dy[t]`` over the positions ``t`` with
    ``ids[t] == v``, rows no id selects zero.  Each id's rows are added in
    ascending position, from zero, and every add is rounded to dy's
    dtype (a float32 add for bf16), as the reference's VJP of
    ``jnp.take`` (a scatter-add whose combiner adds in the table's
    compute dtype, ``src/repro/models/nn.py:94-98``) adds them on the
    CPU.  Vectorised over ids: sweep k adds the k-th occurrence of every
    id, so an address receives one add a sweep.  On the meta device it
    gives the shape only."""
    D = dy.shape[-1]
    dy, ids = dy.reshape(-1, D), ids.reshape(-1)
    if ids.numel() != dy.shape[0]:
        raise ValueError(f"embedding_bwd: {ids.numel()} ids for {dy.shape[0]} rows of dy")
    out = torch.zeros((vocab, D), dtype=dy.dtype, device=dy.device)
    if dy.device.type == "meta" or ids.numel() == 0:
        return out
    acc = torch.float64 if dy.dtype == torch.float64 else torch.float32
    sorted_ids, order = torch.sort(ids.long(), stable=True)
    pos = torch.arange(ids.numel(), device=ids.device)
    first = torch.ones_like(sorted_ids, dtype=torch.bool)
    first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    for k in range(int(rank.max()) + 1):
        sel = rank == k
        v, t = sorted_ids[sel], order[sel]
        out[v] = (out[v].to(acc) + dy[t].to(acc)).to(dy.dtype)
    return out


def pack_segments(sources: Sequence[Tuple[torch.Tensor, int]],
                  sizes: Sequence[int]) -> torch.Tensor:
    """Pack N member slabs into one ``(R, sum(sizes))`` staging buffer.

    Member ``j`` is columns ``[col, col + sizes[j])`` of the 2-D
    ``(R, W)`` tensor ``sources[j] = (tensor, col)``: a whole slab
    flattened per rank (``col = 0``), or a segment of an earlier hop's
    received buffer.  Members land at consecutive column offsets.
    """
    first = sources[0][0]
    out = torch.empty((first.shape[0], sum(sizes)), dtype=first.dtype,
                      device=first.device)
    off = 0
    for (src, col), n in zip(sources, sizes):
        out[:, off:off + n].copy_(src[:, col:col + n])
        off += n
    return out


def unpack_segments(buf: torch.Tensor, outs: Sequence[torch.Tensor],
                    offsets: Sequence[int],
                    masks: Optional[torch.Tensor] = None) -> None:
    """Split a received ``(R, S)`` staging buffer into N slabs, in place.

    ``outs[j]`` (``R * n_j`` elements) takes columns ``[offsets[j],
    offsets[j] + n_j)`` of every rank whose ``masks[j, rank]`` is set
    (all ranks when ``masks`` is None); other ranks keep their values,
    as a replace deposit keeps a rank that has no sender.
    """
    n_ranks = buf.shape[0]
    for j, (out, off) in enumerate(zip(outs, offsets)):
        view = out.view(n_ranks, -1)
        piece = buf[:, off:off + view.shape[1]]
        if masks is not None:
            piece = torch.where(masks[j].view(n_ranks, 1), piece, view)
        view.copy_(piece)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, C: torch.Tensor, *,
             init_state: Optional[torch.Tensor] = None,
             return_state: bool = False):
    """Sequential Mamba2 SSD scan in float32 (``repro.kernels.ref.ssd_scan``).

    ``h_t = exp(A dt_t) h_{t-1} + dt_t (x_t ⊗ B_t)``, ``y_t = h_t · C_t``
    per head; x ``[B,S,H,P]``, dt ``[B,S,H]``, A ``[H]``, Bm and C
    ``[B,S,G,N]``, and head ``h`` reads group ``h // (H/G)``.  The
    increment ``x ⊗ B`` is formed in the inputs' dtype before it meets
    ``dt``, as the reference does.  One step at a time, so no
    ``[B,S,H,P,N]`` tensor is held.  Returns y in x's dtype (and the
    final float32 state ``[B,H,P,N]`` when ``return_state``).
    """
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if H % G:
        raise ValueError(f"{H} heads do not split into {G} groups")
    rep = H // G
    Bh = Bm.repeat_interleave(rep, dim=2)
    Ch = C.repeat_interleave(rep, dim=2).float()
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    decay = torch.exp(A[None, None, :] * dt)
    ys = []
    for t in range(S):
        inc = dt[:, t, :, None, None] * (x[:, t, :, :, None] * Bh[:, t, :, None, :])
        h = decay[:, t, :, None, None] * h + inc.float()
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    y = torch.stack(ys, dim=1).to(x.dtype)
    return (y, h) if return_state else y


def ssd_scan_shapes(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, C: torch.Tensor, *,
                    init_state: Optional[torch.Tensor] = None,
                    return_state: bool = False):
    """The dry run's stand-in of :func:`ssd_scan` on ``meta`` tensors,
    which hold no values: the same outputs (shapes, dtypes) from the same
    inputs, and the same contractions (``h_t · C_t``: ``2·B·S·H·P·N``
    FLOPs, and their VJPs under autograd), with the sequence folded into
    the batch, so that a full-length trace takes a few ops a layer, not a
    few a token.  The recurrence is a cumulative sum here, since meta
    tensors carry no values to get wrong; any other device is refused."""
    if any(t.device.type != "meta" for t in (x, dt, A, Bm, C)):
        raise ValueError("ssd_scan_shapes takes meta tensors only: ssd_scan computes values")
    H, G = x.shape[2], Bm.shape[2]
    if H % G:
        raise ValueError(f"{H} heads do not split into {G} groups")
    Bh = Bm.repeat_interleave(H // G, dim=2)
    Ch = C.repeat_interleave(H // G, dim=2).float()
    inc = dt[..., None, None] * (x[..., None] * Bh[:, :, :, None, :])
    h = torch.exp(A[None, None, :] * dt)[..., None, None] * torch.cumsum(inc.float(), dim=1)
    if init_state is not None:
        h = h + init_state.float()[:, None]
    y = torch.einsum("bshpn,bshn->bshp", h, Ch).to(x.dtype)
    return (y, h[:, -1]) if return_state else y


def ssd_scan_vjp(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                 C: torch.Tensor, init_state: Optional[torch.Tensor],
                 dy: Optional[torch.Tensor], dh: Optional[torch.Tensor]):
    """``(dx, ddt, dA, dBm, dC, dinit_state)`` of :func:`ssd_scan`'s
    ``(y, final state)`` for the cotangents ``dy`` and ``dh`` (None: zero):
    ``torch.autograd.grad`` of the sequential scan, as the reference's
    ``custom_vjp`` differentiates ``kref.ssd_scan``
    (``src/repro/models/ssm.py:46-49``).  ``dinit_state`` is None without
    an ``init_state``.  The oracle of the hand-written backward kernel."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, dt, A, Bm, C)]
        if init_state is not None:
            ins.append(init_state.detach().requires_grad_())
        y, h = ssd_scan(*ins[:5], init_state=ins[5] if init_state is not None else None,
                        return_state=True)
        outs, cots = [], []
        for out, cot in ((y, dy), (h, dh)):
            if cot is not None:
                outs.append(out)
                cots.append(cot.to(out.dtype))
        if not outs:
            grads = [torch.zeros_like(t) for t in ins]
        else:
            grads = list(torch.autograd.grad(outs, ins, cots, allow_unused=True))
            grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, ins)]
    if init_state is None:
        grads.append(None)
    return tuple(grads)
