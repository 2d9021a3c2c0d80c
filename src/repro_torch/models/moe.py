"""Mixture-of-Experts layer with sort-based (dropping) token dispatch —
port of ``repro.models.moe``.

Routing flavours, as in the reference:

* ``softmax`` (grok-1): softmax over the router logits, top-k,
  renormalised;
* ``sigmoid`` (deepseek-v3): sigmoid scores, top-k on score + bias (the
  aux-free balancing bias, a buffer), weights normalised over the
  selected experts and scaled by ``routed_scaling``.

Dispatch: the ``T·k`` assignments sort by expert (a stable sort, so
within an expert by token); each expert takes a fixed capacity ``C =
ceil(T·k/E · capacity_factor)`` and drops the overflow; gather, the
batched expert FFN (``torch.bmm``), then each token's kept contributions
weighted and added.

Every step has a shape fixed by ``(T, E, k, C)`` and none reads data on
the host, so the layer runs inside a CUDA graph and gives the same bits
on every run:

* top-k is a stable descending sort (:func:`_top_k`): ties go to the
  lower expert index, as ``lax.top_k`` orders them, where ``torch.topk``
  leaves the order of equal values unspecified;
* each expert's first and last sorted assignment come from
  ``torch.searchsorted`` on the sorted expert ids (no ``bincount``, whose
  size and sync come from the data), each capacity slot gathers the
  token of its sorted assignment (no scatter), and each assignment's
  rank within its expert is its sorted position less its expert's first;
* the combine has no float atomics (no ``index_add_`` or
  ``scatter_add_``): each token gathers its ``k`` contributions and adds
  them one after another in ascending expert order, the order in which
  the reference's ``segment_sum`` meets them in the sorted assignments.

The dispatch and the combine are ``torch.autograd.Function`` classes
(:class:`_Dispatch`, :class:`_Combine`) whose backwards are gathers
added in a fixed order, so the layer's backward gives the same bits on
every run and in a graph, without ``torch.use_deterministic_algorithms``
(autograd of ``index_select`` would add into shared rows with float
atomics).  So does a whole training step: the embedding's lookup
(``nn.apply_embedding``) has a hand-written backward that adds in token
order (``kernels/embedding.py``).

* the dispatch's backward gives token ``t`` the sum of its kept slots'
  gradients, ``dx[t] = Σ_j dxin[slot[t, j]]``, added in ascending expert
  order: the order in which the reference's scatter-add (the autodiff of
  ``x_pad[dispatch]``) meets a token's slots.  Empty slots give nothing;
* the combine's backward gives each filled slot ``dy[t] · w[a]`` of the
  one assignment ``a`` that fills it (the slot → assignment map
  :func:`dispatch_plan` computes anyway), empty slots zero, and each
  assignment's weight ``keep[a] · <dy[t], yout[slot[a]]>`` with the
  product rounded in ``yout``'s dtype.

The router's ``torch.gather`` of the top-k scores stays under autograd:
its indices are a row's distinct top-k experts, so its backward never
adds two values into one address.

:func:`apply_moe_ep` is the reference's expert-parallel path: under a
sharding context (:func:`repro_torch.parallel.sharding_ctx`, which the
step bundles open) it computes on one card what every (data, model) shard
of the reference's ``shard_map`` computes, with the same per-shard
routing, capacity and drops, and returns None exactly where the
reference's does (``apply_moe`` then takes the gather path).
:func:`build_moe_dispatch_program` gives the expert-parallel dispatch as
a stream-triggered all-to-all program (``core.collectives``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import current_ctx
from .nn import dtype_of, param


def init_moe(gen, cfg: ModelConfig, *, device):
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    dt = dtype_of(cfg.param_dtype)
    kw = dict(device=device)
    out_scale = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    p = {"router": param(gen, (d, e), ("embed", "act_expert"), dt, scale=0.006, **kw),
         "wi": param(gen, (e, d, f), ("expert", "embed", "expert_mlp"), dt, **kw)}
    if cfg.act == "silu":
        p["wg"] = param(gen, (e, d, f), ("expert", "embed", "expert_mlp"), dt, **kw)
    p["wo"] = param(gen, (e, f, d), ("expert", "expert_mlp", "embed"), dt, scale=out_scale,
                    **kw)
    if cfg.router == "sigmoid":
        # aux-free balancing bias: a buffer, not a trained weight
        p["router_bias"] = param(None, (e,), ("act_expert",), torch.float32, init="zeros",
                                 **kw)
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared_wi"] = param(gen, (d, fs), ("embed", "mlp"), dt, **kw)
        p["shared_wg"] = param(gen, (d, fs), ("embed", "mlp"), dt, **kw)
        p["shared_wo"] = param(gen, (fs, d), ("mlp", "embed"), dt, scale=out_scale, **kw)
    return p


def _top_k(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest along the last axis,
    largest first and, among equal values, lower index first (a stable
    descending sort), as ``jax.lax.top_k`` gives them."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p, x2d: torch.Tensor, cfg: ModelConfig):
    """x2d ``[T, D]`` → (topk_idx ``[T,k]``, topk_w ``[T,k]``, router_probs
    ``[T,E]``), all but the indices in float32."""
    logits = x2d.float() @ p["router"].float()
    if cfg.router == "sigmoid":
        scores = torch.sigmoid(logits)
        _, idx = _top_k(scores + p["router_bias"][None, :], cfg.top_k)
        # the top-k indices of a row are distinct: the gather's backward
        # (a scatter-add) gives each address one add, so no float atomics meet
        w = torch.gather(scores, -1, idx)
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
        w = w * cfg.routed_scaling
        probs = scores / (scores.sum(-1, keepdim=True) + 1e-20)
    else:
        probs = torch.softmax(logits, dim=-1)
        w, idx = _top_k(probs, cfg.top_k)
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w, probs


def _expert_ffn(p, xin: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """xin ``[E, C, D]`` → ``[E, C, D]``: each expert's FFN as batched
    matrix products."""
    dt = xin.dtype
    h = torch.bmm(xin, p["wi"].to(dt))
    if "wg" in p:
        h = F.silu(torch.bmm(xin, p["wg"].to(dt))) * h
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return torch.bmm(h, p["wo"].to(dt))


def apply_moe_ep(p, x: torch.Tensor, cfg: ModelConfig) -> Optional[Tuple[torch.Tensor, Dict]]:
    """The reference's expert-parallel MoE (its ``shard_map`` over the
    mesh), every shard computed on this one device.  Under a sharding
    context whose mesh has a ``model`` axis of size ``m``:

    * the batch splits over the mesh's ``pod`` and ``data`` axes into
      ``n_b`` data shards of ``T_loc`` tokens; each routes its own tokens
      and gives each expert a capacity ``C_loc = ceil(T_loc·k/E·cf)``, so
      drops are per data shard;
    * the experts split over ``model``: ``E/m`` real experts a shard, or,
      when ``E < m`` (grok-1: 8 experts on a 16-way axis), ``r = m/E``
      virtual experts a real one, each with ``F/r`` of its FFN columns
      (the elementwise gate keeps the partial outputs exact, and the
      combine adds them);
    * a token's output adds its contributions within a model shard in
      ascending expert order, then the shards' partial sums in ascending
      shard order (the reference's ``psum`` over ``model``);
    * ``lb_loss``, ``router_probs_mean`` and ``dropped_frac`` are the
      per-shard values averaged as the reference's ``pmean`` calls
      average them.

    All data shards go through one dispatch (expert ``e`` of shard ``b``
    is ``b·E + e``, with capacity ``C_loc``), which gives each shard the
    reference's local dispatch: assignments sorted by expert, stably.
    The dispatch and the combine are :class:`_Dispatch` and
    :class:`_Combine`, whose backwards add in a fixed order with no float
    atomics.  Returns None without a context, a ``model`` axis, experts
    that split over it, a batch that splits over the data shards, or an
    FFN that splits into the virtual experts, as the reference's does."""
    ctx = current_ctx()
    if ctx is None:
        return None
    _, mesh = ctx
    sizes = dict(mesh.shape)
    if "model" not in sizes:
        return None
    m, E, k = sizes["model"], cfg.n_experts, cfg.top_k
    if E % m and m % E:
        return None
    B, S, D = x.shape
    n_b = 1
    for a in ("pod", "data"):
        n_b *= sizes.get(a, 1)
    E_loc, n_rep, F = max(E // m, 1), max(m // E, 1), cfg.d_ff_expert
    if B % n_b or F % n_rep:
        return None
    T, T_loc = B * S, (B // n_b) * S
    C = max(1, int(math.ceil(T_loc * k / E * cfg.capacity_factor)))
    x2d = x.reshape(T, D)
    idx, w, probs = _route(p, x2d, cfg)
    shard = torch.div(torch.arange(T, device=x.device), T_loc, rounding_mode="floor")
    xin, (slot, keep, source, by_expert) = _dispatch(x2d, idx + shard[:, None] * E,
                                                     n_b * E, C)
    # each real expert's rows of every data shard, [E, n_b·C, D], and its
    # n_rep virtual experts' copies of them (an expand: its backward sums)
    xe = xin.view(n_b, E, C, D).transpose(0, 1).reshape(E, n_b * C, D)
    if n_rep > 1:
        xe = xe[:, None].expand(E, n_rep, n_b * C, D).reshape(E * n_rep, n_b * C, D)
    yout = _expert_ffn(_virtual_experts(p, n_rep), xe, cfg).reshape(-1, D)
    # virtual expert v = e·n_rep + i holds data shard b's slot c at row
    # (v·n_b + b)·C + c; the real dispatch's slot s is (b·E + e)·C + c
    e_real = torch.div(slot, C, rounding_mode="floor") % E
    row0 = slot - (e_real + shard[:, None] * E) * C + shard[:, None] * C
    reps = torch.arange(n_rep, device=x.device)
    v = (e_real * n_rep)[:, :, None] + reps                      # [T, k, n_rep]
    vslot = (v * (n_b * C) + row0[:, :, None]).reshape(T, k * n_rep)
    vkeep = keep[:, :, None].expand(T, k, n_rep).reshape(T, k * n_rep)
    groups = torch.div(v, E_loc, rounding_mode="floor").reshape(T, k * n_rep)
    vsource = (source.view(n_b, E, C).transpose(0, 1)[:, None]
               .expand(E, n_rep, n_b, C).reshape(-1))
    y = _Combine.apply(yout, w, vslot, vkeep, vsource, by_expert, groups)
    y = y.reshape(B, S, D).to(x.dtype)
    if "shared_wi" in p:
        y = y + _shared_experts(p, x)

    # balance statistics of each data shard, averaged over the shards
    chosen = torch.zeros((T, E), dtype=torch.float32, device=x.device).scatter_(1, idx, 1.0)
    frac_tokens = chosen.view(n_b, T_loc, E).mean(1)
    frac_probs = probs.view(n_b, T_loc, E).mean(1)
    lb = (E * torch.sum(frac_tokens * frac_probs, -1)).mean(0)
    # each (data, model) shard's kept share of its own assignments
    total = chosen.view(n_b, T_loc, E).sum(1)
    kept = total.clamp(max=C)
    if n_rep > 1:
        total, kept = (t[:, :, None].expand(n_b, E, n_rep).reshape(n_b, m)
                       for t in (total, kept))
    else:
        total, kept = (t.view(n_b, m, E_loc).sum(-1) for t in (total, kept))
    dropped = (1.0 - kept / total.clamp(min=1.0)).mean(1).mean(0)
    return y, {"lb_loss": lb, "router_probs_mean": frac_probs.mean(0),
               "dropped_frac": dropped}


def _virtual_experts(p, n_rep: int):
    """The expert weights as ``E·n_rep`` virtual experts, each with
    ``F/n_rep`` of a real expert's FFN columns (the reference's
    ``_virtualize_in`` / ``_virtualize_out``); ``p`` itself when
    ``n_rep`` is 1."""
    if n_rep == 1:
        return p
    E, D, F = p["wi"].shape
    f = F // n_rep
    out = {"wi": p["wi"].reshape(E, D, n_rep, f).transpose(1, 2).reshape(E * n_rep, D, f),
           "wo": p["wo"].reshape(E * n_rep, f, D)}
    if "wg" in p:
        out["wg"] = p["wg"].reshape(E, D, n_rep, f).transpose(1, 2).reshape(E * n_rep, D, f)
    return out


def _shared_experts(p, x: torch.Tensor) -> torch.Tensor:
    """The shared experts' dense gated FFN (always on)."""
    dt = x.dtype
    h = x @ p["shared_wi"].to(dt)
    g = x @ p["shared_wg"].to(dt)
    return (F.silu(g) * h) @ p["shared_wo"].to(dt)


def dispatch_plan(idx: torch.Tensor, n_experts: int, capacity: int):
    """The sort-based dispatch of the assignments ``idx [T, k]`` (token
    ``t``'s ``j``-th expert is assignment ``t·k + j``): returns
    ``(dispatch [E·C], slot [T·k], keep [T·k], source [E·C])``.
    ``dispatch[e·C + c]`` is the token in expert ``e``'s capacity slot
    ``c``, ``T`` (the zero row) where the slot is empty; ``slot[a]`` is
    where assignment ``a``'s output lies (its expert's slot 0 when
    dropped) and ``keep[a]`` whether it fits the capacity; ``source`` is
    the assignment that fills each slot (``T·k`` where it is empty).
    Assignments sort by expert, stably; an expert keeps its first ``C``."""
    T, k = idx.shape
    E, C, A = n_experts, capacity, T * k
    flat_e = idx.reshape(A)
    se, order = torch.sort(flat_e, stable=True)
    experts = torch.arange(E, device=idx.device, dtype=se.dtype)
    first = torch.searchsorted(se, experts)
    last = torch.searchsorted(se, experts, right=True)
    # the capacity slots: sorted assignment first[e] + c, while it is e's
    src = first[:, None] + torch.arange(C, device=idx.device)[None, :]
    filled = src < last[:, None]
    source = torch.where(filled, order[src.clamp(max=A - 1)], A).reshape(E * C)
    dispatch = torch.where(source < A, torch.div(source, k, rounding_mode="floor"), T)
    # each assignment's rank within its expert, in the original order
    rank_sorted = torch.arange(A, device=idx.device) - first[se]
    rank = torch.empty_like(rank_sorted).index_put_((order,), rank_sorted)
    keep = rank < C
    slot = flat_e * C + torch.where(keep, rank, 0)
    return dispatch, slot, keep, source


class _Dispatch(torch.autograd.Function):
    """``xin [E·C, D]``: the rows of ``x2d [T, D]`` at ``dispatch``, zeros
    in the empty slots.  Backward: each token's kept slots' gradients
    (``slot``, ``keep`` ``[T, k]``: each token's assignments in ascending
    expert order) gathered and added in that order, no float atomics."""

    @staticmethod
    def forward(ctx, x2d, dispatch, slot, keep):
        T = x2d.shape[0]
        xin = x2d.index_select(0, dispatch.clamp(max=T - 1))
        xin.masked_fill_((dispatch == T)[:, None], 0)
        ctx.save_for_backward(slot, keep)
        return xin

    @staticmethod
    def backward(ctx, dxin):
        slot, keep = ctx.saved_tensors
        dx = None
        for j in range(slot.shape[1]):
            term = torch.where(keep[:, j, None], dxin.index_select(0, slot[:, j]), 0)
            dx = term if dx is None else dx + term
        return dx, None, None, None


class _Combine(torch.autograd.Function):
    """``y [T, D]``: each token's kept expert outputs (``yout [rows, D]`` at
    ``slot``) weighted by ``w [T, k]`` and added in ascending expert
    order, in ``yout``'s dtype (``slot`` and ``keep`` ``[T, k·r]``, and
    ``by_expert`` ``[T, k]``: each token's assignments in that order; with
    ``r`` virtual experts a real one, each assignment's ``r`` rows, which
    share its weight).  ``groups [T, k·r]`` (the expert-parallel path:
    each contribution's model shard, ascending) adds the contributions of
    a group, then the groups' sums in order; None adds them one after
    another.  Backward: a gather per filled row (its assignment from
    ``source``) and a row product per contribution, no float atomics."""

    @staticmethod
    def forward(ctx, yout, w, slot, keep, source, by_expert, groups):
        n_rep = slot.shape[1] // w.shape[1]
        wk = torch.gather(w, 1, by_expert)
        if n_rep > 1:
            wk = wk[:, :, None].expand(*wk.shape, n_rep).reshape(slot.shape)
        wk = (wk * keep).to(yout.dtype)
        y = total = None
        for j in range(slot.shape[1]):
            c = yout.index_select(0, slot[:, j]) * wk[:, j, None]
            if y is None:
                y = c
            elif groups is None:
                y = y + c
            else:
                # a new group: its predecessor's sum joins the total
                new = (groups[:, j] != groups[:, j - 1])[:, None]
                total = (torch.where(new, y, 0) if total is None
                         else torch.where(new, total + y, total))
                y = torch.where(new, c, y + c)
        if total is not None:
            y = total + y
        ctx.save_for_backward(yout, w, slot, keep, source, by_expert)
        return y

    @staticmethod
    def backward(ctx, dy):
        yout, w, slot, keep, source, by_expert = ctx.saved_tensors
        T, k = w.shape
        A = T * k
        dyout = dw = None
        if ctx.needs_input_grad[0]:
            a = source.clamp(max=A - 1)
            dyout = (dy.index_select(0, torch.div(a, k, rounding_mode="floor"))
                     * w.reshape(-1).to(dy.dtype).index_select(0, a)[:, None])
            dyout.masked_fill_((source == A)[:, None], 0)
        if ctx.needs_input_grad[1]:
            rows = yout.index_select(0, slot.reshape(-1)).view(*slot.shape, -1)
            dw = torch.where(keep, (dy[:, None, :] * rows).sum(-1).to(w.dtype), 0)
            if slot.shape[1] != k:   # an assignment's virtual experts, in order
                dw = dw.view(T, k, -1).sum(-1)
            # back from ascending expert order to w's: a row's inverse permutation
            dw = torch.gather(dw, 1, torch.argsort(by_expert, dim=1))
        return dyout, dw, None, None, None, None, None


def _dispatch(x2d: torch.Tensor, idx: torch.Tensor, n_experts: int, capacity: int):
    """The experts' capacity buffers ``xin [E, C, D]`` of ``x2d [T, D]``
    (zeros in empty slots) and the plan the combine takes: ``(slot, keep,
    source, by_expert)`` (:func:`dispatch_plan`), with ``slot`` and
    ``keep`` ``[T, k]`` in the order ``by_expert`` gives each token's
    assignments: ascending expert order."""
    T, k = idx.shape
    dispatch, slot, keep, source = dispatch_plan(idx, n_experts, capacity)
    by_expert = torch.sort(idx, dim=1, stable=True)[1]
    slot = torch.gather(slot.view(T, k), 1, by_expert)
    keep = torch.gather(keep.view(T, k), 1, by_expert)
    xin = _Dispatch.apply(x2d, dispatch, slot, keep)
    return xin.view(n_experts, capacity, x2d.shape[1]), (slot, keep, source, by_expert)


def _combine(yout: torch.Tensor, w: torch.Tensor, plan) -> torch.Tensor:
    """Each token's kept expert outputs (``yout [E·C, D]``), weighted by
    ``w`` and added one after another in ascending expert order, the order
    the reference's ``segment_sum`` meets them in the sorted assignments:
    ``[T, D]`` in ``yout``'s dtype."""
    return _Combine.apply(yout, w, *plan, None)


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig, *,
              capacity: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """x ``[B, S, D]`` → ``(y, aux)`` with ``aux = {"lb_loss",
    "router_probs_mean", "dropped_frac"}`` (float32 tensors)."""
    if cfg.moe_impl == "ep" and capacity is None:
        out = apply_moe_ep(p, x, cfg)
        if out is not None:
            return out
    B, S, D = x.shape
    T = B * S
    E = cfg.n_experts
    x2d = x.reshape(T, D)
    idx, w, probs = _route(p, x2d, cfg)
    if capacity is None:
        capacity = max(1, int(math.ceil(T * cfg.top_k / E * cfg.capacity_factor)))
    C = capacity
    xin, plan = _dispatch(x2d, idx, E, C)
    keep = plan[1]
    yout = _expert_ffn(p, xin, cfg).reshape(E * C, D)
    y = _combine(yout, w, plan).reshape(B, S, D).to(x.dtype)

    if "shared_wi" in p:
        y = y + _shared_experts(p, x)

    # load-balance loss (Switch-style; reported for the sigmoid router too)
    chosen = torch.zeros((T, E), dtype=torch.float32, device=x.device).scatter_(1, idx, 1.0)
    frac_tokens = chosen.mean(0)
    frac_probs = probs.mean(0)
    lb_loss = E * torch.sum(frac_tokens * frac_probs)
    aux = {"lb_loss": lb_loss, "router_probs_mean": frac_probs,
           "dropped_frac": 1.0 - keep.float().mean()}
    return y, aux


def build_moe_dispatch_program(mesh, axis: str, n_experts: int, capacity: int,
                               d_model: int, dtype=torch.float32, *, verify: str = "warn",
                               name: str = "st_moe_dispatch"):
    """The MoE's expert-parallel dispatch as a composable ST program: every
    rank's sorted capacity buffer ``[E, C, D]`` (flattened to ``E·C``
    rows, experts contiguous) sent so that expert ``e``'s block lands on
    the rank owning it, a tiled all-to-all over the expert rows
    (:func:`repro_torch.core.collectives.build_all_to_all`: one start
    gate of ``n - 1`` staged trigger→wait channels).  Pure copies, so it
    equals a plain tiled all-to-all bit for bit; the tiled all-to-all is
    an involution, so running the program twice routes the expert outputs
    back (the combine).  Returns a ``CollectiveMatmul`` whose ``inputs`` /
    ``output`` buffers are the flattened dispatch rows."""
    from repro_torch.core import collectives

    n = dict(mesh.shape)[axis]
    if n_experts % n:
        raise ValueError(
            f"n_experts ({n_experts}) must divide by the {axis!r} axis "
            f"size ({n}) for expert-parallel dispatch")
    rows = n * n_experts * capacity  # global: every rank holds E*C rows
    return collectives.build_all_to_all(mesh, axis, rows, d_model, dtype,
                                        verify=verify, name=name)
