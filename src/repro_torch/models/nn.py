"""Core NN building blocks of the port: the dense, MoE (MLA), SSM,
hybrid, encoder-decoder and vision paths.

Port of ``repro.models.nn``: parameter init, RMSNorm, token embedding
(with gemma's ``sqrt(d_model)`` scale), the tied or untied unembedding,
the MLP (gated silu or plain tanh-gelu), NeoX RoPE and GQA attention
with qkv bias, qk-norm, sliding windows, soft-capping, a KV cache and
cross attention, as plain functions on dicts of tensors in the
reference's layout.  Weights are stored in ``cfg.param_dtype`` and cast
to the compute dtype at each use, as the reference does; the cast is
free when a caller has cast them once already (``Model.compute_params``).

Every RMSNorm, the qk-norm included, is ``ops.rmsnorm`` (the Hopper
kernel on the card).  Attention over more than one query — the no-cache
forward (causal, or not in whisper's encoder) and the prefill — is
``ops.flash_attention``; the reference's models compute both with jnp,
and in the port the Hopper kernel is the GPU lowering wherever the
function is the kernel's.  So is cross attention (``kv_x``: whisper's
decoder against the encoder output), at every step, the one-token
decode included: it is not causal, has no window and writes no cache,
so no per-slot depth enters and the function is the kernel's.  Its K and
V are projected from ``kv_x`` at every call, as the reference does (no
cross-K/V cache).  The one-token decode step of self-attention keeps
the reference's plain ``_sdpa`` over the full-capacity cache with a
per-slot mask, because the kernel's ``q_offset`` is a host integer and
per-slot depths change at every replay of a CUDA graph.  The KV cache
is written in place (the reference's functional update, without a copy
of the cache per step).  RoPE applies only where ``cfg.pos_embedding ==
"rope"``, and never to cross attention.  Multi-head latent attention
(deepseek-v3's MLA, :func:`_apply_mla`) runs its no-cache forward and
its prefill on ``ops.flash_attention`` at q/k head dim ``dn + dr`` and v
head dim ``dv`` (K and V expanded per head from the compressed cache),
and its one-token decode in the reference's absorbed form.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every tensor leaf of nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def param(gen: Optional[torch.Generator], shape, axes, dtype, *, device,
          scale: Optional[float] = None, init: str = "normal") -> torch.Tensor:
    """A parameter as the reference initialises it: ``normal × scale``
    (0.02 by default), zeros or ones.  On the ``meta`` device (shapes
    only) nothing is drawn.  ``axes``, the logical axis of each dimension
    (the reference's boxed axes), stays on the tensor as its attribute
    ``logical_axes`` (``Model.param_axes``; a stacked parameter's lead
    with ``"layers"``)."""
    if init not in ("normal", "zeros", "ones"):
        raise ValueError(init)
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} differ in rank")
    device = torch.device(device)
    if device.type == "meta":
        v = torch.empty(shape, dtype=dtype, device=device)
    elif init == "zeros":
        v = torch.zeros(shape, dtype=dtype, device=device)
    elif init == "ones":
        v = torch.ones(shape, dtype=dtype, device=device)
    else:
        v = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        v.mul_(0.02 if scale is None else scale)
    v.logical_axes = tuple(axes)
    return v


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def init_rmsnorm(d: int, dtype, *, device):
    # stored at zero; applied as (scale + 1), as in the reference
    return {"scale": param(None, (d,), ("embed",), dtype, device=device, init="zeros")}


def apply_rmsnorm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    # stored scale is centred at 0: the effective weight is scale + 1
    return ops.rmsnorm(x, p["scale"], eps=cfg.norm_eps, weight_offset=1.0)


def init_embedding(gen, cfg: ModelConfig, *, device):
    return {"table": param(gen, (cfg.vocab, cfg.d_model), ("vocab", "embed"),
                           dtype_of(cfg.param_dtype), device=device)}


def apply_embedding(p, ids: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    # the table's gradient adds each id's rows in token order, rounding to
    # the compute dtype after every add, as the reference's VJP (no float
    # atomics on the card: ``kernels/embedding.py``)
    table = p["table"].to(dtype_of(cfg.dtype))
    x = ops.embedding(table, ids.reshape(-1)).reshape(*ids.shape, -1)
    if cfg.embed_scale:
        # sqrt(d_model) rounded to the activation dtype first, as the
        # reference does (in bf16, sqrt(1152) is 34.0)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()
    return x


def apply_unembed(p_embed, p_head, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits: against the embedding table when tied, else against the
    head ``p_head["w"]`` ``[d_model, vocab]``."""
    if cfg.tie_embeddings:
        return x @ p_embed["table"].to(x.dtype).t()
    return x @ p_head["w"].to(x.dtype)


def init_unembed(gen, cfg: ModelConfig, *, device):
    if cfg.tie_embeddings:
        return {}
    return {"w": param(gen, (cfg.d_model, cfg.vocab), ("embed", "vocab"),
                       dtype_of(cfg.param_dtype), device=device)}


def init_mlp(gen, cfg: ModelConfig, *, device, d_ff: Optional[int] = None):
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    dt = dtype_of(cfg.param_dtype)
    out_scale = 0.02 / math.sqrt(2 * max(cfg.n_layers, 1))
    p = {"wi": param(gen, (d, f), ("embed", "mlp"), dt, device=device)}
    if cfg.act == "silu":  # gated (swiglu)
        p["wg"] = param(gen, (d, f), ("embed", "mlp"), dt, device=device)
    p["wo"] = param(gen, (f, d), ("mlp", "embed"), dt, device=device, scale=out_scale)
    return p


def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    h = x @ p["wi"].to(dt)
    if "wg" in p:
        h = F.silu(x @ p["wg"].to(dt)) * h
    else:
        h = F.gelu(h, approximate="tanh")  # jax.nn.gelu's default
    return h @ p["wo"].to(dt)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_dim: int) -> torch.Tensor:
    """x: [..., S, H, D] (positions [..., S] broadcastable); NeoX halves.

    As in the reference, the exponents ``i / half`` and the angles are
    float32.  Each inverse frequency ``theta ** -e`` is the float32 power
    rounded once (a float64 power of the float32 exponent, then cast),
    which is what the reference's float32 ``jnp.power`` gives; PyTorch's
    own float32 power is 1 ulp off for some ``i``, and at positions near
    1000 that moves the angles by ~1e-4."""
    if rotary_dim <= 0:
        return x
    half = rotary_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    base = torch.full((), theta, dtype=torch.float64, device=x.device)
    inv_freq = torch.pow(base, -exps.double()).float()
    ang = positions[..., None].float() * inv_freq              # [..., S, half]
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:rotary_dim].float()
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)
    if rotary_dim == x.shape[-1]:
        return rot
    return torch.cat([rot, x[..., rotary_dim:]], dim=-1)


# --------------------------------------------------------------------------
# attention (GQA)
# --------------------------------------------------------------------------


def init_attention(gen, cfg: ModelConfig, *, device, cross: bool = False):
    if cfg.use_mla and not cross:
        return _init_mla(gen, cfg, device=device)
    d = cfg.d_model
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    dt = dtype_of(cfg.param_dtype)
    kw = dict(device=device)
    p = {
        "wq": param(gen, (d, hq, hd), ("embed", "heads", "head_dim"), dt, **kw),
        "wk": param(gen, (d, hkv, hd), ("embed", "kv_heads", "head_dim"), dt, **kw),
        "wv": param(gen, (d, hkv, hd), ("embed", "kv_heads", "head_dim"), dt, **kw),
        "wo": param(gen, (hq, hd, d), ("heads", "head_dim", "embed"), dt,
                    scale=0.02 / math.sqrt(2 * max(cfg.n_layers, 1)), **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = param(None, (hq, hd), ("heads", "head_dim"), dt, init="zeros", **kw)
        p["bk"] = param(None, (hkv, hd), ("kv_heads", "head_dim"), dt, init="zeros", **kw)
        p["bv"] = param(None, (hkv, hd), ("kv_heads", "head_dim"), dt, init="zeros", **kw)
    if cfg.qk_norm:
        p["q_norm"] = param(None, (hd,), ("head_dim",), dt, init="zeros", **kw)
        p["k_norm"] = param(None, (hd,), ("head_dim",), dt, init="zeros", **kw)
    return p


def _headwise_rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return ops.rmsnorm(x, scale, eps=eps, weight_offset=1.0)


def _attn_mask(*, T: int, causal: bool, window: int, q_pos: torch.Tensor,
               k_valid: torch.Tensor) -> torch.Tensor:
    """Validity x causal x window mask, batch-aware: ``q_pos`` [S] or
    [B,S], ``k_valid`` scalar or [B]; returns [b?,S,T], b? in {1,B}."""
    qp = q_pos if q_pos.dim() == 2 else q_pos[None]              # [b?,S]
    kv = k_valid if k_valid.dim() == 1 else k_valid[None]        # [b?]
    kpos = torch.arange(T, device=qp.device)
    mask = kpos[None, None, :] < kv[:, None, None]               # [b?,1,T]
    if causal:
        mask = mask & (kpos[None, None, :] <= qp[:, :, None])
    if window > 0:
        mask = mask & (kpos[None, None, :] > qp[:, :, None] - window)
    return mask


def _sdpa(q, k, v, *, scale: float, causal: bool, window: int, softcap: float,
          q_pos: torch.Tensor, k_valid: torch.Tensor) -> torch.Tensor:
    """Attention of q [B,S,Hq,D] over a cache k, v [B,T,Hkv,D] in float32
    with the per-slot mask (the reference's ``_sdpa``); the kv heads are
    grouped, not repeated in memory."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qf = q.float().mul(scale).view(B, S, Hkv, group, D)
    logits = torch.einsum("bskgd,btkd->bkgst", qf, k.float())
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    mask = _attn_mask(T=T, causal=causal, window=window, q_pos=q_pos, k_valid=k_valid)
    logits = logits.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, Hq, D).to(q.dtype)


def _cache_write_step(buf: torch.Tensor, val: torch.Tensor, pos: torch.Tensor) -> None:
    """Write one step's ``val`` [B,1,...] into ``buf`` [B,T,...] in place
    at ``pos``: a scalar (one depth for the batch) or [B] (every slot at
    its own depth).  Indices past the end clamp to the last entry, as the
    reference's ``dynamic_update_slice`` does (a frozen slot's discarded
    write)."""
    idx = pos.long().clamp(0, buf.shape[1] - 1)
    if idx.dim() == 1:
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf.index_put_((rows, idx), val[:, 0])
    else:
        buf.index_copy_(1, idx.view(1), val)


def attention_qkv(p, x: torch.Tensor, cfg: ModelConfig, *,
                  rope_theta: Optional[float], positions: torch.Tensor,
                  k_positions: Optional[torch.Tensor] = None,
                  kv_x: Optional[torch.Tensor] = None):
    """q ``[B,S,Hq,hd]`` of ``x [B,S,d]``, k and v ``[B,Skv,Hkv,hd]`` of
    ``kv_x`` (cross attention) or of ``x``: the projections, qkv bias,
    qk-norm and, where ``cfg.pos_embedding == "rope"`` and not across,
    RoPE (q at ``positions``, k at ``k_positions``, by default ``0..S-1``
    as the reference's no-cache path has it)."""
    B, S, d = x.shape
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim()
    dt = x.dtype
    src = x if kv_x is None else kv_x
    Skv = src.shape[1]
    q = (x @ p["wq"].to(dt).reshape(d, hq * hd)).view(B, S, hq, hd)
    k = (src @ p["wk"].to(dt).reshape(d, hkv * hd)).view(B, Skv, hkv, hd)
    v = (src @ p["wv"].to(dt).reshape(d, hkv * hd)).view(B, Skv, hkv, hd)
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if "q_norm" in p:
        q = _headwise_rms(q, p["q_norm"], cfg.norm_eps)
        k = _headwise_rms(k, p["k_norm"], cfg.norm_eps)
    theta = cfg.rope_theta if rope_theta is None else rope_theta
    rotary_dim = int(hd * cfg.rotary_frac) if cfg.pos_embedding == "rope" else 0
    if rotary_dim and kv_x is None:
        q = apply_rope(q, positions, theta, rotary_dim)
        k = apply_rope(k, torch.arange(S, device=x.device) if k_positions is None
                       else k_positions, theta, rotary_dim)
    return q, k, v


def apply_attention(p, x: torch.Tensor, cfg: ModelConfig, *, causal: bool = True,
                    window: int = 0, rope_theta: Optional[float] = None,
                    positions: Optional[torch.Tensor] = None,
                    cache: Optional[Dict] = None, kv_x: Optional[torch.Tensor] = None):
    """Self-attention (``causal`` or not), or cross attention over ``kv_x``
    ``[B,Skv,d]``; returns ``(y, new_cache_or_None)``.

    ``cache = {"k", "v", "pos", "depth"}``: k, v ``[B,T,Hkv,hd]``, written
    in place; ``pos`` the write position, a scalar or [B] tensor.  With
    ``depth`` (a host int, every slot at that depth: the prefill) the S
    new entries land at ``depth`` and attention is ``ops.flash_attention``
    over the cache's first ``depth + S`` entries at ``q_offset = depth``;
    without it (``depth=None``: one decode step, S = 1) attention is the
    plain ``_sdpa`` over the whole cache, masked per slot.  With no cache,
    ``ops.flash_attention`` over the S new entries.  ``window`` 0 is full
    attention.  With ``kv_x``: ``ops.flash_attention`` of every query over
    all of ``kv_x``'s entries, not causal, with no window, no RoPE and no
    cache (the reference's ``kv_x`` path); ``cache`` and ``window`` are
    not used.
    """
    if cfg.use_mla and kv_x is None:
        return _apply_mla(p, x, cfg, window=window, rope_theta=rope_theta,
                          positions=positions, cache=cache, causal=causal)
    B, S, _ = x.shape
    hq, hd = cfg.n_heads, cfg.resolved_head_dim()
    dt = x.dtype
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = attention_qkv(p, x, cfg, rope_theta=rope_theta, positions=positions,
                            k_positions=None if cache is None else positions, kv_x=kv_x)

    scale = cfg.attn_output_multiplier or hd ** -0.5
    softcap = cfg.attn_softcap
    new_cache = None
    if kv_x is not None or cache is None:
        across = kv_x is not None
        out = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal and not across, scale=scale,
            window=None if across else (window or None),
            logit_softcap=softcap or None).transpose(1, 2)
    elif cache.get("depth") is not None:
        depth, T = cache["depth"], cache["k"].shape[1]
        if depth + S > T:
            raise ValueError(f"prefill of {S} tokens at depth {depth} exceeds the "
                             f"cache's {T} entries")
        ck, cv = cache["k"], cache["v"]
        ck[:, depth:depth + S] = k.to(ck.dtype)
        cv[:, depth:depth + S] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv}
        kc = ck[:, :depth + S].to(dt)
        vc = cv[:, :depth + S].to(dt)
        out = ops.flash_attention(
            q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2), causal=causal,
            scale=scale, window=window or None, logit_softcap=softcap or None,
            q_offset=depth).transpose(1, 2)
    else:
        if S != 1:
            raise NotImplementedError(
                "attention over a cache whose slots sit at different depths takes one "
                "token at a time: a prefill into slots at differing depths (a per-row "
                "q_offset) is not ported (ROADMAP.md)")
        ck, cv, pos = cache["k"], cache["v"], cache["pos"]
        _cache_write_step(ck, k.to(ck.dtype), pos)
        _cache_write_step(cv, v.to(cv.dtype), pos)
        new_cache = {"k": ck, "v": cv}
        out = _sdpa(q, ck.to(dt), cv.to(dt), scale=scale, causal=causal, window=window,
                    softcap=softcap, q_pos=positions, k_valid=pos + S)
    y = out.reshape(B, S, hq * hd) @ p["wo"].to(dt).reshape(hq * hd, -1)
    return y, new_cache


# --------------------------------------------------------------------------
# MLA (deepseek-v3)
# --------------------------------------------------------------------------


def _init_mla(gen, cfg: ModelConfig, *, device):
    d, h = cfg.d_model, cfg.n_heads
    ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = dtype_of(cfg.param_dtype)
    kw = dict(device=device)
    return {
        "wq_a": param(gen, (d, ql), ("embed", "q_lora"), dt, **kw),
        "q_norm": param(None, (ql,), ("q_lora",), dt, init="zeros", **kw),
        "wq_b": param(gen, (ql, h, dn + dr), ("q_lora", "heads", "head_dim"), dt,
                      **kw),
        "wkv_a": param(gen, (d, kl + dr), ("embed", "kv_lora"), dt, **kw),
        "kv_norm": param(None, (kl,), ("kv_lora",), dt, init="zeros", **kw),
        "wkv_b": param(gen, (kl, h, dn + dv), ("kv_lora", "heads", "head_dim"), dt,
                       **kw),
        "wo": param(gen, (h, dv, d), ("heads", "head_dim", "embed"), dt,
                    scale=0.02 / math.sqrt(2 * max(cfg.n_layers, 1)), **kw),
    }


def _vecnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return ops.rmsnorm(x, scale, eps=eps, weight_offset=1.0)


def _expand_kv(p, c_kv: torch.Tensor, k_rope: torch.Tensor, cfg: ModelConfig):
    """Per-head K ``[B,T,h,dn+dr]`` and V ``[B,T,h,dv]`` of the compressed
    ``c_kv [B,T,kl]`` and the shared ``k_rope [B,T,dr]``."""
    B, T, kl = c_kv.shape
    h, dn = cfg.n_heads, cfg.qk_nope_head_dim
    w = p["wkv_b"].to(c_kv.dtype)
    kv = (c_kv @ w.reshape(kl, -1)).view(B, T, h, w.shape[-1])
    k = torch.cat([kv[..., :dn], k_rope[:, :, None, :].expand(B, T, h, k_rope.shape[-1])],
                  dim=-1)
    return k, kv[..., dn:]


def mla_qkv(p, x: torch.Tensor, cfg: ModelConfig, *, rope_theta: Optional[float],
            positions: torch.Tensor):
    """MLA's ``(q_nope [B,S,h,dn], q_rope [B,S,h,dr], c_kv [B,S,kl], k_rope
    [B,S,dr])`` of ``x [B,S,d]``: queries through the low-rank ``wq_a`` /
    ``q_norm`` / ``wq_b`` path, the compressed ``c_kv`` (``wkv_a``,
    ``kv_norm``) and the one RoPE key every head shares, RoPE at
    ``positions``."""
    B, S, _ = x.shape
    h, ql, kl = cfg.n_heads, cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    dt = x.dtype
    theta = cfg.rope_theta if rope_theta is None else rope_theta
    q_c = _vecnorm(x @ p["wq_a"].to(dt), p["q_norm"], cfg.norm_eps)
    q = (q_c @ p["wq_b"].to(dt).reshape(ql, h * (dn + dr))).view(B, S, h, dn + dr)
    q_rope = apply_rope(q[..., dn:], positions, theta, dr)
    ckv = x @ p["wkv_a"].to(dt)
    c_kv = _vecnorm(ckv[..., :kl], p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(ckv[..., kl:][:, :, None, :], positions, theta, dr)[:, :, 0]
    return q[..., :dn], q_rope, c_kv, k_rope


def _apply_mla(p, x: torch.Tensor, cfg: ModelConfig, *, window: int = 0,
               rope_theta: Optional[float] = None,
               positions: Optional[torch.Tensor] = None, cache: Optional[Dict] = None,
               causal: bool = True):
    """Multi-head latent attention (the reference's ``_apply_mla``); returns
    ``(y, new_cache_or_None)``.

    Queries go through the low-rank ``wq_a`` / ``q_norm`` / ``wq_b`` path,
    keys and values through the compressed ``c_kv`` (``wkv_a``,
    ``kv_norm``) and one RoPE key ``k_rope`` shared by every head.  With
    no cache, and at the prefill (``cache["depth"]`` a host int: ``c_kv``
    and ``k_rope`` written at ``depth``), K and V are expanded per head
    from the compressed entries (the cache's first ``depth + S`` at the
    prefill) and attention is ``ops.flash_attention`` with q/k head dim
    ``dn + dr`` and v head dim ``dv``, at ``q_offset = depth``.  The
    one-token decode (``depth=None``) keeps the reference's absorbed
    form in float32: scores in the compressed space against the ``c_kv``
    and ``k_rope`` caches, masked per slot, as ``_sdpa`` does for the
    other decodes."""
    B, S, _ = x.shape
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    dt = x.dtype
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q_nope, q_rope, c_kv, k_rope = mla_qkv(p, x, cfg, rope_theta=rope_theta,
                                           positions=positions)
    scale = (dn + dr) ** -0.5

    new_cache = None
    if cache is not None and cache.get("depth") is None:
        if S != 1:
            raise NotImplementedError(
                "MLA over a cache whose slots sit at different depths takes one token at "
                "a time (ROADMAP.md)")
        cc, cr, pos = cache["c_kv"], cache["k_rope"], cache["pos"]
        _cache_write_step(cc, c_kv.to(cc.dtype), pos)
        _cache_write_step(cr, k_rope.to(cr.dtype), pos)
        # absorbed decode: scores in the compressed space
        w = p["wkv_b"].to(dt)
        q_eff = torch.einsum("bshe,rhe->bshr", q_nope, w[..., :dn])
        logits = (torch.einsum("bshr,btr->bhst", q_eff.float(), cc.float())
                  + torch.einsum("bshe,bte->bhst", q_rope.float(), cr.float())) * scale
        mask = _attn_mask(T=cc.shape[1], causal=causal, window=window, q_pos=positions,
                          k_valid=pos + S)
        probs = torch.softmax(logits.masked_fill(~mask[:, None], -1e30), dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", probs, cc.float()).to(dt)
        out = torch.einsum("bshr,rhe->bshe", ctx, w[..., dn:])
        new_cache = {"c_kv": cc, "k_rope": cr}
    else:
        q_offset = 0
        if cache is not None:
            depth, cc, cr = cache["depth"], cache["c_kv"], cache["k_rope"]
            if depth + S > cc.shape[1]:
                raise ValueError(f"prefill of {S} tokens at depth {depth} exceeds the "
                                 f"cache's {cc.shape[1]} entries")
            cc[:, depth:depth + S] = c_kv.to(cc.dtype)
            cr[:, depth:depth + S] = k_rope.to(cr.dtype)
            new_cache = {"c_kv": cc, "k_rope": cr}
            # contiguous, so that at depth 0 the expansion is the no-cache
            # path's product on the same values
            c_kv = cc[:, :depth + S].to(dt).contiguous()
            k_rope = cr[:, :depth + S].to(dt).contiguous()
            q_offset = depth
        k, v = _expand_kv(p, c_kv, k_rope, cfg)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        out = ops.flash_attention(
            qq.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal,
            scale=scale, window=window or None, q_offset=q_offset).transpose(1, 2)
    y = out.reshape(B, S, h * dv) @ p["wo"].to(dt).reshape(h * dv, -1)
    return y, new_cache
