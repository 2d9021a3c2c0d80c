"""Layer stacks — port of ``repro.models.transformer``.

A trunk is a list of segments, runs of structurally identical layers.
Block kinds: ``attn_mlp`` (dense models, the vision backbone and
whisper's encoder, which runs it not causal), ``attn_moe`` (attention
and a mixture of experts: deepseek-v3 after its ``first_k_dense`` dense
layers, grok-1), ``ssm`` (mamba2), ``hybrid`` (hymba: attention and an
SSD head side by side on separately normed inputs, mixed by
``softmax(mix)`` in float32, then the MLP) and ``dec_cross`` (whisper's
decoder: self-attention, cross attention over the encoder output, MLP).
A MoE layer's balance loss is summed over the layers into ``aux``
(``apply_stack(aux=...)``).  Parameters keep
the reference's layout — stacked with a leading ``layers`` axis when
``cfg.scan_layers``, a list of per-layer dicts when not — and the layers
run as a Python loop over views of them, each with its own static
window and rope theta (``layer_window_theta``); stacked tensors are
split once per call with ``torch.unbind`` (:func:`unbind_layers`).  When
autograd records a no-cache forward and ``cfg.remat == "block"``, each
layer runs under ``torch.utils.checkpoint`` (non-reentrant), as the
reference wraps each in ``jax.checkpoint``: its activations are
recomputed in the backward.  Caches are stacked per
segment: attention ``k``, ``v`` ``[L,B,T,Hkv,hd]`` in ``cfg.dtype``, or
with MLA ``c_kv [L,B,T,kv_lora]`` and ``k_rope [L,B,T,rope_dim]``
(written in place, so the stacked tensors are the new caches too), ssm
``conv [L,B,K-1,conv_dim]`` in ``cfg.dtype`` and ``state [L,B,H,P,N]``
in float32; a hybrid layer has both.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel import current_ctx, sharding_ctx
from . import moe as moe_lib
from . import ssm as ssm_lib
from .nn import (
    apply_attention,
    apply_mlp,
    apply_rmsnorm,
    dtype_of,
    init_attention,
    init_mlp,
    init_rmsnorm,
    param,
    tree_map,
)


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str
    n_layers: int
    first_layer: int = 0  # absolute index of the segment's first layer


#: block kinds with a self-attention layer (and a K/V cache)
ATTENTION_KINDS = ("attn_mlp", "attn_moe", "hybrid", "dec_cross")


def plan_segments(cfg: ModelConfig, *, decoder: bool = True) -> List[Segment]:
    """The trunk's segments: the decoder's, or (``decoder=False``) the
    encoder's of an encoder-decoder config."""
    if cfg.enc_dec and not decoder:
        return [Segment("attn_mlp", cfg.n_enc_layers)]
    if cfg.enc_dec:
        return [Segment("dec_cross", cfg.n_layers)]
    if cfg.arch_type == "ssm":
        return [Segment("ssm", cfg.n_layers)]
    if cfg.hybrid:
        return [Segment("hybrid", cfg.n_layers)]
    if cfg.n_experts > 0:
        segs = [Segment("attn_mlp", cfg.first_k_dense)] if cfg.first_k_dense else []
        return segs + [Segment("attn_moe", cfg.n_layers - cfg.first_k_dense,
                               cfg.first_k_dense)]
    return [Segment("attn_mlp", cfg.n_layers)]


def layer_window_theta(cfg: ModelConfig, layer_idx: int,
                       serve_window: int = 0) -> Tuple[int, float]:
    """Static per-layer (window, rope_theta); window 0 is full attention.
    gemma3: every ``global_every``-th layer (1-based) is global, with
    ``rope_theta_global``; the others slide a ``sliding_window``.  A
    ``serve_window`` narrows every attention layer's window."""
    is_global = bool(cfg.global_every) and ((layer_idx + 1) % cfg.global_every == 0)
    if cfg.global_every and not is_global:
        window, theta = cfg.sliding_window, cfg.rope_theta
    elif cfg.sliding_window and not cfg.global_every:
        window, theta = cfg.sliding_window, cfg.rope_theta
    else:
        window, theta = 0, cfg.rope_theta_global or cfg.rope_theta
    if serve_window:
        window = serve_window if window == 0 else min(window, serve_window)
    return window, theta


def init_block(gen, cfg: ModelConfig, kind: str, *, device):
    if kind not in ("attn_mlp", "attn_moe", "ssm", "hybrid", "dec_cross"):
        raise ValueError(kind)
    pdt = dtype_of(cfg.param_dtype)
    p: Dict[str, Any] = {}
    if kind != "ssm":
        p["ln_attn"] = init_rmsnorm(cfg.d_model, pdt, device=device)
        p["attn"] = init_attention(gen, cfg, device=device)
    if kind == "dec_cross":
        p["ln_cross"] = init_rmsnorm(cfg.d_model, pdt, device=device)
        p["cross"] = init_attention(gen, cfg, device=device, cross=True)
    if kind in ("ssm", "hybrid"):
        p["ln_ssm"] = init_rmsnorm(cfg.d_model, pdt, device=device)
        p["ssm"] = ssm_lib.init_ssm(gen, cfg, device=device)
    if kind == "hybrid":
        # learned output mixing of the two parallel heads
        p["mix"] = param(None, (2,), (None,), torch.float32, device=device, init="ones")
    if kind != "ssm":
        p["ln_mlp"] = init_rmsnorm(cfg.d_model, pdt, device=device)
    if kind == "attn_moe":
        p["moe"] = moe_lib.init_moe(gen, cfg, device=device)
    elif kind != "ssm":
        p["mlp"] = init_mlp(gen, cfg, device=device)
    return p


def _attn_cache(cache, cache_pos, depth):
    if cache is None or "attn" not in cache:
        return None
    return {**cache["attn"], "pos": cache_pos, "depth": depth}


def apply_block(p, x, cfg: ModelConfig, kind: str, *, causal: bool = True,
                window: int = 0, rope_theta: Optional[float] = None, positions=None,
                cache: Optional[Dict] = None, cache_pos=None,
                depth: Optional[int] = None, enc_out: Optional[torch.Tensor] = None,
                aux: Optional[Dict[str, torch.Tensor]] = None):
    """Returns (y, new_cache); a MoE block puts its ``lb_loss``,
    ``router_probs_mean`` and ``dropped_frac`` into ``aux`` when given."""
    new_cache: Dict[str, Any] = {}
    if kind == "ssm":
        h = apply_rmsnorm(p["ln_ssm"], x, cfg)
        s, sc = ssm_lib.apply_ssm(p["ssm"], h, cfg,
                                  cache=cache.get("ssm") if cache else None)
        return x + s, ({"ssm": sc} if sc is not None else {})
    if kind not in ("attn_mlp", "attn_moe", "hybrid", "dec_cross"):
        raise ValueError(kind)
    h = apply_rmsnorm(p["ln_attn"], x, cfg)
    a, kv = apply_attention(p["attn"], h, cfg, causal=causal, window=window,
                            rope_theta=rope_theta, positions=positions,
                            cache=_attn_cache(cache, cache_pos, depth))
    if kv is not None:
        new_cache["attn"] = kv
    if kind == "hybrid":
        # the SSD head on its own norm of the same input, beside attention
        h = apply_rmsnorm(p["ln_ssm"], x, cfg)
        s, sc = ssm_lib.apply_ssm(p["ssm"], h, cfg,
                                  cache=cache.get("ssm") if cache else None)
        if sc is not None:
            new_cache["ssm"] = sc
        mix = torch.softmax(p["mix"].float(), dim=0)
        x = x + (mix[0] * a.float() + mix[1] * s.float()).to(x.dtype)
    else:
        x = x + a
    if kind == "dec_cross":
        h = apply_rmsnorm(p["ln_cross"], x, cfg)
        c, _ = apply_attention(p["cross"], h, cfg, positions=positions, kv_x=enc_out)
        x = x + c
    h = apply_rmsnorm(p["ln_mlp"], x, cfg)
    if kind == "attn_moe":
        m, moe_aux = moe_lib.apply_moe(p["moe"], h, cfg)
        if aux is not None:
            aux.update(moe_aux)
        return x + m, new_cache
    return x + apply_mlp(p["mlp"], h, cfg), new_cache


def init_stack(gen, cfg: ModelConfig, *, device, decoder: bool = True):
    params = []
    for seg in plan_segments(cfg, decoder=decoder):
        layers = [init_block(gen, cfg, seg.kind, device=device)
                  for _ in range(seg.n_layers)]
        params.append(_stack(layers) if cfg.scan_layers else layers)
    return {"segments": params}


def _stack(layers: List) -> Dict:
    """Per-layer dicts → one dict of tensors with a leading layers axis.
    Each leaf's per-layer tensors are dropped from ``layers`` once they are
    stacked, so that stacking costs the memory of one leaf's layers beyond
    the parameters, not of all of them (a deepseek-v3 MoE layer's experts
    are 22.5 GB in bf16)."""
    if isinstance(layers[0], dict):
        return {k: _stack([l.pop(k) for l in layers]) for k in list(layers[0])}
    out = torch.stack(layers)
    if hasattr(layers[0], "logical_axes"):   # a parameter's, with the layers axis first
        out.logical_axes = ("layers",) + layers[0].logical_axes
    layers.clear()
    return out


def unbind_layers(seg_params, n_layers: int) -> List[Dict]:
    """Every layer's parameters: the list itself, or views into the
    stacked tensors split with ``torch.unbind``.  Under autograd the
    split's backward is ONE stack of the layers' gradients, where
    indexing each layer out of the stack would build a zero tensor of the
    whole stack per layer."""
    if isinstance(seg_params, list):
        return seg_params
    flat: Dict[str, Any] = {}

    def split(tree, prefix):
        if isinstance(tree, dict):
            return {k: split(v, f"{prefix}/{k}") for k, v in tree.items()}
        flat[prefix] = torch.unbind(tree, 0)
        return prefix

    keys = split(seg_params, "")

    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return flat[tree][i]

    return [pick(keys, i) for i in range(n_layers)]


def _remat(cfg: ModelConfig, caches) -> bool:
    """Whether each layer runs under activation checkpointing: the
    reference wraps every layer in ``jax.checkpoint`` when ``remat ==
    "block"`` (``src/repro/models/transformer.py:249-250``); the port does
    where it matters, when autograd records the no-cache forward."""
    return cfg.remat == "block" and caches is None and torch.is_grad_enabled()


def apply_stack(params, x, cfg: ModelConfig, *, decoder: bool = True,
                causal: bool = True, positions=None,
                caches: Optional[List] = None, cache_pos=None,
                depth: Optional[int] = None, serve_window: int = 0,
                enc_out: Optional[torch.Tensor] = None,
                aux: Optional[Dict[str, torch.Tensor]] = None):
    """Run all segments of the decoder or (``decoder=False``) the encoder.
    Returns (y, new_caches): per segment, the new caches (``None`` without
    caches).  ``depth``: the host int every slot's cache sits at (the
    prefill), or None (a decode step); ``enc_out``: the encoder output the
    ``dec_cross`` layers attend to; ``aux``: a dict that receives
    ``lb_loss``, the MoE layers' balance losses added in layer order."""
    new_caches = []
    remat = _remat(cfg, caches)
    for si, seg in enumerate(plan_segments(cfg, decoder=decoder)):
        seg_cache = caches[si] if caches is not None else None
        seg_new = []
        layers = unbind_layers(params["segments"][si], seg.n_layers)
        moe = seg.kind == "attn_moe"
        for i in range(seg.n_layers):
            window, theta = layer_window_theta(cfg, seg.first_layer + i, serve_window)
            layer_aux: Dict[str, torch.Tensor] = {}
            if remat:
                def block(h, p, e, _kind=seg.kind, _w=window, _t=theta, _moe=moe,
                          _ctx=current_ctx()):
                    # the recompute runs in the backward's thread, which does
                    # not see this thread's sharding context: it is carried
                    out_aux: Dict[str, torch.Tensor] = {}
                    with sharding_ctx(*_ctx) if _ctx else contextlib.nullcontext():
                        y = apply_block(p, h, cfg, _kind, causal=causal, window=_w,
                                        rope_theta=_t, positions=positions, enc_out=e,
                                        aux=out_aux)[0]
                    return (y, out_aux["lb_loss"]) if _moe else y
                out = checkpoint(block, x, layers[i], enc_out, use_reentrant=False,
                                 preserve_rng_state=False)
                x, layer_aux = (out[0], {"lb_loss": out[1]}) if moe else (out, {})
                seg_new.append({})
            else:
                layer_cache = (tree_map(lambda c, _i=i: c[_i], seg_cache)
                               if seg_cache is not None else None)
                x, nc = apply_block(layers[i], x, cfg, seg.kind, causal=causal,
                                    window=window, rope_theta=theta, positions=positions,
                                    cache=layer_cache, cache_pos=cache_pos, depth=depth,
                                    enc_out=enc_out, aux=layer_aux)
                seg_new.append(nc)
            if aux is not None and "lb_loss" in layer_aux:
                lb = layer_aux["lb_loss"]
                aux["lb_loss"] = lb if "lb_loss" not in aux else aux["lb_loss"] + lb
        if not seg_new or not seg_new[0]:
            new_caches.append(None)
            continue
        merged = {}
        for key in seg_new[0]:
            # the attention caches were written in place into the stacked
            # tensors; the ssm caches are new tensors per layer
            merged[key] = (seg_cache[key] if key == "attn"
                           else _stack([n[key] for n in seg_new]))
        new_caches.append(merged)
    return x, new_caches


def init_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                device) -> List[Dict[str, Any]]:
    """Per-segment stacked decode caches (zeros) of the decoder: attention
    ``k``, ``v`` ``[L,B,max_len,Hkv,hd]`` in ``cfg.dtype``, or with MLA
    ``c_kv [L,B,max_len,kv_lora]`` and ``k_rope [L,B,max_len,rope_dim]``;
    ssm ``conv [L,B,K-1,conv_dim]`` in ``cfg.dtype`` and ``state
    [L,B,H,P,N]`` in float32; a hybrid layer both."""
    dt = dtype_of(cfg.dtype)
    caches = []
    for seg in plan_segments(cfg):
        L = seg.n_layers
        entry: Dict[str, Any] = {}
        if seg.kind in ATTENTION_KINDS and cfg.use_mla:
            entry["attn"] = {
                "c_kv": torch.zeros((L, batch, max_len, cfg.kv_lora_rank), dtype=dt,
                                    device=device),
                "k_rope": torch.zeros((L, batch, max_len, cfg.qk_rope_head_dim), dtype=dt,
                                      device=device),
            }
        elif seg.kind in ATTENTION_KINDS:
            shape = (L, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim())
            entry["attn"] = {
                "k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device),
            }
        if seg.kind in ("ssm", "hybrid"):
            _, H, conv_dim = ssm_lib.ssm_dims(cfg)
            entry["ssm"] = {
                "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, conv_dim), dtype=dt,
                                    device=device),
                "state": torch.zeros((L, batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                                     dtype=torch.float32, device=device),
            }
        caches.append(entry)
    return caches


def cache_logical_axes(cfg: ModelConfig) -> List[Dict[str, Any]]:
    """The logical axes of :func:`init_caches`' leaves (the reference's
    ``cache_logical_axes`` for the ported segments)."""
    out = []
    for seg in plan_segments(cfg):
        entry: Dict[str, Any] = {}
        if seg.kind in ATTENTION_KINDS and cfg.use_mla:
            entry["attn"] = {"c_kv": ("layers", "batch", "cache_seq", "kv_lora"),
                             "k_rope": ("layers", "batch", "cache_seq", "head_dim")}
        elif seg.kind in ATTENTION_KINDS:
            kv = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
            entry["attn"] = {"k": kv, "v": kv}
        if seg.kind in ("ssm", "hybrid"):
            entry["ssm"] = {"conv": ("layers", "batch", None, "act_mlp"),
                            "state": ("layers", "batch", "act_heads", None, "state")}
        out.append(entry)
    return out
