"""Analytic parameter / FLOP counting per config (roofline inputs) — a
copy of ``repro.models.counting`` (pure Python, no JAX).

MODEL_FLOPS uses the standard 6·N·D (train) / 2·N·D (inference) rule
with N = *active* parameters (MoE counts shared + top-k routed experts
only) and D = processed tokens.  Attention's S² term is added separately
(it matters at 32k+).
"""

from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, ShapeConfig
from .ssm import ssm_dims


def _attn_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    if cfg.use_mla:
        ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        h = cfg.n_heads
        return (d * ql + ql * h * (dn + dr) + d * (kl + dr)
                + kl * h * (dn + dv) + h * dv * d)
    hd = cfg.resolved_head_dim()
    n = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd + cfg.n_heads * hd * d
    if cfg.qkv_bias:
        n += (cfg.n_heads + 2 * cfg.n_kv_heads) * hd
    return n


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    mats = 3 if cfg.act == "silu" else 2
    return mats * cfg.d_model * d_ff


def _ssm_params(cfg: ModelConfig) -> int:
    d_inner, H, conv_dim = ssm_dims(cfg)
    d_in_proj = 2 * d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + H
    return (cfg.d_model * d_in_proj + cfg.ssm_conv * conv_dim + conv_dim
            + 3 * H + d_inner + d_inner * cfg.d_model)


def _layer_params(cfg: ModelConfig, layer: int, active_only: bool) -> int:
    kind_moe = cfg.is_moe_layer(layer)
    n = 0
    if cfg.arch_type == "ssm":
        return _ssm_params(cfg) + cfg.d_model
    n += _attn_params(cfg) + 2 * cfg.d_model  # attn + 2 norms
    if cfg.hybrid:
        n += _ssm_params(cfg) + cfg.d_model
        n += _mlp_params(cfg, cfg.d_ff)
        return n
    if kind_moe:
        experts = cfg.top_k if active_only else cfg.n_experts
        n += experts * _mlp_params(cfg, cfg.d_ff_expert)
        n += cfg.d_model * cfg.n_experts  # router
        if cfg.n_shared_experts:
            n += _mlp_params(cfg, cfg.d_ff_expert * cfg.n_shared_experts)
    else:
        n += _mlp_params(cfg, cfg.d_ff)
    return n


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    n = cfg.vocab * cfg.d_model  # embedding
    if not cfg.tie_embeddings:
        n += cfg.d_model * cfg.vocab
    for i in range(cfg.n_layers):
        n += _layer_params(cfg, i, active_only)
    if cfg.enc_dec:
        for i in range(cfg.n_enc_layers):
            n += _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff) + 2 * cfg.d_model
        # cross attention in every decoder layer
        n += cfg.n_layers * (_attn_params(cfg) + cfg.d_model)
    if cfg.frontend == "vision":
        n += cfg.frontend_dim * cfg.d_model + cfg.d_model * cfg.d_model
    if cfg.frontend == "audio":
        n += cfg.frontend_dim * cfg.d_model
    if cfg.n_meta_tokens:
        n += cfg.n_meta_tokens * cfg.d_model
    if cfg.mtp_depth:
        n += 2 * cfg.d_model * cfg.d_model + _attn_params(cfg) + _mlp_params(cfg, cfg.d_ff)
    return n


def _attn_flops_quadratic(cfg: ModelConfig, tokens_q: int, tokens_kv: int,
                          batch: int) -> float:
    """2·(QK) + 2·(PV) per head-dim — the S² term, per forward."""
    if cfg.arch_type == "ssm":
        return 0.0
    hd = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
          if cfg.use_mla else cfg.resolved_head_dim())
    h = cfg.n_heads
    causal_frac = 0.5 if tokens_q == tokens_kv else 1.0
    per_layer = 4.0 * h * hd * tokens_q * tokens_kv * causal_frac * batch
    n_layers = cfg.n_layers + (cfg.n_enc_layers if cfg.enc_dec else 0)
    return per_layer * n_layers


def model_memory_bytes(cfg: ModelConfig, shape: ShapeConfig, *,
                       chips: int = 256, data_shards: int = 16) -> float:
    """Analytic per-device HBM traffic LOWER BOUND (fused-TPU model).

    Components: parameter reads (weights stream from HBM once per pass;
    training adds grad + AdamW moment read/write), activation traffic at
    layer boundaries (intra-layer intermediates assumed fused; ~10
    d_model-sized tensors r/w per layer), logits, and for decode the KV/
    state cache read+write.  The HLO ``bytes accessed`` number is the
    matching UPPER bound (no fusion).  Real TPU traffic lies between.
    """
    p_bytes = {"float32": 4, "bfloat16": 2}[cfg.param_dtype]
    a_bytes = {"float32": 4, "bfloat16": 2}[cfg.dtype]
    n_active = count_params(cfg, active_only=True)
    params_dev = n_active * p_bytes / chips

    B, S = shape.global_batch, shape.seq_len
    L = cfg.n_layers + (cfg.n_enc_layers if cfg.enc_dec else 0)

    if shape.kind == "train":
        tokens_dev = B * S / data_shards
        param_traffic = params_dev * (2 + 1 + 4 + 1)  # fwd+bwd reads, grad w, m/v rw, param w
        act_traffic = tokens_dev * cfg.d_model * a_bytes * L * 10 * 2  # fwd+bwd
        logits = 3 * tokens_dev * cfg.vocab / 16 * 4  # vocab-sharded, f32
        return param_traffic + act_traffic + logits
    if shape.kind == "prefill":
        tokens_dev = B * S / data_shards
        return (params_dev + tokens_dev * cfg.d_model * a_bytes * L * 10
                + tokens_dev * cfg.vocab / 16 * a_bytes / S)  # last-pos logits
    # decode: one token; weights + the whole cache stream per step
    if cfg.use_mla:
        cache_row = cfg.kv_lora_rank + cfg.qk_rope_head_dim
    elif cfg.arch_type == "ssm":
        cache_row = 0
    else:
        hkv = max(cfg.n_kv_heads, 1)
        cache_row = 2 * hkv * cfg.resolved_head_dim()
    window = cfg.sliding_window or cfg.serve_window
    cache_dev = 0.0
    if cache_row:
        if cfg.global_every:
            n_glob = cfg.n_layers // cfg.global_every
            n_loc = cfg.n_layers - n_glob
            rows = n_glob * S + n_loc * min(window or S, S)
        elif window:
            rows = cfg.n_layers * min(window, S)
        else:
            rows = cfg.n_layers * S
        cache_dev = B * rows * cache_row * a_bytes / chips * 1.0
    ssm_dev = 0.0
    if cfg.arch_type in ("ssm", "hybrid"):
        d_inner = cfg.ssm_expand * cfg.d_model
        H = d_inner // cfg.ssm_head_dim
        ssm_dev = (cfg.n_layers * B * H * cfg.ssm_head_dim * cfg.ssm_state * 4
                   * 2 / chips)  # state read+write, fp32
    return params_dev + cache_dev + ssm_dev


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, float]:
    """Returns {"model_flops", "n_params", "n_active"} for the shape."""
    n_total = count_params(cfg)
    n_active = count_params(cfg, active_only=True)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens = B * S
        factor = 6.0
        quad = 3.0 * _attn_flops_quadratic(cfg, S, S, B)
    elif shape.kind == "prefill":
        tokens = B * S
        factor = 2.0
        quad = _attn_flops_quadratic(cfg, S, S, B)
    else:  # decode: one token per sequence against an S cache
        tokens = B
        factor = 2.0
        quad = _attn_flops_quadratic(cfg, 1, S, B)
    return {
        "model_flops": factor * n_active * tokens + quad,
        "n_params": float(n_total),
        "n_active": float(n_active),
        "tokens": float(tokens),
    }
