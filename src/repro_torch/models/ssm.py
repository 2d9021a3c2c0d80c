"""Mamba2 (SSD) block — port of ``repro.models.ssm``.

in_proj → [z | x | B | C | dt]; short causal depthwise conv on (x,B,C);
SSD scan; gated RMSNorm (``ops.rmsnorm`` of ``x · silu(z)``, the
reference's formula); out_proj.  Whenever the scan covers more than
one token — ``forward_logits`` (no cache) and prefill (with the cache's
state as the initial state) — it goes through the hand-written kernel
wrapper ``ops.ssd_scan``, whatever ``cfg.use_ssd_kernel`` says.  The
reference runs its prefill, and with ``use_ssd_kernel=False`` (hymba)
its no-cache forward too, through the sequential oracle
``kref.ssd_scan``, which computes the kernel's function
(``tests/test_kernels.py:test_ssd_with_initial_state``); on the card
the port runs no plain version on its path, so it lowers those scans
onto the kernel, as it lowers the reference's jnp norms and attention.
A one-token decode step uses the single-step recurrence (``_ssd_step``,
the reference's ``kref.ssd_step``), which has no Pallas counterpart.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from .nn import dtype_of, param


def ssm_dims(cfg: ModelConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return d_inner, n_heads, conv_dim


def init_ssm(gen, cfg: ModelConfig, *, device):
    d = cfg.d_model
    d_inner, H, conv_dim = ssm_dims(cfg)
    G, N = cfg.ssm_groups, cfg.ssm_state
    dt = dtype_of(cfg.param_dtype)
    f32 = torch.float32
    d_in_proj = 2 * d_inner + 2 * G * N + H
    kw = dict(device=device)
    return {
        "in_proj": param(gen, (d, d_in_proj), ("embed", "act_mlp"), dt, **kw),
        "conv_w": param(gen, (cfg.ssm_conv, conv_dim), ("conv", "act_mlp"), dt,
                        scale=1.0 / math.sqrt(cfg.ssm_conv), **kw),
        "conv_b": param(gen, (conv_dim,), ("act_mlp",), dt, init="zeros", **kw),
        "A_log": param(gen, (H,), ("heads",), f32, init="ones", **kw),
        "D": param(gen, (H,), ("heads",), f32, init="ones", **kw),
        "dt_bias": param(gen, (H,), ("heads",), f32, init="zeros", **kw),
        "norm": param(gen, (d_inner,), ("act_mlp",), dt, init="zeros", **kw),
        "out_proj": param(gen, (d_inner, d), ("act_mlp", "embed"), dt,
                          scale=0.02 / math.sqrt(2 * max(cfg.n_layers, 1)), **kw),
    }


def _split_proj(zxbcdt, cfg: ModelConfig):
    d_inner, H, _ = ssm_dims(cfg)
    G, N = cfg.ssm_groups, cfg.ssm_state
    z = zxbcdt[..., :d_inner]
    x = zxbcdt[..., d_inner:2 * d_inner]
    Bm = zxbcdt[..., 2 * d_inner:2 * d_inner + G * N]
    C = zxbcdt[..., 2 * d_inner + G * N:2 * d_inner + 2 * G * N]
    dt_raw = zxbcdt[..., 2 * d_inner + 2 * G * N:]
    return z, x, Bm, C, dt_raw


def _causal_conv(xbc, w, b, *, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv.  xbc: [B,S,C]; w: [K,C].  With ``state``
    ([B,K-1,C], decode), prepends it and returns (y, new_state)."""
    K = w.shape[0]
    if state is not None:
        full = torch.cat([state.to(xbc.dtype), xbc], dim=1)
        new_state = full[:, -(K - 1):] if K > 1 else state
    else:
        full = F.pad(xbc, (0, 0, K - 1, 0))
        new_state = None
    S = xbc.shape[1]
    y = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(K):
        y = y + full[:, i:i + S].float() * w[i].float()
    y = F.silu(y + b.float()).to(xbc.dtype)
    return y, new_state


def _gated_norm(x, z, scale, eps):
    return ops.rmsnorm(x * F.silu(z.float()).to(x.dtype), scale, eps=eps,
                       weight_offset=1.0)


def _ssd_step(x, dt, A, Bm, C, state):
    """One decode step of the SSD recurrence → (y, new_state): x [B,H,P],
    dt [B,H], Bm and C [B,G,N], state [B,H,P,N] (``kref.ssd_step``)."""
    rep = x.shape[1] // Bm.shape[1]
    Bh = Bm.repeat_interleave(rep, dim=1)
    Ch = C.repeat_interleave(rep, dim=1)
    decay = torch.exp(A[None, :] * dt)
    new = decay[..., None, None] * state.float() + (
        dt[..., None, None] * (x[..., :, None] * Bh[:, :, None, :])).float()
    y = torch.einsum("bhpn,bhn->bhp", new, Ch.float()).to(x.dtype)
    return y, new


def scan_inputs(p, xin: torch.Tensor, cfg: ModelConfig, *,
                conv_state: Optional[torch.Tensor] = None):
    """The SSD scan's inputs of ``xin [B,S,D]``: ``(z, x [B,S,H,P], dt
    [B,S,H] float32, A [H] float32, Bm and C [B,S,G,N], new conv state)``
    (in_proj, the causal conv with ``conv_state`` prepended, softplus)."""
    B, S, _ = xin.shape
    d_inner, H, _ = ssm_dims(cfg)
    G, N, P = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_head_dim
    zxbcdt = xin @ p["in_proj"].to(xin.dtype)
    z, x, Bm, C, dt_raw = _split_proj(zxbcdt, cfg)

    xbc = torch.cat([x, Bm, C], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], state=conv_state)
    x = xbc[..., :d_inner]
    Bm = xbc[..., d_inner:d_inner + G * N]
    C = xbc[..., d_inner + G * N:]

    dt_v = F.softplus(dt_raw.float() + p["dt_bias"][None, None, :])
    A = -torch.exp(p["A_log"].float())  # [H] negative
    return (z, x.reshape(B, S, H, P), dt_v, A, Bm.reshape(B, S, G, N),
            C.reshape(B, S, G, N), new_conv)


def apply_ssm(p, xin: torch.Tensor, cfg: ModelConfig, *,
              cache: Optional[Dict] = None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """xin: [B,S,D] → (y [B,S,D], new_cache | None).

    cache = {"conv": [B,K-1,conv_dim], "state": [B,H,P,N]} for decode.
    """
    B, S, _ = xin.shape
    d_inner = ssm_dims(cfg)[0]
    z, xh, dt_v, A, Bg, Cg, new_conv = scan_inputs(
        p, xin, cfg, conv_state=cache["conv"] if cache is not None else None)

    if cache is not None and S == 1:
        yh, last = _ssd_step(xh[:, 0], dt_v[:, 0], A, Bg[:, 0], Cg[:, 0], cache["state"])
        y = yh[:, None]
    else:
        y, last = ops.ssd_scan(xh, dt_v, A, Bg, Cg, chunk=cfg.ssm_chunk, return_state=True,
                               init_state=cache["state"] if cache is not None else None)

    y = y + xh * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B, S, d_inner)
    y = _gated_norm(y, z, p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(xin.dtype)

    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv, "state": last}
    return out, new_cache
