"""Modality frontends — port of ``repro.models.frontends``.

The audio (whisper) and vision (internvl2) feature extractors are stubs
in the reference: the batch supplies precomputed frame or patch
embeddings (``audio_embeds`` / ``vision_embeds``, ``[B, T, F]``), and
this module holds only the projector that maps them into the backbone's
embedding space, plus the sinusoidal positions of the encoder-decoder
family.  The vision projector is InternVL's two-layer MLP (tanh-form
gelu, ``jax.nn.gelu``'s default); the audio one a linear adapter.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from .nn import dtype_of, param


def init_frontend(gen, cfg: ModelConfig, *, device):
    dt = dtype_of(cfg.param_dtype)
    if cfg.frontend == "vision":
        return {"proj_in": param(gen, (cfg.frontend_dim, cfg.d_model), ("frontend", "embed"),
                                 dt, device=device),
                "proj_out": param(gen, (cfg.d_model, cfg.d_model), ("embed", "embed"), dt,
                                  device=device)}
    if cfg.frontend == "audio":
        return {"proj_in": param(gen, (cfg.frontend_dim, cfg.d_model), ("frontend", "embed"),
                                 dt, device=device, scale=0.01)}
    return {}


def apply_frontend(p, embeds: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Project stub embeddings into backbone space: ``[B, T, F] → [B, T, D]``
    in ``cfg.dtype``."""
    dt = dtype_of(cfg.dtype)
    x = embeds.to(dt) @ p["proj_in"].to(dt)
    if "proj_out" in p:
        x = F.gelu(x, approximate="tanh") @ p["proj_out"].to(dt)
    return x


def timescales(d: int, device=None) -> torch.Tensor:
    """``10000 ** (2 i / d)`` for ``i < d/2``: a float32 exponent, the power
    rounded once to float32 (what the reference's float32 ``jnp.power``
    gives; :func:`repro_torch.models.nn.apply_rope` says why)."""
    exps = 2 * torch.arange(d // 2, dtype=torch.float32, device=device) / d
    return torch.pow(torch.full((), 10000.0, dtype=torch.float64, device=device),
                     exps.double()).float()


def sinusoidal_positions(n: int, d: int, dtype=torch.float32, *, device=None) -> torch.Tensor:
    """``[n, d]``: ``sin`` then ``cos`` of ``position / 10000^(2i/d)``,
    computed in float32 and returned in ``dtype``."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    ang = pos / timescales(d, device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)
