"""Deterministic synthetic token pipeline — port of
``repro.data.synthetic``.

``SyntheticTokens.batch(step)`` draws from the same
``np.random.RandomState`` stream as the reference, so a batch equals
the reference's exactly: token t+1 = (token t + drift) mod vocab, with a
fraction of tokens replaced by noise, seeded per (seed, step).
:meth:`SyntheticTokens.device_batch` puts it on a torch device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    seed: int = 0
    drift: int = 7          # deterministic next-token multiplier
    noise_frac: float = 0.1  # fraction of tokens replaced by noise


class SyntheticTokens:
    """Stateless batch source: ``batch(step)`` is pure in (seed, step)."""

    def __init__(self, model_cfg: ModelConfig, shape: ShapeConfig,
                 cfg: SyntheticConfig = SyntheticConfig()):
        self.model_cfg = model_cfg
        self.shape = shape
        self.cfg = cfg

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        mc, sh, cfg = self.model_cfg, self.shape, self.cfg
        rng = np.random.RandomState((cfg.seed * 100003 + step) % (2**31 - 1))
        B, S = sh.global_batch, sh.seq_len
        start = rng.randint(0, mc.vocab, (B, 1))
        steps = np.arange(S + 1)[None, :]
        seq = (start + cfg.drift * steps) % mc.vocab
        noise_mask = rng.rand(B, S + 1) < cfg.noise_frac
        noise = rng.randint(0, mc.vocab, (B, S + 1))
        seq = np.where(noise_mask, noise, seq).astype(np.int32)
        out = {"tokens": seq[:, :S], "targets": seq[:, 1:]}
        if mc.enc_dec:
            out["audio_embeds"] = rng.randn(
                B, mc.frontend_tokens, mc.frontend_dim).astype(np.float32)
        if mc.frontend == "vision":
            out["vision_embeds"] = rng.randn(
                B, mc.frontend_tokens, mc.frontend_dim).astype(np.float32)
        return out

    def device_batch(self, step: int, device) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in self.batch(step).items()}


def make_batch_specs(model_cfg: ModelConfig, shape: ShapeConfig):
    """Logical axes of each batch entry."""
    specs = {"tokens": ("batch", "seq"), "targets": ("batch", "seq")}
    if model_cfg.enc_dec:
        specs["audio_embeds"] = ("batch", None, "frontend")
    if model_cfg.frontend == "vision":
        specs["vision_embeds"] = ("batch", None, "frontend")
    return specs
