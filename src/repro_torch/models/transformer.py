"""Layer stacks — port of the ``ssm`` segment of ``repro.models.transformer``.

A trunk is a list of segments, runs of structurally identical layers.
The port has the ``ssm`` kind only (mamba2); the other kinds raise
``NotImplementedError`` until ``ROADMAP.md`` brings them.  Parameters
keep the reference's layout — stacked with a leading ``layers`` axis
when ``cfg.scan_layers``, a list of per-layer dicts when not — and the
layers run as a Python loop over views of them.  Caches are stacked per
segment: ``conv [L,B,K-1,conv_dim]`` in ``cfg.dtype`` and ``state
[L,B,H,P,N]`` in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from . import ssm as ssm_lib
from .nn import apply_rmsnorm, dtype_of, init_rmsnorm, tree_map


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str
    n_layers: int


def plan_segments(cfg: ModelConfig) -> List[Segment]:
    if cfg.arch_type == "ssm" and not cfg.enc_dec:
        return [Segment("ssm", cfg.n_layers)]
    raise NotImplementedError(
        f"{cfg.name}: only the ssm segment (mamba2) is ported to repro_torch; "
        f"see ROADMAP.md")


def init_block(gen, cfg: ModelConfig, kind: str, *, device):
    if kind != "ssm":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    return {
        "ln_ssm": init_rmsnorm(cfg.d_model, dtype_of(cfg.param_dtype), device=device),
        "ssm": ssm_lib.init_ssm(gen, cfg, device=device),
    }


def apply_block(p, x, cfg: ModelConfig, kind: str, *, cache: Optional[Dict] = None):
    """Returns (y, new_cache)."""
    if kind != "ssm":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    h = apply_rmsnorm(p["ln_ssm"], x, cfg)
    s, sc = ssm_lib.apply_ssm(p["ssm"], h, cfg,
                              cache=cache.get("ssm") if cache else None)
    return x + s, ({"ssm": sc} if sc is not None else {})


def init_stack(gen, cfg: ModelConfig, *, device):
    params = []
    for seg in plan_segments(cfg):
        layers = [init_block(gen, cfg, seg.kind, device=device)
                  for _ in range(seg.n_layers)]
        params.append(_stack(layers) if cfg.scan_layers else layers)
    return {"segments": params}


def _stack(layers: List[Dict]) -> Dict:
    """Per-layer dicts → one dict of tensors with a leading layers axis."""
    first = layers[0]
    if isinstance(first, dict):
        return {k: _stack([l[k] for l in layers]) for k in first}
    return torch.stack(layers)


def _layer(seg_params, i: int):
    """Layer ``i``'s parameters: an entry of the list, or views into the
    stacked tensors."""
    if isinstance(seg_params, list):
        return seg_params[i]
    return tree_map(lambda a: a[i], seg_params)


def apply_stack(params, x, cfg: ModelConfig, *, caches: Optional[List] = None):
    """Run all segments.  Returns (y, new_caches): per segment, the
    stacked new caches (``None`` without caches)."""
    new_caches = []
    for si, seg in enumerate(plan_segments(cfg)):
        seg_cache = caches[si] if caches is not None else None
        seg_new = []
        for i in range(seg.n_layers):
            layer_cache = (tree_map(lambda c, _i=i: c[_i], seg_cache)
                           if seg_cache is not None else None)
            x, nc = apply_block(_layer(params["segments"][si], i), x, cfg, seg.kind,
                                cache=layer_cache)
            seg_new.append(nc)
        new_caches.append(_stack(seg_new) if seg_new and seg_new[0] else None)
    return x, new_caches


def init_caches(cfg: ModelConfig, batch: int, *, device) -> List[Dict[str, Any]]:
    """Per-segment stacked decode caches (zeros): ssm ``conv [L,B,K-1,
    conv_dim]`` in ``cfg.dtype`` and ``state [L,B,H,P,N]`` in float32."""
    caches = []
    for seg in plan_segments(cfg):
        L = seg.n_layers
        _, H, conv_dim = ssm_lib.ssm_dims(cfg)
        caches.append({"ssm": {
            "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, conv_dim),
                                dtype=dtype_of(cfg.dtype), device=device),
            "state": torch.zeros((L, batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                                 dtype=torch.float32, device=device),
        }})
    return caches
