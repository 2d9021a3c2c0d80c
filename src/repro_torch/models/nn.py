"""Core NN building blocks of the port: the subset the SSM path uses.

Port of ``repro.models.nn``: parameter init, RMSNorm, token embedding
and the (tied) unembedding, as plain functions on dicts of tensors, in
the reference's layout.  Weights are stored in ``cfg.param_dtype`` and
cast to the compute dtype at each use, as the reference does; the cast
is free when a caller has cast them once already (``launch.serve``).
RMSNorm is plain torch here because the reference's models call the jnp
form too, not ``rmsnorm_call``.  The unembedding is tied to the
embedding table, as in mamba2-2.7b.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig


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


def param(gen: Optional[torch.Generator], shape, dtype, *, device,
          scale: Optional[float] = None, init: str = "normal") -> torch.Tensor:
    """A parameter as the reference initialises it: ``normal × scale``
    (0.02 by default), zeros or ones.  On the ``meta`` device (shapes
    only) nothing is drawn."""
    if init not in ("normal", "zeros", "ones"):
        raise ValueError(init)
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    v = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return v.mul_(0.02 if scale is None else scale)


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def init_rmsnorm(d: int, dtype, *, device):
    # stored at zero; applied as (scale + 1), as in the reference
    return {"scale": param(None, (d,), dtype, device=device, init="zeros")}


def apply_rmsnorm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + cfg.norm_eps)
    return (y * (p["scale"].float() + 1.0)).to(x.dtype)


def init_embedding(gen, cfg: ModelConfig, *, device):
    return {"table": param(gen, (cfg.vocab, cfg.d_model),
                           dtype_of(cfg.param_dtype), device=device)}


def apply_embedding(p, ids: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    table = p["table"].to(dtype_of(cfg.dtype))
    return torch.index_select(table, 0, ids.reshape(-1)).reshape(*ids.shape, -1)


def apply_unembed(p_embed, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits against the embedding table."""
    return x @ p_embed["table"].to(x.dtype).t()
