"""AdamW with global-norm clipping and a chosen moment dtype — port of
``repro.optim.adamw``.

The arithmetic is the reference's, leaf by leaf: the gradients are
scaled by ``min(1, clip_norm / (global_norm + 1e-12))``, the moments
updated, bias-corrected, and weight decay added only where
``p.ndim >= 2``.  Two differences, both for the card:

* the update works IN PLACE: ``params``, ``state["m"]``, ``state["v"]``
  and ``state["step"]`` are written and returned (the same tensors), so
  that a CUDA graph captured over a training step reads and writes fixed
  addresses, and the card holds one copy of the state (at mamba2-2.7b,
  float32 params, grads and moments take ~43 GB);
* the step counter, the clip scale, the learning rate and the bias
  corrections are 0-d device tensors computed from ``state["step"]``: a
  Python float computed on the host would be frozen into a captured
  graph.

A leaf of more than :data:`CHUNK` elements is updated a chunk at a time
(the same bits: the update is elementwise), so that its float32
temporaries fit beside a full-width MoE model's state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.nn import dtype_of, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"   # float32 | bfloat16


#: elements of a leaf updated at a time: a float32 temporary of a chunk is
#: 1 GiB, where one of a whole full-width expert stack (grok-1's ``wi``,
#: 1.6 B elements) would be 6.4 GB
CHUNK = 1 << 28


def adamw_init(params, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments in ``cfg.moment_dtype`` shaped like ``params``, and
    the int32 step counter, on the params' device."""
    mdt = dtype_of(cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """``sqrt(sum of every leaf's sum of squares)``, in float32."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig,
                 lr: Optional[torch.Tensor] = None) -> Tuple[Any, Dict, Dict]:
    """One AdamW step, in place (see the module docstring); returns
    ``(params, state, {"grad_norm", "lr"})``.  ``lr``: a 0-d tensor or a
    float (``cfg.lr`` by default)."""
    step = state["step"].add_(1)
    device = step.device
    lr = torch.as_tensor(cfg.lr if lr is None else lr, dtype=torch.float32, device=device)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-12), max=1.0)
    step_f = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, step_f)
    bc2 = 1.0 - torch.pow(cfg.b2, step_f)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        decay = bool(cfg.weight_decay) and p.dim() >= 2   # no decay on norms and biases
        for parts in zip(p.view(-1).split(CHUNK), g.reshape(-1).split(CHUNK),
                         m.view(-1).split(CHUNK), v.view(-1).split(CHUNK)):
            _update_leaf(*parts, cfg, scale, lr, bc1, bc2, decay)
    return params, state, {"grad_norm": gnorm, "lr": lr}


def _update_leaf(p, g, m, v, cfg: AdamWConfig, scale, lr, bc1, bc2, decay: bool) -> None:
    """The reference's ``upd`` for one leaf (or a chunk of one: the
    arithmetic is elementwise), written into p, m and v, with at most
    four float32 temporaries of its size."""
    g32 = g.float() * scale
    m32 = m.float()  # m itself when the moments are float32
    m32.mul_(cfg.b1).add_(g32 * (1 - cfg.b1))
    v32 = v.float()
    v32.mul_(cfg.b2).add_((g32 * (1 - cfg.b2)).mul_(g32))
    if m32 is not m:
        m.copy_(m32)
    if v32 is not v:
        v.copy_(v32)
    den = torch.div(v32, bc2).sqrt_().add_(cfg.eps)
    delta = torch.div(m32, bc1, out=g32).div_(den)   # g32 is free: reuse it
    del den
    if decay:
        delta.add_(p.float() * cfg.weight_decay)
    delta.mul_(lr)
    if p.dtype == torch.float32:
        p.sub_(delta)
    else:
        p.copy_(p.float() - delta)
