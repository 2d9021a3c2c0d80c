"""Carry the JAX package's weights and caches into the port, and back.

The port keeps the reference's parameter layout (stacked with a leading
``layers`` axis when ``cfg.scan_layers``, a per-layer list when not), so
a reference tree of numpy arrays — ``jax.tree.map(np.asarray,
repro.models.Model(cfg).init(key)[0])`` — maps leaf for leaf onto the
tree of :meth:`repro_torch.models.Model.init`, the MoE (``moe``: the
router and its bias, the stacked experts, the shared expert), MLA
(``wq_a``, ``q_norm``, ``wq_b``, ``wkv_a``, ``kv_norm``, ``wkv_b``) and
MTP (``mtp``) leaves included, and a cache tree maps onto the port's
(MLA's ``c_kv`` and ``k_rope`` too).  Every leaf is checked against the
port's own shapes and dtypes first.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from .model import Model
from .nn import tree_map


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def from_reference_params(params_np: Dict[str, Any], cfg: ModelConfig,
                          device) -> Dict[str, Any]:
    """The reference's parameters (a tree of numpy arrays) as the port's,
    on ``device``; raises if the trees differ in structure, shape or
    dtype."""
    want = dict(_paths(Model(cfg).abstract_init()))
    got = dict(_paths(params_np))
    if want.keys() != got.keys():
        raise ValueError(f"parameter trees differ: {sorted(want.keys() ^ got.keys())}")
    for path, w in want.items():
        a = np.asarray(got[path])
        if a.shape != tuple(w.shape) or str(a.dtype) != str(w.dtype).split(".")[1]:
            raise ValueError(f"{path}: reference {a.shape} {a.dtype}, port "
                             f"{tuple(w.shape)} {w.dtype}")
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), params_np)


def caches_from_reference(caches_np: Dict[str, Any], device) -> Dict[str, Any]:
    """The reference's cache tree (numpy arrays) as tensors on ``device``."""
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), caches_np)


def caches_to_numpy(caches: Dict[str, Any]) -> Dict[str, Any]:
    """A cache tree of tensors as numpy arrays (bfloat16 widened to float32)."""
    return tree_map(lambda t: (t.float() if t.dtype == torch.bfloat16 else t)
                    .cpu().numpy(), caches)
