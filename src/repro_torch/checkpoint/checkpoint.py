"""Numpy checkpoints of trees of tensors — port of
``repro.checkpoint.checkpoint``.

The reference's layout: ``<dir>/step_<N>/arrays.npz`` plus
``manifest.json`` (step, each key's shape and dtype, ``extra``).  A key
is the leaf's path, dict keys and list indices joined by ``/``, as the
reference's ``tree_flatten_with_path`` names them; bfloat16 is saved as
float32.  So a checkpoint written by either package restores in the
other.  The port walks dicts, lists and tuples itself.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def _paths(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:  # numpy has no bfloat16
            t = t.float()
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    return arr.astype(np.float32) if arr.dtype.name == "bfloat16" else arr


def save_pytree(directory: str, step: int, tree: Any, *,
                extra: Optional[Dict] = None) -> str:
    d = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(d, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in _paths(tree)}
    np.savez(os.path.join(d, "arrays.npz"), **arrays)
    manifest = {
        "step": step,
        "keys": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                 for k, v in arrays.items()},
        "extra": extra or {},
    }
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return d


def restore_pytree(directory: str, step: int, like: Any) -> Any:
    """The checkpoint in the structure of ``like``: a tensor leaf comes
    back as a new tensor of its dtype on its device, any other leaf as the
    saved numpy array.  A key missing from the checkpoint raises
    ``KeyError``."""
    d = os.path.join(directory, f"step_{step:08d}")
    data = np.load(os.path.join(d, "arrays.npz"))

    def build(tree, prefix):
        if isinstance(tree, dict):
            return {k: build(v, prefix + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v, prefix + (str(i),)) for i, v in enumerate(tree))
        arr = data["/".join(prefix)]
        if isinstance(tree, torch.Tensor):
            return torch.from_numpy(np.array(arr)).to(device=tree.device, dtype=tree.dtype)
        return arr

    return build(like, ())


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"step_(\d+)$", f))]
    return max(steps) if steps else None
