"""Program buffers as tensors: allocation and carrying state across.

Faces has no weights: its field and message buffers are the whole
state.  :func:`from_reference` turns a JAX engine's buffer dict (as
numpy arrays) into the port's tensors for the same program, and
:func:`to_numpy` goes back, so a run can start in one package and be
checked in the other.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def to_tensor(x: Any, dtype: torch.dtype, device) -> torch.Tensor:
    """A new contiguous ``dtype`` tensor on ``device`` holding ``x`` (a
    tensor, or anything numpy reads — including the JAX package's
    bfloat16 arrays, which go through float32 losslessly)."""
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        if a.dtype.kind not in "biuf":
            a = a.astype(np.float32)
        x = torch.from_numpy(np.array(a, order="C"))  # a writable copy
        return x.to(device=device, dtype=dtype).contiguous()
    return x.to(device=device, dtype=dtype, copy=True).contiguous()


def init_buffers(program, init: Optional[Dict[str, Any]] = None,
                 device=None) -> Dict[str, torch.Tensor]:
    """One tensor per program buffer on ``device`` (default: the mesh's):
    ``init[name]`` where given, zeros elsewhere."""
    init = init or {}
    device = program.mesh.device if device is None else torch.device(device)
    out = {}
    for name, spec in program.buffers.items():
        if name in init:
            t = to_tensor(init[name], spec.dtype, device)
            if tuple(t.shape) != tuple(spec.shape):
                raise ValueError(f"buffer {name!r}: got shape {tuple(t.shape)}, "
                                 f"program declares {spec.shape}")
            out[name] = t
        else:
            out[name] = torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    return out


def from_reference(mem_np: Dict[str, Any], program,
                   device=None) -> Dict[str, torch.Tensor]:
    """The port's buffers from a JAX engine's (``{name: np.asarray(a)}``)
    for the same program; every buffer of ``program`` must be present."""
    missing = sorted(set(program.buffers) - set(mem_np))
    if missing:
        raise KeyError(f"reference state lacks buffers {missing}")
    return init_buffers(program, {n: mem_np[n] for n in program.buffers},
                        device=device)


def to_numpy(mem: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Host copies of a buffer dict (bfloat16 widened to float32)."""
    out = {}
    for name, t in mem.items():
        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[name] = t.cpu().numpy()
    return out
