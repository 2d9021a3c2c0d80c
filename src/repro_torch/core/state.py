"""Program buffers as tensors: layouts, allocation and carrying state
across.

A buffer is declared, as in the reference, by its *global* shape and a
partition spec over the mesh axes.  One GPU holds every rank, so an
engine stores each buffer in one of two layouts:

* **rank-major** (the spec's leading entries are the mesh axes in
  order, over leading dims of exactly the axis sizes, and nothing else
  is partitioned — every Faces buffer): stored as the global tensor
  itself, ``(gx, gy, gz, *rest)``; a kernel sees it whole.
* **stacked** (anything else: a dim sharded over an axis, ``(axis,)`` on
  dim 0 or ``(None, axis)`` on dim 1, or replicated ``()``): stored as
  the stack of its rank-local blocks, ``(R, *local)`` with ``R`` the
  mesh's ranks in row-major order.  A replicated buffer is held once a
  rank, because ranks hold different values mid-ring.

Either way a channel is a permute along the leading rank dimension(s).
:func:`to_storage` and :func:`to_global` convert between the
reference's global arrays and the stored form; the engines take and
return the global form.  A replicated buffer's global value is rank
0's copy (along every axis it is replicated over), which is what
``np.asarray`` of the reference's replicated output returns.

Faces has no weights: its field and message buffers are the whole
state.  :func:`from_reference` turns a JAX engine's buffer dict (as
numpy arrays) into the port's tensors for the same program, and
:func:`to_numpy` goes back, so a run can start in one package and be
checked in the other.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

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


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None or entry == ():
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _dim_axes(spec) -> Tuple[Tuple[str, ...], ...]:
    pspec = tuple(spec.pspec) + (None,) * (len(spec.shape) - len(spec.pspec))
    return tuple(_entry_axes(e) for e in pspec)


def is_rank_major(spec, mesh) -> bool:
    """True when the engines store ``spec`` as its global tensor (module
    docstring)."""
    k = len(mesh.axis_names)
    return (tuple(spec.pspec[:k]) == tuple(mesh.axis_names)
            and tuple(spec.shape[:k]) == tuple(mesh.axis_sizes)
            and all(p is None for p in spec.pspec[k:]))


def local_shape(spec, mesh) -> Tuple[int, ...]:
    """The reference's per-rank block shape of ``spec``."""
    sizes = mesh.shape
    out = []
    for dim, axes in zip(spec.shape, _dim_axes(spec)):
        k = 1
        for a in axes:
            k *= sizes[a]
        if dim % k:
            raise ValueError(f"buffer {spec.name!r}: dim {dim} does not divide "
                             f"by the mesh factor {k} of {axes}")
        out.append(dim // k)
    return tuple(out)


def storage_shape(spec, mesh) -> Tuple[int, ...]:
    """The shape an engine stores ``spec`` in."""
    if is_rank_major(spec, mesh):
        return tuple(spec.shape)
    return (mesh.size,) + local_shape(spec, mesh)


def _split_dims(spec, mesh):
    """The global dims split into ``(*axis sizes, local)`` per dim, with a
    label per split dim: an axis name, or the local dim's index."""
    sizes, labels, shape = mesh.shape, [], []
    for d, (axes, loc) in enumerate(zip(_dim_axes(spec), local_shape(spec, mesh))):
        for a in axes:
            labels.append(a)
            shape.append(sizes[a])
        labels.append(d)
        shape.append(loc)
    return labels, shape


def to_storage(spec, mesh, t: torch.Tensor) -> torch.Tensor:
    """The stored form (contiguous) of a global-layout tensor ``t``."""
    if is_rank_major(spec, mesh):
        return t if t.is_contiguous() else t.contiguous()
    labels, shape = _split_dims(spec, mesh)
    x = t.reshape(shape)
    used = [a for a in mesh.axis_names if a in labels]
    x = x.permute([labels.index(a) for a in used]
                  + [i for i, l in enumerate(labels) if not isinstance(l, str)])
    # replicated axes: one copy a rank
    view = []
    for a, n in zip(mesh.axis_names, mesh.axis_sizes):
        view.append(n if a in used else 1)
    x = x.reshape(*view, *x.shape[len(used):])
    x = x.expand(*mesh.axis_sizes, *x.shape[len(view):])
    return x.reshape(mesh.size, *local_shape(spec, mesh)).contiguous()


def to_global(spec, mesh, t: torch.Tensor) -> torch.Tensor:
    """The global layout of a stored tensor ``t`` (a view where the
    layout allows; rank 0's copy along replicated axes)."""
    if is_rank_major(spec, mesh):
        return t
    labels, _ = _split_dims(spec, mesh)
    loc = local_shape(spec, mesh)
    x = t.reshape(*mesh.axis_sizes, *loc)
    index = tuple(slice(None) if a in labels else 0 for a in mesh.axis_names)
    x = x[index]
    used = [a for a in mesh.axis_names if a in labels]
    pos = {a: i for i, a in enumerate(used)}
    order = [pos[l] if isinstance(l, str) else len(used) + l for l in labels]
    return x.permute(order).reshape(spec.shape)


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
