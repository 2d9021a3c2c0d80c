"""Named rank grid on one device — the port's stand-in for a JAX mesh.

The JAX package spreads ranks over devices with ``jax.sharding.Mesh``.
The port holds *every* rank on one GPU: a buffer keeps the reference's
global layout ``(gx, gy, gz, *local)``, its leading dimensions are the
rank axes, and a channel is an on-device copy that permutes along them.
A :class:`Mesh` therefore carries only what that needs: the named axes
and their sizes, the device, the linear rank of a coordinate, and the
static ``(src, dst)`` rank pairs of a peer.

Entry points run on the card: :func:`make_mesh` without ``device=``
means CUDA and raises where there is none.  Tests pass
``device="cpu"`` explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device: torch.device

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes, dtype=np.int64))

    def linear_rank(self, coords: Sequence[int]) -> int:
        """Row-major rank of a coordinate over all mesh axes."""
        return int(np.ravel_multi_index(tuple(coords), self.axis_sizes))

    def pairs(self, peer) -> List[Tuple[int, int]]:
        """Static ``(src, dst)`` pairs of ``peer`` over its own axes
        (``descriptors.perm_for``, the ppermute permutation)."""
        from .core.descriptors import perm_for
        return list(perm_for(peer, self.shape)[1])

    def rank_sources(self, axes: Tuple[str, ...],
                     perm: Sequence[Tuple[int, int]]) -> np.ndarray:
        """For every rank of the mesh, the rank it receives from when
        ``perm`` (pairs linearized over ``axes``) moves data along
        ``axes``; ``-1`` where no pair targets it (ppermute zero-fills
        those ranks).  Axes not in ``axes`` keep their coordinate."""
        pos = [self.axis_names.index(a) for a in axes]
        dims = tuple(self.axis_sizes[p] for p in pos)
        src_of = {int(d): int(s) for s, d in perm}
        out = np.full(self.size, -1, dtype=np.int64)
        for rank, coord in enumerate(np.ndindex(*self.axis_sizes)):
            sub = int(np.ravel_multi_index(tuple(coord[p] for p in pos), dims))
            if sub not in src_of:
                continue
            src = list(coord)
            for p, c in zip(pos, np.unravel_index(src_of[sub], dims)):
                src[p] = int(c)
            out[rank] = self.linear_rank(src)
        return out


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device=None) -> Mesh:
    """A rank grid of ``shape`` over ``axes`` on one device.

    ``device=None`` means the current CUDA device; without a GPU that
    raises instead of sliding to the CPU.  Pass ``device="cpu"`` to run
    the plain PyTorch versions of the kernels (tests do).
    """
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} must align")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
    return Mesh(axes, shape, resolve_device(device, "make_mesh"))


def resolve_device(device, who: str) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    device, and raises without a GPU instead of sliding to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device is available; pass device='cpu' "
            f"to run the port's plain PyTorch path on the host")
    return torch.device("cuda", torch.cuda.current_device())
