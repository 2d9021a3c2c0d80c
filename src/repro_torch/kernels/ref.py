"""Plain PyTorch versions of the halo kernels, over the global layout.

Port of the halo part of ``repro.kernels.ref``.  Each function here is
the semantic ground truth of one hand-written CUDA kernel in
:mod:`.halo_pack`: the wrappers there call it for CPU tensors, and
``chip_smoke.py`` holds each kernel against it on the card, bit for
bit.  Tensors carry every rank: leading dimensions are rank axes, the
last three (for the halo pack family) the local ``(px, py, pz)`` block.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def region3(region: Sequence[slice]) -> Tuple[slice, slice, slice]:
    """Validate a static 3-D region: three unit-step slices with
    explicit bounds (``core.halo._region_for`` gives such regions)."""
    region = tuple(region)
    if len(region) != 3 or not all(
            isinstance(s, slice) and isinstance(s.start, int)
            and isinstance(s.stop, int) and s.step in (None, 1)
            and 0 <= s.start <= s.stop for s in region):
        raise ValueError(f"halo region must be three unit-step slices with "
                         f"explicit bounds, got {region!r}")
    return region


def region_shape(region: Sequence[slice]) -> Tuple[int, ...]:
    return tuple(s.stop - s.start for s in region)


def halo_pack(u: torch.Tensor, region: Sequence[slice]) -> torch.Tensor:
    """Copy one static boundary region of every rank's block into a new
    contiguous slab ``(*ranks, *region)``."""
    return u[(..., *region3(region))].clone(memory_format=torch.contiguous_format)


def halo_unpack_add(u: torch.Tensor, msg: torch.Tensor,
                    region: Sequence[slice]) -> torch.Tensor:
    """Add ``msg`` into every rank's ``region`` of ``u``, in place, cast
    to ``u``'s dtype (one float add, rounded once); returns ``u``."""
    u[(..., *region3(region))] += msg.to(u.dtype)
    return u


def pack_segments(sources: Sequence[Tuple[torch.Tensor, int]],
                  sizes: Sequence[int]) -> torch.Tensor:
    """Pack N member slabs into one ``(R, sum(sizes))`` staging buffer.

    Member ``j`` is columns ``[col, col + sizes[j])`` of the 2-D
    ``(R, W)`` tensor ``sources[j] = (tensor, col)``: a whole slab
    flattened per rank (``col = 0``), or a segment of an earlier hop's
    received buffer.  Members land at consecutive column offsets.
    """
    first = sources[0][0]
    out = torch.empty((first.shape[0], sum(sizes)), dtype=first.dtype,
                      device=first.device)
    off = 0
    for (src, col), n in zip(sources, sizes):
        out[:, off:off + n].copy_(src[:, col:col + n])
        off += n
    return out


def unpack_segments(buf: torch.Tensor, outs: Sequence[torch.Tensor],
                    offsets: Sequence[int],
                    masks: Optional[torch.Tensor] = None) -> None:
    """Split a received ``(R, S)`` staging buffer into N slabs, in place.

    ``outs[j]`` (``R * n_j`` elements) takes columns ``[offsets[j],
    offsets[j] + n_j)`` of every rank whose ``masks[j, rank]`` is set
    (all ranks when ``masks`` is None); other ranks keep their values,
    as a replace deposit keeps a rank that has no sender.
    """
    n_ranks = buf.shape[0]
    for j, (out, off) in enumerate(zip(outs, offsets)):
        view = out.view(n_ranks, -1)
        piece = buf[:, off:off + view.shape[1]]
        if masks is not None:
            piece = torch.where(masks[j].view(n_ranks, 1), piece, view)
        view.copy_(piece)
