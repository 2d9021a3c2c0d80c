"""Hopper kernel of the embedding lookup's backward: wrapper, autograd
Function and launch counter.

The hand-written CUDA kernel ``csrc/embedding.cu`` (built for ``sm_90a``
at first use by :mod:`.build`) replaces no Pallas kernel: the JAX package
differentiates its lookup (``jnp.take`` of the table cast to the compute
dtype, ``src/repro/models/nn.py:94-98``) with XLA, whose VJP is a
scatter-add that adds each id's rows in ascending token position,
rounding to the compute dtype after every add.  The kernel computes that
sum in that order (:func:`.ref.embedding_bwd` is its plain version), with
no float atomics, so the gradient is the reference's bits on the CPU and
the same bits on every run and in a CUDA graph on the card.  Autograd of
``torch.index_select`` would add such rows with float atomics on the card
(and in float32, rounded once, on the CPU).  It is bound by bytes: the
table's gradient, every row of it, is written once.

:func:`embedding` is the lookup: ``torch.index_select`` forward and, when
autograd records, :class:`_Lookup`, whose backward is
:func:`embedding_bwd`.  For CPU (and meta) tensors that runs the plain
version, and only then; for CUDA tensors it sorts the ids (a stable
``torch.sort`` of int32 ids, which lie in ``[0, vocab)``: an exact integer
permutation) and launches the kernel, or raises.  ``embedding_bwd.launches`` counts its launches (a launch recorded
into a CUDA graph counts once, at capture).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import ref
from .build import check_launch, load_library, stream_arg, use_plain

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: the C entry point of ``csrc/embedding.cu`` and its argument types
SIGNATURES = {"rt_embedding_bwd": [_I, _P, _I64, _P, _P, _P, _I64, _P, _I64, _I, _I, _P]}
#: the columns of a table row one warp writes: its serial chains (an id's
#: rows added in order) run in parallel across the row's slices, and the
#: rows no id selects take fewer warps the wider a slice is; 512 measured
#: best of 256, 512 and 1024 over distinct, 16-valued and one-id batches
#: (``scripts/embedding_bwd_times.py``)
SLICE_COLS = 512


def embedding_bwd(dy: torch.Tensor, ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """The table's gradient ``[vocab, D]`` in dy's dtype for the rows
    ``dy`` ``[T, D]`` looked up at ``ids`` ``[T]`` (integer): each id's
    rows added in ascending position from zero, every add rounded to dy's
    dtype; rows no id selects zero (:func:`.ref.embedding_bwd`).

    On the card a stable sort of the ids, then ``csrc/embedding.cu``: a
    memset and a kernel that mark where each id's run starts, and the
    kernel that writes every row of the result (one counted launch);
    nothing is read back on the host, so it can be captured.  It takes
    float32 or bf16 ``dy`` with unit stride along D (any row stride);
    anything else raises."""
    if dy.dim() != 2 or ids.dim() != 1 or ids.shape[0] != dy.shape[0]:
        raise ValueError(f"embedding_bwd takes dy [T, D] and ids [T], got "
                         f"{tuple(dy.shape)} and {tuple(ids.shape)}")
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"embedding_bwd: ids of {ids.dtype}, want int32 or int64")
    if use_plain(dy, ids):
        return ref.embedding_bwd(dy, ids, vocab)
    if dy.dtype not in _DTYPE_CODE:
        raise ValueError(f"the embedding_bwd kernel takes float32 or bfloat16, got {dy.dtype}")
    if dy.stride(1) != 1 and dy.shape[1] > 1 and dy.shape[0] > 0:
        raise ValueError(f"the embedding_bwd kernel takes dy with unit stride along D, got "
                         f"strides {tuple(dy.stride())}")
    T, D = dy.shape
    out = torch.empty((vocab, D), dtype=dy.dtype, device=dy.device)
    first = torch.empty(vocab, dtype=torch.int32, device=dy.device)
    sorted_ids, order = torch.sort(ids.int(), stable=True)
    lib = load_library("embedding", SIGNATURES)
    check_launch("embedding", lib.rt_embedding_bwd(
        _DTYPE_CODE[dy.dtype], dy.data_ptr(), dy.stride(0), sorted_ids.data_ptr(),
        order.data_ptr(), first.data_ptr(), T, out.data_ptr(), vocab, D, SLICE_COLS,
        stream_arg(dy)))
    embedding_bwd.launches += 1
    return out


class _Lookup(torch.autograd.Function):
    """``table[ids]`` by ``index_select``, with :func:`embedding_bwd` as
    its backward."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.vocab = table.shape[0]
        return torch.index_select(table, 0, ids)

    @staticmethod
    def backward(ctx, dy):
        (ids,) = ctx.saved_tensors
        dy = dy.reshape(-1, dy.shape[-1])
        if dy.stride(1) != 1:
            dy = dy.contiguous()
        return embedding_bwd(dy, ids, ctx.vocab), None


def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` ``[V, D]`` at the flat ``ids`` ``[T]``:
    ``[T, D]``.  When autograd records a table that requires grad, the
    table's gradient is :func:`embedding_bwd` (the reference's order)."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _Lookup.apply(table, ids)
    return torch.index_select(table, 0, ids)


embedding_bwd.launches = 0


def launch_counts() -> Dict[str, int]:
    return {"embedding_bwd": embedding_bwd.launches}


def reset_launches() -> None:
    embedding_bwd.launches = 0
