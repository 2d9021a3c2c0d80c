"""Hopper kernel of RMSNorm: wrapper and launch counter.

The hand-written CUDA kernel ``csrc/rmsnorm.cu`` (built for ``sm_90a``
at first use by :mod:`.build`) replaces ``rmsnorm_call``
(``src/repro/kernels/rmsnorm.py:28``), which the JAX package reaches
through ``kernels/ops.py:rmsnorm``.  It is bound by bytes (each row read
and written once); the source says how its design meets that.

For CPU tensors the wrapper runs the plain version (:func:`.ref.rmsnorm`),
and only then; for CUDA tensors it launches the kernel or raises.
``rmsnorm.launches`` counts the kernel launches it made (a launch
recorded into a CUDA graph counts once, at capture).
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import ref
from .build import check_launch, load_library, stream_arg, use_plain

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
#: the C entry point of ``csrc/rmsnorm.cu`` and its argument types
SIGNATURES = {"rt_rmsnorm": [_I, _I, _P, _P, _P, _I64, _I, _I64, _F, _F, _P]}


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            weight_offset: float = 0.0) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · (w + weight_offset)`` over the last
    dimension of ``x`` (any leading dimensions), statistics in float32,
    returned in x's dtype as a new contiguous tensor.

    On the card, ONE launch normalises every row, a warp per row.  x may
    be a strided view whose leading dimensions merge into one row axis
    (unit stride in the last); the kernel reads it in place.
    """
    d = x.shape[-1] if x.dim() else 0
    if x.dim() == 0 or tuple(w.shape) != (d,):
        raise ValueError(f"rmsnorm takes x [..., d] and w [d], got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if use_plain(x, w):
        return ref.rmsnorm(x, w, eps=eps, weight_offset=weight_offset)
    if x.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise TypeError(f"the rmsnorm kernel takes float32 or bfloat16, got x "
                        f"{x.dtype} and w {w.dtype}")
    if d >= 2 ** 31:
        raise ValueError(f"the rmsnorm kernel takes d < 2^31, got {d}")
    try:
        x2 = x.view(-1, d)
    except RuntimeError:
        raise ValueError("the rmsnorm kernel takes x whose leading dimensions merge "
                         "into one row axis without a copy") from None
    if d > 1 and x2.stride(1) != 1 or not w.is_contiguous():
        raise ValueError("the rmsnorm kernel takes unit stride along d and a "
                         "contiguous w")
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    err = load_library("rmsnorm", SIGNATURES).rt_rmsnorm(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], x2.data_ptr(), w.data_ptr(),
        y.data_ptr(), x2.shape[0], d, x2.stride(0), float(eps), float(weight_offset),
        stream_arg(x))
    check_launch("rmsnorm", err)
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0


def launch_counts() -> Dict[str, int]:
    return {"rmsnorm": rmsnorm.launches}


def reset_launches() -> None:
    rmsnorm.launches = 0
