"""Hopper kernel of flash-attention (forward): wrapper and launch counter.

The hand-written CUDA kernel ``csrc/flash_attention.cu`` (built for
``sm_90a`` at first use by :mod:`.build`) replaces
``flash_attention_call`` (``src/repro/kernels/flash_attention.py:96``),
which the JAX package reaches through ``kernels/ops.py:flash_attention``.
It is bound by operations (bf16 products summed in float32); the source
says how its first design meets that and why its tiles are sized as
they are.

For CPU tensors the wrapper runs the plain version
(:func:`.ref.attention`), and only then; for CUDA tensors it launches the
kernel or raises.  ``flash_attention.launches`` counts the kernel
launches it made (a launch recorded into a CUDA graph counts once, at
capture).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import ref
from .build import check_launch, load_library, stream_arg, use_plain

HEAD_DIMS = (16, 32, 64, 128, 256)   # csrc launch_t
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
#: the C entry point of ``csrc/flash_attention.cu`` and its argument types
SIGNATURES = {"rt_flash_attention": [_I] + [_P] * 4 + [_I] * 6 + [_I64] * 12
              + [_F, _F, _I, _I, _I, _P]}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    window: Optional[int] = None,
                    logit_softcap: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Attention of q ``[B,Hq,Sq,D]`` against k, v ``[B,Hkv,Skv,D]``
    (``Hq % Hkv == 0``), query ``i`` at global position ``q_offset + i``;
    ``causal`` and a sliding ``window`` (tokens of lookback) mask keys,
    ``logit_softcap`` caps the scaled logits with ``tanh``, and a row that
    sees no key gives zeros.  Returns ``[B,Hq,Sq,D]`` in q's dtype.

    On the card, one launch; q, k and v may be strided views (unit stride
    along D), as the model's ``[B,S,H,D]`` tensors transposed are, and the
    result is a ``[B,Hq,Sq,D]`` view of memory laid out ``[B,Sq,Hq,D]``,
    so that the model's transpose back is free too.
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q [B,Hq,Sq,D], k and v [B,Hkv,Skv,D]")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hkv, Skv, D) or tuple(v.shape) != (B, Hkv, Skv, D):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} query heads do not split into "
                         f"{Hkv} kv heads")
    if use_plain(q, k, v):
        return ref.attention(q, k, v, causal=causal, scale=scale, window=window,
                             logit_softcap=logit_softcap, q_offset=q_offset)
    if D not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {D}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash_attention kernel takes q, k, v of one dtype, "
                        f"float32 or bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the flash_attention kernel takes unit stride along D")
    if max(B, Hq) > 65535 or max(Sq, Skv, abs(q_offset) + Sq + Skv) >= 2 ** 31:
        raise ValueError("flash_attention: shape beyond the kernel's grid")
    scale = D ** -0.5 if scale is None else float(scale)
    softcap = 0.0 if logit_softcap is None else float(logit_softcap)
    if window is not None and int(window) < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    err = load_library("flash_attention", SIGNATURES).rt_flash_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, Sq, Skv, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], scale, softcap, int(bool(causal)),
        -1 if window is None else int(window), int(q_offset), stream_arg(q))
    check_launch("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def launch_counts() -> Dict[str, int]:
    return {"flash_attention": flash_attention.launches}


def reset_launches() -> None:
    flash_attention.launches = 0
