"""Hopper kernels of flash-attention, forward and backward: wrappers,
the autograd Function and launch counters.

The hand-written CUDA source ``csrc/flash_attention.cu`` (built for
``sm_90a`` at first use by :mod:`.build`) replaces ``flash_attention_call``
(``src/repro/kernels/flash_attention.py:96``), which the JAX package
reaches through ``kernels/ops.py:flash_attention``.  It is bound by
operations (bf16 products summed in float32); the source says how each
of its kernels meets that and why its tiles are sized as they are.

Head dims come in pairs ``(Dqk, Dv)``: q and k's, and v's (and the
output's).  They are equal but for MLA's (deepseek-v3: 192 = 128 + 64
rope, 128; its smoke config 48, 32).  The route rule, fixed by dtype and
the pair alone:

* ``bfloat16`` at a pair of :data:`WGMMA_HEAD_DIMS` ((64, 64), (128,
  128), (256, 256), (192, 128)) takes the tensor-core kernel (``wgmma``
  products, TMA loads);
* ``float32`` at any pair of :data:`HEAD_DIMS`, and ``bfloat16`` at
  (16, 16), (32, 32) or (48, 32), take the CUDA-core kernel.  wgmma in
  TF32 would not hold float32's bound against the plain version (rtol
  2e-4 / atol 3e-5).

For CPU tensors the wrapper runs the plain version (:func:`.ref.attention`,
differentiable by autograd), and only then; for CUDA tensors it launches
its route's kernel or raises.  Under autograd on the card it runs
:class:`_FlashAttention`: the forward kernel also writes each row's
log-sum-exp ``L`` (and, in bf16, the output in float32), and the backward
is :func:`flash_attention_bwd` (no Pallas counterpart: the JAX package
differentiates its plain ``_sdpa`` with XLA), three kernels of the same
source on the forward's route: on the tensor cores (bf16 at the
:data:`WGMMA_HEAD_DIMS` pairs: dK/dV and dQ on ``wgmma`` with P and dS in
two bf16 parts, the GQA sum in thread-block clusters), else on CUDA cores.
``flash_attention.launches_wgmma`` and ``launches_cuda_core`` count each
forward route's launches, ``flash_attention.launches`` their sum, and
``flash_attention_bwd``'s three counters the same for the backward's calls
(a launch recorded into a CUDA graph counts once, at capture).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import ref
from .build import check_launch, load_library, stream_arg, use_plain

#: (Dqk, Dv) pairs of the CUDA-core kernel (csrc launch_t)
HEAD_DIMS = ((16, 16), (32, 32), (64, 64), (128, 128), (256, 256), (48, 32), (192, 128))
#: (Dqk, Dv) pairs of the tensor-core kernel, bf16 (csrc tc::launch)
WGMMA_HEAD_DIMS = ((64, 64), (128, 128), (256, 256), (192, 128))
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_ARGS = [_P] * 4 + [_I] * 7 + [_I64] * 12 + [_F, _F, _I, _I, _I, _P, _P, _P]
_BWD_ARGS = [_I] + [_P] * 10 + [_I] * 7 + [_I64] * 24 + [_F, _F, _I, _I, _I, _P]
#: the C entry points of ``csrc/flash_attention.cu`` and their argument types
SIGNATURES = {"rt_flash_attention": [_I] + _ARGS, "rt_flash_attention_wgmma": _ARGS,
              "rt_flash_attention_bwd": _BWD_ARGS,
              "rt_flash_attention_bwd_wgmma": _BWD_ARGS[1:]}


def route(dtype: torch.dtype, head_dim: int, v_head_dim: Optional[int] = None) -> str:
    """``"wgmma"`` or ``"cuda_core"``: which kernels a CUDA call takes at
    q and k's ``head_dim`` and v's ``v_head_dim`` (by default the same),
    in the forward and in the backward alike."""
    pair = (head_dim, head_dim if v_head_dim is None else v_head_dim)
    return "wgmma" if dtype == torch.bfloat16 and pair in WGMMA_HEAD_DIMS else "cuda_core"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    window: Optional[int] = None,
                    logit_softcap: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Attention of q ``[B,Hq,Sq,D]`` against k ``[B,Hkv,Skv,D]`` and v
    ``[B,Hkv,Skv,Dv]`` (``Hq % Hkv == 0``; ``Dv`` is ``D`` but for MLA's
    pairs), query ``i`` at global position ``q_offset + i``; ``causal``
    and a sliding ``window`` (tokens of lookback) mask keys,
    ``logit_softcap`` caps the scaled logits with ``tanh``, and a row that
    sees no key gives zeros.  Returns ``[B,Hq,Sq,Dv]`` in q's dtype.

    On the card, one launch of the route's kernel (:func:`route`); q, k
    and v may be strided views (unit stride along D), as the model's
    ``[B,S,H,D]`` tensors transposed are, and the result is a
    ``[B,Hq,Sq,Dv]`` view of memory laid out ``[B,Sq,Hq,Dv]``, so that the
    model's transpose back is free too.  The tensor-core route loads
    through TMA, so it also takes 16-byte aligned data and strides.  When
    autograd records and q, k or v requires grad, the same launch goes
    through :class:`_FlashAttention`, whose backward is
    :func:`flash_attention_bwd`.
    """
    _check_shapes(q, k, v)
    if use_plain(q, k, v):
        return ref.attention(q, k, v, causal=causal, scale=scale, window=window,
                             logit_softcap=logit_softcap, q_offset=q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, scale, window, logit_softcap,
                                     int(q_offset))
    return _forward(q, k, v, causal, scale, window, logit_softcap, q_offset, False)[0]


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q [B,Hq,Sq,D], k [B,Hkv,Skv,D] and v "
                         "[B,Hkv,Skv,Dv]")
    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if tuple(k.shape) != (B, Hkv, Skv, D):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    if tuple(v.shape) != (B, Hkv, Skv, Dv):
        raise ValueError(f"flash_attention: v {tuple(v.shape)} does not match k "
                         f"{tuple(k.shape)}")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} query heads do not split into "
                         f"{Hkv} kv heads")


def _check_kernel_args(q, k, v, window, q_offset) -> None:
    """What both kernels' entry points take, beyond the shapes."""
    B, Hq, Sq, D = q.shape
    Skv, Dv = k.shape[2], v.shape[3]
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernels take (head_dim, v head_dim) in "
                         f"{HEAD_DIMS}, got {(D, Dv)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the flash_attention kernels take q, k, v of one dtype, "
                        f"float32 or bfloat16; got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("the flash_attention kernels take unit stride along D")
    if max(B, Hq) > 65535 or max(Sq, Skv, abs(q_offset) + Sq + Skv) >= 2 ** 31:
        raise ValueError("flash_attention: shape beyond the kernels' grid")
    if window is not None and int(window) < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")


def _forward(q, k, v, causal, scale, window, logit_softcap, q_offset, for_backward: bool):
    """One launch of the route's forward kernel: ``(out, o32, lse)``.  With
    ``for_backward`` the kernel also writes ``lse`` (``[B,Hq,Sq]`` float32,
    each row's natural-log log-sum-exp of its scaled, capped logits,
    ``-inf`` for a row that sees no key) and ``o32`` (the output in
    float32, ``[B,Hq,Sq,Dv]`` contiguous: ``out`` itself for float32);
    without, both are None and the kernel writes neither."""
    _check_kernel_args(q, k, v, window, q_offset)
    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[3]
    scale = D ** -0.5 if scale is None else float(scale)
    softcap = 0.0 if logit_softcap is None else float(logit_softcap)
    which = route(q.dtype, D, Dv)
    if which == "wgmma":
        strides = [_tma_strides(t) for t in (q, k, v)]
    else:
        strides = [t.stride()[:3] for t in (q, k, v)]
    out = torch.empty((B, Sq, Hq, Dv), dtype=q.dtype, device=q.device).transpose(1, 2)
    lse = o32 = None
    if for_backward:
        lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
        if q.dtype != torch.float32:
            o32 = torch.empty((B, Hq, Sq, Dv), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq, Hkv, Sq, Skv,
            D, Dv, *strides[0], *strides[1], *strides[2], *out.stride()[:3], scale, softcap,
            int(bool(causal)), -1 if window is None else int(window), int(q_offset),
            _ptr(lse), _ptr(o32), stream_arg(q))
    lib = load_library("flash_attention", SIGNATURES)
    if which == "wgmma":
        check_launch("flash_attention", lib.rt_flash_attention_wgmma(*args))
        flash_attention.launches_wgmma += 1
    else:
        check_launch("flash_attention", lib.rt_flash_attention(_DTYPE_CODE[q.dtype], *args))
        flash_attention.launches_cuda_core += 1
    flash_attention.launches += 1
    if for_backward and o32 is None:
        o32 = out
    return out, o32, lse


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def forward_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, scale: Optional[float] = None,
                     window: Optional[int] = None, logit_softcap: Optional[float] = None,
                     q_offset: int = 0):
    """``(out, o32, lse)``: the training forward of :func:`flash_attention`
    on the card (the forward of :class:`_FlashAttention`), one launch of
    the route's kernel that also writes what :func:`flash_attention_bwd`
    takes (the output in float32 and each row's log-sum-exp); no
    autograd.  It takes CUDA tensors only: on the CPU, autograd
    differentiates the plain version."""
    _check_shapes(q, k, v)
    if use_plain(q, k, v):
        raise ValueError("forward_with_lse launches the kernel: it takes CUDA tensors")
    return _forward(q, k, v, causal, scale, window, logit_softcap, q_offset, True)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o32: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = True, scale: Optional[float] = None,
                        window: Optional[int] = None,
                        logit_softcap: Optional[float] = None, q_offset: int = 0):
    """``(dq, dk, dv)`` of :func:`flash_attention` at ``(q, k, v)`` for
    the output's cotangent ``dout``, given the forward's float32 output
    ``o32`` and row log-sum-exp ``lse`` (:func:`forward_with_lse`).
    Gradients in q's dtype, each a ``[B,H,S,D]`` view of ``[B,S,H,D]``
    memory (as the forward's output is), float32 arithmetic.

    On the card three launches on the stream (``csrc/flash_attention.cu``:
    delta, then dK and dV, then dQ) of the route :func:`route` gives, the
    forward's: the tensor-core kernels (bf16 at a pair of
    :data:`WGMMA_HEAD_DIMS`; TMA loads, so 16-byte aligned q, k and v
    with strides in multiples of 8, and dout made so when it is not), else
    the CUDA-core ones.  Counted once in ``flash_attention_bwd.launches``
    and in ``launches_wgmma`` or ``launches_cuda_core``; no float atomics,
    so the result is the same bits every run.  It takes CUDA tensors only,
    as :func:`forward_with_lse` does."""
    _check_shapes(q, k, v)
    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if tuple(dout.shape) != (B, Hq, Sq, Dv):
        raise ValueError(f"flash_attention_bwd: dout {tuple(dout.shape)}, want "
                         f"{(B, Hq, Sq, Dv)}")
    if use_plain(q, k, v, dout):
        raise ValueError("flash_attention_bwd launches the kernels: it takes CUDA tensors")
    _check_kernel_args(q, k, v, window, q_offset)
    if (tuple(o32.shape) != (B, Hq, Sq, Dv) or o32.dtype != torch.float32
            or o32.stride(3) != 1 or tuple(lse.shape) != (B, Hq, Sq)
            or lse.dtype != torch.float32 or not lse.is_contiguous()):
        raise ValueError("flash_attention_bwd takes the forward's float32 output "
                         "[B,Hq,Sq,Dv] and its contiguous float32 lse [B,Hq,Sq]")
    dout = dout.to(q.dtype)
    which = route(q.dtype, D, Dv)
    if dout.stride(3) != 1 or (which == "wgmma" and not _tma_ready(dout)):
        dout = dout.contiguous()
    scale = D ** -0.5 if scale is None else float(scale)
    softcap = 0.0 if logit_softcap is None else float(logit_softcap)
    dq = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((B, Skv, Hkv, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((B, Skv, Hkv, Dv), dtype=q.dtype, device=q.device).transpose(1, 2)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    if which == "wgmma":
        strides = [_tma_strides(t) for t in (q, k, v, dout)]
    else:
        strides = [t.stride()[:3] for t in (q, k, v, dout)]
    strides += [t.stride()[:3] for t in (o32, dq, dk, dv)]
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), o32.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Hq, Hkv, Sq, Skv, D, Dv, *[st for t in strides for st in t], scale, softcap,
            int(bool(causal)), -1 if window is None else int(window), int(q_offset),
            stream_arg(q))
    lib = load_library("flash_attention", SIGNATURES)
    if which == "wgmma":
        check_launch("flash_attention", lib.rt_flash_attention_bwd_wgmma(*args))
        flash_attention_bwd.launches_wgmma += 1
    else:
        check_launch("flash_attention", lib.rt_flash_attention_bwd(_DTYPE_CODE[q.dtype], *args))
        flash_attention_bwd.launches_cuda_core += 1
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The route's forward kernel (writing ``L`` and the float32 output)
    with :func:`flash_attention_bwd` as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, logit_softcap, q_offset):
        out, o32, lse = forward_with_lse(q, k, v, causal=causal, scale=scale, window=window,
                                         logit_softcap=logit_softcap, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.kw = dict(causal=causal, scale=scale, window=window,
                      logit_softcap=logit_softcap, q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o32, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o32, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def _tma_ready(t: torch.Tensor) -> bool:
    """Whether a TMA map takes the view: 16-byte aligned data, and strides
    in multiples of 8 elements along every dimension it steps."""
    return t.data_ptr() % 16 == 0 and t.shape[3] % 8 == 0 and all(
        s > 0 and s % 8 == 0 for n, s in zip(t.shape[:3], t.stride()[:3]) if n > 1)


def _tma_strides(t: torch.Tensor):
    """(batch, head, seq) element strides of a bf16 view for a TMA map:
    16-byte aligned data and strides (a dimension of size 1 is never
    stepped, so its stride is replaced by the view's head dim)."""
    if not _tma_ready(t):
        raise ValueError("the flash_attention tensor-core route takes 16-byte aligned "
                         f"bf16 views with strides in multiples of 8; got strides "
                         f"{tuple(t.stride())}")
    return [s if n > 1 else t.shape[3] for n, s in zip(t.shape[:3], t.stride()[:3])]


flash_attention.launches = 0
flash_attention.launches_wgmma = 0
flash_attention.launches_cuda_core = 0
flash_attention_bwd.launches = 0
flash_attention_bwd.launches_wgmma = 0
flash_attention_bwd.launches_cuda_core = 0


def launch_counts() -> Dict[str, int]:
    return {"flash_attention": flash_attention.launches,
            "flash_attention_wgmma": flash_attention.launches_wgmma,
            "flash_attention_cuda_core": flash_attention.launches_cuda_core,
            "flash_attention_bwd": flash_attention_bwd.launches,
            "flash_attention_bwd_wgmma": flash_attention_bwd.launches_wgmma,
            "flash_attention_bwd_cuda_core": flash_attention_bwd.launches_cuda_core}


def reset_launches() -> None:
    for fn in (flash_attention, flash_attention_bwd):
        fn.launches = fn.launches_wgmma = fn.launches_cuda_core = 0
