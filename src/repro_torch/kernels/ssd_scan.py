"""Hopper kernel of the Mamba2 SSD chunked scan: wrapper and launch counter.

The hand-written CUDA kernel ``csrc/ssd_scan.cu`` (built for ``sm_90a``
at first use by :mod:`.build`) replaces ``ssd_scan_call``
(``src/repro/kernels/ssd_scan.py:80``), which the JAX package reaches
through ``kernels/ops.py:ssd_scan``.  It is bound by float32 operations
(the chunk's small matrix products), not by bytes; the source says how
its first design meets that.

For a CPU tensor the wrapper runs the plain version
(:func:`.ref.ssd_scan`, the sequential float32 scan), and only then;
for CUDA tensors it launches the kernel or raises.  ``ssd_scan.
launches`` counts the kernel launches it made (a launch recorded into a
CUDA graph counts once, at capture).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import ref
from .build import check_launch, load_library, stream_arg, use_plain

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128  # csrc kMaxChunk, kMaxP, kMaxN
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: the C entry point of ``csrc/ssd_scan.cu`` and its argument types
SIGNATURES = {"rt_ssd_scan": [_I] + [_P] * 8 + [_I] * 7 + [_I64] * 11 + [_P]}


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, C: torch.Tensor, *,
             init_state: Optional[torch.Tensor] = None, chunk: int = 128,
             return_state: bool = False):
    """Mamba2 SSD scan: x ``[B,S,H,P]``, dt ``[B,S,H]`` float32, A ``[H]``
    float32, Bm and C ``[B,S,G,N]`` in x's dtype, optional float32
    ``init_state [B,H,P,N]``.  Returns y ``[B,S,H,P]`` in x's dtype (and
    the final float32 state ``[B,H,P,N]`` when ``return_state``).

    On the card, one launch runs every (batch, head) over chunks of
    ``min(chunk, S)`` rows, the last one short when ``S % chunk``: the
    result of the reference's call padded with ``dt = 0``.  x, Bm and C
    may be strided views (unit stride in the last dimension): the kernel
    reads them in place, with no copy.
    """
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError("ssd_scan takes x [B,S,H,P] and Bm, C [B,S,G,N]")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    want = {"dt": (Bsz, S, H), "A": (H,), "Bm": (Bsz, S, G, N), "C": (Bsz, S, G, N)}
    got = {"dt": dt, "A": A, "Bm": Bm, "C": C}
    if init_state is not None:
        want["init_state"], got["init_state"] = (Bsz, H, P, N), init_state
    for k, shape in want.items():
        if tuple(got[k].shape) != shape:
            raise ValueError(f"ssd_scan: {k} has shape {tuple(got[k].shape)}, want {shape}")
    if G == 0 or H % G:
        raise ValueError(f"ssd_scan: {H} heads do not split into {G} groups")
    if use_plain(x, *got.values()):
        return ref.ssd_scan(x, dt, A, Bm, C, init_state=init_state,
                            return_state=return_state)

    chunk = min(int(chunk), S)
    if not (0 < chunk <= MAX_CHUNK and P <= MAX_HEAD_DIM and N <= MAX_STATE):
        raise ValueError(f"the ssd_scan kernel takes chunk <= {MAX_CHUNK}, P <= "
                         f"{MAX_HEAD_DIM}, N <= {MAX_STATE}; got {chunk}, {P}, {N}")
    if x.dtype not in _DTYPE_CODE or Bm.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan takes x, Bm, C of one dtype, float32 or bfloat16; "
                        f"got {x.dtype}, {Bm.dtype}, {C.dtype}")
    fp32 = [dt, A] + ([] if init_state is None else [init_state])
    if any(t.dtype != torch.float32 for t in fp32):
        raise TypeError("ssd_scan takes dt, A and init_state in float32")
    if (x.stride(3) != 1 or Bm.stride(3) != 1 or C.stride(3) != 1 or dt.stride(2) != 1
            or not A.is_contiguous()
            or (init_state is not None and not init_state.is_contiguous())):
        raise ValueError("ssd_scan takes unit stride in the last dimension of x, dt, "
                         "Bm and C, and contiguous A and init_state")
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    err = load_library("ssd_scan", SIGNATURES).rt_ssd_scan(
        _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        C.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), h.data_ptr(), Bsz, S, H, P, G, N, chunk,
        *x.stride()[:3], *dt.stride()[:2], *Bm.stride()[:3], *C.stride()[:3],
        stream_arg(x))
    check_launch("ssd_scan", err)
    ssd_scan.launches += 1
    return (y, h) if return_state else y


ssd_scan.launches = 0


def launch_counts() -> Dict[str, int]:
    return {"ssd_scan": ssd_scan.launches}


def reset_launches() -> None:
    ssd_scan.launches = 0
