"""Hopper kernels of the Mamba2 SSD chunked scan: wrapper and launch counters.

The hand-written CUDA source ``csrc/ssd_scan.cu`` (built for ``sm_90a``
at first use by :mod:`.build`) replaces ``ssd_scan_call``
(``src/repro/kernels/ssd_scan.py:80``), which the JAX package reaches
through ``kernels/ops.py:ssd_scan``.  The route rule, fixed by dtype,
head dim, state dim and chunk alone (:func:`route`):

* ``bfloat16`` x, B and C at P 64, N 128 and chunk 128 (mamba2's served
  shapes) take the tensor-core kernel: one CTA per chunk on ``wgmma``,
  the CTAs of a (batch, head) in a thread-block cluster that carries the
  float32 state from chunk to chunk through distributed shared memory.
  Bound by bytes;
* ``bfloat16`` at P 64, N 16 and chunk 128 (hymba-1.5b's SSD heads) take
  the tensor-core kernel of that width (``"wgmma_n16"``): the same
  algorithm, B and C in 32-byte rows, a [P, N] state in one warpgroup's
  accumulator.  Bound by bytes;
* ``float32``, and every other shape, take the CUDA-core kernel: one CTA
  per (batch, head) walking its chunks in float32 FMA.  Bound by
  float32 operations.

For a CPU tensor the wrapper runs the plain version
(:func:`.ref.ssd_scan`, the sequential float32 scan), and only then;
for CUDA tensors it launches its route's kernel or raises.
``ssd_scan.launches_wgmma``, ``launches_wgmma_n16`` and
``launches_cuda_core`` count each route's launches, ``ssd_scan.launches``
their sum (a launch recorded into a CUDA graph counts once, at capture).

On the card the scan is differentiable through hand-written backward
kernels in the same source (the reference has no Pallas backward, it
differentiates the plain scan through a ``custom_vjp``,
``src/repro/models/ssm.py:46-49``): when grad mode is on and an input
requires grad, :func:`ssd_scan` runs as a ``torch.autograd.Function``
whose forward is the route's kernel and whose backward is
:func:`ssd_scan_bwd`.  Its route rule, fixed by dtype, head dim and state
dim alone (:func:`bwd_route`): bf16 at P 64, N 128 takes the tensor-core
backward (``rt_ssd_scan_bwd_wgmma``: the chunks of a (batch, head) in
parallel in a cluster, as the forward), bf16 at P 64, N 16 its counterpart
at that width (the same entry point), float32 and every other
shape the CUDA-core one (``rt_ssd_scan_bwd``).
``ssd_scan_bwd.launches_wgmma``, ``launches_wgmma_n16`` and
``launches_cuda_core`` count each route's launches, ``launches`` their
sum.  Its plain version, for tests only, is :func:`.ref.ssd_scan_vjp`.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import ref
from .build import check_launch, load_library, stream_arg, use_plain

MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 128, 64, 128  # csrc kMaxChunk, kMaxP, kMaxN
WGMMA_CHUNK, WGMMA_HEAD_DIM, WGMMA_STATE = 128, 64, 128  # csrc tc::kL, kP, kN
WGMMA_N16_STATE = 16  # csrc n16::kN
MAX_CLUSTER = 8  # csrc tc::kMaxCluster: CTAs of a (batch, head)
#: bf16 parts of (G, x o w, h) the tensor-core kernel takes on the served
#: path: the fewest that meet the checks' bounds (scripts/ssd_scan_times.py)
PARTS = (1, 2, 1)
#: the variants ``csrc/ssd_scan.cu`` instantiates (rt_ssd_scan_wgmma)
PARTS_VARIANTS = ((1, 1, 1), (1, 2, 1), (2, 2, 2), (3, 3, 3))
#: the same at N 16 (rt_ssd_scan_wgmma at N 16): one part of x o w fewer leaves
#: the state outside the served bound there too (tests/test_torch_ssd.py)
PARTS_N16 = (1, 2, 1)
PARTS_N16_VARIANTS = ((1, 1, 1), (1, 2, 1), (2, 2, 2))
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
#: the C entry points of ``csrc/ssd_scan.cu`` and their argument types
SIGNATURES = {"rt_ssd_scan": [_I] + [_P] * 8 + [_I] * 7 + [_I64] * 11 + [_P],
              "rt_ssd_scan_wgmma": [_P] * 8 + [_I] * 7 + [_I64] * 11 + [_P],
              "rt_ssd_scan_bwd": [_I] + [_P] * 18 + [_I] * 6 + [_I64] * 11 + [_P],
              "rt_ssd_scan_bwd_wgmma": [_P] * 18 + [_I] * 7 + [_I64] * 11 + [_P]}
#: rows of a sub-chunk of the CUDA-core backward kernel (csrc ``bwd::kBL``)
BWD_ROWS = 32
#: bf16 parts of (x o w, eh o dy, the scores, H0, U) the tensor-core
#: backward takes on the served path: the fewest that meet the checks'
#: gradient bounds (tests/test_torch_backward.py, scripts/ssd_bwd_times.py)
BWD_PARTS = (2, 2, 2, 2, 2)
#: the variants ``csrc/ssd_scan.cu`` instantiates (rt_ssd_scan_bwd_wgmma)
BWD_PARTS_VARIANTS = ((1, 1, 1, 1, 1), (2, 2, 2, 2, 2))
#: the same at N 16 (rt_ssd_scan_bwd_wgmma at N 16): every operand two parts
#: again, one fewer of any leaving the gradient bound
#: (tests/test_torch_backward.py)
BWD_PARTS_N16 = (2, 2, 2, 2, 2)
BWD_PARTS_N16_VARIANTS = ((1, 1, 1, 1, 1), (2, 2, 2, 2, 2))
#: each tensor-core route's served parts and variants, forward and backward
_WGMMA = {"wgmma": (PARTS, PARTS_VARIANTS, BWD_PARTS, BWD_PARTS_VARIANTS),
          "wgmma_n16": (PARTS_N16, PARTS_N16_VARIANTS, BWD_PARTS_N16, BWD_PARTS_N16_VARIANTS)}


def route(dtype: torch.dtype, head_dim: int, state_dim: int, chunk: int) -> str:
    """``"wgmma"``, ``"wgmma_n16"`` or ``"cuda_core"``: which kernel a CUDA
    call of this dtype (x's), head dim P, state dim N and requested chunk
    takes."""
    if chunk != WGMMA_CHUNK:
        return "cuda_core"
    return bwd_route(dtype, head_dim, state_dim)


def bwd_route(dtype: torch.dtype, head_dim: int, state_dim: int) -> str:
    """``"wgmma"``, ``"wgmma_n16"`` or ``"cuda_core"``: which backward
    kernel a CUDA call of this dtype (x's, and so dy's), head dim P and
    state dim N takes.  The backward has its own chunk (128 rows on the
    tensor cores, 32 on CUDA cores), whatever the forward's was."""
    if dtype == torch.bfloat16 and head_dim == WGMMA_HEAD_DIM:
        if state_dim == WGMMA_STATE:
            return "wgmma"
        if state_dim == WGMMA_N16_STATE:
            return "wgmma_n16"
    return "cuda_core"


def max_cluster(seq_len: int) -> int:
    """The most CTAs a (batch, head) can take on the tensor-core route:
    one a chunk, at most :data:`MAX_CLUSTER`."""
    return min(-(-seq_len // WGMMA_CHUNK), MAX_CLUSTER)


def default_cluster(seq_len: int, state_dim: int = WGMMA_STATE) -> int:
    """CTAs of a (batch, head) on a tensor-core route; each CTA walks the
    cluster's groups of chunks.  At N 128 one for every two chunks, at
    most :data:`MAX_CLUSTER`: at the served S 512 (4 chunks, 1 280 CTAs
    of one chunk or 640 of two) two chunks a CTA measured faster than one
    or four (``scripts/ssd_scan_times.py``): the second chunk's set-up
    and loads overlap the other CTA of its SM, with half the CTAs to
    place in clusters.  At N 16 one a chunk (:func:`max_cluster`)."""
    if state_dim == WGMMA_N16_STATE:
        return max_cluster(seq_len)
    return min(-(-seq_len // (2 * WGMMA_CHUNK)), MAX_CLUSTER)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, C: torch.Tensor, *,
             init_state: Optional[torch.Tensor] = None, chunk: int = 128,
             return_state: bool = False):
    """Mamba2 SSD scan: x ``[B,S,H,P]``, dt ``[B,S,H]`` float32, A ``[H]``
    float32, Bm and C ``[B,S,G,N]`` in x's dtype, optional float32
    ``init_state [B,H,P,N]``.  Returns y ``[B,S,H,P]`` in x's dtype (and
    the final float32 state ``[B,H,P,N]`` when ``return_state``).

    On the card, one launch of the route's kernel (:func:`route`) runs
    every (batch, head) over chunks of ``min(chunk, S)`` rows, the last
    one short when ``S % chunk``: the result of the reference's call
    padded with ``dt = 0``.  x, Bm and C may be strided views (unit
    stride in the last dimension): the kernels read them in place.  The
    tensor-core route loads them with TMA, which takes 16-byte aligned
    data and strides; a view that breaks that (none on the served path)
    is copied to a contiguous tensor first.
    """
    if not use_plain(x, dt, A, Bm, C) and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, A, Bm, C, init_state)):
        y, h = _SSDScan.apply(x, dt, A, Bm, C, init_state, chunk)
        return (y, h) if return_state else y
    return _scan(x, dt, A, Bm, C, init_state, chunk, return_state, None, None)


class _SSDScan(torch.autograd.Function):
    """The route's forward kernel with :func:`ssd_scan_bwd` as its backward."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, C, init_state, chunk):
        ctx.set_materialize_grads(False)  # an unused output's cotangent is None
        ctx.save_for_backward(x, dt, A, Bm, C, init_state)
        return _scan(x, dt, A, Bm, C, init_state, chunk, True, None, None)

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, Bm, C, init_state = ctx.saved_tensors
        grads = ssd_scan_bwd(x, dt, A, Bm, C, init_state=init_state, dy=dy, dh=dh)
        return (*grads, None)


def ssd_scan_bwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                 C: torch.Tensor, *, init_state: Optional[torch.Tensor] = None,
                 dy: Optional[torch.Tensor] = None, dh: Optional[torch.Tensor] = None):
    """The VJP of :func:`ssd_scan`'s ``(y, final state)``: ``(dx, ddt, dA,
    dBm, dC, dinit_state)`` for the cotangents ``dy [B,S,H,P]`` and ``dh
    [B,H,P,N]`` (None: zero), each in its input's dtype;
    ``dinit_state`` is None without an ``init_state``.

    On the card, one launch of the route's kernel (:func:`bwd_route`):
    a tensor-core kernel (bf16 at P 64, N 128 or N 16; a CTA per 128-row chunk,
    the chunks of a (batch, head) in one cluster, :func:`max_cluster` of
    them, a longer sequence walking groups of chunks), or the CUDA-core
    kernel (a CTA per (batch, head), float32; any shape the CUDA-core
    forward takes: P <= 64, N <= 128, G dividing H, any S), which
    recomputes the states at every 32 rows and walks them in reverse.
    Then a head's partials of dB and dC are added over each group and dA's
    over the batch (and chunks), in a fixed order (no float atomics).  x, Bm and C may be strided views, read in place.  For CPU
    tensors, the plain version :func:`.ref.ssd_scan_vjp`."""
    _check_shapes(x, dt, A, Bm, C, init_state)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if dy is not None and tuple(dy.shape) != (Bsz, S, H, P):
        raise ValueError(f"ssd_scan_bwd: dy has shape {tuple(dy.shape)}, want {(Bsz, S, H, P)}")
    if dh is not None and tuple(dh.shape) != (Bsz, H, P, N):
        raise ValueError(f"ssd_scan_bwd: dh has shape {tuple(dh.shape)}, want {(Bsz, H, P, N)}")
    if use_plain(*(t for t in (x, dt, A, Bm, C, init_state, dy, dh) if t is not None)):
        return ref.ssd_scan_vjp(x, dt, A, Bm, C, init_state, dy, dh)
    _check_inputs(x, dt, A, Bm, C, init_state)
    which = bwd_route(x.dtype, P, N)
    if which in _WGMMA:
        return _bwd_wgmma(which, x, dt, A, Bm, C, init_state, dy, dh)
    return _bwd_cuda_core(x, dt, A, Bm, C, init_state, dy, dh)


def _bwd_cuda_core(x, dt, A, Bm, C, init_state, dy, dh):
    """The CUDA-core backward kernel, then the group and batch sums."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if not (P <= MAX_HEAD_DIM and N <= MAX_STATE):
        raise ValueError(f"the ssd_scan backward kernel takes P <= {MAX_HEAD_DIM}, N <= "
                         f"{MAX_STATE}; got {P}, {N}")
    dev, f32 = x.device, torch.float32
    dy = None if dy is None else dy.to(x.dtype).contiguous()
    dh = None if dh is None else dh.to(f32).contiguous()
    dx = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((Bsz, S, H), dtype=f32, device=dev)
    dA = torch.empty((H,), dtype=f32, device=dev)
    dB = torch.empty((Bsz, S, G, N), dtype=x.dtype, device=dev)
    dC = torch.empty((Bsz, S, G, N), dtype=x.dtype, device=dev)
    dh0 = torch.empty((Bsz, H, P, N), dtype=f32, device=dev)
    dA_part = torch.empty((Bsz, H), dtype=f32, device=dev)
    dB_part = torch.empty((Bsz, S, H, N), dtype=f32, device=dev)
    dC_part = torch.empty((Bsz, S, H, N), dtype=f32, device=dev)
    hs = torch.empty((Bsz, H, -(-S // BWD_ROWS), P, N), dtype=f32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = load_library("ssd_scan", SIGNATURES).rt_ssd_scan_bwd(
        _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        C.data_ptr(), ptr(init_state), ptr(dy), ptr(dh), dx.data_ptr(), ddt.data_ptr(),
        dA.data_ptr(), dB.data_ptr(), dC.data_ptr(), dh0.data_ptr(), dA_part.data_ptr(),
        dB_part.data_ptr(), dC_part.data_ptr(), hs.data_ptr(), Bsz, S, H, P, G, N,
        *x.stride()[:3], *dt.stride()[:2], *Bm.stride()[:3], *C.stride()[:3], stream_arg(x))
    check_launch("ssd_scan", err)
    _count(ssd_scan_bwd, "cuda_core")
    return dx, ddt, dA, dB, dC, (dh0 if init_state is not None else None)


def ssd_scan_bwd_variant(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         Bm: torch.Tensor, C: torch.Tensor, *,
                         init_state: Optional[torch.Tensor] = None,
                         dy: Optional[torch.Tensor] = None, dh: Optional[torch.Tensor] = None,
                         cluster: Optional[int] = None, parts: Optional[Tuple[int, ...]] = None,
                         kernel: str = "wgmma"):
    """:func:`ssd_scan_bwd` on a tensor-core route's CUDA inputs (N 128 or
    N 16), for measurements and tests (``scripts/ssd_bwd_times.py``): with
    another cluster size (1 to :func:`max_cluster`; fewer CTAs than chunks
    walk groups of chunks) or bf16 parts (one of the route's variants,
    :data:`BWD_PARTS_VARIANTS` or :data:`BWD_PARTS_N16_VARIANTS`), or,
    with ``kernel="cuda_core"``, the CUDA-core kernel on them (the
    route's kernel before the tensor-core one)."""
    _check_shapes(x, dt, A, Bm, C, init_state)
    which = bwd_route(x.dtype, x.shape[-1], Bm.shape[-1])
    if which not in _WGMMA or use_plain(x):
        raise ValueError("ssd_scan_bwd_variant takes a tensor-core route's CUDA inputs")
    _check_inputs(x, dt, A, Bm, C, init_state)
    if kernel == "cuda_core":
        return _bwd_cuda_core(x, dt, A, Bm, C, init_state, dy, dh)
    if kernel != "wgmma":
        raise ValueError(f"ssd_scan_bwd_variant: kernel {kernel!r} is not wgmma or cuda_core")
    return _bwd_wgmma(which, x, dt, A, Bm, C, init_state, dy, dh, cluster, parts)


def _bwd_wgmma(which, x, dt, A, Bm, C, init_state, dy, dh, cluster=None, parts=None):
    """The tensor-core backward of route ``which``: x, Bm and C read in
    place where TMA can (:func:`_tma_ok`), dy contiguous (zeros when
    absent), every output and scratch allocated here."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dev, f32 = x.device, torch.float32
    x, Bm, C = (t if _tma_ok(t) else t.contiguous() for t in (x, Bm, C))
    dy = torch.zeros_like(x, memory_format=torch.contiguous_format) if dy is None else (
        dy.to(x.dtype).contiguous())
    dh = None if dh is None else dh.to(f32).contiguous()
    chunks = -(-S // WGMMA_CHUNK)
    served, variants = _WGMMA[which][2:]
    cluster = max_cluster(S) if cluster is None else int(cluster)
    parts = served if parts is None else tuple(parts)
    if parts not in variants or not 1 <= cluster <= max_cluster(S):
        raise ValueError(f"ssd_scan_bwd: parts {parts} not in {variants}, or "
                         f"cluster {cluster} outside 1..{max_cluster(S)}")
    groups = -(-chunks // cluster)
    dx = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
    ddt = torch.empty((Bsz, S, H), dtype=f32, device=dev)
    dA = torch.empty((H,), dtype=f32, device=dev)
    dB = torch.empty((Bsz, S, G, N), dtype=x.dtype, device=dev)
    dC = torch.empty((Bsz, S, G, N), dtype=x.dtype, device=dev)
    dh0 = torch.empty((Bsz, H, P, N), dtype=f32, device=dev)
    dA_part = torch.empty((Bsz, chunks, H), dtype=f32, device=dev)
    dB_part = torch.empty((Bsz, S, H, N), dtype=f32, device=dev)
    dC_part = torch.empty((Bsz, S, H, N), dtype=f32, device=dev)
    hcarry = (torch.empty((Bsz, H, groups - 1, P, N), dtype=f32, device=dev) if groups > 1
              else None)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = load_library("ssd_scan", SIGNATURES).rt_ssd_scan_bwd_wgmma(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), C.data_ptr(),
        ptr(init_state), dy.data_ptr(), ptr(dh), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), dh0.data_ptr(), dA_part.data_ptr(), dB_part.data_ptr(),
        dC_part.data_ptr(), ptr(hcarry), Bsz, S, H, G, N, cluster,
        int("".join(map(str, parts))),
        *_tma_strides(x), *dt.stride()[:2], *_tma_strides(Bm), *_tma_strides(C), stream_arg(x))
    check_launch("ssd_scan", err)
    _count(ssd_scan_bwd, which)
    return dx, ddt, dA, dB, dC, (dh0 if init_state is not None else None)


def ssd_scan_variant(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     Bm: torch.Tensor, C: torch.Tensor, *,
                     init_state: Optional[torch.Tensor] = None, cluster: int,
                     parts: Tuple[int, int, int]):
    """:func:`ssd_scan` at chunk 128 on a tensor-core route (N 128 or
    N 16) with another cluster size (1 to :func:`max_cluster`) or bf16
    parts (one of the route's variants, :data:`PARTS_VARIANTS` or
    :data:`PARTS_N16_VARIANTS`), for measurements
    (``scripts/ssd_scan_times.py``); returns (y, final state)."""
    if route(x.dtype, x.shape[-1], Bm.shape[-1], 128) not in _WGMMA:
        raise ValueError("ssd_scan_variant takes a tensor-core route's inputs")
    return _scan(x, dt, A, Bm, C, init_state, 128, True, cluster, parts)


def _check_shapes(x, dt, A, Bm, C, init_state):
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


def _check_inputs(x, dt, A, Bm, C, init_state):
    """The kernels' dtype and stride checks."""
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


def _scan(x, dt, A, Bm, C, init_state, chunk, return_state, cluster, parts):
    _check_shapes(x, dt, A, Bm, C, init_state)
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if use_plain(*(t for t in (x, dt, A, Bm, C, init_state) if t is not None)):
        plain = ref.ssd_scan_shapes if x.device.type == "meta" else ref.ssd_scan
        return plain(x, dt, A, Bm, C, init_state=init_state, return_state=return_state)

    which = route(x.dtype, P, N, int(chunk))
    chunk = min(int(chunk), S)
    if not (0 < chunk <= MAX_CHUNK and P <= MAX_HEAD_DIM and N <= MAX_STATE):
        raise ValueError(f"the ssd_scan kernel takes chunk <= {MAX_CHUNK}, P <= "
                         f"{MAX_HEAD_DIM}, N <= {MAX_STATE}; got {chunk}, {P}, {N}")
    _check_inputs(x, dt, A, Bm, C, init_state)
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    h = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    lib = load_library("ssd_scan", SIGNATURES)
    h0 = None if init_state is None else init_state.data_ptr()
    if which in _WGMMA:
        x, Bm, C = (t if _tma_ok(t) else t.contiguous() for t in (x, Bm, C))
        served, variants = _WGMMA[which][:2]
        cluster = default_cluster(S, N) if cluster is None else int(cluster)
        parts = served if parts is None else tuple(parts)
        if parts not in variants or not 1 <= cluster <= max_cluster(S):
            raise ValueError(f"ssd_scan: parts {parts} not in {variants}, or cluster "
                             f"{cluster} outside 1..{max_cluster(S)}")
        err = lib.rt_ssd_scan_wgmma(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), C.data_ptr(), h0,
            y.data_ptr(), h.data_ptr(), Bsz, S, H, G, N, cluster,
            100 * parts[0] + 10 * parts[1] + parts[2], *_tma_strides(x), *dt.stride()[:2],
            *_tma_strides(Bm), *_tma_strides(C), stream_arg(x))
    else:
        err = lib.rt_ssd_scan(
            _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            C.data_ptr(), h0, y.data_ptr(), h.data_ptr(), Bsz, S, H, P, G, N, chunk,
            *x.stride()[:3], *dt.stride()[:2], *Bm.stride()[:3], *C.stride()[:3],
            stream_arg(x))
    check_launch("ssd_scan", err)
    _count(ssd_scan, which)
    return (y, h) if return_state else y


def _tma_strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """(batch, seq, head or group) element strides of a view for a TMA
    map: a dimension of size 1 is never stepped, so its stride is
    replaced by the row's length (a multiple of 16 bytes)."""
    return tuple(s if n > 1 else t.shape[3] for n, s in zip(t.shape[:3], t.stride()[:3]))


def _tma_ok(t: torch.Tensor) -> bool:
    """Whether TMA can read the bf16 view in place: 16-byte aligned data
    and strides."""
    return t.data_ptr() % 16 == 0 and all(s > 0 and s % 8 == 0 for s in _tma_strides(t))


#: the routes, each with its own launch counter
ROUTES = ("wgmma", "wgmma_n16", "cuda_core")


def _count(fn, which: str) -> None:
    """One launch of ``fn``'s kernel on route ``which``."""
    setattr(fn, f"launches_{which}", getattr(fn, f"launches_{which}") + 1)
    fn.launches += 1


def launch_counts() -> Dict[str, int]:
    out = {"ssd_scan": ssd_scan.launches}
    out.update({f"ssd_scan_{r}": getattr(ssd_scan, f"launches_{r}") for r in ROUTES})
    out["ssd_scan_bwd"] = ssd_scan_bwd.launches
    out.update({f"ssd_scan_bwd_{r}": getattr(ssd_scan_bwd, f"launches_{r}") for r in ROUTES})
    return out


def reset_launches() -> None:
    for fn in (ssd_scan, ssd_scan_bwd):
        fn.launches = 0
        for r in ROUTES:
            setattr(fn, f"launches_{r}", 0)


reset_launches()
