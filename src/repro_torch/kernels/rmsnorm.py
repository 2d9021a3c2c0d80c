"""Hopper kernel of RMSNorm: wrapper, route rule and launch counter.

The hand-written CUDA kernel ``csrc/rmsnorm.cu`` (built for ``sm_90a``
at first use by :mod:`.build`) replaces ``rmsnorm_call``
(``src/repro/kernels/rmsnorm.py:28``), which the JAX package reaches
through ``kernels/ops.py:rmsnorm``.  It is bound by bytes (each row read
and written once); the source says how its design meets that.

It has two routes, which :func:`route` picks from ``(rows, d, dtype)``
alone: ``"rows"`` (many rows: a warp walks rows, w held in registers)
and ``"team"`` (few rows, or wide ones: a CTA of several warps per
row).  Both add a row's squares in the order :func:`partition` fixes
from d alone, so a row's output is the same bits whatever route, row
count or row stride it was launched with.

For CPU tensors the wrapper runs the plain version (:func:`.ref.rmsnorm`),
and only then; for CUDA tensors it launches the kernel or raises.
``rmsnorm.launches`` counts the kernel launches it made (a launch
recorded into a CUDA graph counts once, at capture).

On the card the norm is differentiable through a hand-written backward
kernel (``rt_rmsnorm_bwd`` in the same source; the reference has no
Pallas backward: XLA differentiates its plain norm): when grad mode is on
and x or w requires grad, :func:`rmsnorm` runs as a
``torch.autograd.Function`` whose backward is :func:`rmsnorm_bwd`.  Its
plain version, for tests only, is :func:`.ref.rmsnorm_vjp`; CPU tensors
keep the plain forward, which autograd differentiates.  The backward has
the forward's two routes, with their own limits: :func:`bwd_plan` picks
the route, the CTA and team sizes and the number of dw partials from
``(rows, d, dtype)`` alone, so the order in which dw is added is fixed by
the shape.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from . import ref
from .build import check_launch, load_library, stream_arg, use_plain

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _I64, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
#: the C entry point of ``csrc/rmsnorm.cu`` and its argument types
SIGNATURES = {"rt_rmsnorm": [_I, _I, _P, _P, _P, _I64, _I, _I64, _F, _F, _I, _P],
              "rt_rmsnorm_bwd": [_I, _I, _P, _P, _P, _P, _P, _P, _I64, _I, _I64, _F, _F, _I,
                                 _I, _I, _I, _P]}

GROUP = 8                 # elements of a group (csrc kGroup)
ROUTES = ("rows", "team")  # the C route codes 0 and 1
ROWS_ROUTE_MIN_ROWS = 1024
#: the most groups a lane of the rows route holds (csrc ``launch``)
ROWS_ROUTE_MAX_LANE_GROUPS = {torch.bfloat16: 8, torch.float32: 4}
MAX_D = 32 * 32 * 4 * GROUP   # 32 warps of a team, 4 groups a thread

# The backward's plan (csrc ``launch_bwd``).  Its partial counts are sized
# to the H100's 132 SMs, but fixed in this table, not read from the card.
BWD_SMS = 132
BWD_ROWS_WARPS = 4         # warps of a CTA of the rows route (csrc kBwdRowsWarps)
BWD_ROWS_CTAS = 3 * BWD_SMS  # the rows route's most CTAs: three an SM
#: the most groups a lane of the backward's rows route holds (x, dy, the
#: next row's, w and the dw sums in registers)
BWD_ROWS_MAX_LANE_GROUPS = {torch.bfloat16: 4, torch.float32: 2}
BWD_TEAM_GROUPS = 2        # the most groups a thread of the team route holds
BWD_TEAM_MAX_WARPS = 16    # warps of a team's CTA (csrc kBwdTeamMaxWarps)
#: warps of teams an SM holds at once (96 registers a thread), and the
#: most teams an SM is given
BWD_TEAM_SM_WARPS, BWD_TEAM_SM_TEAMS = 20, 8
BWD_DW_SLICES = 64         # threads of the dw pass a column quad (csrc kDwSlices)


class BwdPlan(NamedTuple):
    """The backward's launch on rows of width d, from (rows, d, dtype)."""
    route: str               # "rows" or "team"
    warps: int               # warps of a CTA
    cluster: int             # CTAs of a team (a thread-block cluster if > 1)
    row_threads: int         # threads that share a row: 32, or 32 warps cluster
    groups_per_thread: int   # groups of 8 columns a thread holds (its own, every row)
    partials: int            # dw partials: CTAs (rows route) or teams (team route)


def _pow2ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def partition(d: int) -> Tuple[int, int]:
    """``(groups, slots)`` of a row of width d: the row is cut into
    ``groups = ceil(d / 8)`` groups of 8 columns, and group g adds its
    squares to slot ``g mod slots``, ``slots = 32 K`` with ``K =
    min(32, pow2ceil(ceil(groups / 64)))``.  The kernel's sum of squares
    follows it on both routes (``csrc/rmsnorm.cu`` says the tree)."""
    groups = -(-d // GROUP)
    return groups, 32 * min(32, _pow2ceil(-(-groups // 64)))


def route(rows: int, d: int, dtype: torch.dtype) -> str:
    """``"rows"`` when there are enough rows to give every SM several
    warps and a lane can hold its share of a row (d up to 2048 in bf16,
    1024 in float32); ``"team"`` otherwise."""
    lane_groups = _pow2ceil(-(-partition(d)[0] // 32))
    if rows >= ROWS_ROUTE_MIN_ROWS and lane_groups <= ROWS_ROUTE_MAX_LANE_GROUPS[dtype]:
        return "rows"
    return "team"


def bwd_plan(rows: int, d: int, dtype: torch.dtype) -> BwdPlan:
    """The backward's plan.  ``"rows"`` (at least 1024 rows, a lane's share
    of a row at most ``BWD_ROWS_MAX_LANE_GROUPS`` groups: d up to 1024 in
    bf16, 512 in float32): a warp a row, CTAs of ``BWD_ROWS_WARPS`` warps,
    a partial a CTA.  ``"team"`` otherwise: a row shared by the fewest
    warps that hold it at ``BWD_TEAM_GROUPS`` groups a thread, in CTAs of
    at most ``BWD_TEAM_MAX_WARPS`` warps (a cluster of them above d 8192),
    a partial a team, as many teams as the card holds at once (fewer
    when there are fewer rows)."""
    groups = -(-d // GROUP)
    lane_groups = -(-groups // 32)
    if rows >= ROWS_ROUTE_MIN_ROWS and lane_groups <= BWD_ROWS_MAX_LANE_GROUPS[dtype]:
        return BwdPlan("rows", BWD_ROWS_WARPS, 1, 32, lane_groups,
                       min(-(-rows // BWD_ROWS_WARPS), BWD_ROWS_CTAS))
    team_warps = -(-groups // (32 * BWD_TEAM_GROUPS))
    cluster = -(-team_warps // BWD_TEAM_MAX_WARPS)
    warps = -(-team_warps // cluster)
    threads = 32 * warps * cluster
    teams = BWD_SMS * min(BWD_TEAM_SM_TEAMS, max(1, BWD_TEAM_SM_WARPS // warps)) // cluster
    return BwdPlan("team", warps, cluster, threads, -(-groups // threads), min(rows, teams))


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            weight_offset: float = 0.0) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · (w + weight_offset)`` over the last
    dimension of ``x`` (any leading dimensions), statistics in float32,
    returned in x's dtype as a new contiguous tensor.

    On the card, ONE launch normalises every row, on the route of
    :func:`route`.  x may be a strided view whose leading dimensions
    merge into one row axis (unit stride in the last); the kernel reads
    it in place.
    """
    d = _check_shapes(x, w)
    if use_plain(x, w):
        return ref.rmsnorm(x, w, eps=eps, weight_offset=weight_offset)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNorm.apply(x, w, float(eps), float(weight_offset))
    return _forward(x, w, eps, weight_offset)


def _check_shapes(x: torch.Tensor, w: torch.Tensor) -> int:
    d = x.shape[-1] if x.dim() else 0
    if x.dim() == 0 or tuple(w.shape) != (d,):
        raise ValueError(f"rmsnorm takes x [..., d] and w [d], got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    return d


def _rows_view(x: torch.Tensor, w: torch.Tensor, d: int) -> torch.Tensor:
    """x as ``[rows, d]`` without a copy, after the kernels' checks."""
    if x.dtype not in _DTYPE_CODE or w.dtype not in _DTYPE_CODE:
        raise TypeError(f"the rmsnorm kernel takes float32 or bfloat16, got x "
                        f"{x.dtype} and w {w.dtype}")
    if d > MAX_D:
        raise ValueError(f"the rmsnorm kernel takes d <= {MAX_D}, got {d}")
    try:
        x2 = x.view(-1, d)
    except RuntimeError:
        raise ValueError("the rmsnorm kernel takes x whose leading dimensions merge "
                         "into one row axis without a copy") from None
    if d > 1 and x2.stride(1) != 1 or not w.is_contiguous():
        raise ValueError("the rmsnorm kernel takes unit stride along d and a "
                         "contiguous w")
    return x2


def _forward(x: torch.Tensor, w: torch.Tensor, eps: float,
             weight_offset: float) -> torch.Tensor:
    d = x.shape[-1]
    x2 = _rows_view(x, w, d)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    rows = x2.shape[0]
    if rows == 0:
        return y
    err = load_library("rmsnorm", SIGNATURES).rt_rmsnorm(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], x2.data_ptr(), w.data_ptr(),
        y.data_ptr(), rows, d, x2.stride(0), float(eps), float(weight_offset),
        ROUTES.index(route(rows, d, x.dtype)), stream_arg(x))
    check_launch("rmsnorm", err)
    rmsnorm.launches += 1
    return y


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *, eps: float = 1e-6,
                weight_offset: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of :func:`rmsnorm` at ``(x, w)`` for the cotangent
    ``dy`` (x's shape): dx in x's dtype, dw in w's, float32 arithmetic.

    On the card ONE launch of the row pass covers every row on the route
    of :func:`bwd_plan` (any leading dimensions, any d the forward takes,
    x strided as the forward reads it), writing dx and the dw partials;
    then one launch adds the partials in a fixed tree: no float atomics,
    so the result is the same bits every run.  ``rmsnorm_bwd.launches``
    counts the call once.  For CPU tensors, the plain version
    :func:`.ref.rmsnorm_vjp`."""
    d = _check_shapes(x, w)
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"rmsnorm_bwd: dy has shape {tuple(dy.shape)}, want {tuple(x.shape)}")
    if use_plain(x, w, dy):
        return ref.rmsnorm_vjp(x, w, dy, eps=eps, weight_offset=weight_offset)
    x2 = _rows_view(x, w, d)
    dy2 = dy.to(x.dtype).reshape(-1, d).contiguous()
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dw = torch.empty((d,), dtype=w.dtype, device=x.device)
    rows = x2.shape[0]
    if rows == 0:
        return dx, dw.zero_()
    plan = bwd_plan(rows, d, x.dtype)
    # the dw partials, 8 ceil(d / 8) wide
    scratch = torch.empty((plan.partials * -(-d // GROUP) * GROUP,), dtype=torch.float32,
                          device=x.device)
    err = load_library("rmsnorm", SIGNATURES).rt_rmsnorm_bwd(
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], x2.data_ptr(), dy2.data_ptr(),
        w.data_ptr(), dx.data_ptr(), dw.data_ptr(), scratch.data_ptr(), rows, d,
        x2.stride(0), float(eps), float(weight_offset), ROUTES.index(plan.route), plan.warps,
        plan.cluster, plan.partials, stream_arg(x))
    check_launch("rmsnorm", err)
    rmsnorm_bwd.launches += 1
    return dx, dw


class _RMSNorm(torch.autograd.Function):
    """The kernel's forward with :func:`rmsnorm_bwd` as its backward."""

    @staticmethod
    def forward(ctx, x, w, eps, weight_offset):
        ctx.save_for_backward(x, w)
        ctx.eps, ctx.weight_offset = eps, weight_offset
        return _forward(x, w, eps, weight_offset)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd(x, w, dy, eps=ctx.eps, weight_offset=ctx.weight_offset)
        return dx, dw, None, None


rmsnorm.launches = 0
rmsnorm_bwd.launches = 0


def launch_counts() -> Dict[str, int]:
    return {"rmsnorm": rmsnorm.launches, "rmsnorm_bwd": rmsnorm_bwd.launches}


def reset_launches() -> None:
    rmsnorm.launches = 0
    rmsnorm_bwd.launches = 0
