"""The backward kernels' plain versions and arithmetic, on the CPU.

The two hand-written backward kernels (``rt_rmsnorm_bwd`` and
``rt_ssd_scan_bwd``) run only on the card, where ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` hold them against their plain versions.  Here:

* the plain versions (``ref.rmsnorm_vjp``, ``ref.ssd_scan_vjp``:
  ``torch.autograd.grad`` of the plain functions) against the JAX
  package's VJPs (``jax.vjp`` of ``repro.kernels.ref``, which is what the
  reference's ``custom_vjp`` differentiates): float32, rtol 1e-5 plus
  1e-5 of the leaf's largest entry (the same arithmetic in another
  order);
* a float64 emulation of the CUDA-core SSD backward kernel's arithmetic
  (32-row sub-chunks, recomputed start states, the carried dL/dh, the
  per-head partials summed over a group) against the plain VJP: rtol 1e-5
  plus 1e-5 of the leaf's largest entry.  A change to the kernel's
  algorithm must be mirrored in :func:`emulate_ssd_bwd`;
* a float32 emulation of the tensor-core SSD backward kernel's arithmetic
  (:func:`emulate_ssd_bwd_wgmma`: chunks in parallel, the prefix and suffix
  combinations of the states in cluster groups, da from its pairs, the
  operands cut into bf16 parts) against the plain VJP and ``jax.vjp``
  within the kernel's gradient bound (``chip_smoke.py``'s GRAD_RTOL 2e-4
  plus GRAD_FRAC 2e-5 of the leaf's largest entry, one bf16 rounding more
  for a bf16 result): in float32 without parts, and at the served widths
  with ``ssd_scan.BWD_PARTS``, one part fewer of any operand leaving the
  bound.  A change to that kernel's algorithm or parts must be mirrored
  in :func:`emulate_ssd_bwd_wgmma`.  The N-16 tensor-core backward
  (hymba's widths, P 64, N 16) runs the same arithmetic with
  ``ssd_scan.BWD_PARTS_N16``: held the same way against the plain VJP and
  ``jax.vjp`` at several sequence lengths, with and without init_state
  and dh, one part fewer of any operand leaving the bound;
* a float32 emulation of the RMSNorm backward kernel's order of operations
  (:func:`emulate_rmsnorm_bwd`: the row sums by the plan's thread layout,
  the lanes' butterfly and the team's warps in order; dw by the plan's
  partition of rows into partials and the dw pass's fixed tree) against
  the plain VJP and ``jax.vjp`` at the plain VJP's bounds, on both routes,
  a cluster of CTAs a row and more rows than partials.  A change to that
  kernel's order or plan must be mirrored in :func:`emulate_rmsnorm_bwd`;
* the wrappers on CPU tensors run the plain versions (no launch counted),
  and ``ops.rmsnorm`` / ``ops.ssd_scan`` stay differentiable by autograd.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as rk
from repro_torch.kernels import ssd_scan as ssd
from test_torch_ssd import _split

# (B, S, H, P, G, N, init_state): a short last sub-chunk, 2 groups, the
# smoke model's P 16 / N 16 at S 32 (one sub-chunk), several sub-chunks
SSD_CASES = [
    (2, 45, 4, 8, 2, 16, True),
    (1, 70, 2, 16, 1, 8, False),
    (2, 32, 4, 16, 1, 16, True),
    (1, 100, 6, 4, 3, 4, False),
]


def _close(got, want, rtol=1e-5, frac=1e-5):
    g = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = want.detach().double().numpy() if isinstance(want, torch.Tensor) else np.asarray(
        want, np.float64)
    np.testing.assert_allclose(g, w, rtol=rtol, atol=frac * float(np.abs(w).max()) + 1e-30)


def _ssd_inputs(B, S, H, P, G, N, init, seed=5):
    rs = np.random.RandomState(seed)
    f = lambda *shape: rs.randn(*shape).astype(np.float32)
    x, Bm, C = f(B, S, H, P), f(B, S, G, N) * 0.5, f(B, S, G, N) * 0.5
    dt = np.log1p(np.exp(f(B, S, H) - 1.0)).astype(np.float32)
    A = -np.exp(f(H) * 0.5).astype(np.float32)
    h0 = f(B, H, P, N) if init else None
    dy, dh = f(B, S, H, P), f(B, H, P, N)
    return x, dt, A, Bm, C, h0, dy, dh


def _t(a):
    return None if a is None else torch.from_numpy(a)


def emulate_ssd_bwd(x, dt, A, Bm, C, h0, dy, dh, L=ssd.BWD_ROWS):
    """``csrc/ssd_scan.cu``'s backward (namespace ``bwd``) in float64,
    vectorised over (batch, head): the start state of every L-row
    sub-chunk recomputed forward, then the sub-chunks in reverse with the
    carried ``U = dL/dh``; dB and dC from per-head partials summed over a
    group, dA over the batch."""
    f = torch.float64
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    x, dt, A = x.to(f), dt.to(f), A.to(f)
    Bh, Ch = Bm.to(f).repeat_interleave(rep, 2), C.to(f).repeat_interleave(rep, 2)
    dy = torch.zeros_like(x) if dy is None else dy.to(f)
    U = torch.zeros(Bsz, H, P, N, dtype=f) if dh is None else dh.to(f).clone()
    state = torch.zeros(Bsz, H, P, N, dtype=f) if h0 is None else h0.to(f).clone()
    starts = []
    for t0 in range(0, S, L):
        sl = slice(t0, min(S, t0 + L))
        starts.append(state)
        cum = torch.cumsum(A * dt[:, sl], 1)
        w = torch.exp(cum[:, -1:] - cum) * dt[:, sl]
        state = (torch.exp(cum[:, -1])[..., None, None] * state
                 + torch.einsum("bsh,bshp,bshn->bhpn", w, x[:, sl], Bh[:, sl]))
    dx, ddt = torch.zeros_like(x), torch.zeros_like(dt)
    dB, dC, dA = torch.zeros_like(Bh), torch.zeros_like(Ch), torch.zeros(H, dtype=f)
    for k in reversed(range(len(starts))):
        t0 = k * L
        sl = slice(t0, min(S, t0 + L))
        n = sl.stop - t0
        H0, xs, dys, Bs, Cs, d = starts[k], x[:, sl], dy[:, sl], Bh[:, sl], Ch[:, sl], dt[:, sl]
        cum = torch.cumsum(A * d, 1)
        eh, wend = torch.exp(cum), torch.exp(cum[:, -1:] - cum)
        tri = torch.tril(torch.ones(n, n, dtype=torch.bool))[None, :, :, None]
        diff = torch.where(tri, cum[:, :, None, :] - cum[:, None, :, :], 0.0)
        Lm = torch.where(tri, torch.exp(diff), 0.0)                       # [b,t,s,h]
        DX = torch.einsum("bthp,bshp->btsh", dys, xs)
        M1 = torch.einsum("bthn,bshn->btsh", Cs, Bs) * Lm
        M2 = DX * Lm
        RI = torch.einsum("btsh,bthp->bshp", M1, dys)
        UB = torch.einsum("bhpn,bshn->bshp", U, Bs)
        dx[:, sl] = d[..., None] * (RI + wend[..., None] * UB)
        UX = torch.einsum("bhpn,bshp->bshn", U, xs)
        dB[:, sl] = d[..., None] * (torch.einsum("btsh,bthn->bshn", M2, Cs)
                                    + wend[..., None] * UX)
        inter = eh[..., None] * torch.einsum("bhpn,bthp->bthn", H0, dys)
        dC[:, sl] = inter + torch.einsum("btsh,bsh,bshn->bthn", M2, d, Bs)
        ri, re = (xs * RI).sum(-1), (xs * UB).sum(-1)
        E = d * wend * re
        dcum = (M1 * DX * d[:, None]).sum(2) - d * ri + (inter * Cs).sum(-1) - E
        dcum[:, -1] += eh[:, -1] * (U * H0).sum((-1, -2)) + E.sum(1)
        da = torch.flip(torch.cumsum(torch.flip(dcum, [1]), 1), [1])
        ddt[:, sl] = ri + wend * re + A * da
        dA += (d * da).sum((0, 1))
        U = eh[:, -1][..., None, None] * U + torch.einsum("bth,bthp,bthn->bhpn", eh, dys, Cs)
    fold = lambda t: t.reshape(Bsz, S, G, rep, N).sum(3)
    return dx, ddt, dA, fold(dB), fold(dC), (U if h0 is not None else None)


def emulate_ssd_bwd_wgmma(x, dt, A, Bm, C, h0, dy, dh, chunk=128, parts=None, cluster=None):
    """``csrc/ssd_scan.cu``'s tensor-core backward (namespace ``tcb``) in
    float32, vectorised over (batch, head, chunk).  Per chunk of ``chunk``
    rows, padded with zeros and dt 0: cum, the increments h_inc = (x o wend
    dt)^T B and u_inc = (eh o dy)^T C; then, over groups of ``cluster``
    chunks (a cluster's CTAs; default one a chunk, at most 8), each
    chunk's start state H0 by prefix combination (groups walked forward,
    the carry init_state) and its end cotangent U by suffix combination
    (groups in reverse, the carry dh), dh0 the U the first chunk leaves;
    the local gradients with the state products' rows scaled before the
    slices add; da summed from its parts and pairs (no row-minus-column
    cancellation).  ``parts = (x o w, eh o dy, scores, H0, U)`` cuts those
    wgmma operands into bf16 parts first (None: float32, uncut).  Returns
    the six gradients, dx, dB and dC in x's dtype."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2:]
    rep = H // G
    cut = (lambda v, n: v) if parts is None else _split
    pw, pe, ps, ph, pu = parts or (0,) * 5
    nc = -(-S // chunk)
    K = min(nc, ssd.MAX_CLUSTER) if cluster is None else cluster

    def chunked(t, width):  # [B, S, H, width] -> [B, H, chunks, chunk, width]
        out = torch.zeros(Bsz, nc * chunk, H, width)
        out[:, :S] = t.float()
        return out.view(Bsz, nc, chunk, H, width).permute(0, 3, 1, 2, 4)

    T = lambda m: m.transpose(-1, -2)  # noqa: E731
    scale = lambda e: torch.exp(e)[..., None, None]  # noqa: E731
    xs = chunked(x, P)
    dys = chunked(torch.zeros_like(x) if dy is None else dy, P)
    Bs, Cs = (chunked(t.repeat_interleave(rep, 2), N) for t in (Bm, C))
    dts = chunked(dt[..., None], 1)[..., 0]
    cum = torch.cumsum(A[None, :, None, None] * dts, -1)
    last = cum[..., -1]                                          # [B, H, chunks]
    eh, wend = torch.exp(cum), torch.exp(last[..., None] - cum)
    h_inc = T(cut(xs * (wend * dts)[..., None], pw)) @ Bs
    u_inc = T(cut(dys * eh[..., None], pe)) @ Cs
    carry = torch.zeros(Bsz, H, P, N) if h0 is None else h0.float()
    H0 = [None] * nc
    for g0 in range(0, nc, K):
        for c in range(g0, min(g0 + K, nc)):
            H0[c] = scale(last[..., g0:c].sum(-1)) * carry
            for j in range(g0, c):
                H0[c] = H0[c] + scale(last[..., j + 1:c].sum(-1)) * h_inc[:, :, j]
        carry = scale(last[..., c]) * H0[c] + h_inc[:, :, c]
    carry = torch.zeros(Bsz, H, P, N) if dh is None else dh.float()
    U = [None] * nc
    for g0 in reversed(range(0, nc, K)):
        end = min(g0 + K, nc)
        for c in range(g0, end):
            U[c] = scale(last[..., c + 1:end].sum(-1)) * carry
            for j in range(c + 1, end):
                U[c] = U[c] + scale(last[..., c + 1:j].sum(-1)) * u_inc[:, :, j]
        carry = scale(last[..., g0]) * U[g0] + u_inc[:, :, g0]
    H0, U = torch.stack(H0, 2), torch.stack(U, 2)
    causal = torch.ones(chunk, chunk, dtype=torch.bool).tril()   # [t, s]: t >= s
    Lm = torch.where(causal, torch.exp(torch.where(causal, cum[..., :, None] - cum[..., None, :],
                                                   0.0)), 0.0)
    Hc, Uc = cut(H0, ph), cut(U, pu)
    dxa = (Bs @ T(Uc)) * wend[..., None]
    E = dts * (xs * dxa).sum(-1)
    dxa = dxa + cut((Bs @ T(Cs)) * T(Lm), ps) @ dys
    ddtd = (xs * dxa).sum(-1)
    dx = dts[..., None] * dxa
    dBh = dts[..., None] * ((xs @ Uc) * wend[..., None] + cut((xs @ T(dys)) * T(Lm), ps) @ Cs)
    M2dt = (dys @ T(xs)) * Lm * dts[..., None, :]                 # [t, u]
    dCs = (dys @ Hc) * eh[..., None]
    dCh = dCs + cut(M2dt, ps) @ Bs
    y0 = (Cs * dCs).sum(-1)
    Q = (Cs @ T(Bs)) * M2dt
    pairs = ((torch.cumsum(Q, -1) - Q) * causal).sum(-2)        # sum_{t>=s} sum_{u<s} Q[t, u]
    da = (torch.flip(torch.cumsum(torch.flip(y0, [-1]), -1), [-1])
          + (eh[..., -1] * (U * H0).sum((-1, -2)))[..., None]
          + torch.cumsum(E, -1) - E + pairs)
    ddt = ddtd + A[None, :, None, None] * da
    dA = (dts * da).sum((0, 2, 3))

    def unchunk(t):  # [B, H, chunks, chunk, ...] -> [B, S, H, ...]
        t = t.permute(0, 2, 3, 1, *range(4, t.dim()))
        return t.reshape(Bsz, nc * chunk, H, *t.shape[4:])[:, :S]

    fold = lambda t: unchunk(t).reshape(Bsz, S, G, rep, N).sum(3).to(x.dtype)  # noqa: E731
    return (unchunk(dx).to(x.dtype), unchunk(ddt), dA, fold(dBh), fold(dCh),
            carry if h0 is not None else None)


def _jax_vjp(x, dt, A, Bm, C, h0, dy, dh):
    ins = [jnp.asarray(a) for a in (x, dt, A, Bm, C)]
    if h0 is None:
        fn = lambda *a: jref.ssd_scan(*a, return_state=True)  # noqa: E731
    else:
        ins.append(jnp.asarray(h0))
        fn = lambda *a: jref.ssd_scan(*a[:5], init_state=a[5], return_state=True)  # noqa: E731
    _, vjp = jax.vjp(fn, *ins)
    return vjp((jnp.asarray(dy), jnp.asarray(dh)))


GRAD_RTOL, GRAD_FRAC = 2e-4, 2e-5  # chip_smoke.py's bound of the backward kernels


def _bound_share(got, want):
    """The share of the backward kernels' bound (``chip_smoke.py``
    ``grad_check``) that ``got`` uses against ``want``."""
    g, w = got.float(), torch.as_tensor(np.array(want)).float()
    bound = GRAD_RTOL * w.abs() + GRAD_FRAC * float(w.abs().max()) + 1e-30
    if got.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -8 * (g.abs() + w.abs())
    return float(((g - w).abs() / bound).max())


@pytest.mark.parametrize("cluster", [None, 1, 2, 3])
@pytest.mark.parametrize("case", SSD_CASES + [(1, 300, 2, 8, 1, 16, True)], ids=str)
def test_wgmma_backward_arithmetic_matches_plain_and_jax_vjp(case, cluster):
    """In float32 without parts, at chunk 16 (S 45 to 300: 3 to 19 chunks,
    so S 300 spans three groups of 8, and every case several groups of 1,
    2 or 3: each chunk's own, even and ragged), the tensor-core backward's
    form meets the kernel's gradient bound against the plain VJP and
    against ``jax.vjp`` of the reference scan."""
    x, dt, A, Bm, C, h0, dy, dh = _ssd_inputs(*case)
    got = emulate_ssd_bwd_wgmma(*map(_t, (x, dt, A, Bm, C, h0, dy, dh)), chunk=16,
                                cluster=cluster)
    want = ref.ssd_scan_vjp(*map(_t, (x, dt, A, Bm, C, h0, dy, dh)))
    jwant = _jax_vjp(x, dt, A, Bm, C, h0, dy, dh)
    assert (got[5] is None) == (h0 is None) == (want[5] is None)
    for g, w, jw in zip([g for g in got if g is not None], [w for w in want if w is not None],
                        jwant):
        assert _bound_share(g, w) <= 1 and _bound_share(g, jw) <= 1


def _served_bwd_inputs(init, B=2, S=300, H=8, G=2, P=64, N=128, seed=0):
    """bf16 x, B, C (views of one conv output) and dy at the served widths,
    softplus dt, A = -e, as ``chip_smoke.py`` draws them; S 300 leaves a
    short last chunk; with ``init``, init_state and dh too."""
    gen = torch.Generator().manual_seed(seed)
    wide = torch.randn(B, S, H * P + 2 * G * N, generator=gen).bfloat16()
    x = wide[..., :H * P].reshape(B, S, H, P)
    Bm = wide[..., H * P:H * P + G * N].reshape(B, S, G, N)
    C = wide[..., H * P + G * N:].reshape(B, S, G, N)
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, generator=gen))
    A = torch.full((H,), -float(np.e))
    h0 = torch.randn(B, H, P, N, generator=gen) if init else None
    dy = torch.randn(B, S, H, P, generator=gen).bfloat16()
    dh = torch.randn(B, H, P, N, generator=gen) if init else None
    return x, dt, A, Bm, C, h0, dy, dh


@pytest.fixture(scope="module")
def served_bwd():
    """The served-width inputs with init_state and dh, and their plain VJP
    on the widened values."""
    ins = _served_bwd_inputs(True)
    x, dt, A, Bm, C, h0, dy, dh = ins
    return ins, ref.ssd_scan_vjp(x.float(), dt, A, Bm.float(), C.float(), h0, dy.float(), dh)


def _shares(got, want):
    return [_bound_share(g, w) for g, w in zip(got, want) if g is not None]


@pytest.mark.parametrize("init", [True, False], ids=["init_dh", "dy_only"])
def test_wgmma_backward_served_parts_meet_the_bound(served_bwd, init):
    """bf16 inputs at P 64, N 128, two groups, a short last chunk, with
    init_state and dh and as the model calls it (dy only): with
    ``ssd_scan.BWD_PARTS`` every gradient meets the kernel's bound against
    the plain VJP of the widened inputs."""
    if init:
        ins, want = served_bwd
    else:
        ins = _served_bwd_inputs(False)
        x, dt, A, Bm, C, h0, dy, dh = ins
        want = ref.ssd_scan_vjp(x.float(), dt, A, Bm.float(), C.float(), None, dy.float(), None)
    got = emulate_ssd_bwd_wgmma(*ins, parts=ssd.BWD_PARTS)
    assert all(bool(torch.isfinite(g.float()).all()) for g in got if g is not None)
    assert max(_shares(got, want)) <= 1


def test_one_part_fewer_of_any_operand_breaks_the_gradient_bound(served_bwd):
    """Why every operand takes two parts: with any one of x o w, eh o dy,
    the scores, H0 or U in a single part (a rounding of 2^-9 of each term),
    some gradient leaves the bound (ddt, dh0, dx, ddt and dx
    respectively, through dA's and ddt's sums); the served parts do not."""
    ins, want = served_bwd
    assert ssd.BWD_PARTS in ssd.BWD_PARTS_VARIANTS
    assert max(_shares(emulate_ssd_bwd_wgmma(*ins, parts=ssd.BWD_PARTS), want)) <= 1
    for i in range(5):
        fewer = tuple(1 if j == i else n for j, n in enumerate(ssd.BWD_PARTS))
        assert max(_shares(emulate_ssd_bwd_wgmma(*ins, parts=fewer), want)) > 1, fewer


@pytest.fixture(scope="module")
def served_bwd_n16():
    """hymba's widths (P 64, N 16, G 1) at B 1, H 2, S 200 (a short last
    chunk) with init_state and dh, and their plain VJP on the widened
    inputs."""
    ins = _served_bwd_inputs(True, B=1, S=200, H=2, G=1, N=16, seed=16)
    x, dt, A, Bm, C, h0, dy, dh = ins
    return ins, ref.ssd_scan_vjp(x.float(), dt, A, Bm.float(), C.float(), h0, dy.float(), dh)


@pytest.mark.parametrize("init", [True, False], ids=["S200_init_dh", "S256_dy_only"])
def test_wgmma_n16_backward_served_parts_meet_the_bound(served_bwd_n16, init):
    """bf16 inputs at hymba's widths, one CTA a chunk: with
    ``ssd_scan.BWD_PARTS_N16`` every gradient meets the kernel's bound
    against the plain VJP of the widened inputs, with init_state and dh
    and a short last chunk (also against ``jax.vjp`` of the reference
    scan) and as the model calls it (dy only, two whole chunks)."""
    if init:
        ins, want = served_bwd_n16
    else:
        ins = _served_bwd_inputs(False, B=1, S=256, H=2, G=1, N=16, seed=256)
        x, dt, A, Bm, C, _, dy, _ = ins
        want = ref.ssd_scan_vjp(x.float(), dt, A, Bm.float(), C.float(), None, dy.float(), None)
    got = emulate_ssd_bwd_wgmma(*ins, parts=ssd.BWD_PARTS_N16)
    assert all(bool(torch.isfinite(g.float()).all()) for g in got if g is not None)
    assert max(_shares(got, want)) <= 1
    if init:
        jwant = _jax_vjp(*[None if t is None else t.float().numpy() for t in ins])
        assert max(_shares(got, jwant)) <= 1


def test_one_part_fewer_of_any_operand_breaks_the_n16_gradient_bound(served_bwd_n16):
    """At N 16 as at N 128 every operand takes two parts: with any one of
    x o w, eh o dy, the scores, H0 or U in a single part some gradient
    leaves the bound (at S 200; at S 160 one part of x o w happens to
    stay inside it); the served parts do not."""
    ins, want = served_bwd_n16
    assert ssd.BWD_PARTS_N16 in ssd.BWD_PARTS_N16_VARIANTS
    assert max(_shares(emulate_ssd_bwd_wgmma(*ins, parts=ssd.BWD_PARTS_N16), want)) <= 1
    for i in range(5):
        fewer = tuple(1 if j == i else n for j, n in enumerate(ssd.BWD_PARTS_N16))
        assert max(_shares(emulate_ssd_bwd_wgmma(*ins, parts=fewer), want)) > 1, fewer


def test_ssd_bwd_route_is_a_function_of_dtype_and_shape():
    import inspect
    assert list(inspect.signature(ssd.bwd_route).parameters) == [
        "dtype", "head_dim", "state_dim"]
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {(bf16, 64, 128): "wgmma",        # mamba2's training shapes
             (f32, 64, 128): "cuda_core",     # float32 keeps CUDA cores
             (bf16, 32, 128): "cuda_core", (bf16, 64, 64): "cuda_core",
             (bf16, 16, 16): "cuda_core", (torch.float16, 64, 128): "cuda_core",
             (bf16, 64, 16): "wgmma_n16",     # hymba's training shapes
             (f32, 64, 16): "cuda_core", (bf16, 32, 16): "cuda_core",
             (torch.float16, 64, 16): "cuda_core"}
    assert {c: ssd.bwd_route(*c) for c in cases} == cases


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_plain_vjp_matches_jax_vjp(case):
    x, dt, A, Bm, C, h0, dy, dh = _ssd_inputs(*case)
    got = ref.ssd_scan_vjp(*map(_t, (x, dt, A, Bm, C, h0, dy, dh)))
    want = _jax_vjp(x, dt, A, Bm, C, h0, dy, dh)
    assert (got[5] is None) == (h0 is None)
    for g, w in zip([g for g in got if g is not None], want):
        _close(g, np.asarray(w))


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
@pytest.mark.parametrize("cotangents", ["both", "dy", "dh"])
def test_ssd_backward_kernel_arithmetic_matches_plain_vjp(case, cotangents):
    x, dt, A, Bm, C, h0, dy, dh = map(_t, _ssd_inputs(*case))
    dy = dy if cotangents in ("both", "dy") else None
    dh = dh if cotangents in ("both", "dh") else None
    got = emulate_ssd_bwd(x, dt, A, Bm, C, h0, dy, dh)
    want = ref.ssd_scan_vjp(x, dt, A, Bm, C, h0, dy, dh)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            _close(g, w)


def test_ssd_bwd_wrapper_takes_the_plain_version_on_cpu():
    x, dt, A, Bm, C, h0, dy, dh = map(_t, _ssd_inputs(*SSD_CASES[0]))
    before = ssd.launch_counts()
    got = ssd.ssd_scan_bwd(x, dt, A, Bm, C, init_state=h0, dy=dy, dh=dh)
    assert ssd.launch_counts() == before
    want = ref.ssd_scan_vjp(x, dt, A, Bm, C, h0, dy, dh)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="dy has shape"):
        ssd.ssd_scan_bwd(x, dt, A, Bm, C, dy=dy[:, 1:])


def test_ops_ssd_scan_is_differentiable_on_cpu():
    x, dt, A, Bm, C, h0, dy, dh = map(_t, _ssd_inputs(*SSD_CASES[0]))
    ins = [t.requires_grad_() for t in (x, dt, A, Bm, C, h0)]
    y, h = ops.ssd_scan(*ins[:5], init_state=ins[5], chunk=16, return_state=True)
    grads = torch.autograd.grad((y, h), ins, (dy, dh))
    want = ref.ssd_scan_vjp(*[t.detach() for t in ins[:5]], h0, dy, dh)
    for g, w in zip(grads, want):
        _close(g, w)


# (shape, eps, weight_offset): a gated-norm row (d 5120), leading
# dimensions, an odd width
NORM_CASES = [((6, 5120), 1e-5, 1.0), ((2, 3, 7, 256), 1e-6, 0.0), ((5, 1000), 1e-6, 1.0)]


@pytest.mark.parametrize("shape,eps,offset", NORM_CASES, ids=str)
def test_rmsnorm_plain_vjp_matches_jax_vjp(shape, eps, offset):
    rs = np.random.RandomState(7)
    x = rs.randn(*shape).astype(np.float32)
    w = rs.randn(shape[-1]).astype(np.float32) * 0.1
    dy = rs.randn(*shape).astype(np.float32)
    dx, dw = ref.rmsnorm_vjp(_t(x), _t(w), _t(dy), eps=eps, weight_offset=offset)
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm(a, b, eps=eps, weight_offset=offset),
                     jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(dy))
    _close(dx, np.asarray(want_dx))
    _close(dw, np.asarray(want_dw))
    # the wrapper on CPU tensors: the plain version, no launch
    before = rk.rmsnorm_bwd.launches
    got = rk.rmsnorm_bwd(_t(x), _t(w), _t(dy), eps=eps, weight_offset=offset)
    assert rk.rmsnorm_bwd.launches == before
    assert torch.equal(got[0], dx) and torch.equal(got[1], dw)


def test_ops_rmsnorm_is_differentiable_on_cpu():
    rs = np.random.RandomState(8)
    x = _t(rs.randn(4, 9, 64).astype(np.float32)).requires_grad_()
    w = _t(rs.randn(64).astype(np.float32)).requires_grad_()
    dy = _t(rs.randn(4, 9, 64).astype(np.float32))
    dx, dw = torch.autograd.grad(ops.rmsnorm(x, w, eps=1e-5, weight_offset=1.0), (x, w), dy)
    want = ref.rmsnorm_vjp(x.detach(), w.detach(), dy, eps=1e-5, weight_offset=1.0)
    _close(dx, want[0])
    _close(dw, want[1])


def _fma(a, b, c):
    """float32 ``a * b + c`` rounded once (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _butterfly(t):
    """``warp_total`` over the last axis, in lanes of 32: lane l adds lane
    l xor m for m 16, 8, 4, 2, 1; every lane ends with the total."""
    lane = torch.arange(32)
    t = t.unflatten(-1, (-1, 32))
    for m in (16, 8, 4, 2, 1):
        t = t + t[..., lane ^ m]
    return t.flatten(-2)


def emulate_rmsnorm_bwd(x, w, dy, eps, offset):
    """``csrc/rmsnorm.cu``'s backward (``rmsnorm_bwd_rows_kernel`` /
    ``rmsnorm_bwd_team_kernel``, then ``rmsnorm_dw_kernel``) in float32 on the plan of
    ``rmsnorm.bwd_plan``, vectorised over rows.  Thread u of a row holds
    groups u, u + T, ... (T the row's threads); its two sums run over them
    in order (one fma an element), the lanes meet by the butterfly and a
    team's warps in order.  dw: each partial adds its rows' dy * (x * r)
    in row order (a rows-route CTA's warps each theirs, then added in warp
    order); then, a column at a time, slice u of ``BWD_DW_SLICES`` adds
    partials u, u + 64, ... in order, a warp's 8 slices meet by the
    butterfly and the warps in order.  Returns (dx in x's dtype, dw in
    w's)."""
    d = x.shape[-1]
    X = x.reshape(-1, d).float()
    DY = dy.reshape(-1, d).to(x.dtype).float()
    rows = X.shape[0]
    plan = rk.bwd_plan(rows, d, x.dtype)
    T, NG = plan.row_threads, plan.groups_per_thread
    width = T * NG * rk.GROUP
    pad = lambda t: torch.nn.functional.pad(t, (0, width - d))  # noqa: E731
    X, DY = pad(X), pad(DY)
    WP = pad((w.float() + offset)[None])
    GW = DY * WP
    by_thread = lambda t: t.view(rows, NG, T, rk.GROUP)  # noqa: E731
    ss, gx = torch.zeros(rows, T), torch.zeros(rows, T)
    for i in range(NG):
        for e in range(rk.GROUP):
            xe, ge = by_thread(X)[:, i, :, e], by_thread(GW)[:, i, :, e]
            ss, gx = _fma(xe, xe, ss), _fma(ge, xe, gx)
    ss, gx = _butterfly(ss)[:, ::32], _butterfly(gx)[:, ::32]   # [rows, warps of the row]
    if plan.route == "rows":
        ss, gx = ss[:, 0], gx[:, 0]
    else:
        s_tot, g_tot = torch.zeros(rows), torch.zeros(rows)
        for k in range(ss.shape[1]):
            s_tot, g_tot = s_tot + ss[:, k], g_tot + gx[:, k]
        ss, gx = s_tot, g_tot
    rs = torch.rsqrt(ss / d + eps)[:, None]
    c = (rs * rs) * (gx / d)[:, None]
    dx = (rs * (GW - X * c))[:, :d].to(x.dtype).reshape(x.shape)
    XR = X * rs

    def partial_sums(n):
        """dy * (x * r) of rows u, u + n, ... added in order, for u < n."""
        acc = torch.zeros(n, width)
        for r0 in range(0, rows, n):
            m = min(n, rows - r0)
            acc[:m] = _fma(DY[r0:r0 + m], XR[r0:r0 + m], acc[:m])
        return acc

    P = plan.partials
    if plan.route == "rows":
        warp_acc = partial_sums(P * plan.warps).view(P, plan.warps, width)
        part = warp_acc[:, 0]
        for k in range(1, plan.warps):
            part = part + warp_acc[:, k]
    else:
        part = partial_sums(P)
    # a column quad's slices: slice u adds partials u, u + 64, ... in order
    n = rk.BWD_DW_SLICES
    slices = torch.zeros(n, width)
    for u in range(min(n, P)):
        slices[u] = part[u]
        for p in range(u + n, P, n):
            slices[u] = slices[u] + part[p]
    # a warp's 8 slices by the butterfly (pairs differing in the slice's
    # bit 0, then 1, then 2), then the warps in order
    by_warp = slices.view(n // 8, 8, width)
    idx = torch.arange(8)
    for bit in (1, 2, 4):
        by_warp = by_warp + by_warp[:, idx ^ bit]
    dw = by_warp[0, 0]
    for k in range(1, n // 8):
        dw = dw + by_warp[k, 0]
    return dx, dw[:d].to(w.dtype)


# NORM_CASES, then: the rows route (1100 rows of 512 in float32: 275 CTAs of
# 4 warps), more rows than team partials (600 rows of 256 on 1-warp teams:
# the plan's 600; 1100 rows of 1000: 264 teams of 2 warps), and a team of a
# cluster of 3 CTAs (d 16392)
EMU_CASES = NORM_CASES + [((1100, 512), 1e-6, 1.0), ((600, 256), 1e-5, 0.0),
                          ((1100, 1000), 1e-6, 1.0), ((3, 16392), 1e-6, 1.0)]


@pytest.mark.parametrize("shape,eps,offset", EMU_CASES, ids=str)
def test_rmsnorm_backward_kernel_arithmetic_matches_plain_and_jax_vjp(shape, eps, offset):
    """The backward kernel's order of operations, in float32, within the
    plain VJP's bounds (rtol 1e-5 plus 1e-5 of the leaf's largest entry)
    of ``ref.rmsnorm_vjp`` and of ``jax.vjp`` of the reference norm."""
    rs = np.random.RandomState(9)
    x = rs.randn(*shape).astype(np.float32)
    w = rs.randn(shape[-1]).astype(np.float32) * 0.1
    dy = rs.randn(*shape).astype(np.float32)
    dx, dw = emulate_rmsnorm_bwd(_t(x), _t(w), _t(dy), eps, offset)
    assert dx.shape == x.shape and dw.shape == w.shape
    want = ref.rmsnorm_vjp(_t(x), _t(w), _t(dy), eps=eps, weight_offset=offset)
    _, vjp = jax.vjp(lambda a, b: jref.rmsnorm(a, b, eps=eps, weight_offset=offset),
                     jnp.asarray(x), jnp.asarray(w))
    for got, plain, jw in zip((dx, dw), want, vjp(jnp.asarray(dy))):
        _close(got, plain)
        _close(got, np.asarray(jw))


def test_rmsnorm_bwd_plan_is_a_function_of_rows_d_dtype():
    """The backward's route and partial count (so the order in which dw is
    added) follow from (rows, d, dtype) alone; every plan covers the row
    at its groups per thread, and the training shapes take the routes
    and partial counts the kernel table times."""
    import inspect
    assert list(inspect.signature(rk.bwd_plan).parameters) == ["rows", "d", "dtype"]
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {(2048, 2560, bf16): ("team", 528), (2048, 5120, bf16): ("team", 264),
             (4096, 1024, bf16): ("rows", 396), (4096, 1024, f32): ("team", 1056),
             (1024, 512, f32): ("rows", 256), (1023, 512, f32): ("team", 1023),
             (4096, 1032, bf16): ("team", 792), (1, 5120, bf16): ("team", 1),
             (37, 1152, f32): ("team", 37), (3, rk.MAX_D, bf16): ("team", 3),
             (2048, 8192, bf16): ("team", 132), (264, 32768, f32): ("team", 33)}
    got = {c: rk.bwd_plan(*c) for c in cases}
    assert {c: (p.route, p.partials) for c, p in got.items()} == cases
    assert got == {c: rk.bwd_plan(*c) for c in cases}
    for (rows, d, dtype), p in got.items():
        groups = -(-d // rk.GROUP)
        assert p.row_threads * p.groups_per_thread >= groups
        assert 1 <= p.partials <= rows
        if p.route == "rows":
            assert (p.warps, p.cluster, p.row_threads) == (rk.BWD_ROWS_WARPS, 1, 32)
            assert p.groups_per_thread <= rk.BWD_ROWS_MAX_LANE_GROUPS[dtype]
        else:
            assert p.row_threads == 32 * p.warps * p.cluster
            assert p.groups_per_thread <= rk.BWD_TEAM_GROUPS
            assert p.warps <= rk.BWD_TEAM_MAX_WARPS and p.cluster <= 8
    assert rk.bwd_plan(3, rk.MAX_D, bf16).cluster == 4
