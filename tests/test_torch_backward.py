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
* a float64 emulation of the SSD backward kernel's arithmetic (32-row
  sub-chunks, recomputed start states, the carried dL/dh, the per-head
  partials summed over a group) against the plain VJP: rtol 1e-5 plus
  1e-5 of the leaf's largest entry.  A change to the kernel's algorithm
  must be mirrored in :func:`emulate_ssd_bwd`;
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


@pytest.mark.parametrize("case", SSD_CASES, ids=str)
def test_ssd_plain_vjp_matches_jax_vjp(case):
    x, dt, A, Bm, C, h0, dy, dh = _ssd_inputs(*case)
    got = ref.ssd_scan_vjp(*map(_t, (x, dt, A, Bm, C, h0, dy, dh)))
    ins = [jnp.asarray(a) for a in (x, dt, A, Bm, C)]
    if h0 is None:
        fn = lambda *a: jref.ssd_scan(*a, return_state=True)
    else:
        ins.append(jnp.asarray(h0))
        fn = lambda *a: jref.ssd_scan(*a[:5], init_state=a[5], return_state=True)
    _, vjp = jax.vjp(fn, *ins)
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
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
    before = ssd.ssd_scan_bwd.launches
    got = ssd.ssd_scan_bwd(x, dt, A, Bm, C, init_state=h0, dy=dy, dh=dh)
    assert ssd.ssd_scan_bwd.launches == before
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
