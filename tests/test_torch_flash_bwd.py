"""Flash attention's backward on the CPU: the port's gradients against
the JAX package's, and the CUDA kernels' tiled algorithm emulated.

The backward kernels (``rt_flash_attention_bwd`` in
``src/repro_torch/kernels/csrc/flash_attention.cu``) run only on the card,
where ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold them against
``ref.attention_vjp``.  Here, on seeded numpy inputs:

* ``ops.flash_attention`` under autograd on CPU tensors (the plain
  version, differentiated by autograd) against ``jax.vjp`` of the JAX
  package's ``repro.kernels.ref.attention``: float32, rtol = atol = 1e-5;
* :func:`emulate_flash_bwd`, the kernels' algorithm in float32 (the
  forward's row log-sum-exp ``L`` and float32 output, delta = rowsum(dO o
  O), the dK/dV blocks of 32 keys walking the group's query heads and the
  64-row query tiles that can see them, the dQ blocks of 64 rows walking
  their kv tiles of 32, P = exp(t - L) recomputed in each, the soft-cap's
  derivative from t), against ``ref.attention_vjp``: rtol 1e-5 plus 1e-5
  of the leaf's largest entry (float32 in another order).  Rows that see
  no key give zero gradients.  A change to the kernels' tiles, ranges or
  arithmetic must be mirrored in :func:`emulate_flash_bwd`;
* why the forward writes its output in float32 for the backward: delta
  from the bf16 output leaves ``chip_smoke.py``'s gradient bound on bf16
  inputs, delta from the float32 output holds it;
* on CPU tensors autograd differentiates the plain version and no
  kernel is counted; the training forward and the backward, which only
  launch kernels, refuse CPU tensors;
* :func:`emulate_flash_bwd_wgmma`, the tensor-core route's algorithm
  (``flash_bwd_dkdv_wgmma_kernel``, ``flash_bwd_dq_wgmma_kernel``: tiles of
  64 keys and 64 query rows, bf16 operands, P and dS cut into
  :data:`PARTS` bf16 parts each multiplied in float32, the GQA sum over a
  cluster's CTAs in rank order), on bf16 inputs at every
  ``WGMMA_HEAD_DIMS`` pair against ``ref.attention_vjp`` and ``jax.vjp`` of
  ``repro.kernels.ref.attention`` within ``chip_smoke.py``'s gradient
  bound; one part fewer for P or for dS leaves that bound.  A change to
  those kernels' tiles, ranges, parts or sum order must be mirrored in
  :func:`emulate_flash_bwd_wgmma`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops, ref

#: the kernels' tiles (csrc/flash_attention.cu: kBQ, kBwdBK)
BQ, BK = 64, 32
#: chip_smoke.py's gradient bound (GRAD_RTOL, GRAD_FRAC)
GRAD_RTOL, GRAD_FRAC = 2e-4, 2e-5

# (B, Hq, Hkv, Sq, Skv, D, Dv, kwargs)
CASES = {
    "causal": (2, 2, 2, 70, 70, 32, 32, {}),
    "window": (1, 2, 1, 150, 150, 32, 32, dict(window=40)),
    "softcap": (1, 4, 2, 80, 80, 16, 16, dict(logit_softcap=5.0, scale=0.5)),
    "gqa": (2, 6, 2, 100, 100, 16, 16, dict(window=70)),
    "q_offset": (1, 4, 1, 40, 130, 32, 32, dict(q_offset=90, window=60)),
    "mla_pair": (1, 2, 2, 75, 75, 48, 32, dict(scale=192 ** -0.5)),
    "mla_192_128": (1, 2, 1, 40, 40, 192, 128, {}),
    "cross": (2, 4, 2, 30, 90, 32, 32, dict(causal=False)),
}
#: rows that see no key: window 0 masks every key; a negative q_offset
#: puts the first rows before every key
NO_KEY_CASES = {
    "window0": (1, 2, 1, 40, 40, 16, 16, dict(window=0)),
    "before_keys": (1, 4, 2, 70, 70, 16, 16, dict(q_offset=-20)),
}


def _inputs(B, Hq, Hkv, Sq, Skv, D, Dv, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, Hq, Sq, D).astype(np.float32)
    k = rs.randn(B, Hkv, Skv, D).astype(np.float32)
    v = rs.randn(B, Hkv, Skv, Dv).astype(np.float32)
    dout = rs.randn(B, Hq, Sq, Dv).astype(np.float32)
    return q, k, v, dout


def _close(got, want, rtol, frac):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = w.float()
        np.testing.assert_allclose(g.float().numpy(), w.numpy(), rtol=rtol,
                                   atol=frac * float(w.abs().max()) + 1e-12, err_msg=name)


def _visible(qpos, kpos, Skv, causal, window):
    ok = kpos[None, :] < Skv
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        ok = ok & (kpos[None, :] > qpos[:, None] - window)
    return ok


def kv_query_range(k0, kv_rows, Sq, causal, window, q_offset):
    """The query rows ``[lo, hi)`` a dK/dV block of keys ``[k0, k0 +
    kv_rows)`` walks (flash_bwd_dkdv_kernel)."""
    lo, hi = 0, Sq
    if causal:
        lo = max(lo, k0 - q_offset)
    if window is not None:
        hi = min(hi, k0 + kv_rows - 1 + window - q_offset)
    return lo, hi


def q_key_range(q0, q_rows, Skv, causal, window, q_offset):
    """The keys ``[lo, hi)`` a dQ block of rows ``[q0, q0 + q_rows)``
    walks (flash_bwd_dq_kernel, as the forward's kernel)."""
    lo, hi = 0, Skv
    if causal:
        hi = min(hi, q_offset + q0 + q_rows)
    if window is not None:
        lo = max(lo, q_offset + q0 - window + 1)
    return lo, hi


def emulate_flash_bwd(q, k, v, dout, *, causal=True, scale=None, window=None,
                      logit_softcap=None, q_offset=0, delta_from_bf16_output=False):
    """``(dq, dk, dv)`` by the backward kernels' algorithm, in float32 (see
    the module docstring).  ``delta_from_bf16_output``: delta from the
    output rounded to bf16 instead of the forward's float32 output."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[3]
    group = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    qf, kf, vf, gf = (t.float() for t in (q, k, v, dout))

    def logits(b, h, rows, keys):
        t = (qf[b, h, rows] @ kf[b, h // group, keys].T) * scale
        dcap = torch.ones_like(t)
        if logit_softcap is not None:
            th = torch.tanh(t / logit_softcap)
            t, dcap = logit_softcap * th, 1 - th * th
        ok = _visible(rows + q_offset, keys, Skv, causal, window)
        return t, dcap, ok

    # the forward: L = m + log(l) over the visible keys (-inf without one)
    # and the output in float32
    all_q, all_k = torch.arange(Sq), torch.arange(Skv)
    L = torch.full((B, Hq, Sq), float("-inf"))
    O = torch.zeros(B, Hq, Sq, Dv)
    for b in range(B):
        for h in range(Hq):
            t, _, ok = logits(b, h, all_q, all_k)
            L[b, h] = torch.logsumexp(t.masked_fill(~ok, float("-inf")), dim=-1)
            P = torch.where(ok & (L[b, h] > float("-inf"))[:, None],
                            torch.exp(t - L[b, h][:, None]), 0.0)
            O[b, h] = P @ vf[b, h // group]
    if delta_from_bf16_output:
        O = O.bfloat16().float()
    delta = (gf * O).sum(-1)

    def tile(b, h, q0, k0):
        rows = torch.arange(q0, min(q0 + BQ, Sq))
        keys = torch.arange(k0, min(k0 + BK, Skv))
        t, dcap, ok = logits(b, h, rows, keys)
        lse = L[b, h, rows][:, None]
        ok = ok & (lse > float("-inf"))
        P = torch.where(ok, torch.exp(t - lse), 0.0)
        dP = gf[b, h, rows] @ vf[b, h // group, keys].T
        dS = P * (dP - delta[b, h, rows][:, None]) * dcap
        return rows, keys, P, dS

    dk = torch.zeros(B, Hkv, Skv, D)
    dv = torch.zeros(B, Hkv, Skv, Dv)
    for b in range(B):
        for hk in range(Hkv):
            for k0 in range(0, Skv, BK):
                kv_rows = min(BK, Skv - k0)
                lo, hi = kv_query_range(k0, kv_rows, Sq, causal, window, q_offset)
                acc_k = torch.zeros(kv_rows, D)
                acc_v = torch.zeros(kv_rows, Dv)
                for j in range(group if lo < hi else 0):
                    h = hk * group + j
                    for q0 in range(lo // BQ * BQ, hi, BQ):
                        rows, keys, P, dS = tile(b, h, q0, k0)
                        acc_v += P.T @ gf[b, h, rows]
                        acc_k += dS.T @ qf[b, h, rows]
                dk[b, hk, k0:k0 + kv_rows] = acc_k * scale
                dv[b, hk, k0:k0 + kv_rows] = acc_v
    dq = torch.zeros(B, Hq, Sq, D)
    for b in range(B):
        for h in range(Hq):
            for q0 in range(0, Sq, BQ):
                q_rows = min(BQ, Sq - q0)
                lo, hi = q_key_range(q0, q_rows, Skv, causal, window, q_offset)
                acc = torch.zeros(q_rows, D)
                for k0 in range(lo // BK * BK, hi if lo < hi else 0, BK):
                    rows, keys, _, dS = tile(b, h, q0, k0)
                    acc += dS @ kf[b, h // group, keys]
                dq[b, h, q0:q0 + q_rows] = acc * scale
    return tuple(t.to(q.dtype) for t in (dq, dk, dv))


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_gradients_match_jax_vjp(name):
    B, Hq, Hkv, Sq, Skv, D, Dv, kw = CASES[name]
    q, k, v, dout = _inputs(B, Hq, Hkv, Sq, Skv, D, Dv)
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*ins, **kw)
    got = torch.autograd.grad(out, ins, torch.from_numpy(dout))
    jout, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, **kw),
                        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    for g, w, n in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=n)


@pytest.mark.parametrize("name", sorted(CASES) + sorted(NO_KEY_CASES))
def test_emulated_kernels_match_plain_vjp(name):
    B, Hq, Hkv, Sq, Skv, D, Dv, kw = {**CASES, **NO_KEY_CASES}[name]
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(B, Hq, Hkv, Sq, Skv, D, Dv))
    got = emulate_flash_bwd(q, k, v, dout, **kw)
    want = ref.attention_vjp(q, k, v, dout, **kw)
    for g in (*got, *want):
        assert bool(torch.isfinite(g).all())
    _close(got, want, 1e-5, 1e-5)
    if name in NO_KEY_CASES:
        sees = _visible(torch.arange(Sq) + kw.get("q_offset", 0), torch.arange(Skv), Skv,
                        kw.get("causal", True), kw.get("window")).any(-1)
        assert not bool(sees.all())
        assert bool((got[0][:, :, ~sees] == 0).all())
        assert bool((want[0][:, :, ~sees] == 0).all())


def test_query_ranges_cover_every_visible_pair():
    """Every (query, key) pair the masks leave visible lies in the ranges
    the dK/dV and dQ blocks walk, at tile edges and past them."""
    for Sq, Skv, causal, window, q_offset in [(70, 70, True, None, 0), (150, 150, True, 40, 0),
                                              (40, 130, True, 60, 90), (30, 90, False, None, 0),
                                              (70, 70, True, 1, -20), (64, 96, True, 33, 32)]:
        ok = _visible(torch.arange(Sq) + q_offset, torch.arange(Skv), Skv, causal, window)
        for i, j in ok.nonzero().tolist():
            k0 = j // BK * BK
            lo, hi = kv_query_range(k0, min(BK, Skv - k0), Sq, causal, window, q_offset)
            assert lo <= i < hi
            q0 = i // BQ * BQ
            lo, hi = q_key_range(q0, min(BQ, Sq - q0), Skv, causal, window, q_offset)
            assert lo <= j < hi


@pytest.mark.parametrize("from_bf16", [False, True])
def test_delta_needs_the_float32_output(from_bf16):
    """bf16 inputs, gemma3's group of 4 at D 64, a window: delta from the
    forward's float32 output holds chip_smoke.py's bound (GRAD_RTOL plus
    GRAD_FRAC of the leaf's largest entry, one bf16 rounding of the
    result); delta from the output rounded to bf16 leaves it (the first
    rows, which see few keys, carry its 2^-9 error into dS)."""
    q, k, v, dout = (torch.from_numpy(a).bfloat16()
                     for a in _inputs(1, 4, 1, 128, 128, 64, 64, seed=3))
    got = emulate_flash_bwd(q, k, v, dout, window=96, delta_from_bf16_output=from_bf16)
    want = ref.attention_vjp(*(t.float() for t in (q, k, v, dout)), window=96)
    used = 0.0
    for g, w in zip(got, want):
        g = g.float()
        bound = (GRAD_RTOL * w.abs() + GRAD_FRAC * float(w.abs().max())
                 + 2.0 ** -8 * (g.abs() + w.abs()))
        used = max(used, float(((g - w).abs() / bound).max()))
    assert (used > 1.0) == from_bf16, used


def test_wrappers_on_cpu_run_the_plain_versions():
    B, Hq, Hkv, Sq, Skv, D, Dv, kw = CASES["gqa"]
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(B, Hq, Hkv, Sq, Skv, D, Dv))
    before = dict(fk.launch_counts())
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(fk.flash_attention(*ins, **kw), ins, dout)
    want = ref.attention_vjp(q, k, v, dout, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert fk.launch_counts() == before
    assert "flash_attention_bwd" in ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        fk.forward_with_lse(q, k, v, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention_bwd(q, k, v, None, None, dout, **kw)
    with pytest.raises(ValueError, match="dout"):
        fk.flash_attention_bwd(q, k, v, None, None, dout[:, :, 1:], **kw)


#: the tensor-core route (csrc/flash_attention.cu, namespace tcb): tiles of
#: 64 keys and 64 query rows (wgmma's M), bf16 parts of P and of dS, the
#: largest cluster
TC_ROWS, PARTS, MAX_CLUSTER = 64, 2, 8

# (B, Hq, Hkv, Sq, Skv, D, Dv, kwargs) at every WGMMA_HEAD_DIMS pair, bf16
TC_CASES = {
    "d64_causal_gqa4": (2, 4, 1, 150, 150, 64, 64, {}),
    "d64_cross": (1, 3, 3, 70, 100, 64, 64, dict(causal=False)),
    "d128_softcap_gqa6": (1, 12, 2, 130, 130, 128, 128,
                          dict(logit_softcap=15.0, scale=0.08838834764831845)),
    "d128_window": (1, 4, 2, 200, 200, 128, 128, dict(window=70)),
    "d256_window_gqa4": (1, 4, 1, 140, 140, 256, 256, dict(window=48)),
    "d256_q_offset": (1, 8, 1, 70, 200, 256, 256, dict(q_offset=130, window=100)),
    "mla_192_128": (1, 4, 2, 100, 100, 192, 128, dict(scale=192 ** -0.5)),
    "no_key_rows": (1, 8, 2, 120, 120, 128, 128, dict(q_offset=-40, window=30)),
    "window0": (1, 2, 1, 40, 40, 64, 64, dict(window=0)),
}


def cluster_size(group):
    """CTAs of a dK/dV cluster: the largest power of two up to
    MAX_CLUSTER that divides the group (rt_flash_attention_bwd_wgmma)."""
    c = 1
    while c < MAX_CLUSTER and group % (2 * c) == 0:
        c *= 2
    return c


def _parts(x, n):
    """x as n bf16 parts in float32, each rounding what the ones before
    left (the kernels' to_parts)."""
    out = []
    for _ in range(n):
        part = x.bfloat16().float()
        out.append(part)
        x = x - part
    return out


def emulate_flash_bwd_wgmma(q, k, v, dout, *, causal=True, scale=None, window=None,
                            logit_softcap=None, q_offset=0, p_parts=PARTS, ds_parts=PARTS):
    """``(dq, dk, dv)`` by the tensor-core backward's algorithm (see the
    module docstring) on bf16 ``q, k, v, dout``; ``p_parts`` and
    ``ds_parts``: bf16 parts of P (dV) and of dS (dK, dQ)."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[3]
    group = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale
    qf, kf, vf, gf = (t.float() for t in (q, k, v, dout))
    neg = float("-inf")

    def logits(b, h, rows, keys):
        t = (qf[b, h, rows] @ kf[b, h // group, keys].T) * scale
        dcap = torch.ones_like(t)
        if logit_softcap is not None:
            th = torch.tanh(t / logit_softcap)
            t, dcap = logit_softcap * th, 1 - th * th
        return t, dcap, _visible(rows + q_offset, keys, Skv, causal, window)

    # the training forward's L and float32 output; delta from the latter
    L = torch.full((B, Hq, Sq), neg)
    O = torch.zeros(B, Hq, Sq, Dv)
    for b in range(B):
        for h in range(Hq):
            t, _, ok = logits(b, h, torch.arange(Sq), torch.arange(Skv))
            L[b, h] = torch.logsumexp(t.masked_fill(~ok, neg), dim=-1)
            P = torch.where(ok & (L[b, h] > neg)[:, None], torch.exp(t - L[b, h][:, None]), 0.0)
            O[b, h] = P @ vf[b, h // group]
    delta = (gf * O).sum(-1)

    def tile(b, h, rows, keys):
        t, dcap, ok = logits(b, h, rows, keys)
        lse = L[b, h, rows][:, None]
        P = torch.where(ok & (lse > neg), torch.exp(t - lse), 0.0)
        dS = P * (gf[b, h, rows] @ vf[b, h // group, keys].T - delta[b, h, rows][:, None]) * dcap
        return P, dS

    # dK, dV: a cluster per (batch, kv head, 64 keys); CTA r walks its
    # `per` heads in order; the CTAs' float32 sums added in rank order
    c = cluster_size(group)
    per = group // c
    dk = torch.zeros(B, Hkv, Skv, D)
    dv = torch.zeros(B, Hkv, Skv, Dv)
    for b in range(B):
        for hk in range(Hkv):
            for k0 in range(0, Skv, TC_ROWS):
                keys = torch.arange(k0, min(k0 + TC_ROWS, Skv))
                lo, hi = kv_query_range(k0, len(keys), Sq, causal, window, q_offset)
                sums = []
                for r in range(c):
                    ak, av = torch.zeros(len(keys), D), torch.zeros(len(keys), Dv)
                    for h in range(hk * group + r * per, hk * group + (r + 1) * per):
                        for q0 in range(lo // TC_ROWS * TC_ROWS, hi if lo < hi else 0, TC_ROWS):
                            rows = torch.arange(q0, min(q0 + TC_ROWS, Sq))
                            P, dS = tile(b, h, rows, keys)
                            for part in _parts(P.T, p_parts):
                                av += part @ gf[b, h, rows]
                            for part in _parts(dS.T, ds_parts):
                                ak += part @ qf[b, h, rows]
                    sums.append((ak, av))
                ak, av = sums[0]
                for bk, bv in sums[1:]:
                    ak, av = ak + bk, av + bv
                dk[b, hk, k0:k0 + len(keys)] = ak * scale
                dv[b, hk, k0:k0 + len(keys)] = av
    # dQ: each warpgroup's 64 query rows walk the key tiles they can see
    dq = torch.zeros(B, Hq, Sq, D)
    for b in range(B):
        for h in range(Hq):
            for q0 in range(0, Sq, TC_ROWS):
                rows = torch.arange(q0, min(q0 + TC_ROWS, Sq))
                lo, hi = q_key_range(q0, len(rows), Skv, causal, window, q_offset)
                acc = torch.zeros(len(rows), D)
                for k0 in range(lo // TC_ROWS * TC_ROWS, hi if lo < hi else 0, TC_ROWS):
                    keys = torch.arange(k0, min(k0 + TC_ROWS, Skv))
                    for part in _parts(tile(b, h, rows, keys)[1], ds_parts):
                        acc += part @ kf[b, h // group, keys]
                dq[b, h, q0:q0 + len(rows)] = acc * scale
    return tuple(t.bfloat16() for t in (dq, dk, dv))


def _bound_used(got, want):
    """The largest share of chip_smoke.py's gradient bound (GRAD_RTOL plus
    GRAD_FRAC of the leaf's largest entry, plus 2^-8 of the magnitudes:
    one bf16 rounding of the result) over the three leaves."""
    used = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), torch.as_tensor(np.array(w)).float()
        bound = (GRAD_RTOL * w.abs() + GRAD_FRAC * float(w.abs().max()) + 1e-30
                 + 2.0 ** -8 * (g.abs() + w.abs()))
        used = max(used, float(((g - w).abs() / bound).max()))
    return used


def _bf16_inputs(B, Hq, Hkv, Sq, Skv, D, Dv, seed=5):
    return tuple(torch.from_numpy(a).bfloat16()
                 for a in _inputs(B, Hq, Hkv, Sq, Skv, D, Dv, seed=seed))


@pytest.mark.parametrize("name", sorted(TC_CASES))
def test_emulated_wgmma_kernels_match_plain_and_jax_vjp(name):
    B, Hq, Hkv, Sq, Skv, D, Dv, kw = TC_CASES[name]
    assert fk.route(torch.bfloat16, D, Dv) == "wgmma"
    q, k, v, dout = _bf16_inputs(B, Hq, Hkv, Sq, Skv, D, Dv)
    got = emulate_flash_bwd_wgmma(q, k, v, dout, **kw)
    for g in got:
        assert bool(torch.isfinite(g).all())
    want = ref.attention_vjp(*(t.float() for t in (q, k, v, dout)), **kw)
    assert _bound_used(got, want) <= 1.0
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, **kw),
                     *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
    assert _bound_used(got, vjp(jnp.asarray(dout.float().numpy()))) <= 1.0
    sees = _visible(torch.arange(Sq) + kw.get("q_offset", 0), torch.arange(Skv), Skv,
                    kw.get("causal", True), kw.get("window")).expand(Sq, Skv).any(-1)
    assert bool((got[0][:, :, ~sees] == 0).all())
    if name in ("no_key_rows", "window0"):
        assert not bool(sees.all())


@pytest.mark.parametrize("fewer", ["p", "ds"])
def test_one_part_fewer_leaves_the_bound(fewer):
    """With one bf16 part fewer for P (dV) or for dS (dK, dQ), at least
    one case leaves chip_smoke.py's bound that :data:`PARTS` parts hold:
    the count is the least that holds it."""
    used = []
    for name in ("d256_window_gqa4", "d128_softcap_gqa6", "mla_192_128"):
        B, Hq, Hkv, Sq, Skv, D, Dv, kw = TC_CASES[name]
        q, k, v, dout = _bf16_inputs(B, Hq, Hkv, Sq, Skv, D, Dv)
        want = ref.attention_vjp(*(t.float() for t in (q, k, v, dout)), **kw)
        parts = dict(p_parts=PARTS - (fewer == "p"), ds_parts=PARTS - (fewer == "ds"))
        used.append(_bound_used(emulate_flash_bwd_wgmma(q, k, v, dout, **kw, **parts), want))
    assert max(used) > 1.0, used


@pytest.mark.parametrize("group,cluster", [(1, 1), (2, 2), (4, 4), (5, 1), (6, 2), (8, 8),
                                           (12, 4), (16, 8), (48, 8)])
def test_cluster_size(group, cluster):
    """The dK/dV cluster divides the group and holds at most 8 CTAs; each
    CTA walks group / cluster query heads."""
    assert cluster_size(group) == cluster
    assert group % cluster == 0 and cluster <= MAX_CLUSTER


def test_wgmma_ranges_cover_every_visible_pair():
    """Every visible (query, key) pair lies in the query tiles a 64-key
    dK/dV block walks and in the key tiles a 64-row dQ warpgroup walks."""
    for Sq, Skv, causal, window, q_offset in [(150, 150, True, None, 0), (200, 200, True, 70, 0),
                                              (70, 200, True, 100, 130), (70, 100, False, None, 0),
                                              (120, 120, True, 30, -40), (64, 128, True, 64, 64)]:
        ok = _visible(torch.arange(Sq) + q_offset, torch.arange(Skv), Skv, causal, window)
        for i, j in ok.nonzero().tolist():
            k0 = j // TC_ROWS * TC_ROWS
            lo, hi = kv_query_range(k0, min(TC_ROWS, Skv - k0), Sq, causal, window, q_offset)
            assert lo // TC_ROWS * TC_ROWS <= i < hi
            q0 = i // TC_ROWS * TC_ROWS
            lo, hi = q_key_range(q0, min(TC_ROWS, Sq - q0), Skv, causal, window, q_offset)
            assert lo // TC_ROWS * TC_ROWS <= j < hi


def test_backward_routes_and_counters():
    """The backward takes the forward's route (route() serves both), and
    its launches are counted by route beside their sum."""
    for D, Dv in fk.WGMMA_HEAD_DIMS:
        assert fk.route(torch.bfloat16, D, Dv) == "wgmma"
        assert fk.route(torch.float32, D, Dv) == "cuda_core"
    for D, Dv in set(fk.HEAD_DIMS) - set(fk.WGMMA_HEAD_DIMS):
        assert fk.route(torch.bfloat16, D, Dv) == "cuda_core"
    counts = fk.launch_counts()
    assert {"flash_attention_bwd", "flash_attention_bwd_wgmma",
            "flash_attention_bwd_cuda_core"} <= set(counts)
    assert "flash_attention_bwd_wgmma" in ops.launch_counts()
