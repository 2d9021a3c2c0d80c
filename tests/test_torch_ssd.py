"""The port's SSD scan and mamba2 model against the JAX package, on the CPU.

On CPU tensors the ``ssd_scan`` wrapper runs its plain version (the
sequential float32 scan of ``kernels/ref.py``); the CUDA kernel itself
is held against that plain version on the card (``chip_smoke.py`` and
``tests/test_torch_gpu.py``).  Bounds:

* the plain scan against the JAX package's Pallas kernel (interpret
  mode): the repo's chunked-vs-sequential bound, rtol 2e-4 and atol
  3e-5 (``tests/test_kernels.py``);
* the plain scan against the JAX oracle ``ref.ssd_scan``: the same
  sequential float32 algorithm, so rtol = atol = 1e-5;
* ``forward_logits`` against the JAX model, which reaches the Pallas
  kernel: the repo's bound between the two SSD forms is 2e-3
  (``tests/test_models.py``); at the smoke size in float32 the two meet
  rtol = atol = 2e-5, which is asserted;
* a torch emulation of the tensor-core kernel's arithmetic (chunks
  computed independently, the float32 state chain, G, x o w and h cut
  into bf16 parts): in float32 without parts, the repo's bound against
  both the plain scan and Pallas; with bf16 inputs and the served parts
  (``ssd_scan.PARTS``), the bound ``chip_smoke.py`` holds the kernel to
  at the served shapes, against both.  The same at hymba's widths (P 64,
  N 16), whose tensor-core kernel (``ssd_scan.route`` ``"wgmma_n16"``)
  runs this arithmetic with one CTA a chunk and its own parts
  (``ssd_scan.PARTS_N16``): the served bound against the plain scan and
  the Pallas kernel at several sequence lengths, with and without
  init_state, and one part of x o w fewer leaving it.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import Model as JaxModel
from repro_torch.configs import get_config
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.models import Model
from repro_torch.models.convert import from_reference_params
from repro_torch.models.ssm import _ssd_step

# tests/test_kernels.py SSD_CASES, its init_state case, a tail case and a
# sequence shorter than one chunk
SSD_CASES = [
    dict(B=1, S=32, H=2, P=8, G=1, N=8, chunk=8, h0=False),
    dict(B=2, S=80, H=4, P=16, G=2, N=24, chunk=32, h0=False),   # 80 % 32
    dict(B=1, S=128, H=2, P=32, G=1, N=16, chunk=128, h0=False),  # one chunk
    dict(B=1, S=40, H=2, P=8, G=1, N=8, chunk=8, h0=True),        # init_state
    dict(B=2, S=40, H=4, P=16, G=2, N=16, chunk=16, h0=True),     # 40 % 16
    dict(B=1, S=20, H=2, P=8, G=1, N=8, chunk=128, h0=True),      # S < chunk
]


def ssd_inputs(case, seed=8):
    """numpy float32 inputs as tests/test_kernels.py draws them."""
    rng = np.random.RandomState(seed)
    B, S, H, P, G, N = (case[k] for k in ("B", "S", "H", "P", "G", "N"))
    x = rng.randn(B, S, H, P).astype(np.float32)
    dt = np.abs(rng.randn(B, S, H)).astype(np.float32) * 0.1
    A = -np.abs(rng.randn(H)).astype(np.float32)
    Bm = rng.randn(B, S, G, N).astype(np.float32)
    C = rng.randn(B, S, G, N).astype(np.float32)
    h0 = rng.randn(B, H, P, N).astype(np.float32) if case["h0"] else None
    return x, dt, A, Bm, C, h0


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: f"S{c['S']}c{c['chunk']}h0{c['h0']}")
def test_plain_ssd_matches_jax_oracle_and_pallas(case):
    x, dt, A, Bm, C, h0 = ssd_inputs(case)
    jh0 = None if h0 is None else jnp.asarray(h0)
    before = ssd.ssd_scan.launches
    y, h = ssd.ssd_scan(*_torch(x, dt, A, Bm, C), init_state=_torch(h0)[0],
                        chunk=case["chunk"], return_state=True)
    assert ssd.ssd_scan.launches == before  # CPU tensors: the plain version
    yr, hr = jref.ssd_scan(*map(jnp.asarray, (x, dt, A, Bm, C)), init_state=jh0,
                           return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(hr), rtol=1e-5, atol=1e-5)
    yk, hk = jops.ssd_scan(*map(jnp.asarray, (x, dt, A, Bm, C)), init_state=jh0,
                           chunk=case["chunk"], return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yk), rtol=2e-4, atol=3e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(hk), rtol=2e-4, atol=3e-5)


def test_extreme_decay_needs_the_same_bound_in_pallas():
    """The card's kernel is held to the plain scan under extreme decay
    (chunk 128, dt ~ 1, A = -e) with 1e-4 of the terms' magnitudes added
    to the repo's bound (``tests/test_torch_gpu.py``).  The JAX package's
    own chunked form, Pallas in interpret mode, needs the same addition
    against its sequential oracle on such inputs: cum falls to about
    -350 in a chunk, and the chunk's exponent cum_t - cum_u is a
    difference of two such numbers.  The port's plain scan, sequential
    as the oracle is, meets the repo's bound alone."""
    B, S, H, P, N = 1, 256, 2, 64, 128
    over_repo_bound = 0
    for seed in range(3):
        rng = np.random.RandomState(seed)
        x = rng.randn(B, S, H, P).astype(np.float32)
        Bm = rng.randn(B, S, 1, N).astype(np.float32)
        C = rng.randn(B, S, 1, N).astype(np.float32)
        dt = (1.0 + 0.01 * rng.rand(B, S, H)).astype(np.float32)
        A = np.full((H,), -np.e, np.float32)
        yk, hk = map(np.asarray, jops.ssd_scan(*map(jnp.asarray, (x, dt, A, Bm, C)),
                                               chunk=128, return_state=True))
        yr, hr = map(np.asarray, jref.ssd_scan(*map(jnp.asarray, (x, dt, A, Bm, C)),
                                               return_state=True))
        yabs, habs = map(np.asarray, jref.ssd_scan(
            *map(jnp.asarray, (np.abs(x), dt, A, np.abs(Bm), np.abs(C))),
            return_state=True))
        assert np.isfinite(yk).all() and np.isfinite(hk).all()
        for got, want, mag in ((yk, yr, yabs), (hk, hr, habs)):
            err = np.abs(got - want)
            repo = 2e-4 * np.abs(want) + 3e-5
            assert (err <= repo + 1e-4 * mag).all()
            over_repo_bound += int((err > repo).sum())
        y, h = ssd.ssd_scan(*_torch(x, dt, A, Bm, C), chunk=128, return_state=True)
        np.testing.assert_allclose(y.numpy(), yr, rtol=2e-4, atol=3e-5)
        np.testing.assert_allclose(h.numpy(), hr, rtol=2e-4, atol=3e-5)
    assert over_repo_bound > 0  # the repo's bound alone does not hold here


# --------------------------------------------------------------------------
# the tensor-core route: its rule, and its arithmetic emulated on the CPU
# --------------------------------------------------------------------------


def test_ssd_route_is_a_function_of_dtype_and_shape():
    assert list(inspect.signature(ssd.route).parameters) == [
        "dtype", "head_dim", "state_dim", "chunk"]
    bf16, f32 = torch.bfloat16, torch.float32
    cases = {(bf16, 64, 128, 128): "wgmma",      # mamba2's served shapes
             (f32, 64, 128, 128): "cuda_core",   # float32 keeps CUDA cores
             (bf16, 64, 128, 64): "cuda_core", (bf16, 64, 128, 32): "cuda_core",
             (bf16, 32, 128, 128): "cuda_core", (bf16, 64, 64, 128): "cuda_core",
             (bf16, 8, 8, 8): "cuda_core", (torch.float16, 64, 128, 128): "cuda_core",
             # hymba's served shapes: the tensor-core kernel of N 16
             (bf16, 64, 16, 128): "wgmma_n16", (f32, 64, 16, 128): "cuda_core",
             (bf16, 64, 16, 64): "cuda_core", (bf16, 32, 16, 128): "cuda_core",
             (bf16, 16, 16, 16): "cuda_core", (bf16, 64, 32, 128): "cuda_core"}
    assert {c: ssd.route(*c) for c in cases} == cases
    assert ssd.PARTS in ssd.PARTS_VARIANTS and ssd.PARTS_N16 in ssd.PARTS_N16_VARIANTS
    # a cluster of at most one CTA a chunk and 8 a (batch, head); by
    # default one CTA for two chunks: S 512 is 2
    seqs = (1, 128, 129, 300, 512, 1024, 1025, 2048, 2049, 4096)
    assert [ssd.max_cluster(s) for s in seqs] == [1, 1, 2, 3, 4, 8, 8, 8, 8, 8]
    assert [ssd.default_cluster(s) for s in seqs] == [1, 1, 1, 2, 2, 4, 5, 8, 8, 8]
    # at N 16, one CTA a chunk: hymba's S 640 is 5
    assert [ssd.default_cluster(s, 16) for s in seqs] == [ssd.max_cluster(s) for s in seqs]
    assert ssd.default_cluster(640, 16) == 5


def _split(v: torch.Tensor, parts: int) -> torch.Tensor:
    """``v`` as the sum of ``parts`` bf16 values, each rounding what the
    ones before left (the kernel's ``take_part``)."""
    rest, out = v, torch.zeros_like(v)
    for _ in range(parts):
        part = rest.bfloat16().float()
        out, rest = out + part, rest - part
    return out


def emulate_wgmma(x, dt, A, Bm, C, init_state=None, chunk=128, parts=None, cluster=None):
    """The tensor-core kernel's arithmetic (``csrc/ssd_scan.cu`` ``tc``)
    in torch on the CPU.  Per chunk of ``chunk`` rows, padded with zeros
    and dt 0, computed independently: cum, S = C B^T, G = S o L o dt with
    the exponent taken only where t >= u, y_intra = G x, and the
    increment h_inc = (x o w)^T B.  Then the states of each group of
    ``cluster`` chunks (a cluster's CTAs) by prefix combination in
    float32, h_{c-1} = exp(sum_{i<r} cum_last_i) carry + sum_{j<r}
    exp(sum_{j<i<r} cum_last_i) h_inc_j, the carry being init_state (or
    zeros) and then the previous group's last state; and y = y_intra +
    exp(cum) (C h_{c-1}^T).  Products take float32 values; ``parts = (G,
    x o w, h)`` cuts those operands into bf16 parts first (None: float32,
    uncut).  Returns y in x's dtype and the final float32 state."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2:]
    cut = (lambda v, n: v) if parts is None else _split
    pg, pw, ph = parts or (0, 0, 0)
    nc = -(-S // chunk)
    # by default one CTA for two chunks, as ssd_scan.default_cluster
    K = min(-(-nc // 2), ssd.MAX_CLUSTER) if cluster is None else cluster

    def chunked(t, width):  # [B, S, H, width] -> [B, H, chunks, chunk, width]
        out = torch.zeros(Bsz, nc * chunk, H, width)
        out[:, :S] = t.float()
        return out.view(Bsz, nc, chunk, H, width).permute(0, 3, 1, 2, 4)

    xs = chunked(x, P)
    Bs, Cs = (chunked(t.repeat_interleave(H // G, 2), N) for t in (Bm, C))
    dts = chunked(dt[..., None], 1)[..., 0]
    cum = torch.cumsum(A[None, :, None, None] * dts, -1)
    last = cum[..., -1]                              # [B, H, chunks]
    causal = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    diff = torch.where(causal, cum[..., :, None] - cum[..., None, :], 0.0)
    Gm = torch.where(causal, (Cs @ Bs.transpose(-1, -2)) * torch.exp(diff) * dts[..., None, :],
                     0.0)
    y_intra = cut(Gm, pg) @ xs
    h_inc = cut(xs * (torch.exp(last[..., None] - cum) * dts)[..., None], pw).transpose(-1, -2) @ Bs
    carry = torch.zeros(Bsz, H, P, N) if init_state is None else init_state.float()
    y_state = []
    scale = lambda e: torch.exp(e)[..., None, None]  # noqa: E731
    for g0 in range(0, nc, K):
        for c in range(g0, min(g0 + K, nc)):
            h = scale(last[..., g0:c].sum(-1)) * carry
            for j in range(g0, c):
                h = h + scale(last[..., j + 1:c].sum(-1)) * h_inc[:, :, j]
            y_state.append(Cs[:, :, c] @ cut(h, ph).transpose(-1, -2))
        carry = scale(last[..., c]) * h + h_inc[:, :, c]
    y = y_intra + torch.exp(cum)[..., None] * torch.stack(y_state, 2)
    y = y.permute(0, 2, 3, 1, 4).reshape(Bsz, nc * chunk, H, P)[:, :S]
    return y.to(x.dtype), carry


@pytest.mark.parametrize("case", SSD_CASES, ids=lambda c: f"S{c['S']}c{c['chunk']}h0{c['h0']}")
def test_chunk_parallel_form_matches_plain_and_pallas_in_float32(case):
    """Without parts the kernel's form is exact float32 arithmetic in
    another order: the repo's chunked-vs-sequential bound holds against
    the plain scan and against the Pallas kernel (interpret mode)."""
    x, dt, A, Bm, C, h0 = ssd_inputs(case)
    chunk = min(case["chunk"], case["S"])
    y, h = emulate_wgmma(*_torch(x, dt, A, Bm, C, h0), chunk=chunk)
    yr, hr = ref.ssd_scan(*_torch(x, dt, A, Bm, C), init_state=_torch(h0)[0],
                          return_state=True)
    torch.testing.assert_close(y, yr, rtol=2e-4, atol=3e-5)
    torch.testing.assert_close(h, hr, rtol=2e-4, atol=3e-5)
    jh0 = None if h0 is None else jnp.asarray(h0)
    yk, hk = jops.ssd_scan(*map(jnp.asarray, (x, dt, A, Bm, C)), init_state=jh0,
                           chunk=case["chunk"], return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(yk), rtol=2e-4, atol=3e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(hk), rtol=2e-4, atol=3e-5)


@pytest.mark.parametrize("cluster", [1, 2, 3])
@pytest.mark.parametrize("case", [SSD_CASES[1], SSD_CASES[4]], ids=["S80c32", "S40c16h0"])
def test_any_cluster_size_gives_the_plain_state(case, cluster):
    """Three chunks in groups of 1, 2 or 3 (a group's carry passed on
    through hout): the same y and state within the repo's bound."""
    x, dt, A, Bm, C, h0 = _torch(*ssd_inputs(case))
    y, h = emulate_wgmma(x, dt, A, Bm, C, h0, chunk=case["chunk"], cluster=cluster)
    yr, hr = ref.ssd_scan(x, dt, A, Bm, C, init_state=h0, return_state=True)
    torch.testing.assert_close(y, yr, rtol=2e-4, atol=3e-5)
    torch.testing.assert_close(h, hr, rtol=2e-4, atol=3e-5)


def served_inputs(kind, B=2, S=300, H=8, G=2, P=64, N=128, seed=0):
    """bf16 x, B, C as views of one conv output (``"served"``: softplus dt,
    A = -e, as ``chip_smoke.py`` draws them), or the extreme-decay inputs
    of ``tests/test_torch_gpu.py`` in bf16 (dt ~ 1, A = -e); float32 dt,
    A and init_state.  S 300 leaves a short last chunk of 44 rows."""
    rng = np.random.RandomState(seed)
    wide = torch.from_numpy(rng.randn(B, S, H * P + 2 * G * N).astype(np.float32)).bfloat16()
    x = wide[..., :H * P].reshape(B, S, H, P)
    Bm = wide[..., H * P:H * P + G * N].reshape(B, S, G, N)
    C = wide[..., H * P + G * N:].reshape(B, S, G, N)
    if kind == "served":
        dt = torch.nn.functional.softplus(torch.from_numpy(rng.randn(B, S, H).astype(np.float32)))
    else:
        dt = torch.from_numpy((1.0 + 0.01 * rng.rand(B, S, H)).astype(np.float32))
    A = torch.full((H,), -float(np.e))
    h0 = torch.from_numpy(rng.randn(B, H, P, N).astype(np.float32))
    return x, dt, A, Bm, C, h0


def served_bound_share(y, h, want_y, want_h, yabs, habs):
    """The largest share of ``chip_smoke.py``'s served bf16 bound (phase
    8) that y and h use: y within one bf16 rounding of each side plus
    (2^-8 + 2^-10) of the terms' magnitudes, h within the latter."""
    dy = (y.float() - want_y.float()).abs()
    tol_y = 2.0 ** -8 * (y.float().abs() + want_y.float().abs()) \
        + (2.0 ** -8 + 2.0 ** -10) * yabs
    tol_h = (2.0 ** -8 + 2.0 ** -10) * habs
    return float((dy / tol_y).max()), float(((h - want_h).abs() / tol_h).max())


@pytest.mark.parametrize("kind", ["served", "extreme_decay"])
def test_served_parts_meet_the_served_bound(kind):
    """bf16 inputs at the served widths (P 64, N 128), a short last
    chunk, init_state, 2 groups: with ``ssd_scan.PARTS`` the kernel's
    arithmetic meets the served bound against the plain scan and against
    the Pallas kernel (interpret mode), and its state meets the
    extreme-decay bound of ``tests/test_torch_gpu.py`` against the plain
    scan of the same values in float32."""
    x, dt, A, Bm, C, h0 = served_inputs(kind)
    y, h = emulate_wgmma(x, dt, A, Bm, C, h0, parts=ssd.PARTS)
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(h).all())
    f32 = (x.float(), dt, A, Bm.float(), C.float())
    yabs, habs = ref.ssd_scan(x.float().abs(), dt, A, Bm.float().abs(), C.float().abs(),
                              init_state=h0.abs(), return_state=True)
    yr, hr = ref.ssd_scan(x, dt, A, Bm, C, init_state=h0, return_state=True)
    assert max(served_bound_share(y, h, yr, hr, yabs, habs)) <= 1
    yk, hk = jops.ssd_scan(*(jnp.asarray(t.float().numpy()) for t in f32),
                           init_state=jnp.asarray(h0.numpy()), chunk=128, return_state=True)
    yk = torch.from_numpy(np.array(yk)).bfloat16()
    assert max(served_bound_share(y, h, yk, torch.from_numpy(np.array(hk)), yabs,
                                  habs)) <= 1
    _, hf = ref.ssd_scan(*f32, init_state=h0, return_state=True)
    assert bool(((h - hf).abs() <= 2e-4 * hf.abs() + 3e-5 + 1e-4 * habs).all())


def test_one_part_of_x_w_breaks_the_served_state_bound():
    """Why x o w takes two parts: in one, each term of the increment
    rounds by up to 2^-9, and the state leaves the served bound; G and h
    in one part each keep y inside it (their errors meet y's own bf16
    rounding)."""
    x, dt, A, Bm, C, h0 = served_inputs("served")
    yabs, habs = ref.ssd_scan(x.float().abs(), dt, A, Bm.float().abs(), C.float().abs(),
                              init_state=h0.abs(), return_state=True)
    yr, hr = ref.ssd_scan(x, dt, A, Bm, C, init_state=h0, return_state=True)
    share = {parts: served_bound_share(*emulate_wgmma(x, dt, A, Bm, C, h0, parts=parts),
                                       yr, hr, yabs, habs)
             for parts in ((1, 1, 1), ssd.PARTS)}
    assert share[(1, 1, 1)][1] > 1 >= max(share[ssd.PARTS])
    assert share[(1, 1, 1)][0] <= 1


# hymba's widths (P 64, N 16, G 1): a short last chunk with init_state,
# two whole chunks without it
N16_CASES = [dict(S=200, h0=True), dict(S=256, h0=False)]


@pytest.mark.parametrize("kind", ["served", "extreme_decay"])
@pytest.mark.parametrize("case", N16_CASES, ids=lambda c: f"S{c['S']}h0{c['h0']}")
def test_n16_served_parts_meet_the_served_bound(case, kind):
    """bf16 inputs at hymba's widths, one CTA a chunk (the N-16 route's
    cluster, :func:`ssd_scan.default_cluster`): with ``ssd_scan.PARTS_N16``
    the kernel's arithmetic meets the served bound against the plain scan
    and against the Pallas kernel (interpret mode), and its state the
    extreme-decay bound against the plain scan of the same values in
    float32."""
    S = case["S"]
    x, dt, A, Bm, C, h0 = served_inputs(kind, B=1, S=S, H=2, G=1, N=16, seed=S)
    h0 = h0 if case["h0"] else None
    cluster = ssd.default_cluster(S, 16)
    y, h = emulate_wgmma(x, dt, A, Bm, C, h0, parts=ssd.PARTS_N16, cluster=cluster)
    assert bool(torch.isfinite(y.float()).all()) and bool(torch.isfinite(h).all())
    f32 = (x.float(), dt, A, Bm.float(), C.float())
    habs0 = None if h0 is None else h0.abs()
    yabs, habs = ref.ssd_scan(x.float().abs(), dt, A, Bm.float().abs(), C.float().abs(),
                              init_state=habs0, return_state=True)
    yr, hr = ref.ssd_scan(x, dt, A, Bm, C, init_state=h0, return_state=True)
    assert max(served_bound_share(y, h, yr, hr, yabs, habs)) <= 1
    yk, hk = jops.ssd_scan(*(jnp.asarray(t.float().numpy()) for t in f32),
                           init_state=None if h0 is None else jnp.asarray(h0.numpy()),
                           chunk=128, return_state=True)
    yk = torch.from_numpy(np.array(yk)).bfloat16()
    assert max(served_bound_share(y, h, yk, torch.from_numpy(np.array(hk)), yabs,
                                  habs)) <= 1
    _, hf = ref.ssd_scan(*f32, init_state=h0, return_state=True)
    assert bool(((h - hf).abs() <= 2e-4 * hf.abs() + 3e-5 + 1e-4 * habs).all())


def test_n16_one_part_fewer_of_x_w_breaks_the_served_state_bound():
    """At N 16 as at N 128, x o w takes two parts: in one, the state leaves
    the served bound; G and h in one part each keep y and h inside it."""
    x, dt, A, Bm, C, h0 = served_inputs("served", B=1, S=200, H=4, G=1, N=16)
    yabs, habs = ref.ssd_scan(x.float().abs(), dt, A, Bm.float().abs(), C.float().abs(),
                              init_state=h0.abs(), return_state=True)
    yr, hr = ref.ssd_scan(x, dt, A, Bm, C, init_state=h0, return_state=True)
    cluster = ssd.default_cluster(x.shape[1], 16)
    share = {parts: served_bound_share(*emulate_wgmma(x, dt, A, Bm, C, h0, parts=parts,
                                                      cluster=cluster),
                                       yr, hr, yabs, habs)
             for parts in ((1, 1, 1), ssd.PARTS_N16)}
    assert ssd.PARTS_N16 == (1, 2, 1)
    assert share[(1, 1, 1)][1] > 1 >= max(share[ssd.PARTS_N16])
    assert share[(1, 1, 1)][0] <= 1


def test_plain_ssd_reads_strided_views():
    """On the path x, B and C are views into the conv output."""
    x, dt, A, Bm, C, _ = ssd_inputs(SSD_CASES[1])
    B, S, H, P = x.shape
    G, N = Bm.shape[2:]
    wide = torch.from_numpy(np.concatenate(
        [x.reshape(B, S, -1), Bm.reshape(B, S, -1), C.reshape(B, S, -1)], -1))
    xv = wide[..., :H * P].reshape(B, S, H, P)
    bv = wide[..., H * P:H * P + G * N].reshape(B, S, G, N)
    cv = wide[..., H * P + G * N:].reshape(B, S, G, N)
    assert not xv.is_contiguous()
    got = ssd.ssd_scan(xv, torch.from_numpy(dt), torch.from_numpy(A), bv, cv)
    want = ref.ssd_scan(*_torch(x, dt, A, Bm, C))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_ssd_wrapper_checks_shapes():
    x, dt, A, Bm, C, _ = _torch(*ssd_inputs(SSD_CASES[0]))
    with pytest.raises(ValueError, match="dt has shape"):
        ssd.ssd_scan(x, dt[:, :-1], A, Bm, C)
    with pytest.raises(ValueError, match="groups"):
        ssd.ssd_scan(x[:, :, :1], dt[:, :, :1], A[:1], Bm.expand(-1, -1, 2, -1),
                     C.expand(-1, -1, 2, -1))
    with pytest.raises(ValueError, match="init_state"):
        ssd.ssd_scan(x, dt, A, Bm, C, init_state=torch.zeros(1, 2, 8, 7))


def test_ssd_step_matches_jax():
    rng = np.random.RandomState(3)
    B, H, P, G, N = 2, 4, 8, 2, 8
    x = rng.randn(B, H, P).astype(np.float32)
    dt = np.abs(rng.randn(B, H)).astype(np.float32) * 0.1
    A = -np.abs(rng.randn(H)).astype(np.float32)
    Bm, C = (rng.randn(B, G, N).astype(np.float32) for _ in range(2))
    state = rng.randn(B, H, P, N).astype(np.float32)
    y, new = _ssd_step(*_torch(x, dt, A, Bm, C, state))
    yr, newr = jref.ssd_step(*map(jnp.asarray, (x, dt, A, Bm, C, state)))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(new.numpy(), np.asarray(newr), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def models():
    """The smoke mamba2 in both packages with the reference's weights."""
    jcfg = jax_get_config("mamba2-2.7b").smoke()
    cfg = get_config("mamba2-2.7b").smoke()
    jm = JaxModel(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    params = from_reference_params(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jm, jp, Model(cfg), params


@pytest.mark.parametrize("seq", [16, 40])
def test_forward_logits_match_jax(models, seq):
    """The JAX forward reaches the Pallas kernel (cache is None)."""
    jm, jp, m, params = models
    toks = np.random.RandomState(seq).randint(0, m.cfg.vocab, (2, seq)).astype(np.int32)
    want = np.asarray(jm.forward_logits(jp, {"tokens": jnp.asarray(toks)}))
    got = m.forward_logits(params, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, seq, m.cfg.vocab) and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
