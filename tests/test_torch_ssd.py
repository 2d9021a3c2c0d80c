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
  rtol = atol = 2e-5, which is asserted.
"""

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
