"""The port's kernel entry point ``repro_torch.kernels.ops`` against the
JAX package's ``repro.kernels.ops`` (Pallas in interpret mode), on the
cases of ``tests/test_kernels.py`` and the same numpy inputs.

On CPU tensors the port runs its plain versions (``kernels/ref.py``); the
Hopper kernels are held against those on the card (``chip_smoke.py``,
``tests/test_torch_gpu.py``).  Tolerances are the JAX tests' own: the
copies and the boundary pair are bit for bit (float32 and bfloat16), the
rmsnorm sweep rtol 2e-5 / atol 1e-5 in float32 and 3e-2 / 1e-2 in
bfloat16, attention rtol 2e-4 / atol 3e-5 in float32 and 5e-2 / 3e-2
in bfloat16.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.halo import DIRECTIONS as JAX_DIRECTIONS
from repro.kernels import ops as jops
from repro_torch.core.halo import DIRECTIONS, _region_for
from repro_torch.kernels import flash_attention as fk
from repro_torch.kernels import ops

REGION_CASES = [
    ((4, 4, 4), (slice(0, 1), slice(0, 4), slice(0, 4))),      # face
    ((4, 4, 4), (slice(3, 4), slice(0, 1), slice(0, 4))),      # edge
    ((4, 4, 4), (slice(3, 4), slice(3, 4), slice(3, 4))),      # corner
    ((7, 5, 3), (slice(0, 7), slice(4, 5), slice(0, 3))),      # odd sizes
    ((2, 9, 6), (slice(1, 2), slice(0, 9), slice(5, 6))),
]


def _np(rng, shape):
    return rng.randn(*shape).astype(np.float32)


def _pair(x: np.ndarray, dtype: str):
    """The same values for both packages, cast by each to ``dtype``."""
    return jnp.asarray(x, dtype), torch.from_numpy(x).to(getattr(torch, dtype))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def test_same_names_and_arguments_as_the_reference():
    """Every public function of the reference's ``ops`` exists in the
    port's with the same arguments, less the TPU tiling and interpret
    ones."""
    tpu_only = {"block_rows", "block_q", "block_k", "interpret"}
    assert set(ops.__all__) == set(jops.__all__)
    for name in jops.__all__:
        if name == "ref":
            continue
        theirs = set(inspect.signature(getattr(jops, name)).parameters) - tpu_only
        assert set(inspect.signature(getattr(ops, name)).parameters) == theirs, name
    assert DIRECTIONS == JAX_DIRECTIONS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,region", REGION_CASES)
def test_halo_pack_and_unpack_add_equal_pallas(shape, region, dtype):
    rng = np.random.RandomState(1)
    ju, tu = _pair(_np(rng, shape), dtype)
    jm, tm = _pair(_np(rng, tuple(s.stop - s.start for s in region)), dtype)
    np.testing.assert_array_equal(_f32(ops.halo_pack(tu, region)),
                                  _f32(jops.halo_pack(ju, region)))
    np.testing.assert_array_equal(_f32(ops.halo_unpack_add(tu.clone(), tm, region)),
                                  _f32(jops.halo_unpack_add(ju, jm, region)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [3, 5])
def test_pack_boundary_contiguous_26_bitwise(p, dtype):
    rng = np.random.RandomState(2)
    regions = [_region_for(d, (p, p, p)) for d in DIRECTIONS]
    ju, tu = _pair(_np(rng, (p, p, p)), dtype)
    got = ops.pack_boundary(tu, regions)
    want = jops.pack_boundary(ju, regions)
    # 6 faces of p^2, 12 edges of p, 8 corners
    assert tuple(got.shape) == want.shape == (6 * p * p + 12 * p + 8,)
    np.testing.assert_array_equal(_f32(got), _f32(want))
    # the overlapping regions accumulate in region order, rounded after each
    jb, tb = _pair(_np(rng, want.shape), dtype)
    np.testing.assert_array_equal(_f32(ops.unpack_boundary_add(tu.clone(), tb, regions)),
                                  _f32(jops.unpack_boundary_add(ju, jb, regions)))


def test_boundary_pair_takes_every_rank_at_once():
    """Leading dimensions are ranks: one call equals the per-block calls."""
    rng = np.random.RandomState(3)
    regions = [_region_for(d, (4, 3, 5)) for d in DIRECTIONS]
    u = torch.from_numpy(_np(rng, (2, 3, 4, 3, 5)))
    buf = ops.pack_boundary(u, regions)
    assert tuple(buf.shape[:2]) == (2, 3)
    msg = torch.from_numpy(_np(rng, tuple(buf.shape)))
    out = ops.unpack_boundary_add(u.clone(), msg, regions)
    for i in range(2):
        for j in range(3):
            np.testing.assert_array_equal(
                buf[i, j].numpy(), np.asarray(jops.pack_boundary(jnp.asarray(u[i, j].numpy()),
                                                                 regions)))
            np.testing.assert_array_equal(
                out[i, j].numpy(),
                np.asarray(jops.unpack_boundary_add(jnp.asarray(u[i, j].numpy()),
                                                    jnp.asarray(msg[i, j].numpy()), regions)))


@pytest.mark.parametrize("offset", [0.0, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d", [(1, 64), (37, 256), (128, 128), (5, 1024)])
def test_rmsnorm_sweep_equals_pallas(rows, d, dtype, offset):
    rng = np.random.RandomState(3)
    jx, tx = _pair(_np(rng, (rows, d)), dtype)
    jw, tw = _pair(_np(rng, (d,)), dtype)
    got = ops.rmsnorm(tx, tw, weight_offset=offset)
    assert got.dtype == tx.dtype
    want = jops.rmsnorm(jx, jw, weight_offset=offset, block_rows=32)
    np.testing.assert_allclose(_f32(got), _f32(want),
                               rtol=3e-2 if dtype == "bfloat16" else 2e-5,
                               atol=1e-2 if dtype == "bfloat16" else 1e-5)


def test_rmsnorm_leading_dims_equal_pallas():
    rng = np.random.RandomState(4)
    jx, tx = _pair(_np(rng, (2, 3, 5, 64)), "float32")
    jw, tw = _pair(_np(rng, (64,)), "float32")
    got = ops.rmsnorm(tx, tw, eps=1e-5, weight_offset=1.0)
    assert tuple(got.shape) == (2, 3, 5, 64)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jops.rmsnorm(jx, jw, eps=1e-5, weight_offset=1.0)),
                               rtol=2e-5)


ATTN_CASES = [
    dict(B=1, Hq=2, Hkv=1, Sq=64, Skv=64, D=32, causal=True),
    dict(B=2, Hq=4, Hkv=4, Sq=48, Skv=48, D=16, causal=False),
    dict(B=1, Hq=8, Hkv=2, Sq=32, Skv=96, D=64, causal=True, q_offset=64),
    dict(B=1, Hq=2, Hkv=2, Sq=64, Skv=64, D=32, causal=True, window=19),
    dict(B=1, Hq=2, Hkv=1, Sq=64, Skv=64, D=32, causal=True,
         logit_softcap=15.0),
    dict(B=2, Hq=4, Hkv=1, Sq=1, Skv=80, D=32, causal=True, q_offset=79),
]


def _qkv(rng, B, Hq, Hkv, Sq, Skv, D, dtype):
    q = _pair(_np(rng, (B, Hq, Sq, D)), dtype)
    k = _pair(_np(rng, (B, Hkv, Skv, D)), dtype)
    v = _pair(_np(rng, (B, Hkv, Skv, D)), dtype)
    return (q[0], k[0], v[0]), (q[1], k[1], v[1])


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "-".join(
    f"{k}{v}" for k, v in c.items()))
def test_flash_attention_sweep_equals_pallas(case):
    case = dict(case)
    shape = [case.pop(k) for k in ("B", "Hq", "Hkv", "Sq", "Skv", "D")]
    jqkv, tqkv = _qkv(np.random.RandomState(5), *shape, "float32")
    got = ops.flash_attention(*tqkv, **case)
    want = jops.flash_attention(*jqkv, block_q=32, block_k=32, **case)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=3e-5)


def test_flash_attention_bf16_equals_pallas():
    jqkv, tqkv = _qkv(np.random.RandomState(6), 1, 2, 2, 64, 64, 32, "bfloat16")
    got = ops.flash_attention(*tqkv)
    assert got.dtype == torch.bfloat16
    want = jops.flash_attention(*jqkv, block_q=32, block_k=32)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=5e-2, atol=3e-2)


def test_flash_attention_unaligned_padding_equals_pallas():
    jqkv, tqkv = _qkv(np.random.RandomState(7), 1, 2, 1, 50, 70, 32, "float32")
    got = ops.flash_attention(*tqkv, causal=False)
    want = jops.flash_attention(*jqkv, causal=False, block_q=32, block_k=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=3e-5)


def test_flash_attention_fully_masked_rows_are_zero():
    """A window of 0 leaves a causal row no key: zeros, not NaNs, in both."""
    jqkv, tqkv = _qkv(np.random.RandomState(8), 1, 2, 1, 8, 8, 16, "float32")
    got = ops.flash_attention(*tqkv, window=0)
    want = jops.flash_attention(*jqkv, window=0, block_q=8, block_k=8)
    np.testing.assert_array_equal(got.numpy(), np.zeros((1, 2, 8, 16), np.float32))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 16, "cuda_core"),
    (torch.bfloat16, 32, "cuda_core"), (torch.float32, 16, "cuda_core"),
    (torch.float32, 64, "cuda_core"), (torch.float32, 256, "cuda_core")])
def test_flash_route_rule(dtype, D, want):
    """The CUDA kernel a call on the card takes depends on dtype and
    head_dim alone; CPU tensors run the plain version and launch none."""
    assert fk.route(dtype, D) == want
    q = torch.zeros(1, 2, 4, D, dtype=dtype)
    before = fk.launch_counts()
    ops.flash_attention(q, q[:, :1], q[:, :1])
    assert fk.launch_counts() == before


def test_flash_tensor_core_route_takes_16_byte_strides():
    """TMA's rule: 16-byte aligned data and strides; a dimension of size
    1 is never stepped, so its stride does not matter."""
    view = torch.zeros(2, 10, 4, 64, dtype=torch.bfloat16).transpose(1, 2)
    assert fk._tma_strides(view) == [10 * 4 * 64, 64, 4 * 64]
    one = torch.zeros(1, 10, 1, 128, dtype=torch.bfloat16).transpose(1, 2)
    assert fk._tma_strides(one) == [128, 128, 128]
    with pytest.raises(ValueError, match="16-byte"):
        fk._tma_strides(torch.zeros(1, 2, 8, 68, dtype=torch.bfloat16)[..., :64])


def test_ssd_scan_equals_pallas():
    rng = np.random.RandomState(9)
    B, S, H, P, G, N = 1, 40, 2, 8, 1, 8
    x, dt = _np(rng, (B, S, H, P)), np.abs(_np(rng, (B, S, H))) * 0.1
    A, Bm, C = -np.abs(_np(rng, (H,))), _np(rng, (B, S, G, N)), _np(rng, (B, S, G, N))
    y, h = ops.ssd_scan(*map(torch.from_numpy, (x, dt, A, Bm, C)), chunk=16,
                        return_state=True)
    jy, jh = jops.ssd_scan(*map(jnp.asarray, (x, dt, A, Bm, C)), chunk=16,
                           return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-4, atol=3e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=2e-4, atol=3e-5)
