"""The port's halo kernels (plain versions, as CPU tensors run them)
against the JAX package's Pallas kernels in interpret mode, bit for bit.

Every function here is a copy or a single add, so equality is exact.
The CUDA kernels themselves are held against these plain versions on
the card (``chip_smoke.py`` and ``tests/test_torch_gpu.py``).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.kernels import ops
from repro.kernels.halo_pack import pack_segments_call, unpack_segments_call
from repro_torch.kernels import halo_pack as hk
from repro_torch.kernels import ref

# the cases of tests/test_kernels.py (face, edge, corner, odd sizes)
REGION_CASES = [
    ((4, 4, 4), (slice(0, 1), slice(0, 4), slice(0, 4))),
    ((4, 4, 4), (slice(3, 4), slice(0, 1), slice(0, 4))),
    ((4, 4, 4), (slice(3, 4), slice(3, 4), slice(3, 4))),
    ((7, 5, 3), (slice(0, 7), slice(4, 5), slice(0, 3))),
    ((2, 9, 6), (slice(1, 2), slice(0, 9), slice(5, 6))),
]
RANKS = 3  # the port's kernels take every rank at once


def _inputs(seed, shape, dtype):
    """The same values for both packages: float32 numpy, cast by each."""
    x = np.random.RandomState(seed).randn(RANKS, *shape).astype(np.float32)
    return x, torch.from_numpy(x).to(getattr(torch, dtype))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,region", REGION_CASES)
def test_halo_pack_equals_pallas(shape, region, dtype):
    x, u = _inputs(0, shape, dtype)
    got = hk.halo_pack(u, region)
    assert got.is_contiguous()
    for r in range(RANKS):
        want = ops.halo_pack(jnp.asarray(x[r], dtype), region)
        np.testing.assert_array_equal(_np(got[r]),
                                      np.asarray(want, np.float32))
    np.testing.assert_array_equal(_np(got), _np(ref.halo_pack(u, region)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,region", REGION_CASES)
def test_halo_unpack_add_equals_pallas(shape, region, dtype):
    x, u = _inputs(1, shape, dtype)
    rshape = ref.region_shape(region)
    m = np.random.RandomState(2).randn(RANKS, *rshape).astype(np.float32)
    msg = torch.from_numpy(m).to(u.dtype)
    got = hk.halo_unpack_add(u.clone(), msg, region)
    for r in range(RANKS):
        want = ops.halo_unpack_add(jnp.asarray(x[r], dtype),
                                   jnp.asarray(m[r], dtype), region)
        np.testing.assert_array_equal(_np(got[r]), np.asarray(want, np.float32))


def test_halo_unpack_add_is_in_place_and_casts():
    u = torch.zeros(2, 3, 3, 3)
    msg = torch.ones(2, 1, 3, 3, dtype=torch.float64)
    out = hk.halo_unpack_add(u, msg, (slice(2, 3), slice(0, 3), slice(0, 3)))
    assert out is u and u.dtype == torch.float32
    assert float(u.sum()) == 18.0 and float(u[:, 2].sum()) == 18.0


SEG_SHAPES = [(2, 3), (1, 4), (5,), (1, 1, 4)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_segments_equals_pallas(dtype):
    rng = np.random.RandomState(3)
    slabs = [rng.randn(RANKS, *s).astype(np.float32) for s in SEG_SHAPES]
    sources = [(torch.from_numpy(s.reshape(RANKS, -1)).to(getattr(torch, dtype)), 0)
               for s in slabs]
    sizes = [int(np.prod(s)) for s in SEG_SHAPES]
    got = hk.pack_segments(sources, sizes)
    for r in range(RANKS):
        want = pack_segments_call([jnp.asarray(s[r], dtype) for s in slabs],
                                  interpret=True)
        np.testing.assert_array_equal(_np(got[r]), np.asarray(want, np.float32))


def test_pack_segments_relays_columns_of_a_received_buffer():
    """A later hop packs a segment of an earlier hop's buffer verbatim."""
    recv = torch.arange(3 * 10, dtype=torch.float32).view(3, 10)
    slab = -torch.arange(3 * 2, dtype=torch.float32).view(3, 2)
    got = hk.pack_segments([(slab, 0), (recv, 4), (recv, 0)], [2, 3, 1])
    want = torch.cat([slab, recv[:, 4:7], recv[:, 0:1]], dim=1)
    assert torch.equal(got, want)


def test_unpack_segments_equals_pallas_roundtrip():
    rng = np.random.RandomState(4)
    slabs = [rng.randn(RANKS, *s).astype(np.float32) for s in SEG_SHAPES]
    sizes = [int(np.prod(s)) for s in SEG_SHAPES]
    buf = np.concatenate([s.reshape(RANKS, -1) for s in slabs], axis=1)
    outs = [torch.zeros(RANKS, *s) for s in SEG_SHAPES]
    hk.unpack_segments(torch.from_numpy(buf), outs,
                       list(np.cumsum([0] + sizes[:-1])))
    for r in range(RANKS):
        want = unpack_segments_call(jnp.asarray(buf[r]), SEG_SHAPES,
                                    interpret=True)
        for o, w in zip(outs, want):
            np.testing.assert_array_equal(o[r].numpy(), np.asarray(w))


def test_unpack_segments_mask_keeps_ranks_without_sender():
    buf = torch.arange(3 * 4, dtype=torch.float32).view(3, 4)
    a, b = torch.full((3, 2), -1.0), torch.full((3, 2), -2.0)
    masks = torch.tensor([[True, False, True], [False, True, False]])
    hk.unpack_segments(buf, [a, b], [0, 2], masks)
    assert torch.equal(a, torch.tensor([[0., 1.], [-1., -1.], [8., 9.]]))
    assert torch.equal(b, torch.tensor([[-2., -2.], [6., 7.], [-2., -2.]]))


def test_wrappers_count_no_launch_on_cpu():
    hk.reset_launches()
    u = torch.zeros(2, 3, 3, 3)
    region = (slice(0, 1), slice(0, 3), slice(0, 3))
    hk.halo_unpack_add(u, hk.halo_pack(u, region), region)
    staged = hk.pack_segments([(u.view(2, -1), 0)], [27])
    hk.unpack_segments(staged, [u], [0])
    hk.unpack_boundary_add(u, hk.pack_boundary(u, [region]), [region])
    assert hk.launch_counts() == dict.fromkeys(
        ("halo_pack", "halo_unpack_add", "pack_boundary", "unpack_boundary_add",
         "pack_segments", "unpack_segments"), 0)


def test_segment_validation():
    with pytest.raises(ValueError, match="dtype"):
        hk.pack_segments([(torch.zeros(1, 2), 0),
                          (torch.zeros(1, 2, dtype=torch.float64), 0)], [2, 2])
    with pytest.raises(ValueError, match="does not fit"):
        hk.pack_segments([(torch.zeros(1, 2), 1)], [2])
    with pytest.raises(ValueError, match="at most"):
        hk.pack_segments([(torch.zeros(1, 1), 0)] * 65, [1] * 65)
    with pytest.raises(ValueError, match="does not fit"):
        hk.unpack_segments(torch.zeros(1, 5), [torch.zeros(2), torch.zeros(2)],
                           [0, 4])
    with pytest.raises(ValueError, match="masks"):
        hk.unpack_segments(torch.zeros(2, 2), [torch.zeros(2, 2)], [0],
                           torch.ones(1, 2, dtype=torch.uint8))


def test_region_validation():
    u = torch.zeros(1, 4, 4, 4)
    with pytest.raises(ValueError, match="unit-step"):
        hk.halo_pack(u, (slice(0, 4, 2), slice(0, 1), slice(0, 1)))
    with pytest.raises(ValueError, match="unit-step"):
        hk.halo_pack(u, (slice(None), slice(0, 1), slice(0, 1)))
    with pytest.raises(ValueError, match="message shape"):
        hk.halo_unpack_add(u, torch.zeros(1, 2, 4, 4),
                           (slice(0, 1), slice(0, 4), slice(0, 4)))


def test_wrappers_refuse_other_devices():
    """Tensors on two devices are refused; ``meta`` tensors alone take the
    plain version's shapes (a dry run), and compute nothing."""
    u = torch.zeros(1, 4, 4, 4, device="meta")
    region = (slice(0, 1), slice(0, 4), slice(0, 4))
    with pytest.raises(ValueError, match="CPU or on one CUDA"):
        hk.halo_unpack_add(torch.zeros(1, 4, 4, 4), torch.zeros(1, 1, 4, 4, device="meta"),
                           region)
    msg = hk.halo_pack(u, region)
    assert msg.device.type == "meta" and tuple(msg.shape) == (1, 1, 4, 4)
