"""The embedding lookup's backward against the JAX package, on the CPU.

The reference's ``apply_embedding`` (``jnp.take`` of the table cast to the
compute dtype) has a VJP that adds each id's rows in ascending token
position, rounding to the compute dtype after every add.  Seeded numpy
ids that repeat (4096 ids over 64 or 1000 rows) and cotangents go through
``jax.vjp`` of it and through the port:

* the plain version (``kernels/ref.py`` ``embedding_bwd``, which the
  wrapper runs for CPU tensors) and autograd of the port's
  ``apply_embedding``: the table's gradient equal bit for bit, in bf16 and
  float32, with and without ``embed_scale``;
* ``Model.loss`` of qwen1.5-0.5b and whisper-large-v3 smoke on a batch
  whose tokens repeat heavily: the loss at rtol = atol = 1e-5 and every
  gradient against ``jax.grad`` at rtol 1e-4 plus 1e-4 of the leaf's
  largest entry (``tests/test_torch_families.py``'s bounds, its rule for
  the key bias without rope included);
* the smoke ``Model.loss`` of all ten configs holds no backward node
  that adds into shared rows (with float atomics on the card): no
  ``IndexSelectBackward0``, ``EmbeddingBackward0``, ``IndexAddBackward0``,
  ``ScatterAddBackward0`` or accumulating ``IndexPutBackward0``, names
  checked against the installed PyTorch.
"""

import collections
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as jax_get_config
from repro.launch.serve import synthetic_batch as jax_synthetic_batch
from repro.models import Model as JaxModel
from repro.models import nn as jnn
from repro_torch.configs import ARCH_IDS, ShapeConfig, get_config
from repro_torch.data import SyntheticTokens
from repro_torch.kernels import embedding as ek
from repro_torch.kernels import ref
from repro_torch.launch.serve import synthetic_batch
from repro_torch.models import Model
from repro_torch.models import nn as tnn
from repro_torch.models.convert import from_reference_params

TIGHT = dict(rtol=1e-5, atol=1e-5)
#: backward nodes that add into shared rows (float atomics on the card)
ATOMIC_NODES = {"IndexSelectBackward0", "EmbeddingBackward0", "IndexAddBackward0",
                "ScatterAddBackward0"}
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


def _lookup_case(vocab, n_ids, d, seed):
    """(table float32 [vocab, d], ids [4, n_ids / 4], dy float32 [4, n_ids / 4, d])."""
    rng = np.random.RandomState(seed)
    table = rng.randn(vocab, d).astype(np.float32)
    ids = rng.randint(0, vocab, (4, n_ids // 4)).astype(np.int32)
    dy = rng.randn(4, n_ids // 4, d).astype(np.float32)
    return table, ids, dy


def _cfg(dtype: str, d: int, embed_scale: bool):
    # the fields both packages' apply_embedding read
    return types.SimpleNamespace(dtype=dtype, d_model=d, embed_scale=embed_scale)


def _jax_table_grad(table, ids, dy, cfg):
    """jax.vjp of the reference's apply_embedding, the table's cotangent."""
    jdt = DTYPES[cfg.dtype][0]
    f = lambda t: jnn.apply_embedding({"table": t}, jnp.asarray(ids), cfg)
    _, vjp = jax.vjp(f, jnp.asarray(table))
    return np.asarray(vjp(jnp.asarray(dy).astype(jdt))[0])


# (vocab, ids): 4096 ids over 64 rows (each id ~64 times) and over 1000
# (~4 times), 8 columns; autograd of index_select in bf16 misses the
# reference's bits on most of the 64-row table's entries
LOOKUP_CASES = [(64, 4096), (1000, 4096)]


@pytest.mark.parametrize("embed_scale", [False, True], ids=["plain", "scaled"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("vocab,n_ids", LOOKUP_CASES)
def test_plain_version_and_autograd_equal_jax_vjp(vocab, n_ids, dtype, embed_scale):
    """The plain version (fed the cotangent autograd gives it: dy, times
    the scale in the compute dtype) and autograd of the port's
    ``apply_embedding`` give the reference's table gradient bit for bit."""
    d = 8
    table, ids, dy = _lookup_case(vocab, n_ids, d, seed=vocab + 7 * embed_scale)
    cfg = _cfg(dtype, d, embed_scale)
    want = _jax_table_grad(table, ids, dy, cfg)
    tdt = DTYPES[dtype][1]
    tdy = torch.from_numpy(dy).to(tdt)
    assert np.unique(ids).size < ids.size   # ids repeat

    # the plain version on the cotangent of the lookup itself
    g = tdy.reshape(-1, d)
    if embed_scale:
        g = g * torch.tensor(np.sqrt(d), dtype=tdt).item()
    plain = ref.embedding_bwd(g, torch.from_numpy(ids).reshape(-1), vocab)
    assert plain.dtype == tdt and tuple(plain.shape) == (vocab, d)
    np.testing.assert_array_equal(_bits(plain.float().numpy()), _bits(want))

    # autograd of the port's apply_embedding, the float32 table a leaf
    t = torch.from_numpy(table).requires_grad_()
    x = tnn.apply_embedding({"table": t}, torch.from_numpy(ids), cfg)
    assert x.grad_fn is not None and type(x.grad_fn).__name__ not in ATOMIC_NODES
    x.backward(tdy)
    np.testing.assert_array_equal(_bits(t.grad.numpy()), _bits(want))


def _sequential(dy: torch.Tensor, ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """The sum written as a loop over positions: each add rounded to dy's dtype."""
    out = torch.zeros((vocab, dy.shape[1]), dtype=dy.dtype)
    for t, v in enumerate(ids.tolist()):
        out[v] = (out[v].float() + dy[t].float()).to(dy.dtype)
    return out


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", ["one_id", "distinct", "few", "empty"])
def test_plain_version_equals_the_sequential_sum(kind, dtype):
    """The vectorised sweeps equal a loop over positions bit for bit at
    ragged sizes: one id repeated, all ids distinct, a few values, no
    ids; rows no id selects are zero, signed zeros included."""
    rng = np.random.RandomState(11)
    vocab, T, d = 37, {"one_id": 300, "distinct": 37, "few": 301, "empty": 0}[kind], 7
    ids = {"one_id": np.full(T, 5), "distinct": rng.permutation(vocab)[:T],
           "few": rng.choice([0, 3, 36], T), "empty": np.zeros(0)}[kind]
    ids = torch.from_numpy(ids.astype(np.int64))
    dy = torch.from_numpy(rng.randn(T, d).astype(np.float32)).to(dtype)
    if T:
        dy[0] = -0.0
    got = ref.embedding_bwd(dy, ids, vocab)
    want = _sequential(dy, ids, vocab)
    np.testing.assert_array_equal(_bits(got.float().numpy()), _bits(want.float().numpy()))
    unused = sorted(set(range(vocab)) - set(ids.tolist()))
    assert not got[unused].float().abs().sum() and not torch.signbit(got[unused].float()).any()


def test_wrapper_refuses_mismatched_shapes_and_takes_cpu_tensors():
    dy = torch.ones(4, 3)
    with pytest.raises(ValueError):
        ek.embedding_bwd(dy, torch.zeros(5, dtype=torch.int64), 10)
    with pytest.raises(ValueError):
        ek.embedding_bwd(dy, torch.zeros(4, dtype=torch.float32), 10)
    before = ek.embedding_bwd.launches
    got = ek.embedding_bwd(dy, torch.tensor([1, 1, 2, 9]), 10)
    assert ek.embedding_bwd.launches == before   # the plain version: no launch
    assert got[1].tolist() == [2.0] * 3 and got[9].tolist() == [1.0] * 3


# -- Model.loss on repeating tokens ------------------------------------------------

REPEAT_ARCHS = ["qwen1.5-0.5b", "whisper-large-v3"]


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", REPEAT_ARCHS)
def test_loss_and_gradients_on_repeating_tokens_match_jax(arch):
    """2 x 16 tokens from 3 values (each id 8-13 times a batch, as frequent
    tokens repeat in text) through ``Model.loss``: the loss and every
    gradient (the tied table's two contributions included) against
    ``jax.grad``."""
    jcfg, cfg = jax_get_config(arch).smoke(), get_config(arch).smoke()
    jm, m = JaxModel(jcfg), Model(cfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3))[0])
    params = from_reference_params(jp, cfg, "cpu")
    jb = jax_synthetic_batch(jcfg, np.random.RandomState(5), 2, 16)
    b = synthetic_batch(cfg, np.random.RandomState(5), 2, 16, device="cpu")
    rng = np.random.RandomState(6)
    tokens = rng.choice([3, 17, cfg.vocab - 1], (2, 16)).astype(np.int32)
    targets = rng.randint(0, cfg.vocab, (2, 16)).astype(np.int32)
    jb = {**jb, "tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
    b = {**b, "tokens": torch.from_numpy(tokens), "targets": torch.from_numpy(targets)}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, jp), jb)
    leaves = dict(_paths(params))
    for t in leaves.values():
        t.requires_grad_(True)
    loss, met = m.loss(params, b)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), **TIGHT)
    np.testing.assert_allclose(met["ce"].item(), float(jmet["ce"]), **TIGHT)
    want = dict(_paths(jax.tree.map(np.asarray, jgrads)))
    assert want.keys() == leaves.keys() and "/embed/table" in want
    largest = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        g = leaves[k].grad
        assert g is not None, k
        if k.endswith("/bk") and cfg.pos_embedding != "rope":
            # without rope the softmax cancels a key bias: both gradients
            # are rounding noise
            assert max(float(g.abs().max()), float(np.abs(w).max())) <= 1e-6 * largest, k
            continue
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()) + 1e-12, err_msg=k)


# -- no backward node adds into shared rows ----------------------------------------


def _node_names(loss: torch.Tensor):
    """Every node of the loss's backward graph (type name, node)."""
    seen, stack = set(), [loss.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        yield type(fn).__name__, fn
        stack.extend(f for f, _ in fn.next_functions)


def test_atomic_node_names_are_the_installed_pytorchs():
    """Each name the walk looks for is the node the installed PyTorch
    records for that op (a walk for misspelt names would find nothing)."""
    w = torch.randn(6, 3, requires_grad=True)
    idx = torch.tensor([0, 2, 2])
    made = {
        "IndexSelectBackward0": torch.index_select(w, 0, idx),
        "EmbeddingBackward0": F.embedding(idx, w),
        "IndexAddBackward0": torch.zeros(6, 3).index_add(0, idx, w[:3]),
        "ScatterAddBackward0": torch.zeros(6, 3).scatter_add(0, idx[:, None].expand(3, 3),
                                                             w[:3]),
        "IndexPutBackward0": torch.zeros(6, 3).index_put((idx,), w[:3], accumulate=True),
    }
    for name, out in made.items():
        assert type(out.grad_fn).__name__ == name
    assert made["IndexPutBackward0"].grad_fn._saved_accumulate is True


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_graph_has_no_atomic_adding_backward(arch):
    """The smoke ``Model.loss``: no node of the backward graph adds into
    shared rows (float atomics on the card); the embedding's lookup is the
    hand-written backward's Function."""
    cfg = get_config(arch).smoke()
    m = Model(cfg)
    params = m.init(0, device="cpu")
    for t in tnn.tree_leaves(params):
        if t.is_floating_point():
            t.requires_grad_(True)
    batch = SyntheticTokens(cfg, ShapeConfig("t", 16, 2, "train")).device_batch(0, "cpu")
    loss, _ = m.loss(params, batch)
    names = collections.Counter()
    for name, fn in _node_names(loss):
        names[name] += 1
        assert name not in ATOMIC_NODES, (arch, name)
        assert not (name == "IndexPutBackward0" and fn._saved_accumulate), arch
    assert names["_LookupBackward"] == (2 if cfg.mtp_depth else 1), names
