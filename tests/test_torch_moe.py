"""The port's MoE family (deepseek-v3-671b: MLA, 256 routed experts with a
sigmoid router, a shared expert, the MTP head; grok-1-314b: 8 experts,
softmax router, GQA with soft-capping) against the JAX package, on the
CPU.

Smoke models (``cfg.smoke()``: 2 layers, d_model 256, 4 experts, top-2,
float32; deepseek's first layer dense, its MLA at q/k head dim 48 and v
head dim 32).  Weights are the reference's own (``from_reference_params``)
and inputs seeded numpy draws; no Hypothesis.  The port's flash and
rmsnorm wrappers run their plain versions (``kernels/ref.py``), the
reference its jnp attention and norms, so the two differ by float32
rounding only.  The reference runs with no mesh context, where its
``apply_moe_ep`` returns None and ``apply_moe`` takes the gather path
(the port's only path).

Asserted: ``_route`` of both routers (expert ids equal, weights within
1e-6), a constructed top-k tie ordered as ``lax.top_k`` orders it (lower
index first); ``apply_moe`` at rtol = atol = 1e-5 with ``dropped_frac``
and ``lb_loss`` equal at the default capacity and at one that drops; the
dispatch with ample capacity equal to the dense mixture (the reference's
``tests/test_models.py`` check); ``_apply_mla`` without a cache, at a
prefill (at depth 0 and at depth 7) and 3 decode steps, every cache
leaf; ``forward_logits`` within rtol = atol = 2e-5, prefill and decode
logits and caches within 1e-5 (``tests/test_torch_dense.py``'s bounds),
with a scalar and a per-sequence ``pos``; served tokens equal in both
modes; ``Model.loss`` (``ce``, ``lb_loss``, ``mtp_loss``) within 1e-5
and every gradient at ``tests/test_torch_train.py:_grads_close``'s bound;
``count_params``, ``model_memory_bytes`` and ``model_flops`` of all ten
configs equal; ``build_moe_dispatch_program``'s digest and collective
counts equal the reference's, its result equals the plain tiled
all-to-all, and it refuses indivisible experts; the full-size parameter
shapes on the meta device equal ``abstract_init()``.

The dispatch's and the combine's backwards (``moe._Dispatch``,
``moe._Combine``): their forwards and VJPs against ``jax.vjp`` of the
reference's expressions at both routers' (experts, top-k), at a
capacity that drops assignments and leaves slots empty (float32 at
``TIGHT``, bf16 at ``BF16_TOL`` with the weight gradients of unit
scale); at unit-variance bf16 inputs, the weight gradient within its
rounding bound of a float64 witness and nearer it than the
reference's, which adds in bf16; the dispatch's sum equal bit for bit
to an explicit ascending-expert-order sum on gradients another order
rounds otherwise, the combine's to the plain per-slot and per-assignment
products; no ``IndexSelectBackward0``, ``IndexBackward0`` or
``IndexPutBackward0`` node in ``apply_moe``'s graph.  Both smoke models'
3 train steps with bf16 AdamW moments, single and as one
``persistent_steps`` dispatch, against ``repro.launch.steps`` under a
1x1 mesh (where the reference takes ``apply_moe_ep`` at ``C_loc = C``):
the loss trace at rtol 1e-4, the parameters at rtol = atol = 2e-3
(``tests/test_torch_train.py``'s bounds).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

import repro.core.effects as jeffects
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeConfig as JaxShape
from repro.launch import steps as jsteps
from repro.launch.serve import ServeEngine as JaxServeEngine
from repro.launch.serve import serve as jax_serve
from repro.launch.serve import synthetic_batch as jax_synthetic_batch
from repro.models import Model as JaxModel
from repro.models import counting as jcounting
from repro.models import moe as jmoe
from repro.models import nn as jnn
from repro.optim import AdamWConfig as JaxAdamW
from repro.optim import adamw_init as jax_adamw_init
from repro.parallel import make_mesh as jax_make_mesh
from repro_torch import make_mesh
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import program_digest
from repro_torch.core import FusedEngine
from repro_torch.data import SyntheticTokens
from repro_torch.launch import steps
from repro_torch.launch.serve import ServeEngine, serve, synthetic_batch
from repro_torch.models import Model, counting, moe
from repro_torch.models import nn
from repro_torch.models.convert import caches_to_numpy, from_reference_params
from repro_torch.models.nn import tree_leaves
from repro_torch.optim import AdamWConfig, adamw_init

ARCHS = ["deepseek-v3-671b", "grok-1-314b"]
PROMPT, GEN, SLOTS = 12, 5, 4
TIGHT = dict(rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(jax model, jax params, port model, port params) at the smoke size."""
    jcfg, cfg = jax_get_config(arch).smoke(), get_config(arch).smoke()
    jm = JaxModel(jcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3))[0])
    return jm, jax.tree.map(jnp.asarray, jp), Model(cfg), from_reference_params(jp, cfg,
                                                                               "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _grads_close(got, want):
    """Every gradient leaf: rtol 1e-4 plus 1e-4 of the leaf's largest entry
    (``tests/test_torch_train.py:_grads_close``)."""
    g, w = dict(_paths(got)), dict(_paths(want))
    assert g.keys() == w.keys()
    for k in w:
        ref = np.asarray(w[k], np.float32)
        np.testing.assert_allclose(g[k].float().numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(ref).max()) + 1e-12, err_msg=k)


# -- configs, counting, parameters ---------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    ours, theirs = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.smoke()) == dataclasses.asdict(theirs.smoke())


@pytest.mark.parametrize("arch", list(JAX_ARCH_IDS))
def test_counting_equals_the_reference(arch):
    assert tuple(ARCH_IDS) == tuple(JAX_ARCH_IDS)
    ours, theirs = get_config(arch), jax_get_config(arch)
    for cfg, jcfg in ((ours, theirs), (ours.smoke(), theirs.smoke())):
        for active in (False, True):
            assert counting.count_params(cfg, active) == \
                jcounting.count_params(jcfg, active)
        for name, shape in SHAPES.items():
            jshape = JAX_SHAPES[name]
            assert counting.model_flops(cfg, shape) == jcounting.model_flops(jcfg, jshape)
            assert counting.model_memory_bytes(cfg, shape) == \
                jcounting.model_memory_bytes(jcfg, jshape)
            assert counting.model_memory_bytes(cfg, shape, chips=8, data_shards=2) == \
                jcounting.model_memory_bytes(jcfg, jshape, chips=8, data_shards=2)


def test_moe_parameter_counts_at_the_served_cuts():
    """The counts the card's served configs are cut to: deepseek-v3 at 3
    layers, grok-1 at 2 (``chip_smoke.py`` phase 20)."""
    ds = dataclasses.replace(get_config("deepseek-v3-671b"), n_layers=3, first_k_dense=1)
    grok = dataclasses.replace(get_config("grok-1-314b"), n_layers=2)
    assert round(counting.count_params(ds) / 1e9, 2) == 26.14
    assert round(counting.count_params(grok) / 1e9, 2) == 11.45
    assert round(counting.count_params(get_config("deepseek-v3-671b")) / 1e9, 2) == 671.71
    assert round(counting.count_params(get_config("grok-1-314b")) / 1e9, 2) == 316.49


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_parameter_shapes_equal_the_reference(arch):
    """Full size on the meta device against JAX's ``abstract_init()``: the
    same tree, shapes and dtypes; the total is ``count_params`` plus the
    leaves it does not count (the norms' scales and the routers' bias)."""
    cfg = get_config(arch)
    ours = Model(cfg).abstract_init()
    theirs, _ = JaxModel(jax_get_config(arch)).abstract_init()
    assert jax.tree.structure(jax.tree.map(lambda t: 0, ours)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, theirs))
    for o, t in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        assert o.device.type == "meta"
        assert tuple(o.shape) == tuple(t.shape)
        assert str(o.dtype).split(".")[1] == str(t.dtype)
    # count_params counts each layer's two norms, not the final norm, the
    # MTP head's norms, MLA's q and kv norms or the routers' bias
    uncounted = sum(t.numel() for path, t in _paths(ours)
                    if path.endswith(("q_norm", "kv_norm", "router_bias"))
                    or path == "/ln_final/scale"
                    or (path.startswith("/mtp/") and path.endswith("scale")))
    assert sum(t.numel() for t in tree_leaves(ours)) == counting.count_params(cfg) + uncounted


def test_convert_and_compute_params_carry_the_new_leaves():
    """The MoE, MLA and MTP leaves cross value for value; a tree without the
    MTP head is refused; ``compute_params`` casts the MLA projections, the
    experts and the shared expert once, and keeps the router, its bias and
    the norms."""
    jm, jp, m, params = _pair("deepseek-v3-671b")
    for path in ("decoder/segments/1/0/moe/router_bias", "decoder/segments/1/0/moe/wg",
                 "decoder/segments/0/0/attn/wkv_b", "mtp/proj", "mtp/block/attn/wq_a"):
        got, ref = params, jp
        for key in path.split("/"):
            got = got[int(key)] if isinstance(got, list) else got[key]
            ref = ref[int(key)] if isinstance(ref, list) else ref[key]
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=path)
    with pytest.raises(ValueError, match="mtp"):
        from_reference_params({k: v for k, v in jax.tree.map(np.asarray, jp).items()
                               if k != "mtp"}, m.cfg, "cpu")
    model = Model(get_config("deepseek-v3-671b"))
    full = model.abstract_init()
    cast = model.compute_params(full)
    layer = cast["decoder"]["segments"][1]
    for leaf in ("wi", "wg", "wo", "shared_wi", "shared_wg", "shared_wo"):
        assert layer["moe"][leaf].dtype == torch.bfloat16
    for leaf in ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo"):
        assert layer["attn"][leaf].dtype == torch.bfloat16
    assert cast["mtp"]["proj"].dtype == torch.bfloat16
    for leaf in ("router", "router_bias"):
        assert layer["moe"][leaf] is full["decoder"]["segments"][1]["moe"][leaf]
    assert layer["attn"]["q_norm"] is full["decoder"]["segments"][1]["attn"]["q_norm"]


# -- routing and dispatch -------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_route_equals_the_reference(arch):
    jm, jp, m, params = _pair(arch)
    p = params["decoder"]["segments"][-1][0]["moe"]
    jpm = jp["decoder"]["segments"][-1][0]["moe"]
    cfg = m.cfg
    x = np.random.RandomState(11).randn(40, cfg.d_model).astype(np.float32)
    if "router_bias" in p:   # a bias that moves the choice
        bias = np.random.RandomState(12).randn(4).astype(np.float32) * 0.05
        p = {**p, "router_bias": torch.from_numpy(bias)}
        jpm = {**jpm, "router_bias": jnp.asarray(bias)}
    idx, w, probs = moe._route(p, torch.from_numpy(x), cfg)
    jidx, jw, jprobs = jmoe._route(jpm, jnp.asarray(x), jm.cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_route_orders_a_tie_as_lax_top_k(arch):
    """Router logits with equal scores: a zero router (every expert ties)
    and tokens whose two best experts tie.  The port's top-k (a stable
    descending sort) gives the lower index first, as ``lax.top_k``."""
    jm, jp, m, params = _pair(arch)
    cfg = m.cfg
    E, d = cfg.n_experts, cfg.d_model
    router = np.zeros((d, E), np.float32)
    router[0, 3] = router[0, 1] = 1.0      # experts 1 and 3 tie on token 0's feature
    router[1, 2] = 2.0
    x = np.zeros((3, d), np.float32)
    x[0, 0] = 1.0                          # 1 and 3 tie for the top
    x[1, 1] = 1.0                          # 2 first, then 0, 1 and 3 tie
    # token 2: all zero, every expert ties
    p = {"router": torch.from_numpy(router)}
    jpm = {"router": jnp.asarray(router)}
    if cfg.router == "sigmoid":
        p["router_bias"] = torch.zeros(E)
        jpm["router_bias"] = jnp.zeros(E)
    idx, w, _ = moe._route(p, torch.from_numpy(x), cfg)
    jidx, jw, _ = jmoe._route(jpm, jnp.asarray(x), jm.cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.tolist() == [[1, 3], [2, 0], [0, 1]]
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    # the values themselves, past the smoke config's experts
    vals = torch.tensor([[0.5, 0.7, 0.7, 0.1, 0.7, 0.2]])
    jv, ji = jax.lax.top_k(jnp.asarray(vals.numpy()), 4)
    tv, ti = moe._top_k(vals, 4)
    assert ti.tolist() == np.asarray(ji).tolist() == [[1, 2, 4, 0]]
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity", [None, 3, 1])
def test_apply_moe_equals_the_reference(arch, capacity):
    """The default capacity (no drops at 16 tokens here), and capacities
    of 3 and 1 that drop: output, ``dropped_frac``, ``lb_loss`` and the
    mean router probabilities."""
    jm, jp, m, params = _pair(arch)
    si = 1 if m.cfg.first_k_dense else 0
    p = params["decoder"]["segments"][si][0]["moe"]
    jpm = jp["decoder"]["segments"][si][0]["moe"]
    x = np.random.RandomState(13).randn(2, 8, m.cfg.d_model).astype(np.float32)
    y, aux = moe.apply_moe(p, torch.from_numpy(x), m.cfg, capacity=capacity)
    jy, jaux = jmoe.apply_moe(jpm, jnp.asarray(x), jm.cfg, capacity=capacity)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TIGHT)
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"])
    if capacity == 1:
        assert float(aux["dropped_frac"]) > 0
    np.testing.assert_allclose(float(aux["lb_loss"]), float(jaux["lb_loss"]), **TIGHT)
    np.testing.assert_allclose(aux["router_probs_mean"].numpy(),
                               np.asarray(jaux["router_probs_mean"]), **TIGHT)


def test_dispatch_plan_is_the_sorted_capacity_model():
    """Expert 1 gets 5 assignments at capacity 3: the first 3 in token
    order are kept, 2 dropped into expert 1's slot 0; an empty slot holds
    the zero row ``T`` and the filling assignment ``T·k``."""
    idx = torch.tensor([[1, 0], [1, 2], [2, 1], [1, 3], [1, 0]])   # T 5, k 2
    dispatch, slot, keep, source = moe.dispatch_plan(idx, 4, 3)
    T, A = 5, 10
    assert dispatch.view(4, 3).tolist() == [[0, 4, T], [0, 1, 2], [1, 2, T], [3, T, T]]
    assert source.view(4, 3).tolist() == [[1, 9, A], [0, 2, 5], [3, 4, A], [7, A, A]]
    assert keep.view(5, 2).tolist() == [[True, True], [True, True], [True, True],
                                         [False, True], [False, True]]
    assert slot.view(5, 2).tolist() == [[3, 0], [4, 6], [7, 5], [3, 9], [3, 1]]


def test_moe_equals_dense_mixture_when_capacity_ample():
    """With capacity ≥ T·k the sort-based dispatch equals the dense
    weighted mixture (no drops): every expert on every token, each token's
    top-k outputs weighted and added (the reference's check)."""
    jm, jp, m, params = _pair("grok-1-314b")
    p = params["decoder"]["segments"][0][0]["moe"]
    cfg = m.cfg
    x = torch.from_numpy(np.random.RandomState(7).randn(1, 6, cfg.d_model).astype(np.float32))
    T = 6
    y, aux = moe.apply_moe(p, x, cfg, capacity=T * cfg.top_k)
    assert float(aux["dropped_frac"]) == 0.0
    x2 = x.reshape(T, -1)
    idx, w, _ = moe._route(p, x2, cfg)
    dense = torch.stack([(torch.nn.functional.silu(x2 @ p["wg"][e]) * (x2 @ p["wi"][e]))
                         @ p["wo"][e] for e in range(cfg.n_experts)], 1)
    want = sum(torch.gather(dense, 1, idx[:, kk, None, None].expand(T, 1, cfg.d_model))[:, 0]
               * w[:, kk, None] for kk in range(cfg.top_k))
    torch.testing.assert_close(y.reshape(T, -1), want, rtol=1e-5, atol=1e-5)


# -- the dispatch's and the combine's backwards ----------------------------------

#: both routers' (experts, top-k), with a token count and a capacity at
#: which some assignments drop and some slots stay empty
FN_SHAPES = {"deepseek": (256, 8, 40, 2), "grok": (8, 2, 40, 8)}
#: bf16: two bf16 ulps at 1
BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)


def _assignments(E, k, T, seed):
    """Each token's ``k`` distinct experts, skewed towards the low ids so
    that some experts overflow and others stay short of the capacity."""
    rng = np.random.RandomState(seed)
    score = rng.rand(T, E) + np.linspace(1.0, 0.0, E)[None, :]
    return np.argsort(-score, axis=1, kind="stable")[:, :k].astype(np.int32)


def _reference_dispatch_combine(idx, E, C):
    """The reference's dispatch and combine (``repro/models/moe.py``'s
    ``apply_moe``, the sort-based dispatch through the weighted
    ``segment_sum``) as functions of ``x2d`` and of ``(yout, w)``."""
    T, k = idx.shape
    flat_e = jnp.asarray(idx).reshape(T * k)
    flat_t = jnp.repeat(jnp.arange(T), k)
    order = jnp.argsort(flat_e, stable=True)
    se, st = flat_e[order], flat_t[order]
    counts = jnp.bincount(flat_e, length=E)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(T * k) - starts[se]
    keep = rank < C
    slot = se * C + jnp.where(keep, rank, 0)
    slot_scatter = jnp.where(keep, slot, E * C)
    dispatch = jnp.full((E * C + 1,), T, dtype=jnp.int32).at[
        slot_scatter].set(jnp.where(keep, st, T))[:E * C]

    def dispatch_fn(x2d):
        x_pad = jnp.concatenate([x2d, jnp.zeros((1, x2d.shape[1]), x2d.dtype)], axis=0)
        return x_pad[dispatch].reshape(E * C, -1)

    def combine_fn(yout, w):
        sw = w.reshape(T * k)[order]
        y_flat = yout[slot]
        contrib = y_flat * (sw * keep).astype(y_flat.dtype)[:, None]
        return jax.ops.segment_sum(contrib, st, num_segments=T)

    return dispatch_fn, combine_fn


def _port_vjps(idx, E, C, x, yout, w, dxin, dy):
    """The port's dispatch and combine VJPs: ``(xin, dx)`` and ``(y, dyout,
    dw)``."""
    x, yout, w = (t.clone().requires_grad_() for t in (x, yout, w))
    xin, plan = moe._dispatch(x, idx, E, C)
    (dx,) = torch.autograd.grad(xin.reshape(E * C, -1), x, dxin)
    y = moe._combine(yout, w, plan)
    dyout, dw = torch.autograd.grad(y, (yout, w), dy)
    return xin.detach().reshape(E * C, -1), dx, y.detach(), dyout, dw


def _both_vjps(router, dtype, D, div):
    """The port's and the reference's (``jax.vjp``) forwards and VJPs,
    ``{xin, dx, y, dyout, dw}`` each, on one seeded draw at both routers'
    (experts, top-k) and a capacity that drops assignments and leaves
    slots empty; ``yout`` and ``dy`` are unit normals over ``div``.  Also
    the inputs as given (``idx``, ``yout``, ``dy``, ``dtype``'s values in
    float64)."""
    E, k, T, C = FN_SHAPES[router]
    idx = _assignments(E, k, T, seed=E)
    dispatch, _, keep, _ = moe.dispatch_plan(torch.from_numpy(idx).long(), E, C)
    assert not bool(keep.all()) and bool((dispatch == T).any())   # drops and empty slots
    rng = np.random.RandomState(k)
    x, dxin = (rng.randn(*shape).astype(np.float32) for shape in ((T, D), (E * C, D)))
    yout, dy = ((rng.randn(*shape) / div).astype(np.float32)
                for shape in ((E * C, D), (T, D)))
    w = rng.rand(T, k).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tx, tyout, tdxin, tdy = (torch.from_numpy(a).to(tdt) for a in (x, yout, dxin, dy))
    got = _port_vjps(torch.from_numpy(idx).long(), E, C, tx, tyout,
                     torch.from_numpy(w), tdxin, tdy)
    dispatch_fn, combine_fn = _reference_dispatch_combine(idx, E, C)
    jxin, jvjp = jax.vjp(dispatch_fn, jnp.asarray(x, jdt))
    (jdx,) = jvjp(jnp.asarray(dxin, jdt))
    jy, jvjp = jax.vjp(combine_fn, jnp.asarray(yout, jdt), jnp.asarray(w))
    jdyout, jdw = jvjp(jnp.asarray(dy, jdt))
    names = ("xin", "dx", "y", "dyout", "dw")
    for name, t in zip(names, got):
        assert t.dtype == (torch.float32 if name == "dw" else tdt), name
    port = {n: t.double().numpy() for n, t in zip(names, got)}
    ref = {n: np.asarray(a, np.float64) for n, a in zip(names, (jxin, jdx, jy, jdyout, jdw))}
    given = (idx, tyout.double().numpy(), tdy.double().numpy())
    return port, ref, given


@pytest.mark.parametrize("router", sorted(FN_SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_and_combine_vjps_match_jax(router, dtype):
    """The forwards and VJPs of ``_dispatch`` and ``_combine`` against
    ``jax.vjp`` of the reference's expressions on the same ``idx``, ``w``,
    ``x``, ``yout`` and cotangents, at a capacity that drops assignments
    and leaves slots empty: float32 at ``TIGHT``, bf16 at
    ``BF16_TOL``.  ``yout`` and ``dy`` are drawn at ``D^-1/2``, so that
    each weight's gradient, a sum of ``D`` products, is of unit scale,
    where the bf16 bound's two ulps are; at unit variance the test
    below holds the bf16 weight gradient to a float64 witness."""
    D = 24
    port, ref, _ = _both_vjps(router, dtype, D, np.sqrt(D))
    tol = TIGHT if dtype == "float32" else BF16_TOL
    for name in port:
        np.testing.assert_allclose(port[name], ref[name], err_msg=name, **tol)


#: the unit roundoffs of bf16 and float32
U_BF16, U_F32 = 2.0 ** -8, 2.0 ** -24


@pytest.mark.parametrize("router", sorted(FN_SHAPES))
@pytest.mark.parametrize("D", [24, 256])
def test_bf16_weight_gradient_at_unit_scale_against_a_float64_witness(router, D):
    """bf16 with ``yout`` and ``dy`` at unit variance, where each weight's
    gradient ``<dy[t], yout[slot[a]]>`` sums ``D`` products of unit scale:
    ``xin``, ``dx``, ``y`` and ``dyout`` equal JAX's within ``BF16_TOL``.
    ``dw`` is held to the witness, the exact sum of the same bf16 inputs'
    products in float64.  The port rounds each product to bf16 (as
    autograd of the reference's expression does) and adds in float32, so
    it lies within ``u (1 + 2u) (Σ|p| + |exact|) + 2 D u32 Σ|p|`` of the
    witness (``u``, ``u32`` the unit roundoffs).  The reference's VJP adds
    the bf16 products in bf16 (at D 24 bit for bit a sequential bf16 sum),
    so the two packages differ by more than ``BF16_TOL`` here, and the
    port's total error against the witness is the smaller."""
    port, ref, (idx, yout, dy) = _both_vjps(router, "bfloat16", D, 1.0)
    for name in ("xin", "dx", "y", "dyout"):
        np.testing.assert_allclose(port[name], ref[name], err_msg=name, **BF16_TOL)
    E, k, T, C = FN_SHAPES[router]
    _, slot, keep, _ = moe.dispatch_plan(torch.from_numpy(idx).long(), E, C)
    slot, keep = slot.numpy(), keep.numpy()
    products = np.repeat(dy, k, 0) * yout[slot]                  # exact in float64
    exact = np.where(keep, products.sum(-1), 0).reshape(T, k)
    size = np.where(keep, np.abs(products).sum(-1), 0).reshape(T, k)
    bound = U_BF16 * (1 + 2 * U_BF16) * (size + np.abs(exact)) + 2 * D * U_F32 * size
    err, ref_err = np.abs(port["dw"] - exact), np.abs(ref["dw"] - exact)
    assert (err <= bound).all(), float((err / np.maximum(bound, 1e-30)).max())
    assert err.sum() < ref_err.sum(), (err.sum(), ref_err.sum())


def test_dispatch_backward_adds_in_ascending_expert_order():
    """``dx[t]`` is the sum of token ``t``'s kept slots' gradients added one
    after another in ascending expert order, bit for bit, on float32
    gradients whose sum another order rounds otherwise (rows of 1e8,
    1 and -1e8 magnitudes); the combine's gradients are the plain
    per-slot and per-assignment products."""
    E, k, T, C = 8, 4, 16, 6
    D = 32
    idx = _assignments(E, k, T, seed=5)
    tidx = torch.from_numpy(idx).long()
    rng = np.random.RandomState(6)
    dxin = torch.from_numpy((rng.randn(E * C, D) * 10.0 ** rng.randint(-1, 9, (E * C, D)))
                            .astype(np.float32))
    x = torch.from_numpy(rng.randn(T, D).astype(np.float32)).requires_grad_()
    xin, plan = moe._dispatch(x, tidx, E, C)
    _, slot, keep, _ = moe.dispatch_plan(tidx, E, C)   # w's order, not the plan's
    assert not bool(keep.all())
    (dx,) = torch.autograd.grad(xin.reshape(E * C, D), x, dxin)
    ascending, descending = torch.zeros(T, D), torch.zeros(T, D)
    for t in range(T):
        kept = sorted((int(idx[t, j]), int(slot[t * k + j])) for j in range(k)
                      if keep[t * k + j])
        for order, out in ((kept, ascending), (kept[::-1], descending)):
            acc = None
            for _, s in order:
                acc = dxin[s].clone() if acc is None else acc + dxin[s]
            if acc is not None:
                out[t] = acc
    assert torch.equal(dx, ascending)
    assert not torch.equal(dx, descending)   # the inputs tell the orders apart
    # the combine: dyout[s] = dy[t] * w[a] of the assignment filling s,
    # dw[a] = keep[a] <dy[t], yout[slot[a]]>
    yout = torch.from_numpy(rng.randn(E * C, D).astype(np.float32)).requires_grad_()
    w = torch.from_numpy(rng.rand(T, k).astype(np.float32)).requires_grad_()
    dy = torch.from_numpy(rng.randn(T, D).astype(np.float32))
    y = moe._combine(yout, w, plan)
    dyout, dw = torch.autograd.grad(y, (yout, w), dy)
    want_dyout = torch.zeros(E * C, D)
    for a in range(T * k):
        if keep[a]:
            want_dyout[slot[a]] = dy[a // k] * w.detach().reshape(-1)[a]
    want_dw = torch.stack([(dy[a // k] * yout.detach()[slot[a]]).sum() if keep[a]
                           else torch.tensor(0.0) for a in range(T * k)]).view(T, k)
    assert torch.equal(dyout, want_dyout)
    torch.testing.assert_close(dw, want_dw, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_graph_has_no_indexing_backward(arch):
    """The autograd graph of ``apply_moe``'s output (a capacity that drops)
    holds the dispatch's and the combine's Functions and no
    ``IndexSelectBackward0``, ``IndexBackward0`` or ``IndexPutBackward0``
    node, whose backwards add with float atomics on the card."""
    jm, jp, m, params = _pair(arch)
    si = 1 if m.cfg.first_k_dense else 0
    p = {k_: v.detach().requires_grad_()
         for k_, v in params["decoder"]["segments"][si][0]["moe"].items()}
    x = torch.from_numpy(np.random.RandomState(13).randn(2, 8, m.cfg.d_model)
                         .astype(np.float32)).requires_grad_()
    y, aux = moe.apply_moe(p, x, m.cfg, capacity=1)
    assert float(aux["dropped_frac"]) > 0
    names, stack, seen = set(), [y.grad_fn, aux["lb_loss"].grad_fn], set()
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        stack.extend(n for n, _ in node.next_functions)
    assert {"_DispatchBackward", "_CombineBackward"} <= names
    assert not names & {"IndexSelectBackward0", "IndexBackward0", "IndexPutBackward0"}


# -- MLA ---------------------------------------------------------------------------


def test_apply_mla_equals_the_reference():
    """``_apply_mla`` without a cache, at a prefill of 7 tokens at depth 0
    and of 5 at depth 7 (K and V expanded from the cache's first entries,
    against the reference's absorbed form), then 3 decode steps with a
    per-sequence ``pos``: outputs and both caches."""
    jm, jp, m, params = _pair("deepseek-v3-671b")
    cfg = m.cfg
    p = params["decoder"]["segments"][0][0]["attn"]
    jpa = jp["decoder"]["segments"][0][0]["attn"]
    rng = np.random.RandomState(21)
    x = rng.randn(2, 12, cfg.d_model).astype(np.float32)
    y, c = nn._apply_mla(p, torch.from_numpy(x), cfg)
    jy, _ = jnn._apply_mla(jpa, jnp.asarray(x), jm.cfg, window=0, rope_theta=None,
                           positions=None, cache=None)
    assert c is None
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TIGHT)
    T = 16
    cache = {"c_kv": torch.zeros(2, T, cfg.kv_lora_rank),
             "k_rope": torch.zeros(2, T, cfg.qk_rope_head_dim)}
    jcache = {k: jnp.zeros(v.shape) for k, v in cache.items()}
    for lo, hi in ((0, 7), (7, 12)):
        pos = np.arange(lo, hi)
        y, c = nn._apply_mla(p, torch.from_numpy(x[:, lo:hi]), cfg,
                             positions=torch.from_numpy(pos),
                             cache={**cache, "pos": torch.tensor(lo), "depth": lo})
        jy, jcache = jnn._apply_mla(jpa, jnp.asarray(x[:, lo:hi]), jm.cfg, window=0,
                                    rope_theta=None, positions=jnp.asarray(pos),
                                    cache={**jcache, "pos": jnp.asarray(lo, jnp.int32)})
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TIGHT)
        for k in cache:
            np.testing.assert_allclose(c[k].numpy(), np.asarray(jcache[k]), **TIGHT)
    pos = np.array([12, 12], np.int32)
    for _ in range(3):
        xs = rng.randn(2, 1, cfg.d_model).astype(np.float32)
        y, c = nn._apply_mla(p, torch.from_numpy(xs), cfg,
                             positions=torch.from_numpy(pos[:, None]),
                             cache={**cache, "pos": torch.from_numpy(pos), "depth": None})
        jy, jcache = jnn._apply_mla(jpa, jnp.asarray(xs), jm.cfg, window=0, rope_theta=None,
                                    positions=jnp.asarray(pos[:, None]),
                                    cache={**jcache, "pos": jnp.asarray(pos)})
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TIGHT)
        for k in cache:
            np.testing.assert_allclose(c[k].numpy(), np.asarray(jcache[k]), **TIGHT)
        pos = pos + 1


# -- the smoke models against the reference ------------------------------------


def test_forward_logits_match_jax(pair):
    jm, jp, m, params = pair
    toks = np.random.RandomState(2).randint(0, m.cfg.vocab, (2, PROMPT)).astype(np.int32)
    got = m.forward_logits(params, {"tokens": torch.from_numpy(toks)})
    want = jax.jit(jm.forward_logits)(jp, {"tokens": jnp.asarray(toks)})
    assert tuple(got.shape) == (2, PROMPT, m.cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("per_sequence", [False, True])
def test_prefill_and_decode_match_jax(pair, per_sequence):
    """Prefill and three decode steps: logits and every cache leaf (MLA's
    ``c_kv`` and ``k_rope``, grok's K and V)."""
    jm, jp, m, params = pair
    toks = np.random.RandomState(3 + int(per_sequence)).randint(
        0, m.cfg.vocab, (2, PROMPT)).astype(np.int32)
    T = PROMPT + 3
    jc = jm.init_caches(2, T, per_sequence=per_sequence)
    jlog, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)}, jc)
    caches = m.init_caches(2, T, per_sequence=per_sequence, device="cpu")
    logits, caches = m.prefill(params, {"tokens": torch.from_numpy(toks)}, caches)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), **TIGHT)
    rng = np.random.RandomState(9)
    jdecode = jax.jit(jm.decode_step)
    for _ in range(3):
        nxt = rng.randint(0, m.cfg.vocab, (2,)).astype(np.int32)
        jd, jc = jdecode(jp, jc, jnp.asarray(nxt))
        d, caches = m.decode_step(params, caches, torch.from_numpy(nxt))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TIGHT)
    got, want = caches_to_numpy(caches), jax.tree.map(np.asarray, jc)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    jax.tree.map(lambda a, w: np.testing.assert_allclose(a, w, **TIGHT), got, want)


@pytest.fixture(scope="module")
def served(pair):
    """Both packages' ``serve``, resident and host-stepped, on one engine
    each."""
    jm, jp, m, params = pair
    mesh = jax_make_mesh((1, 1), ("data", "model"))
    jeng = JaxServeEngine(jm.cfg, mesh, slots=SLOTS, prompt_len=PROMPT, max_new=GEN,
                          chunk=GEN - 1)
    with mesh:
        jparams = jax.device_put(jp, jeng.pre.in_shardings[0])
    eng = ServeEngine(m.cfg, slots=SLOTS, prompt_len=PROMPT, max_new=GEN, chunk=GEN - 1,
                      device="cpu")
    jb = jax_synthetic_batch(jm.cfg, np.random.RandomState(0), SLOTS, PROMPT)
    b = synthetic_batch(m.cfg, np.random.RandomState(0), SLOTS, PROMPT, device="cpu")
    out = {}
    for resident in (True, False):
        out["jax", resident] = jax_serve(jm.cfg, mesh, batch=SLOTS, prompt_len=PROMPT,
                                         gen_len=GEN, params=jparams, batch_in=jb,
                                         engine=jeng, device_resident=resident)
        out["torch", resident] = serve(m.cfg, batch=SLOTS, prompt_len=PROMPT, gen_len=GEN,
                                       params=params, batch_in=b, engine=eng,
                                       device_resident=resident)
    return out


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "host_stepped"])
def test_serve_tokens_equal_jax(served, resident):
    gen, stats = served["torch", resident]
    jgen, jstats = served["jax", resident]
    assert gen.shape == (SLOTS, GEN) and gen.dtype == np.int32
    np.testing.assert_array_equal(gen, jgen)
    for k in ("decode_tokens", "dispatches", "decode_dispatches"):
        assert stats[k] == jstats[k], k


def test_loss_and_gradients_match_jax(pair):
    """``Model.loss`` with the balance loss (and deepseek's MTP head) and
    every gradient against ``jax.grad`` of the reference's loss; the
    router bias (reached only through top-k's indices) gets zeros in
    both."""
    jm, jp, m, params = pair
    rng = np.random.RandomState(31)
    toks = rng.randint(0, m.cfg.vocab, (2, 16)).astype(np.int32)
    tgts = rng.randint(0, m.cfg.vocab, (2, 16)).astype(np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, jbatch)
    live = [t.detach().requires_grad_() for t in tree_leaves(params)]
    it = iter(live)
    tparams = nn.tree_map(lambda _: next(it), params)
    loss, met = m.loss(tparams, {"tokens": torch.from_numpy(toks),
                                 "targets": torch.from_numpy(tgts)})
    want_keys = {"ce", "lb_loss", "loss"} | ({"mtp_loss"} if m.cfg.mtp_depth else set())
    assert set(met) == set(jmet) == want_keys
    for k in met:
        np.testing.assert_allclose(float(met[k].detach()), float(jmet[k]), **TIGHT)
    grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    it = iter(grads)
    _grads_close(nn.tree_map(lambda _: next(it), params), jax.tree.map(np.asarray, jgrads))


TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 16, 3


@pytest.fixture(scope="module")
def moe_train_runs(pair):
    """3 AdamW steps (bf16 moments) of both packages' train step on the
    same smoke weights and ``SyntheticTokens`` batches: JAX's step by step
    under a 1x1 mesh (where its ``apply_moe_ep`` runs, at ``C_loc = C``),
    the port's step by step and as one ``persistent_steps`` dispatch."""
    jm, jp, m, _ = pair
    jshape = JaxShape("t", TRAIN_SEQ, TRAIN_BATCH, "train")
    shape = ShapeConfig("t", TRAIN_SEQ, TRAIN_BATCH, "train")
    jmesh = jax_make_mesh((1, 1), ("data", "model"))
    jopt, opt = JaxAdamW(moment_dtype="bfloat16"), AdamWConfig(moment_dtype="bfloat16")
    jbundle = jsteps.build_train_step(jm.cfg, jshape, jmesh, opt=jopt)
    bundle = steps.build_train_step(m.cfg, shape, make_mesh((1, 1), ("data", "model"),
                                                            device="cpu"), opt=opt)
    batches = [SyntheticTokens(m.cfg, shape).batch(i) for i in range(TRAIN_STEPS)]
    params_np = jax.tree.map(np.asarray, jp)
    with jmesh:
        step = jax.jit(jbundle.step_fn)
        jparams, jstate, jlosses = jp, jax_adamw_init(jp, jopt), []
        for b in batches:
            jparams, jstate, met = step(jparams, jstate,
                                        {k_: jnp.asarray(v) for k_, v in b.items()})
            jlosses.append(float(met["loss"]))
    out = {"jax": (jax.tree.map(lambda a: np.asarray(a, np.float32), jparams),
                   np.array(jlosses))}
    params = from_reference_params(params_np, m.cfg, "cpu")
    state, losses = adamw_init(params, opt), []
    for b in batches:
        params, state, met = bundle.step_fn(params, state,
                                            {k_: torch.from_numpy(v) for k_, v in b.items()})
        losses.append(float(met["loss"]))
    out["single"] = (params, np.array(losses), int(state["step"]))
    multi = steps.persistent_steps(bundle, TRAIN_STEPS, stacked=True)
    params = from_reference_params(params_np, m.cfg, "cpu")
    state = adamw_init(params, opt)
    stack = {k_: torch.from_numpy(np.stack([b[k_] for b in batches])) for k_ in batches[0]}
    params, state, met = multi.step_fn(params, state, stack)
    assert multi.step_fn.dispatches == 1 and int(met["steps_done"]) == TRAIN_STEPS
    out["persistent"] = (params, met["loss"].numpy(), int(state["step"]))
    return out


@pytest.mark.parametrize("kind", ["single", "persistent"])
def test_three_train_steps_match_jax(moe_train_runs, kind):
    """3 steps with bf16 AdamW moments, single and as one
    ``persistent_steps`` dispatch, against ``repro.launch.steps``: the loss
    trace at rtol 1e-4, every parameter at rtol = atol = 2e-3
    (``tests/test_torch_train.py``'s bounds)."""
    want_params, want_losses = moe_train_runs["jax"]
    params, losses, n = moe_train_runs[kind]
    assert n == TRAIN_STEPS
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    g, w = dict(_paths(params)), dict(_paths(want_params))
    assert g.keys() == w.keys()
    for k_ in w:
        np.testing.assert_allclose(g[k_].detach().float().numpy(), w[k_], rtol=2e-3,
                                   atol=2e-3, err_msg=k_)


# -- the expert-parallel dispatch program ------------------------------------------


def _dispatch_sig(prog, digest):
    return digest(prog), {int(k): tuple(v) for k, v in prog.collective_counts().items()}


@pytest.mark.parametrize("n,experts,capacity", [(1, 4, 2), (2, 4, 3), (4, 8, 2),
                                                (4, 256, 1)])
def test_dispatch_program_equals_the_reference(n, experts, capacity):
    cm = moe.build_moe_dispatch_program(make_mesh((n,), ("x",), device="cpu"), "x",
                                        experts, capacity, 16)
    jcm = jmoe.build_moe_dispatch_program(AbstractMesh((n,), ("x",)), "x", experts,
                                          capacity, 16)
    assert _dispatch_sig(cm.program, program_digest) == \
        _dispatch_sig(jcm.program, jeffects.program_digest)
    assert tuple(cm.inputs) == tuple(jcm.inputs) and cm.output == jcm.output


@pytest.mark.parametrize("n", [2, 4])
def test_dispatch_program_is_the_tiled_all_to_all(n):
    """Pure copies: the program's result equals the plain tiled all-to-all
    bit for bit, and run twice it gives its input back (the combine)."""
    E, C, D = 2 * n, 3, 8
    cm = moe.build_moe_dispatch_program(make_mesh((n,), ("x",), device="cpu"), "x", E, C, D)
    x = np.random.RandomState(n).randn(n * E * C, D).astype(np.float32)
    eng = FusedEngine(cm.program)
    out = eng(eng.init_buffers({"x": x}))["out"]
    blk = E * C // n
    want = torch.from_numpy(x).reshape(n, n, blk, D).transpose(0, 1).reshape(n * E * C, D)
    assert torch.equal(out, want)
    back = eng(eng.init_buffers({"x": out.numpy()}))["out"]
    assert torch.equal(back, torch.from_numpy(x))


def test_dispatch_program_refuses_indivisible_experts():
    """``tests/test_overlap.py``'s refusal: 3 experts over 4 ranks."""
    with pytest.raises(ValueError, match="must divide"):
        moe.build_moe_dispatch_program(make_mesh((4,), ("x",), device="cpu"), "x", 3, 2, 4)
    with pytest.raises(ValueError, match="must divide"):
        jmoe.build_moe_dispatch_program(AbstractMesh((4,), ("x",)), "x", 3, 2, 4)
