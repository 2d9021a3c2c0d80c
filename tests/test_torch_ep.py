"""The port's expert-parallel MoE (``models/moe.py`` ``apply_moe_ep``)
against the JAX package's ``shard_map`` path, on the CPU.

The reference's path needs a device a mesh shard, so it runs in ONE
subprocess with four JAX host devices, for every case at once (each
under ``jax.jit``): the MoE layer of a smoke config, in float32, on a
2×2 ``(data, model)`` mesh (deepseek-v3: 4 experts, 2 a model shard, the sigmoid router and the
shared expert) and on 1×4 meshes (grok-1 with 2 experts: 2 virtual
experts a real one, each with half its FFN columns), each at a capacity
factor that drops tokens per shard.  The port runs the same seeded inputs and the reference's parameters under
its own ``sharding_ctx`` on a mesh of the same shape.  Held: the output
at ``rtol = atol = 1e-5``, the balance loss, the mean router
probabilities and the dropped fraction at ``1e-6``, and the gradients of
``sum(y · g) + 0.5 · lb_loss`` with respect to the input and every
parameter at ``1e-5`` against ``jax.grad``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import make_mesh
from repro_torch.configs import get_config
from repro_torch.models import moe
from repro_torch.parallel import RULES_TRAIN, sharding_ctx

#: (name, arch, mesh shape, config overrides); the capacity factors drop
#: tokens in every case (with 2 experts top-2, each expert takes every
#: token, so below 1)
CASES = (
    ("deepseek_2x2", "deepseek-v3-671b", (2, 2), {"capacity_factor": 1.0}),
    ("deepseek_1x4", "deepseek-v3-671b", (1, 4), {"capacity_factor": 1.0}),
    ("grok_virtual_top1", "grok-1-314b", (1, 4),
     {"n_experts": 2, "top_k": 1, "capacity_factor": 1.0}),
    ("grok_virtual_top2", "grok-1-314b", (1, 4),
     {"n_experts": 2, "top_k": 2, "capacity_factor": 0.75}),
)
X_SHAPE = (4, 8)          # batch, sequence
LB_WEIGHT = 0.5

_JAX_SCRIPT = """
import dataclasses, numpy as np, jax, jax.numpy as jnp
from repro.configs.base import get_config
from repro.models import moe as moe_lib
from repro.models.nn import unbox
from repro.parallel import RULES_TRAIN, make_mesh, sharding_ctx

out = {}
for name, arch, mesh_shape, over in CASES:
    cfg = dataclasses.replace(get_config(arch).smoke(), **over)
    p, _ = unbox(moe_lib.init_moe(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(7)
    x = jnp.asarray(rng.randn(*X_SHAPE, cfg.d_model), jnp.float32)
    g = jnp.asarray(rng.randn(*X_SHAPE, cfg.d_model), jnp.float32)
    mesh = make_mesh(mesh_shape, ("data", "model"))

    def f(p, x):
        with sharding_ctx(RULES_TRAIN, mesh):
            res = moe_lib.apply_moe_ep(p, x, cfg)
        assert res is not None, name
        y, aux = res
        return jnp.sum(y * g) + LB_WEIGHT * aux["lb_loss"], (y, aux)

    with mesh:
        (_, (y, aux)), (gp, gx) = jax.jit(
            jax.value_and_grad(f, argnums=(0, 1), has_aux=True))(p, x)
    out[name + "/x"] = np.asarray(x)
    out[name + "/g"] = np.asarray(g)
    out[name + "/y"] = np.asarray(y)
    out[name + "/dx"] = np.asarray(gx)
    for k in aux:
        out[name + "/aux/" + k] = np.asarray(aux[k])
    for k in p:
        out[name + "/p/" + k] = np.asarray(p[k])
        out[name + "/dp/" + k] = np.asarray(gp[k])
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def reference(subproc, tmp_path_factory):
    out = tmp_path_factory.mktemp("ep") / "ref.npz"
    code = (f"CASES = {CASES!r}\nX_SHAPE = {X_SHAPE!r}\nLB_WEIGHT = {LB_WEIGHT!r}\n"
            f"OUT = {str(out)!r}\n" + _JAX_SCRIPT)
    r = subproc(code, devices=4)
    assert r.returncode == 0, r.stderr[-4000:]
    with np.load(out) as f:
        return dict(f)


def _port(ref, name, arch, mesh_shape, over):
    cfg = dataclasses.replace(get_config(arch).smoke(), **over)
    p = {k[len(name) + 3:]: torch.from_numpy(v).requires_grad_()
         for k, v in ref.items() if k.startswith(name + "/p/")}
    x = torch.from_numpy(ref[name + "/x"]).requires_grad_()
    g = torch.from_numpy(ref[name + "/g"])
    mesh = make_mesh(mesh_shape, ("data", "model"), device="cpu")
    with sharding_ctx(RULES_TRAIN, mesh):
        res = moe.apply_moe_ep(p, x, cfg)
    assert res is not None, name
    y, aux = res
    loss = (y * g).sum() + LB_WEIGHT * aux["lb_loss"]
    keys = sorted(p)
    grads = torch.autograd.grad(loss, [x] + [p[k] for k in keys], allow_unused=True,
                                materialize_grads=True)
    return y, aux, grads[0], dict(zip(keys, grads[1:]))


@pytest.mark.parametrize("name,arch,mesh_shape,over", CASES, ids=[c[0] for c in CASES])
def test_ep_matches_the_reference_forward_and_gradients(reference, name, arch, mesh_shape,
                                                        over):
    y, aux, dx, dp = _port(reference, name, arch, mesh_shape, over)
    np.testing.assert_allclose(y.detach().numpy(), reference[name + "/y"],
                               rtol=1e-5, atol=1e-5)
    for k in ("lb_loss", "router_probs_mean", "dropped_frac"):
        np.testing.assert_allclose(aux[k].detach().numpy(), reference[name + "/aux/" + k],
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(dx.numpy(), reference[name + "/dx"], rtol=1e-5, atol=1e-5)
    for k, v in dp.items():
        np.testing.assert_allclose(v.numpy(), reference[name + "/dp/" + k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_the_cases_drop_tokens(reference):
    """Every case drops tokens, per shard, so that the comparison holds
    the per-shard capacity and not only the products."""
    dropped = {c[0]: float(reference[c[0] + "/aux/dropped_frac"]) for c in CASES}
    assert all(v > 0 for v in dropped.values()), dropped


def test_ep_at_one_shard_equals_the_gather_path():
    """On a 1×1 mesh the expert-parallel path is the gather path: the same
    capacity and the same bits (output and every gradient)."""
    cfg = get_config("deepseek-v3-671b").smoke()
    gen = torch.Generator().manual_seed(3)
    p = moe.init_moe(gen, cfg, device="cpu")
    p = {k: v.requires_grad_() for k, v in p.items()}
    x = torch.randn(*X_SHAPE, cfg.d_model, generator=gen, requires_grad=True)
    outs = []
    for mesh in (None, make_mesh((1, 1), ("data", "model"), device="cpu")):
        if mesh is None:
            y, aux = moe.apply_moe(p, x, cfg)
        else:
            with sharding_ctx(RULES_TRAIN, mesh):
                y, aux = moe.apply_moe(p, x, cfg)
        grads = torch.autograd.grad(y.square().sum(), [x, p["wi"], p["router"]])
        outs.append((y, aux["lb_loss"], *grads))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mesh_shape,axes,over", [
    ((2, 2), ("data", "pod"), {}),                       # no model axis
    ((1, 3), ("data", "model"), {}),                     # 4 experts on 3 shards
    ((3, 1), ("data", "model"), {}),                     # batch 4 on 3 data shards
    ((1, 4), ("data", "model"), {"n_experts": 2, "d_ff_expert": 63}),  # F on 2 parts
])
def test_ep_returns_none_where_the_reference_does(mesh_shape, axes, over):
    cfg = dataclasses.replace(get_config("grok-1-314b").smoke(), **over)
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.randn(*X_SHAPE, cfg.d_model)
    assert moe.apply_moe_ep(p, x, cfg) is None        # no context
    with sharding_ctx(RULES_TRAIN, make_mesh(mesh_shape, axes, device="cpu")):
        assert moe.apply_moe_ep(p, x, cfg) is None


def test_a_recompute_in_the_backward_thread_keeps_the_ep_path():
    """A checkpointed layer's recompute runs where autograd's engine runs
    the backward (on the card, a thread of its own, which does not see the
    caller's thread-local sharding context): it takes the path its forward
    took.  Here the backward runs in another thread on purpose."""
    import threading

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticTokens
    from repro_torch.launch import steps
    from repro_torch.models.nn import tree_leaves, tree_map

    cfg = dataclasses.replace(get_config("deepseek-v3-671b").smoke(), remat="block")
    shape = ShapeConfig("t", 16, 2, "train")
    bundle = steps.build_train_step(cfg, shape, make_mesh((1, 1), ("data", "model"),
                                                          device="cpu"))
    params = bundle.model.init(0, device="cpu")
    batch = SyntheticTokens(cfg, shape).device_batch(0, "cpu")
    live = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(live)
    tree = tree_map(lambda _: next(it), params)
    with torch.enable_grad(), sharding_ctx(RULES_TRAIN, bundle.mesh):
        loss, _ = bundle.model.loss(tree, batch)
    out = {}

    def backward():
        try:
            out["grads"] = torch.autograd.grad(loss, live, allow_unused=True)
        except Exception as e:  # the test reports it below
            out["error"] = e

    t = threading.Thread(target=backward)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive() and "error" not in out, out.get("error")
    want, _ = bundle.grad_fn(params, batch)
    for g, w in zip(out["grads"], tree_leaves(want)):
        if g is not None:
            assert torch.equal(g, w)
