"""The port's training path against the JAX package, on the CPU.

mamba2-2.7b smoke weights from the JAX package (``from_reference_params``)
and seeded numpy batches go through both packages; every JAX result is
computed once per module.  Bounds:

* ``Model.loss`` and ``ce``: rtol = atol = 1e-5 (float32 throughout; the
  JAX forward reaches the Pallas SSD kernel in interpret mode, the port's
  the sequential plain scan, which meet at this size);
* every gradient leaf against ``jax.grad`` (whose SSD backward is the VJP
  of the reference's plain scan): rtol 1e-4 plus 1e-4 of the leaf's
  largest entry;
* one ``adamw_update`` on the same numpy trees: rtol = atol = 1e-5;
  ``linear_warmup_cosine`` at step 0, the end of warm-up and the end:
  rtol 1e-6;
* ``SyntheticTokens.batch``: equal;
* 3 steps of the train step, of ``persistent_steps`` (also until
  ``loss_plateau``: ``steps_done`` equal) and of ``pipelined_steps``:
  the loss trace at rtol 1e-4, params at rtol = atol = 2e-3 (the repo's
  bounds, ``tests/test_launch.py:172-178``);
* ``train()``'s history at rtol 1e-4, and checkpoints across packages:
  equal leaves.

qwen1.5-0.5b, gemma3-1b (past its window) and glm4-9b smoke cases hold
``Model.loss`` and its gradients off the SSM path (attention and MLP;
the plain attention under autograd on the CPU), at the same bounds;
the CLI also trains gemma3-1b smoke on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_config as jax_get_config
from repro.configs.base import ShapeConfig as JaxShape
from repro.data.synthetic import SyntheticConfig as JaxSynthCfg
from repro.data.synthetic import SyntheticTokens as JaxSynth
from repro.launch import steps as jsteps
from repro.launch.train import train as jax_train
from repro.optim import AdamWConfig as JaxAdamW
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import linear_warmup_cosine as jax_warmup_cosine
from repro.parallel import make_mesh as jax_make_mesh
from repro_torch import checkpoint as ckpt
from repro_torch import make_mesh
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticConfig, SyntheticTokens
from repro_torch.launch import steps
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import train
from repro_torch.models import Model
from repro_torch.models.convert import from_reference_params
from repro_torch.models.nn import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, linear_warmup_cosine

ARCH = "mamba2-2.7b"
BATCH, SEQ, STEPS = 2, 32, 3
PLATEAU_FACTORS = (2.0, 0.5)   # eps as a multiple of the first loss move


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, dtype=np.float32)
                        if np.asarray(a).dtype.name == "bfloat16" else np.asarray(a), tree)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _assert_trees_close(got, want, rtol, atol):
    """Leaf by leaf (by path), torch against numpy."""
    g, w = dict(_paths(got)), dict(_paths(want))
    assert g.keys() == w.keys()
    for k in w:
        a = g[k].detach().float().cpu().numpy() if isinstance(g[k], torch.Tensor) else g[k]
        np.testing.assert_allclose(a, np.asarray(w[k], np.float32), rtol=rtol, atol=atol,
                                   err_msg=k)


def _grads_close(got, want):
    """Every gradient leaf: rtol 1e-4 plus 1e-4 of the leaf's largest entry."""
    g, w = dict(_paths(got)), dict(_paths(want))
    assert g.keys() == w.keys()
    for k in w:
        ref = np.asarray(w[k], np.float32)
        np.testing.assert_allclose(g[k].float().numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(ref).max()) + 1e-12, err_msg=k)


class Pair:
    """One config in both packages: the JAX bundle and model, the port's,
    the JAX initial params (numpy) and a fresh torch copy on demand."""

    def __init__(self, arch, batch=BATCH, seq=SEQ):
        self.jcfg = jax_get_config(arch).smoke()
        self.cfg = get_config(arch).smoke()
        self.jshape = JaxShape("t", seq, batch, "train")
        self.shape = ShapeConfig("t", seq, batch, "train")
        self.jmesh = jax_make_mesh((1, 1), ("data", "model"))
        self.mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        self.jbundle = jsteps.build_train_step(self.jcfg, self.jshape, self.jmesh)
        self.bundle = steps.build_train_step(self.cfg, self.shape, self.mesh)
        jp, _ = self.jbundle.model.init(jax.random.PRNGKey(0))
        self.jparams = jp
        self.params_np = _np(jp)
        self.batches = [SyntheticTokens(self.cfg, self.shape).batch(i) for i in range(STEPS)]

    def params(self):
        return from_reference_params(self.params_np, self.cfg, "cpu")

    def tbatch(self, i):
        return {k: torch.from_numpy(v) for k, v in self.batches[i].items()}

    def jbatch(self, i):
        return {k: jnp.asarray(v) for k, v in self.batches[i].items()}

    def stacked(self):
        return ({k: torch.from_numpy(np.stack([b[k] for b in self.batches]))
                 for k in self.batches[0]},
                {k: jnp.asarray(np.stack([b[k] for b in self.batches]))
                 for k in self.batches[0]})


@pytest.fixture(scope="module")
def mamba():
    pair = Pair(ARCH)
    with pair.jmesh:
        grads, met = jax.jit(pair.jbundle.grad_fn)(pair.jparams, pair.jbatch(0))
    pair.jgrads, pair.jmet = _np(grads), {k: float(v) for k, v in met.items()}
    return pair


@pytest.fixture(scope="module")
def mamba_runs(mamba):
    """The JAX package's 3-step runs: sequential, persistent, plateau,
    pipelined."""
    p = mamba
    opt0 = jax_adamw_init(p.jparams, JaxAdamW())
    tstack, jstack = p.stacked()
    out = {}
    with p.jmesh:
        step = jax.jit(p.jbundle.step_fn)
        params, opt, losses = p.jparams, opt0, []
        for i in range(STEPS):
            params, opt, met = step(params, opt, p.jbatch(i))
            losses.append(float(met["loss"]))
        out["sequential"] = (_np(params), np.array(losses))
        for name, bundle in (
                ("persistent", jsteps.persistent_steps(p.jbundle, STEPS, stacked=True)),
                ("pipelined", jsteps.pipelined_steps(p.jbundle, STEPS, stacked=True))):
            pr, _, met = jax.jit(bundle.step_fn)(p.jparams, opt0, jstack)
            out[name] = (_np(pr), np.asarray(met["loss"]), int(met["steps_done"]))
        # plateau bounds twice and half the first loss move: the loop stops
        # after two steps, or runs to the bound
        for factor in PLATEAU_FACTORS:
            eps = factor * abs(losses[1] - losses[0])
            bundle = jsteps.persistent_steps(p.jbundle, STEPS,
                                             until=jsteps.loss_plateau(eps), stacked=True)
            pr, _, met = jax.jit(bundle.step_fn)(p.jparams, opt0, jstack)
            out[("plateau", factor)] = (_np(pr), np.asarray(met["loss"]),
                                        int(met["steps_done"]), eps)
    return out


def test_loss_and_ce_match_jax(mamba):
    loss, met = Model(mamba.cfg).loss(mamba.params(), mamba.tbatch(0))
    assert set(met) == {"ce", "loss"}
    np.testing.assert_allclose(float(loss), mamba.jmet["loss"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(met["ce"]), mamba.jmet["ce"], rtol=1e-5, atol=1e-5)


def test_every_gradient_matches_jax_grad(mamba):
    grads, met = mamba.bundle.grad_fn(mamba.params(), mamba.tbatch(0))
    np.testing.assert_allclose(float(met["loss"]), mamba.jmet["loss"], rtol=1e-5)
    _grads_close(grads, mamba.jgrads)


def test_stacked_layers_and_remat_give_the_same_gradients(mamba):
    """scan_layers (stacked, split by unbind) and remat="block" (each layer
    checkpointed) change nothing in the loss or the gradients."""
    params = mamba.params()
    segs = params["decoder"]["segments"]
    stacked = dict(params, decoder={"segments": [steps._rebuild(
        segs[0][0], [torch.stack(ls) for ls in zip(*[tree_leaves(l) for l in segs[0]])])]})
    cfg = dataclasses.replace(mamba.cfg, scan_layers=True, remat="block")
    bundle = steps.build_train_step(cfg, mamba.shape, mamba.mesh)
    grads, met = bundle.grad_fn(stacked, mamba.tbatch(0))
    np.testing.assert_allclose(float(met["loss"]), mamba.jmet["loss"], rtol=1e-5)
    per_layer = grads["decoder"]["segments"][0]
    for i in range(cfg.n_layers):
        _grads_close(tree_map(lambda g: g[i], per_layer),
                     mamba.jgrads["decoder"]["segments"][0][i])
    _grads_close(grads["embed"], mamba.jgrads["embed"])


def test_adamw_update_and_schedule_match_jax(mamba):
    rs = np.random.RandomState(3)
    grads_np = jax.tree.map(lambda g: (g + rs.randn(*g.shape).astype(np.float32) * 0.01),
                            mamba.jgrads)
    jopt = JaxAdamW(lr=3e-3)
    jp, jst, jmet = jax_adamw_update(mamba.jparams, grads_np, jax_adamw_init(
        mamba.jparams, jopt), jopt, lr=jnp.float32(2e-3))
    opt = AdamWConfig(lr=3e-3)
    params = mamba.params()
    state = adamw_init(params, opt)
    grads = tree_map(lambda g: torch.from_numpy(np.array(g)), grads_np)
    p, st, met = adamw_update(params, grads, state, opt, lr=torch.tensor(2e-3))
    assert p is params and st is state and int(st["step"]) == 1
    _assert_trees_close(p, _np(jp), 1e-5, 1e-5)
    _assert_trees_close(st["m"], _np(jst["m"]), 1e-5, 1e-5)
    _assert_trees_close(st["v"], _np(jst["v"]), 1e-5, 1e-5)
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(float(met["lr"]), 2e-3, rtol=1e-6)
    for s in (0, 9, 10, 57, 100):
        kw = dict(base_lr=1e-3, warmup_steps=10, total_steps=100)
        want = float(jax_warmup_cosine(jnp.int32(s), **kw))
        np.testing.assert_allclose(float(linear_warmup_cosine(torch.tensor(s), **kw)),
                                   want, rtol=1e-6)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_updates_a_large_leaf_in_chunks_with_the_same_bits(monkeypatch, moment_dtype):
    """A leaf of more than ``CHUNK`` elements is updated a chunk at a time
    (ragged last chunk, a 2-d leaf with weight decay and a 1-d one
    without): params and both moments equal the whole-leaf update bit
    for bit over 3 steps."""
    from repro_torch.optim import adamw as adamw_mod

    cfg = AdamWConfig(moment_dtype=moment_dtype)
    rng = np.random.RandomState(4)
    params = {"w": rng.randn(7, 300).astype(np.float32), "b": rng.randn(900).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    runs = []
    for chunk in (adamw_mod.CHUNK, 257):
        monkeypatch.setattr(adamw_mod, "CHUNK", chunk)
        p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        state = adamw_init(p, cfg)
        for g in grads:
            adamw_update(p, {k: torch.from_numpy(v) for k, v in g.items()}, state, cfg)
        runs.append(tree_leaves((p, state)))
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_synthetic_batches_equal_jax():
    for arch in (ARCH, "qwen1.5-0.5b"):
        cfg, jcfg = get_config(arch).smoke(), jax_get_config(arch).smoke()
        for seed in (0, 5):
            ours = SyntheticTokens(cfg, ShapeConfig("t", 24, 3, "train"), SyntheticConfig(seed))
            theirs = JaxSynth(jcfg, JaxShape("t", 24, 3, "train"), JaxSynthCfg(seed))
            for step in (0, 1, 17):
                a, b = ours.batch(step), theirs.batch(step)
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def _run(bundle_fn, mamba):
    params = mamba.params()
    opt = adamw_init(params, AdamWConfig())
    stack, _ = mamba.stacked()
    p, o, met = bundle_fn.step_fn(params, opt, stack)
    return p, o, met


def test_three_train_steps_match_jax(mamba, mamba_runs):
    params = mamba.params()
    opt = adamw_init(params, AdamWConfig())
    losses = []
    for i in range(STEPS):
        params, opt, met = mamba.bundle.step_fn(params, opt, mamba.tbatch(i))
        losses.append(float(met["loss"]))
        assert set(met) == {"ce", "loss", "grad_norm", "lr"}
    want_params, want_losses = mamba_runs["sequential"]
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    _assert_trees_close(params, want_params, 2e-3, 2e-3)
    assert int(opt["step"]) == STEPS


@pytest.mark.parametrize("kind", ["persistent", "pipelined"])
def test_multi_step_dispatch_matches_jax(mamba, mamba_runs, kind):
    wrap = steps.persistent_steps if kind == "persistent" else steps.pipelined_steps
    bundle = wrap(mamba.bundle, STEPS, stacked=True)
    p, o, met = _run(bundle, mamba)
    assert bundle.step_fn.dispatches == 1
    want_params, want_losses, want_done = mamba_runs[kind]
    assert int(met["steps_done"]) == want_done == STEPS
    np.testing.assert_allclose(met["loss"].numpy(), want_losses, rtol=1e-4)
    _assert_trees_close(p, want_params, 2e-3, 2e-3)


@pytest.mark.parametrize("factor", PLATEAU_FACTORS)
def test_plateau_stops_where_jax_stops(mamba, mamba_runs, factor):
    want_params, want_losses, want_done, eps = mamba_runs[("plateau", factor)]
    assert want_done == (2 if factor > 1 else STEPS)
    bundle = steps.persistent_steps(mamba.bundle, STEPS, until=steps.loss_plateau(eps),
                                    stacked=True)
    p, o, met = _run(bundle, mamba)
    done = int(met["steps_done"])
    assert done == want_done
    np.testing.assert_allclose(met["loss"].numpy(), want_losses, rtol=1e-4, atol=1e-12)
    assert not met["loss"][done:].any()
    _assert_trees_close(p, want_params, 2e-3, 2e-3)


def test_batch_regime_inference(mamba):
    stack, _ = mamba.stacked()
    one = mamba.tbatch(0)
    assert steps._is_stacked(mamba.bundle, STEPS, None, stack)
    assert not steps._is_stacked(mamba.bundle, STEPS, None, one)
    with pytest.raises(ValueError, match="match neither"):
        steps._is_stacked(mamba.bundle, STEPS, None, {k: v[:, :3] for k, v in one.items()})
    # a broadcast batch feeds every inner step
    bundle = steps.persistent_steps(mamba.bundle, 2)
    params = mamba.params()
    p, _, met = bundle.step_fn(params, adamw_init(params, AdamWConfig()), one)
    assert int(met["steps_done"]) == 2 and met["loss"].shape == (2,)


def test_train_history_matches_jax(mamba, tmp_path):
    kw = dict(steps=4, log_every=1, inner_steps=2)
    with mamba.jmesh:
        _, _, want = jax_train(mamba.jcfg, mamba.jshape, mamba.jmesh, **kw)
    _, _, got = train(mamba.cfg, mamba.shape, mamba.mesh, params=mamba.params(), **kw)
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1, 2, 3]
    for key in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose([h[key] for h in got], [h[key] for h in want],
                                   rtol=1e-4, err_msg=key)


def test_checkpoints_restore_across_packages(mamba, tmp_path):
    """The port's train() checkpoint restored by the JAX package and back,
    params and AdamW state; a resumed port run continues from it."""
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    params, opt, _ = train(mamba.cfg, mamba.shape, mamba.mesh, params=mamba.params(),
                           steps=2, checkpoint_dir=port_dir, checkpoint_every=2)
    assert ckpt.latest_step(port_dir) == jckpt.latest_step(port_dir) == 2
    like = {"params": mamba.jparams, "opt_state": jax_adamw_init(mamba.jparams, JaxAdamW())}
    restored = jckpt.restore_pytree(port_dir, 2, like)
    _assert_trees_close({"params": params, "opt_state": opt}, _np(restored), 0, 0)
    jckpt.save_pytree(jax_dir, 2, restored)
    back = ckpt.restore_pytree(jax_dir, 2, {"params": params, "opt_state": opt})
    for a, b in zip(tree_leaves(back), tree_leaves({"params": params, "opt_state": opt})):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # resume from the JAX-written checkpoint: steps 2 and 3 only
    _, opt2, hist = train(mamba.cfg, mamba.shape, mamba.mesh, params=mamba.params(),
                          steps=4, log_every=1, checkpoint_dir=jax_dir)
    assert [h["step"] for h in hist] == [2, 3] and int(opt2["step"]) == 4


def test_train_cli_runs_on_cpu(capsys):
    train_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
                "--batch", "2", "--seq", "16", "--inner-steps", "2"])
    out = capsys.readouterr().out
    assert "step     0 loss=" in out and "step     2 loss=" in out
    with pytest.raises(SystemExit):
        train_main(["--arch", ARCH, "--smoke", "--device", "cpu", "--mesh", "2x1"])


def test_train_cli_trains_gemma3_on_cpu(capsys):
    train_main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu", "--steps", "2",
                "--batch", "2", "--seq", "40"])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0]) for line in out.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses))


#: dense smoke configs off the SSM path, (batch, seq): qwen1.5-0.5b;
#: gemma3-1b past its smoke window of 32 (local and global layers, qk-norm,
#: the norms' weight offset); glm4-9b (GQA)
DENSE_CASES = {"qwen1.5-0.5b": (2, 16), "gemma3-1b": (2, 40), "glm4-9b": (2, 16)}


@pytest.mark.parametrize("arch", list(DENSE_CASES))
def test_dense_loss_and_gradients_match_jax(arch):
    """Model.loss and every gradient off the SSM path, through the port's
    attention (the plain version under autograd on the CPU)."""
    batch, seq = DENSE_CASES[arch]
    pair = Pair(arch, batch=batch, seq=seq)
    with pair.jmesh:
        jgrads, jmet = jax.jit(pair.jbundle.grad_fn)(pair.jparams, pair.jbatch(0))
    grads, met = pair.bundle.grad_fn(pair.params(), pair.tbatch(0))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(met["ce"]), float(jmet["ce"]), rtol=1e-5, atol=1e-5)
    _grads_close(grads, _np(jgrads))
