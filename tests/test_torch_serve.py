"""The port's mamba2 serving path against the JAX package, on the CPU.

Weights are the reference's own (``from_reference_params``), prompts
come from ``synthetic_batch`` with the same ``RandomState``.  Both
prefills run the sequential scan on the CPU (the reference's oracle
with ``init_state``, the port's plain version of its kernel), so they
agree far inside the repo's bounds: the asserted bound for prefill and
decode logits and caches is rtol = atol = 1e-5 (the repo's is 5e-3 for
prefill + decode, ``tests/test_models.py``).  Served tokens are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import ServeEngine as JaxServeEngine
from repro.launch.serve import serve as jax_serve
from repro.launch.serve import synthetic_batch as jax_synthetic_batch
from repro.models import Model as JaxModel
from repro.parallel import make_mesh as jax_make_mesh
from repro_torch.configs import ARCH_IDS, PORTED, get_config
from repro_torch.launch.serve import PAD_TOKEN, ServeEngine, serve, synthetic_batch
from repro_torch.models import Model
from repro_torch.models.convert import (
    caches_from_reference,
    caches_to_numpy,
    from_reference_params,
)
from repro_torch.models.nn import tree_leaves

PROMPT, GEN, SLOTS = 8, 6, 4
TIGHT = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pair():
    """(jax model, jax params, port model, port params) at the smoke size."""
    jcfg = jax_get_config("mamba2-2.7b").smoke()
    jm = JaxModel(jcfg)
    jp, _ = jm.init(jax.random.PRNGKey(0))
    cfg = get_config("mamba2-2.7b").smoke()
    return jm, jp, Model(cfg), from_reference_params(jax.tree.map(np.asarray, jp),
                                                     cfg, "cpu")


def test_configs_equal_the_reference():
    for arch in PORTED:
        ours, theirs = get_config(arch), jax_get_config(arch)
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert dataclasses.asdict(ours.smoke()) == dataclasses.asdict(theirs.smoke())
    for arch in set(ARCH_IDS) - set(PORTED):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            get_config(arch)
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_full_size_parameter_shapes_equal_the_reference():
    cfg = get_config("mamba2-2.7b")
    ours = Model(cfg).abstract_init()
    theirs, _ = JaxModel(jax_get_config("mamba2-2.7b")).abstract_init()
    assert jax.tree.structure(jax.tree.map(lambda t: 0, ours)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, theirs))
    for o, t in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        assert o.device.type == "meta"
        assert tuple(o.shape) == tuple(t.shape)
        assert str(o.dtype).split(".")[1] == str(t.dtype)
    total = sum(o.numel() for o in tree_leaves(ours))
    assert 2.6e9 <= total <= 2.8e9, total


@pytest.mark.parametrize("per_sequence", [False, True])
def test_prefill_and_decode_match_jax(pair, per_sequence):
    jm, jp, m, params = pair
    rng = np.random.RandomState(int(per_sequence))
    toks = rng.randint(0, m.cfg.vocab, (2, 16)).astype(np.int32)
    nxt = rng.randint(0, m.cfg.vocab, (2,)).astype(np.int32)
    jc = jm.init_caches(2, 20, per_sequence=per_sequence)
    jlog, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    caches = m.init_caches(2, 20, per_sequence=per_sequence, device="cpu")
    logits, caches = m.prefill(params, {"tokens": torch.from_numpy(toks)}, caches)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), **TIGHT)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **TIGHT),
                 caches_to_numpy(caches), jax.tree.map(np.asarray, jc))

    jd, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
    d, caches = m.decode_step(params, caches, torch.from_numpy(nxt))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TIGHT)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **TIGHT),
                 caches_to_numpy(caches), jax.tree.map(np.asarray, jc))


def test_caches_round_trip(pair):
    jm, _, _, _ = pair
    jc = jax.tree.map(np.asarray, jm.init_caches(2, 8, per_sequence=True))
    back = caches_to_numpy(caches_from_reference(jc, "cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, jc)


@pytest.fixture(scope="module")
def served(pair):
    """Tokens and stats of both packages' ``serve`` in both modes."""
    jm, jp, m, params = pair
    mesh = jax_make_mesh((1, 1), ("data", "model"))
    jeng = JaxServeEngine(jm.cfg, mesh, slots=SLOTS, prompt_len=PROMPT,
                          max_new=GEN, chunk=GEN - 1)
    with mesh:
        jparams = jax.device_put(jp, jeng.pre.in_shardings[0])
    eng = ServeEngine(m.cfg, slots=SLOTS, prompt_len=PROMPT, max_new=GEN,
                      chunk=GEN - 1, device="cpu")
    jbatch = jax_synthetic_batch(jm.cfg, np.random.RandomState(0), SLOTS, PROMPT)
    batch = synthetic_batch(m.cfg, np.random.RandomState(0), SLOTS, PROMPT,
                            device="cpu")
    np.testing.assert_array_equal(batch["tokens"].numpy(), np.asarray(jbatch["tokens"]))
    out = {}
    for mode in (True, False):
        out["jax", mode] = jax_serve(jm.cfg, mesh, batch=SLOTS, prompt_len=PROMPT,
                                     gen_len=GEN, params=jparams, batch_in=jbatch,
                                     engine=jeng, device_resident=mode)
        out["torch", mode] = serve(m.cfg, batch=SLOTS, prompt_len=PROMPT, gen_len=GEN,
                                   params=params, batch_in=batch, engine=eng,
                                   device_resident=mode)
    return out


@pytest.mark.parametrize("resident", [True, False])
def test_serve_tokens_equal_jax(served, resident):
    gen, stats = served["torch", resident]
    jgen, jstats = served["jax", resident]
    assert gen.shape == (SLOTS, GEN) and gen.dtype == np.int32
    np.testing.assert_array_equal(gen, jgen)
    for k in ("decode_tokens", "dispatches", "decode_dispatches"):
        assert stats[k] == jstats[k], k


def test_resident_is_one_dispatch(served):
    res, host = served["torch", True][1], served["torch", False][1]
    assert (res["dispatches"], res["decode_dispatches"]) == (2, 1)
    assert (host["dispatches"], host["decode_dispatches"]) == (GEN, GEN - 1)
    np.testing.assert_array_equal(served["torch", True][0], served["torch", False][0])


def test_eos_masking_matches_host_oracle_and_jax(pair, served):
    """An EOS seen mid-stream stops its slot at the host oracle's step."""
    jm, jp, m, params = pair
    base = served["torch", True][0]
    eos = int(base[0, 2])
    mesh = jax_make_mesh((1, 1), ("data", "model"))
    with mesh:
        jgen, _ = jax_serve(jm.cfg, mesh, batch=SLOTS, prompt_len=PROMPT,
                            gen_len=GEN, params=jp, eos_id=eos)
    for resident in (True, False):
        gen, stats = serve(m.cfg, batch=SLOTS, prompt_len=PROMPT, gen_len=GEN,
                           params=params, eos_id=eos, device_resident=resident,
                           device="cpu")
        np.testing.assert_array_equal(gen, jgen)
        assert gen[0, 3] == PAD_TOKEN
        assert stats["decode_tokens"] == int((gen[:, 1:] != PAD_TOKEN).sum())


def test_entry_points_run_on_the_card():
    cfg = get_config("mamba2-2.7b").smoke()
    if torch.cuda.is_available():
        assert ServeEngine(cfg, slots=1, prompt_len=2, max_new=2).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, slots=1, prompt_len=2, max_new=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve(cfg, batch=1, prompt_len=2, gen_len=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg).init(0)


def test_serve_window_leaves_mamba2_unchanged(pair, served):
    """``serve_window`` narrows attention windows only: mamba2 has none,
    so its tokens are those of the unwindowed serve (and of the JAX
    package's)."""
    _, _, m, params = pair
    batch = synthetic_batch(m.cfg, np.random.RandomState(0), SLOTS, PROMPT, device="cpu")
    gen, _ = serve(m.cfg, batch=SLOTS, prompt_len=PROMPT, gen_len=GEN, params=params,
                   batch_in=batch, serve_window=4, device="cpu")
    np.testing.assert_array_equal(gen, served["torch", True][0])
    np.testing.assert_array_equal(gen, served["jax", True][0])


def test_unported_config_options_are_refused():
    """``use_ssd_kernel=False`` (hymba's) is not refused: the port lowers
    the reference's plain scan onto the kernel wrapper, so the model gives
    the same logits either way.  (Continuous batching of the MoE configs
    is ported: ``tests/test_torch_continuous.py``.)"""
    cfg = get_config("mamba2-2.7b").smoke()
    model = Model(cfg)
    params = model.init(0, device="cpu")
    batch = {"tokens": torch.arange(12, dtype=torch.int32).reshape(2, 6)}
    assert torch.equal(Model(dataclasses.replace(cfg, use_ssd_kernel=False))
                       .forward_logits(params, batch), model.forward_logits(params, batch))


def test_compute_params_cast_the_projections_and_table_once():
    """At full size on the meta device: the weights the forward casts at
    each use are held in bf16, every other leaf is the float32 master."""
    cfg = get_config("mamba2-2.7b")
    model = Model(cfg)
    params = model.abstract_init()
    cast = model.compute_params(params)
    assert cast["embed"]["table"].dtype == torch.bfloat16
    seg, seg_cast = params["decoder"]["segments"][0], cast["decoder"]["segments"][0]
    for name, leaf in seg_cast["ssm"].items():
        want = torch.bfloat16 if name in ("in_proj", "out_proj") else torch.float32
        assert leaf.dtype == want, name
        if want == torch.float32:
            assert leaf is seg["ssm"][name]
    assert cast["ln_final"]["scale"] is params["ln_final"]["scale"]
