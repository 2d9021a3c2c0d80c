"""The port's dense path (gemma3-1b, qwen1.5-0.5b, glm4-9b) against the
JAX package, on the CPU.

Two sizes of the smoke model: ``gemma3-1b`` ``.smoke()`` (2 layers, both
local with a window of 32) and the same with 6 layers, so that layer 6
is global (``rope_theta_global``, full attention); prompts of 40 tokens
are longer than the window, so the local layers mask.  Weights are the
reference's own (``from_reference_params``), with the decoder's matrices
scaled by 8 in both packages: at the init scale the scaled embedding
dominates the residual stream and every slot repeats its last prompt
token, so the served tokens would not depend on attention at all.  Both
packages compute in float32 here: the port's prefill and ``forward_logits`` run the plain
versions of the flash and rmsnorm kernels (``kernels/ref.py``), the
reference its jnp ``_sdpa`` and norms, so the two differ by float32
rounding only.  Asserted: logits of ``forward_logits`` within rtol =
atol = 2e-5, prefill and decode logits and caches within 1e-5 (tighter
than the repo's own bounds between its paths, 2e-3 for prefill against
forward and 5e-3 for decode, ``tests/test_models.py``), and served
tokens equal.  A prompt prefilled in two chunks (the second at depth
24, the key of the prefill graph on the card) through the serve engine,
then decoded, is held for both sizes and the mamba2 smoke model at 32
float32 ulps of each tensor's largest value.  With an EOS id that the
models emit mid-stream (four ids a size), both serve modes stop each
slot where JAX's engine does: equal tokens and ``decode_tokens``.
The forward, prefill and decode checks also run on the qwen1.5-0.5b and
glm4-9b smoke models (qkv bias; glm4's partial rotary, untied head and
small ``norm_eps``) at the init scale; the three new
configs' full-size parameter shapes are held against JAX's
``abstract_init()`` on the meta device (qwen1.5-110b, about 220 GB in
bf16, is checked only this way).
"""

import dataclasses
import functools

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
from repro.models import nn as jnn
from repro.models import transformer as jtfm
from repro.parallel import make_mesh as jax_make_mesh
from repro_torch.configs import get_config
from repro_torch.launch.serve import ServeEngine, serve, synthetic_batch
from repro_torch.models import Model
from repro_torch.models import nn
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import caches_to_numpy, from_reference_params
from repro_torch.models.nn import tree_leaves

PROMPT, GEN, SLOTS = 40, 6, 4
TIGHT = dict(rtol=1e-5, atol=1e-5)
LAYERS = [2, 6]


def _configs(n_layers):
    """The smoke config of both packages, with ``n_layers`` layers."""
    return (dataclasses.replace(jax_get_config("gemma3-1b").smoke(), n_layers=n_layers),
            dataclasses.replace(get_config("gemma3-1b").smoke(), n_layers=n_layers))


def _boost(tree, factor, name=""):
    """The decoder's matrices (``w*`` leaves) times ``factor``."""
    if isinstance(tree, dict):
        return {k: _boost(v, factor, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_boost(v, factor, name) for v in tree]
    return tree * np.float32(factor) if name.startswith("w") else tree


@functools.lru_cache(maxsize=None)
def _make_pair(arch, n_layers):
    """(jax model, jax params, port model, port params): gemma3 smoke with
    ``n_layers`` layers and boosted matrices, qwen1.5-0.5b or glm4-9b smoke
    at the init scale, or mamba2 smoke as ``tests/test_torch_serve.py``
    has it."""
    if arch == "mamba2-2.7b":
        jcfg, cfg = jax_get_config(arch).smoke(), get_config(arch).smoke()
        jm = JaxModel(jcfg)
        jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0))[0])
    elif arch != "gemma3-1b":
        jcfg, cfg = jax_get_config(arch).smoke(), get_config(arch).smoke()
        jm = JaxModel(jcfg)
        jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1))[0])
    else:
        jcfg, cfg = _configs(n_layers)
        jm = JaxModel(jcfg)
        jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(n_layers))[0])
        jp = {**jp, "decoder": _boost(jp["decoder"], 8)}
    return jm, jax.tree.map(jnp.asarray, jp), Model(cfg), from_reference_params(jp, cfg,
                                                                               "cpu")


@pytest.fixture(scope="module", params=LAYERS, ids=lambda n: f"{n}layers")
def pair(request):
    """(jax model, jax params, port model, port params)."""
    return _make_pair("gemma3-1b", request.param)


@pytest.fixture(scope="module", params=[("gemma3-1b", n) for n in LAYERS]
                + [("qwen1.5-0.5b", None), ("glm4-9b", None)],
                ids=[f"{n}layers" for n in LAYERS] + ["qwen1.5-0.5b", "glm4-9b"])
def dense_pair(request):
    """``pair``, and the qwen1.5-0.5b and glm4-9b smoke models."""
    return _make_pair(*request.param)


def test_layer_windows_and_thetas_equal_the_reference():
    for cfg, jcfg in [(get_config("gemma3-1b"), jax_get_config("gemma3-1b")),
                      (get_config("mamba2-2.7b"), jax_get_config("mamba2-2.7b"))]:
        for sw in (0, 100, 4096):
            got = [tfm.layer_window_theta(cfg, i, sw) for i in range(cfg.n_layers)]
            assert got == [jtfm.layer_window_theta(jcfg, i, sw)
                           for i in range(cfg.n_layers)]
    windows = [tfm.layer_window_theta(get_config("gemma3-1b"), i)[0] for i in range(26)]
    assert [i + 1 for i, w in enumerate(windows) if w == 0] == [6, 12, 18, 24]


def test_full_size_parameter_shapes_equal_the_reference():
    cfg = get_config("gemma3-1b")
    ours = Model(cfg).abstract_init()
    theirs, _ = JaxModel(jax_get_config("gemma3-1b")).abstract_init()
    assert jax.tree.structure(jax.tree.map(lambda t: 0, ours)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, theirs))
    for o, t in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        assert o.device.type == "meta"
        assert tuple(o.shape) == tuple(t.shape)
        assert str(o.dtype).split(".")[1] == str(t.dtype)
    total = sum(o.numel() for o in tree_leaves(ours))
    assert 7.9e8 <= total <= 8.0e8, total  # 302 M embedding + 26 x 18.9 M


#: parameters of the full-size dense configs (embedding, head and layers)
DENSE_TOTALS = {"qwen1.5-0.5b": (4.6e8, 4.7e8), "glm4-9b": (9.3e9, 9.5e9),
                "qwen1.5-110b": (1.09e11, 1.12e11)}


@pytest.mark.parametrize("arch", sorted(DENSE_TOTALS))
def test_full_size_dense_parameter_shapes_equal_the_reference(arch):
    """The three dense configs at full size, on the meta device, against
    JAX's ``abstract_init()``: the same tree, shapes and dtypes."""
    ours = Model(get_config(arch)).abstract_init()
    theirs, _ = JaxModel(jax_get_config(arch)).abstract_init()
    assert jax.tree.structure(jax.tree.map(lambda t: 0, ours)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, theirs))
    for o, t in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        assert o.device.type == "meta"
        assert tuple(o.shape) == tuple(t.shape)
        assert str(o.dtype).split(".")[1] == str(t.dtype)
    total = sum(o.numel() for o in tree_leaves(ours))
    lo, hi = DENSE_TOTALS[arch]
    assert lo <= total <= hi, total
    # qwen1.5-0.5b ties its head; glm4-9b and qwen1.5-110b do not
    assert ("w" in ours["unembed"]) == (arch != "qwen1.5-0.5b")


def test_untied_head_carries_across_in_convert():
    """glm4-9b's head ``unembed/w`` [d_model, vocab] crosses in
    ``from_reference_params``, and a tree without it is refused."""
    _, jp, m, params = _make_pair("glm4-9b", None)
    jp = jax.tree.map(np.asarray, jp)
    assert tuple(params["unembed"]["w"].shape) == (m.cfg.d_model, m.cfg.vocab)
    np.testing.assert_array_equal(params["unembed"]["w"].numpy(), jp["unembed"]["w"])
    with pytest.raises(ValueError, match="unembed/w"):
        from_reference_params({**jp, "unembed": {}}, m.cfg, "cpu")


def test_compute_params_cast_the_untied_head_once():
    """The head is cast by its subtree; no other leaf named ``w`` exists to
    be cast by accident, and the norms stay float32."""
    model = Model(get_config("glm4-9b"))
    params = model.abstract_init()
    cast = model.compute_params(params)
    assert cast["unembed"]["w"].dtype == torch.bfloat16
    assert cast["ln_final"]["scale"] is params["ln_final"]["scale"]
    seg = cast["decoder"]["segments"][0]
    assert seg["ln_attn"]["scale"] is params["decoder"]["segments"][0]["ln_attn"]["scale"]
    assert seg["attn"]["bq"].dtype == torch.bfloat16


def test_compute_params_cast_the_matmul_weights_once():
    model = Model(get_config("gemma3-1b"))
    params = model.abstract_init()
    cast = model.compute_params(params)
    assert cast["embed"]["table"].dtype == torch.bfloat16
    seg, seg_cast = params["decoder"]["segments"][0], cast["decoder"]["segments"][0]
    for block in ("attn", "mlp"):
        for name, leaf in seg_cast[block].items():
            if name.startswith("w"):
                assert leaf.dtype == torch.bfloat16, name
            else:  # q_norm, k_norm: the rmsnorm kernel reads float32
                assert leaf is seg[block][name], name
    assert seg_cast["ln_attn"]["scale"] is seg["ln_attn"]["scale"]


def test_embed_scale_is_rounded_to_the_activation_dtype():
    """In bf16 the reference multiplies by sqrt(1152) rounded to 34.0."""
    cfg = dataclasses.replace(get_config("gemma3-1b").smoke(), d_model=1152,
                              dtype="bfloat16")
    table = np.random.RandomState(0).randn(8, 1152).astype(np.float32)
    ids = np.array([[1, 5, 7]], np.int32)
    got = nn.apply_embedding({"table": torch.from_numpy(table)}, torch.from_numpy(ids), cfg)
    want = jnn.apply_embedding({"table": jnp.asarray(table)}, jnp.asarray(ids),
                               dataclasses.replace(jax_get_config("gemma3-1b").smoke(),
                                                   d_model=1152, dtype="bfloat16"))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    np.testing.assert_array_equal(
        got.float().numpy(),
        (torch.from_numpy(table).bfloat16()[ids].float() * 34.0).bfloat16().float().numpy())


def _float32_power(base, exponent):
    """``base ** exponent`` correctly rounded to float32: the float64 power
    of the float32 operands, rounded once."""
    return np.power(np.asarray(base, np.float64),
                    np.asarray(exponent, np.float64)).astype(np.float32)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_equals_the_reference_near_position_1000(theta, monkeypatch):
    """At position 1013 one float32 ulp of an inverse frequency near 1
    moves the angle by ~6e-5, 6x the bound.  XLA's float32 ``power`` is
    within 1 ulp of the correctly rounded value but not always on it
    (64 of 100 000 random exponents are 1 ulp off on the reference's CPU
    build), and which exponents it misses depends on the code XLA
    compiles for the host, so the reference's inverse frequencies are
    held to 1 ulp of the correctly rounded power, and the comparison runs
    the reference's ``apply_rope`` with ``jnp.power`` giving that
    correctly rounded value: the host's rounding of the power stays out
    of it, and every other step of both functions is compared."""
    rng = np.random.RandomState(1)
    x = rng.randn(2, 24, 1, 256).astype(np.float32)
    pos = np.arange(990, 1014, dtype=np.int32)
    exps = jnp.arange(128, dtype=jnp.float32) / 128
    host = jnp.power(jnp.asarray(theta, jnp.float32), -exps)
    assert _ulps(host, _float32_power(np.float32(theta), -np.asarray(exps))).max() <= 1
    got = nn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta, 256)
    monkeypatch.setattr(jnp, "power", lambda b, e: jnp.asarray(_float32_power(b, e)))
    want = jnn.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_forward_logits_match_jax(dense_pair):
    jm, jp, m, params = dense_pair
    toks = np.random.RandomState(2).randint(0, m.cfg.vocab, (2, PROMPT)).astype(np.int32)
    got = m.forward_logits(params, {"tokens": torch.from_numpy(toks)})
    want = jm.forward_logits(jp, {"tokens": jnp.asarray(toks)})
    assert tuple(got.shape) == (2, PROMPT, m.cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("per_sequence", [False, True])
def test_prefill_and_decode_match_jax(dense_pair, per_sequence):
    jm, jp, m, params = dense_pair
    rng = np.random.RandomState(3 + int(per_sequence))
    toks = rng.randint(0, m.cfg.vocab, (2, PROMPT)).astype(np.int32)
    T = PROMPT + 3
    jc = jm.init_caches(2, T, per_sequence=per_sequence)
    jlog, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    caches = m.init_caches(2, T, per_sequence=per_sequence, device="cpu")
    logits, caches = m.prefill(params, {"tokens": torch.from_numpy(toks)}, caches)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), **TIGHT)
    for _ in range(3):
        nxt = rng.randint(0, m.cfg.vocab, (2,)).astype(np.int32)
        jd, jc = jm.decode_step(jp, jc, jnp.asarray(nxt))
        d, caches = m.decode_step(params, caches, torch.from_numpy(nxt))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TIGHT)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **TIGHT),
                 caches_to_numpy(caches), jax.tree.map(np.asarray, jc))


def test_prefill_refuses_slots_at_different_depths(pair):
    _, _, m, params = pair
    caches = m.init_caches(2, 8, per_sequence=True, device="cpu")
    caches["pos"] = torch.tensor([0, 3], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="differing depths"):
        m.prefill(params, {"tokens": torch.zeros((2, 4), dtype=torch.int32)}, caches)


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


#: the port against JAX through a second prefill and decode, relative to
#: each tensor's largest value: both sides compute in float32 and differ
#: by reassociation only, about 10 ulps of that value through these
#: layers (more or less with the CPU's threading), so 32 ulps
CHUNKED_REL = 32 * 2.0 ** -23


@pytest.mark.parametrize("serve_window", [0, 8])
@pytest.mark.parametrize("per_sequence", [False, True])
@pytest.mark.parametrize("arch,n_layers", [("gemma3-1b", 2), ("gemma3-1b", 6),
                                           ("mamba2-2.7b", None)],
                         ids=["gemma3-2layers", "gemma3-6layers", "mamba2"])
def test_chunked_prefill_matches_jax(arch, n_layers, per_sequence, serve_window):
    """A prompt in two prefills (24 then 20 tokens, the second at depth 24)
    and two decode steps through the serve engine's dispatch functions,
    which read the depth on the host and pass it to ``Model.prefill`` as
    the key of the prefill graph on the card (here they run eagerly)."""
    jm, jp, m, params = _make_pair(arch, n_layers)
    rng = np.random.RandomState(7 + 2 * int(per_sequence) + serve_window)
    chunks = [rng.randint(0, m.cfg.vocab, (2, n)).astype(np.int32) for n in (24, 20)]
    T = 24 + 20 + 2
    eng = ServeEngine(m.cfg, slots=2, prompt_len=44, max_new=2,
                      serve_window=serve_window, device="cpu")
    jc = jm.init_caches(2, T, per_sequence=per_sequence)
    caches = m.init_caches(2, T, per_sequence=per_sequence, device="cpu")
    for depth, toks in zip((0, 24), chunks):
        assert m.prefill_depth(caches) == (depth if arch == "gemma3-1b" else None)
        jlog, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc,
                              serve_window=serve_window)
        logits, caches = eng.prefill(params, {"tokens": torch.from_numpy(toks)}, caches)
        assert _rel(logits.numpy(), jlog) <= CHUNKED_REL
    for _ in range(2):
        nxt = rng.randint(0, m.cfg.vocab, (2,)).astype(np.int32)
        jd, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), serve_window=serve_window)
        d, caches = eng.decode_one(params, caches, torch.from_numpy(nxt))
        assert _rel(d.numpy(), jd) <= CHUNKED_REL
    got, want = caches_to_numpy(caches), jax.tree.map(np.asarray, jc)
    np.testing.assert_array_equal(got["pos"], want["pos"])
    assert int(np.max(got["pos"])) == T
    for g, w in zip(jax.tree.leaves(got["segments"]), jax.tree.leaves(want["segments"])):
        assert _rel(g, w) <= CHUNKED_REL
    # on the CPU the dispatches run eagerly: no graph was launched
    assert eng.dispatches == 4
    assert eng.graph_launches == {"prefill": 0, "decode": 0, "decode_one": 0,
                                  "admit_decode": 0}


def _serve_both(pair, serve_window=0):
    """Tokens and stats of both packages' ``serve`` in both modes."""
    jm, jp, m, params = pair
    mesh = jax_make_mesh((1, 1), ("data", "model"))
    jeng = JaxServeEngine(jm.cfg, mesh, slots=SLOTS, prompt_len=PROMPT, max_new=GEN,
                          chunk=GEN - 1, serve_window=serve_window)
    with mesh:
        jparams = jax.device_put(jp, jeng.pre.in_shardings[0])
    eng = ServeEngine(m.cfg, slots=SLOTS, prompt_len=PROMPT, max_new=GEN, chunk=GEN - 1,
                      serve_window=serve_window, device="cpu")
    jbatch = jax_synthetic_batch(jm.cfg, np.random.RandomState(0), SLOTS, PROMPT)
    batch = synthetic_batch(m.cfg, np.random.RandomState(0), SLOTS, PROMPT, device="cpu")
    out = {}
    for mode in (True, False):
        out["jax", mode] = jax_serve(jm.cfg, mesh, batch=SLOTS, prompt_len=PROMPT,
                                     gen_len=GEN, params=jparams, batch_in=jbatch,
                                     engine=jeng, device_resident=mode)
        out["torch", mode] = serve(m.cfg, batch=SLOTS, prompt_len=PROMPT, gen_len=GEN,
                                   params=params, batch_in=batch, engine=eng,
                                   device_resident=mode)
    return out


@pytest.fixture(scope="module")
def served(pair):
    return _serve_both(pair)


@pytest.mark.parametrize("resident", [True, False])
def test_serve_tokens_equal_jax(served, resident):
    gen, stats = served["torch", resident]
    jgen, jstats = served["jax", resident]
    assert gen.shape == (SLOTS, GEN) and gen.dtype == np.int32
    np.testing.assert_array_equal(gen, jgen)
    last = synthetic_batch(get_config("gemma3-1b").smoke(), np.random.RandomState(0),
                           SLOTS, PROMPT, device="cpu")["tokens"][:, -1].numpy()
    assert (gen != last[:, None]).any(), "every slot repeats its last prompt token"
    for k in ("decode_tokens", "dispatches", "decode_dispatches"):
        assert stats[k] == jstats[k], k


def test_resident_is_one_dispatch(served):
    res, host = served["torch", True][1], served["torch", False][1]
    assert (res["dispatches"], res["decode_dispatches"]) == (2, 1)
    assert (host["dispatches"], host["decode_dispatches"]) == (GEN, GEN - 1)
    np.testing.assert_array_equal(served["torch", True][0], served["torch", False][0])


def test_serve_window_tokens_equal_jax(pair, served):
    """A serve window of 8 narrows the local layers (32) and the global
    one (full); the port's tokens equal the JAX engine's with the same
    window, in both modes."""
    out = _serve_both(pair, serve_window=8)
    for mode in (True, False):
        np.testing.assert_array_equal(out["torch", mode][0], out["jax", mode][0])
    unwindowed = served["torch", True][0]
    assert (out["torch", True][0] != unwindowed).any(), "the window changed nothing"


# EOS ids that the boosted smoke models emit mid-stream, by depth
EOS_IDS = {2: (4, 190, 253, 281), 6: (75, 310, 340, 438)}


@pytest.mark.parametrize("k", range(4))
def test_eos_tokens_equal_jax(pair, k):
    """An EOS id stops its slot where JAX's engine stops it, in both modes:
    the port's tokens and ``decode_tokens`` equal JAX's."""
    jm, jp, m, params = pair
    eos = EOS_IDS[m.cfg.n_layers][k]
    mesh = jax_make_mesh((1, 1), ("data", "model"))
    jeng = JaxServeEngine(jm.cfg, mesh, slots=SLOTS, prompt_len=PROMPT, max_new=GEN,
                          chunk=GEN - 1, eos_id=eos)
    with mesh:
        jparams = jax.device_put(jp, jeng.pre.in_shardings[0])
    eng = ServeEngine(m.cfg, slots=SLOTS, prompt_len=PROMPT, max_new=GEN, chunk=GEN - 1,
                      eos_id=eos, device="cpu")
    jbatch = jax_synthetic_batch(jm.cfg, np.random.RandomState(0), SLOTS, PROMPT)
    batch = synthetic_batch(m.cfg, np.random.RandomState(0), SLOTS, PROMPT, device="cpu")
    for resident in (True, False):
        jgen, jstats = jax_serve(jm.cfg, mesh, batch=SLOTS, prompt_len=PROMPT, gen_len=GEN,
                                 params=jparams, batch_in=jbatch, engine=jeng, eos_id=eos,
                                 device_resident=resident)
        gen, stats = serve(m.cfg, batch=SLOTS, prompt_len=PROMPT, gen_len=GEN, params=params,
                           batch_in=batch, engine=eng, eos_id=eos, device_resident=resident)
        np.testing.assert_array_equal(gen, jgen)
        assert stats["decode_tokens"] == jstats["decode_tokens"]
        assert (gen == eos).any() and stats["decode_tokens"] < SLOTS * (GEN - 1)
