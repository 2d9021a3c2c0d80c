"""The port's hybrid (hymba-1.5b), encoder-decoder (whisper-large-v3) and
vision-language (internvl2-76b) families against the JAX package, on the
CPU.

Three smoke models (``cfg.smoke()``: 2 layers, d_model 256, float32):
hymba with 8 meta tokens and a hybrid layer (attention and an SSD head
side by side, mixed by ``softmax(mix)``), whisper with 2 encoder layers
over 16 frames of ``audio_embeds`` and sinusoidal positions, internvl2
with a 16-patch vision prefix.  Weights are the reference's own
(``from_reference_params``); whisper's trunks' matrices are scaled by 8
in both packages, so that its tokens depend on the prompt and the audio
(at the init scale its sinusoids dominate the tokens' embeddings and
every slot emits the same tokens), while hymba's and internvl2's tokens
already do at the init scale.
Inputs are seeded numpy draws (``synthetic_batch`` with the same
``RandomState``); no Hypothesis.  Both packages compute in float32: the
port's flash, rmsnorm and SSD wrappers run their plain versions
(``kernels/ref.py``), the reference its jnp attention and norms and the
sequential scan (hymba's ``use_ssd_kernel`` is False), so they differ by
float32 rounding only.

Asserted, at ``tests/test_torch_dense.py``'s bounds: ``forward_logits``
within rtol = atol = 2e-5; prefill and three decode steps, logits and
every cache leaf (``enc_out`` too), with a scalar and a per-sequence
``pos``, within 1e-5; served tokens (resident, host-stepped and
continuous) equal; ``Model.loss`` within 1e-5 and every gradient at
``tests/test_torch_train.py:_grads_close``'s bound (rtol 1e-4 plus 1e-4
of the leaf's largest entry).  Also: the configs field for field, the
full-size parameter shapes on the meta device against
``abstract_init()``, ``convert`` of the new leaves and caches, the
sinusoids and the frontends, the serve capacity with the prefix, and the
hybrid block's mixing order and both caches.
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
from repro.launch.serve import serve_continuous as jax_serve_continuous
from repro.launch.serve import synthetic_batch as jax_synthetic_batch
from repro.models import Model as JaxModel
from repro.models import frontends as jfront
from repro.models import model as jmodel
from repro.models import transformer as jtfm
from repro.parallel import make_mesh as jax_make_mesh
from repro_torch.configs import get_config
from repro_torch.launch.serve import ServeEngine, main, serve, serve_continuous, synthetic_batch
from repro_torch.models import Model, frontends
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import (
    caches_from_reference,
    caches_to_numpy,
    from_reference_params,
)
from repro_torch.models.nn import tree_leaves

ARCHS = ["hymba-1.5b", "whisper-large-v3", "internvl2-76b"]
PROMPT, GEN, SLOTS = 12, 5, 4
TIGHT = dict(rtol=1e-5, atol=1e-5)
#: full-size parameters (embedding, layers, encoder, frontend, meta tokens)
TOTALS = {"hymba-1.5b": (1.5e9, 1.7e9), "whisper-large-v3": (1.5e9, 1.7e9),
          "internvl2-76b": (6.9e10, 7.2e10)}


def _boost(tree, factor, name=""):
    """A trunk's matrices (``w*`` leaves) times ``factor``."""
    if isinstance(tree, dict):
        return {k: _boost(v, factor, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_boost(v, factor, name) for v in tree]
    return tree * np.float32(factor) if name.startswith("w") else tree


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(jax model, jax params, port model, port params) at the smoke size."""
    jcfg, cfg = jax_get_config(arch).smoke(), get_config(arch).smoke()
    jm = JaxModel(jcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3))[0])
    if arch == "whisper-large-v3":
        jp = {k: (_boost(v, 8) if k in ("decoder", "encoder") else v)
              for k, v in jp.items()}
    return jm, jax.tree.map(jnp.asarray, jp), Model(cfg), from_reference_params(jp, cfg,
                                                                               "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def _batches(m, batch, prompt_len, seed):
    """The same synthetic batch in both packages (tokens and embeddings)."""
    jb = jax_synthetic_batch(m.cfg, np.random.RandomState(seed), batch, prompt_len)
    b = synthetic_batch(m.cfg, np.random.RandomState(seed), batch, prompt_len, device="cpu")
    assert jb.keys() == b.keys()
    for k in jb:
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
    return jb, b


# -- configs, parameters, convert ---------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    ours, theirs = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.smoke()) == dataclasses.asdict(theirs.smoke())


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_parameter_shapes_equal_the_reference(arch):
    """Full size on the meta device against JAX's ``abstract_init()``: the
    same tree, shapes and dtypes (internvl2-76b, ~140 GB in bf16, is
    checked only this way)."""
    ours = Model(get_config(arch)).abstract_init()
    theirs, _ = JaxModel(jax_get_config(arch)).abstract_init()
    assert jax.tree.structure(jax.tree.map(lambda t: 0, ours)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, theirs))
    for o, t in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        assert o.device.type == "meta"
        assert tuple(o.shape) == tuple(t.shape)
        assert str(o.dtype).split(".")[1] == str(t.dtype)
    total = sum(o.numel() for o in tree_leaves(ours))
    lo, hi = TOTALS[arch]
    assert lo <= total <= hi, total


def test_convert_carries_the_new_leaves():
    """``meta`` and hymba's ``mix``, the frontends, whisper's ``encoder``
    and ``ln_enc`` cross value for value; a tree without one is refused;
    a cache tree with ``enc_out`` crosses both ways."""
    want = {"hymba-1.5b": ("meta", "decoder/segments/0/0/mix"),
            "whisper-large-v3": ("frontend/proj_in", "encoder/segments/0/1/attn/wq",
                                 "ln_enc/scale"),
            "internvl2-76b": ("frontend/proj_in", "frontend/proj_out")}
    for arch, paths in want.items():
        jm, jp, m, params = _pair(arch)
        for path in paths:
            got, ref = params, jp
            for key in path.split("/"):
                got = got[int(key)] if isinstance(got, list) else got[key]
                ref = ref[int(key)] if isinstance(ref, list) else ref[key]
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=path)
        top = paths[0].split("/")[0]
        jnp_tree = jax.tree.map(np.asarray, jp)
        with pytest.raises(ValueError, match=top):
            from_reference_params({k: v for k, v in jnp_tree.items() if k != top}, m.cfg,
                                  "cpu")
    jm, _, m, _ = _pair("whisper-large-v3")
    jc = jm.init_caches(2, 10)
    jc = {**jc, "enc_out": jnp.asarray(np.random.RandomState(0).randn(
        *jc["enc_out"].shape).astype(np.float32))}
    c = caches_from_reference(jax.tree.map(np.asarray, jc), "cpu")
    assert c["enc_out"].dtype == torch.float32
    jax.tree.map(np.testing.assert_array_equal, caches_to_numpy(c),
                 jax.tree.map(np.asarray, jc))


def test_compute_params_cast_the_new_leaves_once():
    """``meta``, ``proj_in`` and ``proj_out`` are cast to bf16 once, as the
    other per-use weights; hymba's ``mix`` and the norms stay float32."""
    for arch in ARCHS:
        model = Model(get_config(arch))
        params = model.abstract_init()
        cast = model.compute_params(params)
        for leaf in cast.get("frontend", {}).values():
            assert leaf.dtype == torch.bfloat16
        if "meta" in cast:
            assert cast["meta"].dtype == torch.bfloat16
        seg = cast["decoder"]["segments"][0]
        if "mix" in seg:
            assert seg["mix"] is params["decoder"]["segments"][0]["mix"]
        if "cross" in seg:
            assert seg["cross"]["wq"].dtype == torch.bfloat16
            assert cast["encoder"]["segments"][0]["mlp"]["wi"].dtype == torch.bfloat16
            assert cast["ln_enc"]["scale"] is params["ln_enc"]["scale"]


# -- frontends and sinusoids --------------------------------------------------


@pytest.mark.parametrize("n,d", [(16, 256), (1500, 1280), (648, 64)])
def test_sinusoidal_positions_equal_the_reference(n, d):
    got = frontends.sinusoidal_positions(n, d)
    want = np.asarray(jfront.sinusoidal_positions(n, d))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    pos = np.array([0, 7, n - 1], np.int32)
    for p in (pos, pos[1]):
        got = tmodel._sinusoid_at(torch.from_numpy(np.asarray(p)), d, torch.float32)
        want = np.asarray(jmodel._sinusoid_at(jnp.asarray(p), d, jnp.float32))
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "internvl2-76b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_frontend_equals_the_reference(arch, dtype):
    jm, jp, m, params = _pair(arch)
    jcfg = dataclasses.replace(jm.cfg, dtype=dtype)
    cfg = dataclasses.replace(m.cfg, dtype=dtype)
    embeds = np.random.RandomState(5).randn(2, cfg.frontend_tokens,
                                             cfg.frontend_dim).astype(np.float32)
    got = frontends.apply_frontend(params["frontend"], torch.from_numpy(embeds), cfg)
    want = jfront.apply_frontend(jp["frontend"], jnp.asarray(embeds), jcfg)
    assert str(got.dtype).split(".")[1] == str(want.dtype)
    tol = TIGHT if dtype == "float32" else dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


# -- the smoke models against the reference ------------------------------------


def test_forward_logits_match_jax(pair):
    jm, jp, m, params = pair
    jb, b = _batches(m, 2, PROMPT, seed=2)
    got = m.forward_logits(params, b)
    want = jax.jit(jm.forward_logits)(jp, jb)
    assert tuple(got.shape) == (2, PROMPT, m.cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("per_sequence", [False, True])
def test_prefill_and_decode_match_jax(pair, per_sequence):
    """Prefill (positions and ``pos`` counting the prefix) and three decode
    steps: logits and every cache leaf, ``enc_out`` included."""
    jm, jp, m, params = pair
    jb, b = _batches(m, 2, PROMPT, seed=3 + int(per_sequence))
    T = m._prefix_len() + PROMPT + 3
    jc = jm.init_caches(2, T, per_sequence=per_sequence)
    jlog, jc = jax.jit(jm.prefill)(jp, jb, jc)
    caches = m.init_caches(2, T, per_sequence=per_sequence, device="cpu")
    logits, caches = m.prefill(params, b, caches)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog), **TIGHT)
    np.testing.assert_array_equal(caches["pos"].numpy(),
                                  np.full(caches["pos"].shape, m._prefix_len() + PROMPT))
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
    assert eng.capacity == jeng.capacity == m._prefix_len() + PROMPT + GEN
    jb, b = _batches(m, SLOTS, PROMPT, seed=0)
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


def test_serve_continuous_equals_jax(pair):
    """5 requests over 2 slots, chunk 3: each request's tokens (the
    embedding rows ride with their request) equal JAX's, and so do the
    dispatch stats."""
    jm, jp, m, params = pair
    n, slots, chunk = 5, 2, 3
    mesh = jax_make_mesh((1, 1), ("data", "model"))
    jeng = JaxServeEngine(jm.cfg, mesh, slots=slots, prompt_len=PROMPT, max_new=GEN,
                          chunk=chunk)
    with mesh:
        jparams = jax.device_put(jp, jeng.pre.in_shardings[0])
    jres, jstats = jax_serve_continuous(jm.cfg, mesh, slots=slots, prompt_len=PROMPT,
                                        max_new=GEN, n_requests=n, chunk=chunk, seed=4,
                                        params=jparams, engine=jeng)
    res, stats = serve_continuous(m.cfg, slots=slots, prompt_len=PROMPT, max_new=GEN,
                                  n_requests=n, chunk=chunk, seed=4, params=params,
                                  device="cpu")
    for r, jr in zip(res, jres):
        np.testing.assert_array_equal(r.tokens, np.asarray(jr.tokens))
    for k in ("dispatches", "admit_dispatches", "decode_dispatches",
              "prefill_dispatches", "sync_points", "total_tokens"):
        assert stats[k] == jstats[k], k


def test_serve_capacity_counts_the_prefix():
    """hymba's smoke prefix is its 8 meta tokens, internvl2's its 16
    patches, whisper has none: the capacity and the prefill's ``pos``
    count them, as the reference's do."""
    for arch, prefix in (("hymba-1.5b", 8), ("internvl2-76b", 16),
                         ("whisper-large-v3", 0)):
        cfg = get_config(arch).smoke()
        eng = ServeEngine(cfg, slots=2, prompt_len=PROMPT, max_new=GEN, device="cpu")
        assert eng.prefix_len == prefix
        assert eng.capacity == prefix + PROMPT + GEN
        caches = eng.init_state()[0]
        assert caches["segments"][0]["attn"]["k"].shape[2] == eng.capacity
    assert get_config("hymba-1.5b").n_meta_tokens == 128


def test_cache_axes_and_select_slots_carry_enc_out():
    jm, _, m, _ = _pair("whisper-large-v3")
    axes = m.cache_axes(per_sequence=True)
    assert axes == jax.tree.map(lambda a: a, jm.cache_axes(per_sequence=True),
                                is_leaf=lambda a: isinstance(a, tuple))
    assert axes["enc_out"] == ("batch", None, "act_embed")
    rng = np.random.RandomState(6)
    new = m.init_caches(3, 8, per_sequence=True, device="cpu")
    old = m.init_caches(3, 8, per_sequence=True, device="cpu")
    new["enc_out"] = torch.from_numpy(rng.randn(*new["enc_out"].shape).astype(np.float32))
    old["enc_out"] = torch.from_numpy(rng.randn(*old["enc_out"].shape).astype(np.float32))
    mask = torch.tensor([True, False, True])
    merged = m.select_slots(mask, new, old)
    want = jm.select_slots(jnp.asarray(mask.numpy()), jax.tree.map(jnp.asarray,
                           caches_to_numpy(new)), jax.tree.map(jnp.asarray,
                                                               caches_to_numpy(old)))
    np.testing.assert_array_equal(merged["enc_out"].numpy(), np.asarray(want["enc_out"]))
    np.testing.assert_array_equal(merged["enc_out"][1].numpy(), old["enc_out"][1].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_main_serves_the_new_archs_on_the_cpu(arch, capsys):
    main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
          "6", "--gen", "3"])
    assert "generated tokens" in capsys.readouterr().out


# -- training on the CPU ---------------------------------------------------------


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_loss_and_every_gradient_match_jax(pair):
    """``Model.loss`` (the prefix rows left out of the logits) and the
    gradient of every parameter leaf against ``jax.grad``."""
    jm, jp, m, params = pair
    jb, b = _batches(m, 2, PROMPT, seed=7)
    targets = np.random.RandomState(8).randint(0, m.cfg.vocab, (2, PROMPT)).astype(np.int32)
    jb = {**jb, "targets": jnp.asarray(targets)}
    b = {**b, "targets": torch.from_numpy(targets)}
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, jb)
    leaves = dict(_paths(params))
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        loss, met = m.loss(params, b)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(jloss), **TIGHT)
        np.testing.assert_allclose(met["ce"].item(), float(jmet["ce"]), **TIGHT)
        want = dict(_paths(jax.tree.map(np.asarray, jgrads)))
        assert want.keys() == leaves.keys()
        largest = max(float(np.abs(w).max()) for w in want.values())
        for k, w in want.items():
            g = leaves[k].grad
            assert g is not None, k
            if k.endswith("/bk"):
                # a key bias adds the same q . bk to every logit of a row,
                # which the softmax cancels: its gradient is 0 in exact
                # arithmetic, and both packages' are rounding noise
                assert max(float(g.abs().max()), float(np.abs(w).max())) <= 1e-6 * largest, k
                continue
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(w).max()) + 1e-12, err_msg=k)
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
            t.grad = None


# -- the hybrid block -------------------------------------------------------------


def test_hybrid_block_mixes_in_order_and_writes_both_caches():
    """A hymba layer with ``mix`` (0.3, -1.1): ``softmax(mix)[0]`` weighs
    attention and ``[1]`` the SSD head (swapping them changes the result,
    and each order equals the reference's), and a prefill writes both the
    K/V and the SSM caches, as the reference's does."""
    jm, jp, m, params = _pair("hymba-1.5b")
    jlayer = jax.tree.map(np.asarray, jp["decoder"]["segments"][0][0])
    x = np.random.RandomState(1).randn(2, 10, m.cfg.d_model).astype(np.float32)
    jblock = jax.jit(lambda p, x: jtfm.apply_block(p, x, jm.cfg, "hybrid", window=32)[0])
    outs = []
    for mix in ((0.3, -1.1), (-1.1, 0.3)):
        lp = {**jlayer, "mix": np.asarray(mix, np.float32)}
        tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), lp)
        got, _ = tfm.apply_block(tp, torch.from_numpy(x), m.cfg, "hybrid", window=32)
        want = jblock(jax.tree.map(jnp.asarray, lp), jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
        outs.append(got)
    assert not torch.allclose(outs[0], outs[1])
    caches = m.init_caches(2, m._prefix_len() + 10, device="cpu")
    jb, b = _batches(m, 2, 10, seed=1)
    _, caches = m.prefill(params, b, caches)
    seg = caches["segments"][0]
    assert set(seg) == {"attn", "ssm"}
    S = m._prefix_len() + 10
    assert bool((seg["attn"]["k"][:, :, :S] != 0).any(dim=(-2, -1)).all())
    assert bool((seg["ssm"]["state"] != 0).any()) and bool((seg["ssm"]["conv"] != 0).any())
