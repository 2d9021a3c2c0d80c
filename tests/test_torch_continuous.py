"""The port's continuous batching against the JAX package, on the CPU.

Three smoke models: qwen1.5-0.5b (the reference's own continuous-batching
model, ``tests/test_serve.py``), gemma3-1b (windowed layers under per-slot
depths: 40-token prompts against a window of 32) and mamba2-2.7b (SSM
``conv`` and ``state`` caches).  Weights are the reference's own
(``from_reference_params``); the dense models' decoder matrices are
scaled by 8 in both packages, as in ``tests/test_torch_dense.py``: at the
init scale every slot of either repeats its last prompt token, so the
tokens would not depend on attention.  Prompts are seeded numpy draws.

Two MoE smoke models, deepseek-v3-671b (MLA, a sigmoid router over 4
experts, the MTP head) and grok-1-314b (softmax router, soft-capped GQA),
at the init scale (their tokens are no echo there): an admission
prefills the whole batch, so under capacity drops a slot's experts depend
on its batch-mates, in both packages alike.  They are held to (i) without
the EOS slot and to (iii) against JAX's tokens only: serving a prompt
alone is another batch, so equality with serial serving is not a
property of these configs.

Asserted, for each model:

(i) a scripted mixed-depth sequence — admit slots 0 and 1, one decode
    round, admit slots 2 and 3 while 0 and 1 are in flight, decode until
    every slot stops — through both packages' ``admit_decode`` and
    ``decode``: ``first``, ``out``, ``n``, ``tok``, ``active`` and
    ``rem`` equal after every round, ``pos`` of the active slots equal
    and their caches within ``tests/test_torch_dense.py``'s bound for a
    prefill and decodes through the serve engine (``CHUNKED_REL``: 32
    float32 ulps of each tensor's largest value);
(ii) in the same run, ``eos_id`` is the token slot 2's prefill gives
    (found first by the port's own prefill), so that slot 2 stops at its
    admission while the others run on;
(iii) ``serve_continuous`` at the reference test's shape (5 requests,
    2 slots, chunk 3, rate 0): each request's tokens equal JAX's and the
    port's serial ``serve`` of that prompt alone, and the dispatch stats
    equal JAX's (``prefill_dispatches`` 0, a sync a round);
(iv) ``select_slots`` per leaf, and ``cache_axes`` equal to the
    reference's; the in-place merge the admission uses;
(v) ``main()`` in-process on ``--device cpu --smoke``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import ServeEngine as JaxServeEngine
from repro.launch.serve import serve_continuous as jax_serve_continuous
from repro.models import Model as JaxModel
from repro.parallel import make_mesh as jax_make_mesh
from repro_torch.configs import get_config
from repro_torch.launch.serve import (
    DISPATCH_KINDS,
    PAD_TOKEN,
    ServeEngine,
    main,
    poisson_arrivals,
    serve,
    serve_continuous,
)
from repro_torch.models import Model
from repro_torch.models.convert import caches_to_numpy, from_reference_params
from repro_torch.models.nn import tree_leaves, tree_map

ARCHS = ["qwen1.5-0.5b", "gemma3-1b", "mamba2-2.7b"]
DENSE = ("qwen1.5-0.5b", "gemma3-1b")
MOE_ARCHS = ["deepseek-v3-671b", "grok-1-314b"]
#: tests/test_torch_dense.py's CHUNKED_REL: both sides compute in float32
#: and differ by reassociation only
CHUNKED_REL = 32 * 2.0 ** -23
SLOTS, PROMPT, GEN, CHUNK = 4, 40, 8, 3
OUTPUTS = ("first", "out", "n", "tok", "active", "rem")


def _boost(tree, factor, name=""):
    """The decoder's matrices (``w*`` leaves) times ``factor``."""
    if isinstance(tree, dict):
        return {k: _boost(v, factor, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_boost(v, factor, name) for v in tree]
    return tree * np.float32(factor) if name.startswith("w") else tree


@functools.lru_cache(maxsize=None)
def _pair(arch):
    """(jax config, jax params, port config, port params) at the smoke size."""
    jcfg, cfg = jax_get_config(arch).smoke(), get_config(arch).smoke()
    jp = jax.tree.map(np.asarray, JaxModel(jcfg).init(jax.random.PRNGKey(0))[0])
    if arch in DENSE:
        jp = {**jp, "decoder": _boost(jp["decoder"], 8)}
    return jcfg, jax.tree.map(jnp.asarray, jp), cfg, from_reference_params(jp, cfg, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def _prompts(cfg, n, length, seed):
    return np.random.RandomState(seed).randint(0, cfg.vocab, (n, length)).astype(np.int32)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _scripted(pair, eos_id=-1):
    """The scripted sequence through both packages; returns per round
    ``(jax outputs, port outputs, jax caches, port caches)`` as numpy."""
    jcfg, jp, cfg, params = pair
    mesh = jax_make_mesh((1, 1), ("data", "model"))
    jeng = JaxServeEngine(jcfg, mesh, slots=SLOTS, prompt_len=PROMPT, max_new=GEN,
                          chunk=CHUNK, eos_id=eos_id)
    with mesh:
        jparams = jax.device_put(jp, jeng.pre.in_shardings[0])
    eng = ServeEngine(cfg, slots=SLOTS, prompt_len=PROMPT, max_new=GEN, chunk=CHUNK,
                      eos_id=eos_id, device="cpu")
    prompts = _prompts(cfg, SLOTS, PROMPT, seed=11)
    jstate, state = jeng.init_state(), eng.init_state()
    rounds = []

    def admit(slots):
        mask = np.isin(np.arange(SLOTS), slots)
        rows = np.where(mask[:, None], prompts, 0).astype(np.int32)
        new_rem = np.where(mask, GEN, 0).astype(np.int32)
        return rows, mask, new_rem

    script = [admit([0, 1]), None, admit([2, 3])] + [None] * 6
    for step in script:
        if step is None:
            *jstate, jout, jn = jeng.decode(jparams, *jstate)
            *state, out, n = eng.decode(params, *state)
            jfirst = first = np.full(SLOTS, PAD_TOKEN, np.int32)
        else:
            rows, mask, new_rem = step
            *jstate, jfirst, jout, jn = jeng.admit_decode(
                jparams, *jstate, {"tokens": jnp.asarray(rows)}, jnp.asarray(mask),
                jnp.asarray(new_rem))
            *state, first, out, n = eng.admit_decode(
                params, *state, {"tokens": torch.from_numpy(rows)},
                torch.from_numpy(mask), torch.from_numpy(new_rem))
        jtok, jact, jrem = (_np(a) for a in jstate[1:])
        tok, act, rem = (_np(a) for a in state[1:])
        rounds.append((dict(first=_np(jfirst), out=_np(jout), n=_np(jn), tok=jtok,
                            active=jact, rem=jrem),
                       dict(first=_np(first), out=_np(out), n=_np(n), tok=tok,
                            active=act, rem=rem),
                       jax.tree.map(np.asarray, jstate[0]),
                       # copies: the next round writes the K/V caches in place
                       jax.tree.map(np.copy, caches_to_numpy(state[0]))))
        if len(rounds) > 2 and not act.any():
            break
    return rounds


def _check_rounds(rounds, caches_too=True):
    for r, (want, got, jc, c) in enumerate(rounds):
        for k in OUTPUTS:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"round {r}: {k}")
        if not caches_too:
            continue
        act = want["active"]
        np.testing.assert_array_equal(c["pos"][act], jc["pos"][act])
        for g, w in zip(jax.tree.leaves(c["segments"]), jax.tree.leaves(jc["segments"])):
            # the slot axis is 1 ([L, B, ...])
            g, w = g[:, act].astype(np.float64), w[:, act].astype(np.float64)
            if w.size:
                assert np.abs(g - w).max() <= CHUNKED_REL * np.abs(w).max(), f"round {r}"


@pytest.fixture(scope="module")
def scripted(pair):
    """The scripted rounds, with ``eos_id`` slot 2's prefill token."""
    _, _, cfg, params = pair
    model = Model(cfg)
    caches = model.init_caches(1, PROMPT, per_sequence=True, device="cpu")
    prompt = torch.from_numpy(_prompts(cfg, SLOTS, PROMPT, seed=11)[2:3])
    eos = int(model.prefill(params, {"tokens": prompt}, caches)[0].argmax())
    return eos, _scripted(pair, eos_id=eos)


def test_admit_decode_equals_jax(scripted):
    """(i) every round's outputs equal, the active slots' caches close."""
    eos, rounds = scripted
    _check_rounds(rounds)
    first = rounds[0][1]
    assert (first["first"][:2] != PAD_TOKEN).all() and (first["first"][2:] == PAD_TOKEN).all()
    # slots 0 and 1 are in flight at depth PROMPT + 2 CHUNK when 2 and 3 come
    assert rounds[1][1]["active"][:2].all()
    np.testing.assert_array_equal(rounds[1][3]["pos"][:2], PROMPT + 2 * CHUNK)
    np.testing.assert_array_equal(rounds[2][1]["n"], [GEN - 1 - 2 * CHUNK] * 2 + [0, CHUNK])
    emitted = [sum(int(r[1]["n"][s]) + int(r[1]["first"][s] != PAD_TOKEN) for r in rounds)
               for s in range(SLOTS)]
    assert emitted == [GEN, GEN, 1, GEN]
    assert not any((r[1]["out"][[0, 1, 3]] == eos).any() for r in rounds)


def test_eos_at_admission_equals_jax(scripted):
    """(ii) slot 2's prefill token is the EOS id: it stops at its admission
    (no decode token, inactive from the round it came in), as in JAX."""
    eos, rounds = scripted
    admitted = rounds[2]
    for got in admitted[:2]:
        assert got["first"][2] == eos
        assert not got["active"][2] and got["n"][2] == 0
        assert (got["out"][2] == PAD_TOKEN).all()


@pytest.fixture(scope="module")
def continuous(pair):
    """Both packages' ``serve_continuous`` at the reference test's shape."""
    jcfg, jp, cfg, params = pair
    n, slots, chunk, prompt, gen = 5, 2, 3, 8, 6
    prompts = _prompts(cfg, n, prompt, seed=1)
    mesh = jax_make_mesh((1, 1), ("data", "model"))
    jeng = JaxServeEngine(jcfg, mesh, slots=slots, prompt_len=prompt, max_new=gen,
                          chunk=chunk)
    with mesh:
        jparams = jax.device_put(jp, jeng.pre.in_shardings[0])
    jres, jstats = jax_serve_continuous(
        jcfg, mesh, slots=slots, prompt_len=prompt, max_new=gen, n_requests=n,
        chunk=chunk, params=jparams, prompts={"tokens": jnp.asarray(prompts)}, engine=jeng)
    res, stats = serve_continuous(
        cfg, slots=slots, prompt_len=prompt, max_new=gen, n_requests=n, chunk=chunk,
        params=params, prompts={"tokens": torch.from_numpy(prompts)}, device="cpu")
    return prompts, (slots, prompt, gen), jres, jstats, res, stats


def test_serve_continuous_equals_jax_and_serial(pair, continuous):
    """(iii) tokens per request equal JAX's and the port's serial serve of
    the prompt alone (one slot, host-stepped, as the reference's test)."""
    _, _, cfg, params = pair
    prompts, (slots, prompt, gen), jres, _, res, _ = continuous
    assert [r.rid for r in res] == list(range(len(prompts)))
    eng1 = ServeEngine(cfg, slots=1, prompt_len=prompt, max_new=gen, chunk=gen - 1,
                       device="cpu")
    for r, jr in zip(res, jres):
        assert r.tokens.dtype == np.int32 and len(r.tokens) == gen
        np.testing.assert_array_equal(r.tokens, np.asarray(jr.tokens))
        alone, _ = serve(cfg, batch=1, prompt_len=prompt, gen_len=gen, params=params,
                         batch_in={"tokens": torch.from_numpy(prompts[r.rid:r.rid + 1])},
                         engine=eng1, device_resident=False)
        np.testing.assert_array_equal(r.tokens, alone[0])
        assert r.latency_s >= 0.0


def test_serve_continuous_dispatches_equal_jax(continuous):
    _, (slots, _, gen), _, jstats, _, stats = continuous
    for k in ("dispatches", "admit_dispatches", "decode_dispatches",
              "prefill_dispatches", "sync_points", "total_tokens"):
        assert stats[k] == jstats[k], k
    assert stats["prefill_dispatches"] == 0
    assert stats["sync_points"] == stats["dispatches"] == (
        stats["admit_dispatches"] + stats["decode_dispatches"])
    assert stats["total_tokens"] == 5 * gen
    # on the CPU every dispatch runs eagerly
    assert stats["graph_launches"] == dict.fromkeys(DISPATCH_KINDS, 0)


def test_select_slots_per_leaf(pair):
    """(iv) as the reference's ``tests/test_serve.py`` checks it, and equal
    to the reference's ``select_slots`` on the same trees."""
    jcfg, _, cfg, _ = pair
    model, jmodel = Model(cfg), JaxModel(jcfg)
    axes = model.cache_axes(per_sequence=True)
    assert axes == jax.tree.map(lambda a: a, jmodel.cache_axes(per_sequence=True),
                                is_leaf=lambda x: isinstance(x, tuple))
    old = model.init_caches(3, 16, per_sequence=True, device="cpu")
    rng = np.random.RandomState(5)
    old = tree_map(lambda t: torch.from_numpy(
        rng.randn(*t.shape).astype(np.float32)).to(t.dtype), old)
    new = tree_map(torch.ones_like, old)
    keep = [True, False, True]
    merged = model.select_slots(torch.tensor(keep), new, old)
    want = jmodel.select_slots(jnp.asarray(keep), jax.tree.map(jnp.asarray,
                                                               caches_to_numpy(new)),
                               jax.tree.map(jnp.asarray, caches_to_numpy(old)))
    got = caches_to_numpy(merged)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))
    o = caches_to_numpy(old)
    for path in (("pos",), *(("segments", 0, k1, k2) for k1 in merged["segments"][0]
                             for k2 in merged["segments"][0][k1])):
        m, before, ax = got, o, axes
        for p in path:
            m, before, ax = m[p], before[p], ax[p]
        b = ax.index("batch")
        for s, take_new in enumerate(keep):
            want_s = (np.ones_like(np.take(m, s, axis=b)) if take_new
                      else np.take(before, s, axis=b))
            np.testing.assert_array_equal(np.take(m, s, axis=b), want_s)


def test_select_slots_in_place(pair):
    """(iv) ``in_place``: the merge is written into the old leaves, which
    are returned, and equals the merge into new tensors; the admission
    merges so, and its decode writes the K/V there (no cache copy)."""
    _, _, cfg, params = pair
    model = Model(cfg)
    rng = np.random.RandomState(6)
    old = tree_map(lambda t: torch.from_numpy(
        rng.randn(*t.shape).astype(np.float32)).to(t.dtype),
        model.init_caches(3, 16, per_sequence=True, device="cpu"))
    new = tree_map(torch.ones_like, old)
    keep = torch.tensor([False, True, True])
    want = model.select_slots(keep, new, old)
    ptrs = [t.data_ptr() for t in tree_leaves(old)]
    got = model.select_slots(keep, new, old, in_place=True)
    assert [t.data_ptr() for t in tree_leaves(got)] == ptrs
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(g, w)
    eng = ServeEngine(cfg, slots=2, prompt_len=8, max_new=4, chunk=2, device="cpu")
    caches, *rest = eng.init_state()
    kv = {t.data_ptr() for seg in caches["segments"] for part in seg.values()
          for key, t in part.items() if key in ("k", "v")}
    out = eng.admit_decode(params, caches, *rest,
                           {"tokens": torch.from_numpy(_prompts(cfg, 2, 8, seed=2))},
                           torch.tensor([True, False]), torch.tensor([4, 0], dtype=torch.int32))
    assert kv <= {t.data_ptr() for t in tree_leaves(out[0])}


def test_poisson_arrivals():
    assert (poisson_arrivals(4, 0.0, np.random.RandomState(0)) == 0).all()
    a = poisson_arrivals(100, 50.0, np.random.RandomState(0))
    assert (np.diff(a) > 0).all() and 1.0 < a[-1] < 3.0


@pytest.mark.parametrize("extra", [[], ["--requests", "3", "--chunk", "2"],
                                   ["--host-stepped", "--eos-id", "7"]],
                         ids=["serve", "continuous", "host-stepped"])
def test_main_on_the_cpu(capsys, extra):
    """(v) the CLI in-process."""
    main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
                    "--batch", "2", "--prompt-len", "8", "--gen", "4", *extra])
    out = capsys.readouterr().out
    if "--requests" in extra:
        assert "served 3 requests (12 tokens)" in out and "'prefill_dispatches': 0" in out
    else:
        assert "generated tokens (first row):" in out and "'dispatches': " in out


def test_main_refuses_a_mesh():
    with pytest.raises(SystemExit):
        main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
                        "--mesh", "2x1"])


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "gemma3-1b"])
def test_boosted_dense_tokens_are_not_an_echo(arch):
    """With the boosted matrices no slot just repeats its last prompt token
    (so (i) and (iii) compare more than an echo)."""
    _, _, cfg, params = _pair(arch)
    prompts = _prompts(cfg, 4, 8, seed=3)
    gen, _ = serve(cfg, batch=4, prompt_len=8, gen_len=4, params=params,
                   batch_in={"tokens": torch.from_numpy(prompts)}, device="cpu")
    assert (gen != prompts[:, -1:]).any(axis=1).all()


# -- the MoE configs -------------------------------------------------------------


@pytest.fixture(scope="module", params=MOE_ARCHS)
def moe_pair(request):
    return _pair(request.param)


def test_moe_admit_decode_equals_jax(moe_pair):
    """(i) for the MoE configs: every round's outputs equal JAX's bit for
    bit, the active slots' caches within ``CHUNKED_REL``; slots 0 and 1
    are in flight when 2 and 3 come, and every slot runs to ``GEN``."""
    rounds = _scripted(moe_pair)
    _check_rounds(rounds)
    assert rounds[1][1]["active"][:2].all()
    np.testing.assert_array_equal(rounds[1][3]["pos"][:2], PROMPT + 2 * CHUNK)
    emitted = [sum(int(r[1]["n"][s]) + int(r[1]["first"][s] != PAD_TOKEN) for r in rounds)
               for s in range(SLOTS)]
    assert emitted == [GEN] * SLOTS


def test_moe_serve_continuous_equals_jax(moe_pair):
    """(iii) for the MoE configs: 5 requests, 2 slots, chunk 3, rate 0;
    each request's tokens equal JAX's bit for bit, and the dispatch stats
    equal JAX's."""
    jcfg, jp, cfg, params = moe_pair
    n, slots, chunk, prompt, gen = 5, 2, 3, 8, 6
    prompts = _prompts(cfg, n, prompt, seed=1)
    mesh = jax_make_mesh((1, 1), ("data", "model"))
    jeng = JaxServeEngine(jcfg, mesh, slots=slots, prompt_len=prompt, max_new=gen,
                          chunk=chunk)
    with mesh:
        jparams = jax.device_put(jp, jeng.pre.in_shardings[0])
    jres, jstats = jax_serve_continuous(
        jcfg, mesh, slots=slots, prompt_len=prompt, max_new=gen, n_requests=n,
        chunk=chunk, params=jparams, prompts={"tokens": jnp.asarray(prompts)}, engine=jeng)
    res, stats = serve_continuous(
        cfg, slots=slots, prompt_len=prompt, max_new=gen, n_requests=n, chunk=chunk,
        params=params, prompts={"tokens": torch.from_numpy(prompts)}, device="cpu")
    assert [r.rid for r in res] == [r.rid for r in jres] == list(range(n))
    for r, jr in zip(res, jres):
        assert r.tokens.dtype == np.int32 and len(r.tokens) == gen
        np.testing.assert_array_equal(r.tokens, np.asarray(jr.tokens))
    for k in ("dispatches", "admit_dispatches", "decode_dispatches",
              "prefill_dispatches", "sync_points", "total_tokens"):
        assert stats[k] == jstats[k], k
    assert stats["prefill_dispatches"] == 0
