"""Serving — port of ``repro.launch.serve``: ``ServeEngine``, ``serve``,
continuous batching (``admit_decode``, ``serve_continuous``) and the CLI.

The greedy-decode control loop runs device-resident: ``chunk`` decode
steps captured into ONE CUDA graph, with the reference's per-slot
masking (EOS, the ``rem`` token budget and cache capacity stop a slot;
a stopped slot's ``pos`` freezes and it emits ``PAD_TOKEN``).  The
host-stepped baseline replays a one-step graph once per token.  Prefill
is ONE graph launch too, one graph per (slots, prompt length, cache
depth): the depth is read on the host before the graph is looked up,
and its SSD scans, flash attention and norms take the hand-written
kernels.  Continuous batching admits requests into freed slots between
dispatches: ``admit_decode`` is ONE graph launch that prefills every
slot's row at depth 0 into a zeroed cache view, merges the admitted
slots (``Model.select_slots``) and runs the decode chunk for all active
slots.  The decode and admission graphs share one set of state buffers,
and the admission merges into them in place, so rounds hand the caches
on without a copy, as the reference's donated buffers do.  On the CPU the same functions run eagerly.  Attention
caches hold ``prefix_len + prompt_len + max_new`` entries: the prefix
(meta tokens, vision patches) sits before the prompt, as in the
reference.  Every dispatch takes the whole input batch into its graph:
the tokens and a config's ``audio_embeds`` or ``vision_embeds``.
``serve_window`` narrows the attention windows as the reference's does
(``transformer.layer_window_theta``).  MLA's caches (``c_kv``,
``k_rope``) are written in place as K and V are.  A MoE config's
admission prefills the whole batch, each MoE layer's capacity taken from
that call's tokens, as the reference's does: under capacity drops a
slot's tokens depend on its batch-mates there too.  On one GPU there is no mesh or
sharding bundle: the engine calls the model directly.
:func:`build_admission_schedule` gives the admission handoff as a
two-queue ST schedule for the verifier.

CLI (the reference's, with ``--device`` for ``--mesh``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --smoke [--batch 4 --prompt-len 32 --gen 16] [--serve-window W] \
        [--seed S] [--eos-id K] [--host-stepped] \
        [--requests N --rate R --chunk C] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.kernels import graph_loop, ops
from repro_torch.mesh import resolve_device
from repro_torch.models import Model
from repro_torch.models.nn import tree_leaves, tree_map

#: emission marker for a slot that was not active at a given decode step
PAD_TOKEN = -1
#: the engine's dispatch kinds, each a CUDA-graph launch on the card
DISPATCH_KINDS = ("prefill", "decode", "decode_one", "admit_decode")


class _Counted:
    """Wrap a callable and count host dispatches through it."""

    def __init__(self, fn):
        self._fn = fn
        self.calls = 0

    def __call__(self, *args):
        self.calls += 1
        return self._fn(*args)


def _argmax_tok(logits: torch.Tensor) -> torch.Tensor:
    return logits.argmax(dim=-1).to(torch.int32)


class _Graph:
    """``fn(params, *state)`` captured once into a CUDA graph over static
    state buffers.  ``fn`` returns ``(new_state, extras)``; the graph ends
    by copying ``new_state`` into the state buffers, so a call copies in
    only the state it is given that is not those buffers already, replays
    (ONE launch) and returns ``(state buffers, extras)``.  The returned
    tensors are the graph's own, overwritten by the next call, as the
    reference's donated buffers are.  ``buffers`` (a tree shaped like
    ``state``) gives the state buffers, so that graphs can share them;
    by default the graph clones its own.  ``replays`` counts the
    launches; ``kernel_launches`` holds the hand-written kernels'
    launches recorded into the graph (each replay runs them again), and
    ``tail_bytes`` the bytes its closing copies move: the state ``fn``
    made anew rather than wrote in place."""

    def __init__(self, fn: Callable, params, state, buffers=None):
        self.params = params
        self.state = tree_map(torch.clone, state) if buffers is None else buffers
        self.replays = 0
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):   # warm-up on scratch copies
            fn(params, *tree_map(torch.clone, state))
        torch.cuda.current_stream().wait_stream(stream)
        before = ops.launch_counts()
        self.tail_bytes = 0

        def body():
            new_state, extras = fn(params, *self.state)
            for dst, src in zip(tree_leaves(self.state), tree_leaves(new_state)):
                if dst is not src:
                    dst.copy_(src)
                    self.tail_bytes += dst.numel() * dst.element_size()
            return extras

        self.graph, self.extras = graph_loop.capture(body, keep_graph=False)
        self.kernel_launches = {k: n - before[k] for k, n in ops.launch_counts().items()}

    def __call__(self, state):
        for dst, src in zip(tree_leaves(self.state), tree_leaves(state)):
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        self.graph.replay()
        self.replays += 1
        return self.state, self.extras


def build_admission_schedule(mesh=None, *, slots: int = 4, width: int = 8,
                             verify: str = "error"):
    """The admission composition as an explicit ST schedule (reference
    ``repro.launch.serve.build_admission_schedule``).

    Two :class:`~repro_torch.core.STQueue` programs joined by a
    cross-program link, so the prefill → decode handoff has a lintable
    model: ``prefill`` computes the KV for the admitted slots and *sends*
    it; ``decode`` *receives* it into its cache slot, waits on the
    deposit (the decode step must not read the slot before the prefill
    deposit lands), then steps.  ``python -m repro_torch.analysis`` lints
    it with the Faces programs.  ``mesh`` defaults to one rank on the
    card; its buffers, ``(ranks * slots, width)`` over ``(axis, None)``,
    are held as the stack of each rank's slots.
    """
    from repro_torch.core import OffsetPeer, STQueue, compose
    from repro_torch.mesh import make_mesh

    if mesh is None:
        mesh = make_mesh((1,), ("x",))
    ax = mesh.axis_names[0]
    n = int(mesh.shape[ax]) * slots

    qp = STQueue(mesh, name="prefill")
    qp.buffer("prompt", (n, width), np.float32, pspec=(ax, None))
    qp.buffer("kv", (n, width), np.float32, pspec=(ax, None))
    qp.enqueue_kernel(torch.tanh, ["prompt"], ["kv"], name="prefill")
    qp.enqueue_send("kv", OffsetPeer(ax, 0, periodic=True), tag=31,
                    remote="decode")
    qp.enqueue_start()
    qp.enqueue_wait()
    prefill = qp.build()

    qd = STQueue(mesh, name="decode")
    qd.buffer("cache", (n, width), np.float32, pspec=(ax, None))
    qd.buffer("tok", (n, width), np.float32, pspec=(ax, None))
    qd.enqueue_recv("cache", OffsetPeer(ax, 0, periodic=True), tag=31,
                    remote="prefill")
    qd.enqueue_start()
    qd.enqueue_wait()
    qd.enqueue_kernel(lambda c: torch.cumsum(c, dim=-1), ["cache"], ["tok"],
                      name="decode")
    decode = qd.build()

    return compose(prefill, decode, name="serve_admission", verify=verify)


class ServeEngine:
    """Serve programs over one slot-set of caches on one device.

    * ``prefill(params, batch_in, caches)`` — ONE CUDA-graph launch, one
      graph per (slots, prompt length, cache depth); the depth is read on
      the host first (``Model.prefill_depth``, a sync that cannot happen
      inside a capture).  Its SSD scans, attention and norms go through
      the hand-written kernels.
    * ``decode(params, caches, tok, active, rem)`` — up to ``chunk``
      greedy tokens for every active slot in ONE CUDA-graph launch.
      The reference's ``while_loop`` leaves early once every slot has
      stopped; a fixed graph runs all ``chunk`` steps.  The emitted
      tokens and counts are the same either way; only the SSM and conv
      state of stopped slots moves further (the reference already lets
      it drift while other slots run, since it freezes ``pos`` only),
      and a stopped slot rewrites its K/V at its frozen ``pos``, behind
      its mask, so compare final caches only in runs without EOS.
    * ``decode_one(params, caches, tok)`` — one decode step as one graph
      launch: the host-stepped baseline.
    * ``admit_decode(params, caches, tok, active, rem, batch_in, admit,
      new_rem)`` — continuous batching's admission in ONE CUDA-graph
      launch: every slot's row of ``batch_in`` prefilled at depth 0 into
      a zeroed view of the caches (a recycled slot's stale K/V and SSM
      state must not leak into its new request), the view merged into
      the slots where ``admit`` is set (``Model.select_slots``), their
      first token, budget and stop set, then the decode chunk over all
      active slots.  Returns ``(caches, tok, active, rem, first, out,
      n)``.  The view is zeroed, so its depth is 0 by construction and
      nothing is read on the host.

    ``decode`` and ``admit_decode`` capture their graphs over ONE shared
    set of state buffers (caches, tok, active, rem), the admission merges
    into those buffers in place and the decode writes K/V there: a serve
    chain that passes each dispatch's outputs to the next copies no cache
    set between or within rounds, as the reference's donated buffers
    rotate (a graph's closing copy writes back only what a step makes
    anew: ``pos``, tok, active, rem and the SSM ``conv`` and ``state``).
    On the CPU the admission's merge writes into the caches it is
    given.

    ``device=None`` means the current CUDA device and raises without a
    GPU; on ``device="cpu"`` the same functions run eagerly.  The first
    call of each graph is set-up: one eager warm-up pass, the capture,
    then the launch.  ``dispatches`` counts calls (a resident serve: 2,
    one of them decode; a continuous round: 1); ``graph_launches``
    counts graph replays per dispatch kind.  The engine casts the large
    weights to ``cfg.dtype`` once per params tree it is given.
    """

    def __init__(self, cfg: ModelConfig, *, slots: int, prompt_len: int,
                 max_new: int, chunk: Optional[int] = None, eos_id: int = -1,
                 serve_window: int = 0, device=None):
        self.device = resolve_device(device, "ServeEngine")
        self.cfg = cfg
        self.slots, self.prompt_len, self.max_new = slots, prompt_len, max_new
        self.eos_id, self.serve_window = int(eos_id), int(serve_window)
        self.model = Model(cfg)
        # the meta tokens and vision patches sit in the cache before the prompt
        self.prefix_len = self.model._prefix_len()
        self.capacity = self.prefix_len + prompt_len + max_new
        self.chunk = int(chunk) if chunk else max(max_new - 1, 1)
        self.sync_points = 0
        self._cast = None      # (params, params with cast weights)
        self._graphs: Dict[tuple, _Graph] = {}   # by (kind, key...)
        self._retired = dict.fromkeys(DISPATCH_KINDS, 0)  # replays of dropped graphs
        self._slot_buffers = None   # (caches, tok, active, rem) of the decode graphs
        self.prefill = _Counted(self._prefill_fn)
        self.decode = _Counted(self._decode_fn)
        self.decode_one = _Counted(self._decode_one_fn)
        self.admit_decode = _Counted(self._admit_decode_fn)

    # -- state ------------------------------------------------------------------

    def init_state(self):
        """(caches, tok, active, rem) — all slots free."""
        caches = self.model.init_caches(self.slots, self.capacity,
                                        per_sequence=True, device=self.device)
        tok = torch.zeros((self.slots,), dtype=torch.int32, device=self.device)
        active = torch.zeros((self.slots,), dtype=torch.bool, device=self.device)
        rem = torch.zeros((self.slots,), dtype=torch.int32, device=self.device)
        return caches, tok, active, rem

    @property
    def dispatches(self) -> int:
        return (self.prefill.calls + self.decode.calls + self.decode_one.calls
                + self.admit_decode.calls)

    @property
    def graph_launches(self) -> Dict[str, int]:
        """CUDA-graph launches per dispatch kind (``prefill``, ``decode``,
        ``decode_one``, ``admit_decode``) since the engine was made; all 0
        on the CPU."""
        out = dict(self._retired)
        for key, g in self._graphs.items():
            out[key[0]] += g.replays
        return out

    def captured_launches(self, kind: str) -> Dict[str, int]:
        """The hand-written kernels' launches recorded into the live graphs
        of dispatch ``kind``: what one launch of each runs."""
        out: Dict[str, int] = {}
        for key, g in self._graphs.items():
            if key[0] == kind:
                for name, n in g.kernel_launches.items():
                    out[name] = out.get(name, 0) + n
        return out

    def cast_params(self, params):
        """``Model.compute_params(params)``, made once per params tree;
        the float32 master stays the caller's."""
        if self._cast is None or self._cast[0] is not params:
            self._cast = (params, self.model.compute_params(params))
            for key, g in self._graphs.items():
                self._retired[key[0]] += g.replays
            self._graphs.clear()
        return self._cast[1]

    def _graphed(self, key: tuple, fn: Callable, params, state, shared: bool = False):
        """``fn(params, *state)`` as one launch of the graph for ``key``
        (``(kind, ...)``) on the card, or eagerly on the CPU; returns
        ``(new_state, extras)``.  ``shared``: ``state`` starts with
        (caches, tok, active, rem), held in the engine's shared slot
        buffers."""
        if self.device.type != "cuda":
            return fn(params, *state)
        g = self._graphs.get(key)
        if g is None or g.params is not params:
            buffers = None
            if shared:
                if self._slot_buffers is None:
                    self._slot_buffers = tree_map(torch.clone, tuple(state[:4]))
                buffers = self._slot_buffers + tree_map(torch.clone, tuple(state[4:]))
            g = self._graphs[key] = _Graph(fn, params, state, buffers)
        return g(state)

    # -- the four dispatch kinds --------------------------------------------------

    def _prefill_fn(self, params, batch_in, caches):
        depth = self.model.prefill_depth(caches)   # host sync: before any capture

        def step(p, batch_in, caches):
            logits, caches = self.model.prefill(p, batch_in, caches,
                                                serve_window=self.serve_window,
                                                depth=depth)
            return (batch_in, caches), logits

        (_, caches), logits = self._graphed(
            ("prefill", tuple(batch_in["tokens"].shape), depth), step,
            self.cast_params(params), (batch_in, caches))
        return logits, caches

    def _decode_fn(self, params, caches, tok, active, rem):
        (caches, tok, active, rem), (out, n) = self._graphed(
            ("decode",), self._decode_loop, self.cast_params(params),
            (caches, tok, active, rem), shared=True)
        return caches, tok, active, rem, out, n

    def _admit_decode_fn(self, params, caches, tok, active, rem, batch_in, admit,
                         new_rem):
        state = (caches, tok, active, rem, batch_in, admit, new_rem)
        (caches, tok, active, rem, *_), (first, out, n) = self._graphed(
            ("admit_decode", tuple(batch_in["tokens"].shape)), self._admit_decode_inner,
            self.cast_params(params), state, shared=True)
        return caches, tok, active, rem, first, out, n

    def _admit_decode_inner(self, params, caches, tok, active, rem, batch_in, admit,
                            new_rem):
        """The admission round (reference ``_admit_decode_inner``); returns
        ``((caches, tok, active, rem, batch_in, admit, new_rem), (first,
        out, n))``."""
        zero = tree_map(torch.zeros_like, caches)
        logits, pre = self.model.prefill(params, batch_in, zero,
                                         serve_window=self.serve_window, depth=0)
        # merged into the caches given: in the graph, the shared buffers
        caches = self.model.select_slots(admit, pre, caches, in_place=True)
        tok0 = _argmax_tok(logits)
        first = torch.where(admit, tok0, PAD_TOKEN)
        tok = torch.where(admit, tok0, tok)
        # the prefill token is emission #1 of the admitted request
        rem_admitted = new_rem - 1
        stop = rem_admitted <= 0
        if self.eos_id >= 0:
            stop = stop | (tok0 == self.eos_id)
        stop = stop | (caches["pos"] >= self.capacity)
        active = torch.where(admit, admit & ~stop, active)
        rem = torch.where(admit, rem_admitted, rem)
        (caches, tok, active, rem), (out, n) = self._decode_loop(params, caches, tok,
                                                                 active, rem)
        return (caches, tok, active, rem, batch_in, admit, new_rem), (first, out, n)

    def _decode_one_fn(self, params, caches, tok):
        def step(p, caches, tok):
            logits, caches = self.model.decode_step(p, caches, tok,
                                                    serve_window=self.serve_window)
            return (caches, tok), logits

        (caches, _), logits = self._graphed(("decode_one",), step,
                                            self.cast_params(params), (caches, tok))
        return logits, caches

    def _decode_loop(self, params, caches, tok, active, rem):
        """``chunk`` greedy-decode steps with per-slot masking; returns
        ``((caches, tok, active, rem), (out, n))``."""
        B, chunk, eos = self.slots, self.chunk, self.eos_id
        out = torch.full((B, chunk), PAD_TOKEN, dtype=torch.int32, device=tok.device)
        n = torch.zeros((B,), dtype=torch.int32, device=tok.device)
        for i in range(chunk):
            logits, new_caches = self.model.decode_step(params, caches, tok,
                                                        serve_window=self.serve_window)
            nxt = _argmax_tok(logits)
            out[:, i] = torch.where(active, nxt, PAD_TOKEN)
            n = n + active.to(torch.int32)
            # a frozen slot's depth does not advance
            pos = torch.where(active, new_caches["pos"], caches["pos"])
            caches = dict(new_caches)
            caches["pos"] = pos
            rem = rem - active.to(torch.int32)
            stop = rem <= 0
            if eos >= 0:
                stop = stop | (nxt == eos)
            stop = stop | (pos >= self.capacity)
            active = active & ~stop
            tok = torch.where(active, nxt, tok)
        return (caches, tok, active, rem), (out, n)


# --------------------------------------------------------------------------
# synthetic workload and single-shot serving
# --------------------------------------------------------------------------


def synthetic_batch(cfg: ModelConfig, rng, batch: int, prompt_len: int, *,
                    device=None):
    """Synthetic prompts and the config's frontend embeddings (float32
    ``audio_embeds`` / ``vision_embeds``), value for value those of the
    reference for the same ``numpy.random.RandomState``."""
    out = {"tokens": rng.randint(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)}
    if cfg.enc_dec:
        out["audio_embeds"] = rng.randn(batch, cfg.frontend_tokens,
                                        cfg.frontend_dim).astype(np.float32)
    if cfg.frontend == "vision":
        out["vision_embeds"] = rng.randn(batch, cfg.frontend_tokens,
                                         cfg.frontend_dim).astype(np.float32)
    device = resolve_device(device, "synthetic_batch")
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ModelConfig, *, batch: int, prompt_len: int, gen_len: int,
          seed: int = 0, serve_window: int = 0, eos_id: int = -1,
          device_resident: bool = True, params=None, batch_in=None,
          engine: Optional[ServeEngine] = None, device=None):
    """Batched prefill + greedy decode for one fixed batch.

    ``device_resident=True``: the decode loop is ONE graph launch
    (``stats["decode_dispatches"] == 1``); False: one launch per token.
    Returns ``(gen, stats)`` as the reference does: ``gen`` is ``[batch,
    gen_len]`` int32 (column 0 from prefill, ``PAD_TOKEN`` past EOS), and
    ``stats`` has ``prefill_s``, ``decode_s``, ``decode_tokens``,
    ``tok_per_s``, ``dispatches``, ``decode_dispatches`` and
    ``sync_points``.  ``params=None`` draws the port's own random
    weights from ``seed``; ``serve_window`` narrows attention windows
    (the engine's own, when ``engine`` is given).
    """
    eng = engine or ServeEngine(cfg, slots=batch, prompt_len=prompt_len,
                                max_new=gen_len, chunk=gen_len - 1, eos_id=eos_id,
                                serve_window=serve_window, device=device)
    if (eng.slots, eng.chunk, eng.eos_id) != (batch, gen_len - 1, int(eos_id)):
        raise ValueError("serve: the engine's slots, chunk and eos_id do not match "
                         "batch, gen_len - 1 and eos_id")
    dev = eng.device
    base_disp = eng.dispatches
    base_dec = eng.decode.calls + eng.decode_one.calls
    if params is None:
        params = eng.model.init(seed, device=dev)
    if batch_in is None:
        batch_in = synthetic_batch(cfg, np.random.RandomState(seed), batch,
                                   prompt_len, device=dev)
    caches, tok, active, rem = eng.init_state()

    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = eng.prefill(params, batch_in, caches)
    tok0 = _argmax_tok(logits)
    tok0_np = tok0.cpu().numpy()   # prefill sync point
    t_prefill = time.perf_counter() - t0

    active = torch.ones((batch,), dtype=torch.bool, device=dev)
    rem = torch.full((batch,), gen_len - 1, dtype=torch.int32, device=dev)
    if eos_id >= 0:
        active = active & (tok0 != eos_id)

    t0 = time.perf_counter()
    if device_resident:
        caches, tok, active, rem, out, n_emit = eng.decode(
            params, caches, tok0, active, rem)
        out = out.cpu().numpy()
        n_np = n_emit.cpu().numpy()
        eng.sync_points += 1
    else:
        # host-stepped loop: no per-step host sync, emissions stay on the
        # device until the end
        emitted = []
        cur = tok0
        for _ in range(gen_len - 1):
            logits, caches = eng.decode_one(params, caches, cur)
            cur = _argmax_tok(logits)
            emitted.append(cur)
        _sync(dev)
        eng.sync_points += 1
        out = torch.stack(emitted, dim=1).cpu().numpy()
        # host-side EOS truncation (the oracle of the resident loop's masking)
        if eos_id >= 0:
            for b in range(batch):
                stop = gen_len - 1 if tok0_np[b] != eos_id else 0
                hits = np.nonzero(out[b] == eos_id)[0]
                if hits.size:
                    stop = min(stop, hits[0] + 1)
                out[b, stop:] = PAD_TOKEN
        n_np = (out != PAD_TOKEN).sum(axis=1)
    t_decode = time.perf_counter() - t0

    gen = np.concatenate([tok0_np[:, None], out], axis=1)
    decode_tokens = int(n_np.sum())
    stats = {
        "prefill_s": t_prefill, "decode_s": t_decode,
        "decode_tokens": decode_tokens,
        "tok_per_s": decode_tokens / max(t_decode, 1e-9),
        "dispatches": eng.dispatches - base_disp,
        "decode_dispatches": eng.decode.calls + eng.decode_one.calls - base_dec,
        "sync_points": eng.sync_points,
    }
    return gen, stats


# --------------------------------------------------------------------------
# continuous batching (open-loop arrival stream)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: np.ndarray        # emitted tokens (prefill token first)
    t_arrive: float
    t_done: float

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_arrive


def poisson_arrivals(n: int, rate: float, rng) -> np.ndarray:
    """Arrival offsets (s) for an open-loop Poisson stream; rate <= 0 → a
    t=0 burst."""
    if rate <= 0:
        return np.zeros(n)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def serve_continuous(cfg: ModelConfig, *, slots: int, prompt_len: int, max_new: int,
                     n_requests: int, chunk: int = 4, arrival_rate: float = 0.0,
                     seed: int = 0, eos_id: int = -1, serve_window: int = 0,
                     params=None, prompts=None, engine: Optional[ServeEngine] = None,
                     device=None):
    """Continuous-batching serve of an open-loop arrival stream.

    ``n_requests`` synthetic requests arrive as a Poisson process
    (``arrival_rate`` req/s; 0 → all at t=0), offsets on the host clock,
    and are admitted into freed slots between dispatches.  Each round is
    ONE dispatch — ``admit_decode`` when any slot was admitted, ``decode``
    otherwise — then one host sync (the admission point).  The rows of
    slots not admitted in a round are zero prompts.  Slots are recycled
    without a copy: each round's outputs are the next round's inputs, in
    the engine's shared graph buffers.

    Returns ``(results, stats)``: a :class:`RequestResult` per request
    (its tokens equal serving it alone) and the reference's stats —
    ``total_s``, ``total_tokens``, ``tok_per_s``, ``p50_ms``, ``p99_ms``,
    ``dispatches``, ``admit_dispatches``, ``decode_dispatches``,
    ``prefill_dispatches`` and ``sync_points`` — with ``graph_launches``
    per dispatch kind.
    """
    eng = engine or ServeEngine(cfg, slots=slots, prompt_len=prompt_len,
                                max_new=max_new, chunk=chunk, eos_id=eos_id,
                                serve_window=serve_window, device=device)
    if (eng.slots != slots or eng.prompt_len != prompt_len or eng.max_new < max_new
            or eng.eos_id != int(eos_id)):
        raise ValueError("serve_continuous: the engine's slots, prompt_len, max_new "
                         "and eos_id do not match")
    dev = eng.device
    rng = np.random.RandomState(seed)
    if params is None:
        params = eng.model.init(seed, device=dev)
    all_prompts = (synthetic_batch(cfg, rng, n_requests, prompt_len, device=dev)
                   if prompts is None else prompts)
    rows = {k: v.cpu().numpy() for k, v in all_prompts.items()}
    arrivals = poisson_arrivals(n_requests, arrival_rate, np.random.RandomState(seed + 1))

    caches, tok, active, rem = eng.init_state()
    slot_req = np.full(slots, -1)          # request id per slot
    emitted: List[List[int]] = [[] for _ in range(n_requests)]
    results: List[Optional[RequestResult]] = [None] * n_requests
    next_req = n_done = 0
    base = {"prefill": eng.prefill.calls, "admit": eng.admit_decode.calls,
            "decode": eng.decode.calls, "dispatches": eng.dispatches,
            "graphs": eng.graph_launches}
    _sync(dev)
    t0 = time.perf_counter()

    while n_done < n_requests:
        now = time.perf_counter() - t0
        free = [s for s in range(slots) if slot_req[s] < 0]
        admit_ids: List[Tuple[int, int]] = []   # (slot, rid)
        while free and next_req < n_requests and arrivals[next_req] <= now:
            admit_ids.append((free.pop(0), next_req))
            next_req += 1
        if not admit_ids and not (slot_req >= 0).any():
            # idle: nothing in flight, nothing arrived yet
            time.sleep(min(max(arrivals[next_req] - now, 0.0), 0.01))
            continue

        if admit_ids:
            admit_np = np.zeros(slots, bool)
            new_rem = np.zeros(slots, np.int32)
            batch_rows = {k: np.zeros((slots,) + v.shape[1:], v.dtype)
                          for k, v in rows.items()}
            for s, rid in admit_ids:
                admit_np[s] = True
                new_rem[s] = max_new
                slot_req[s] = rid
                for k in rows:
                    batch_rows[k][s] = rows[k][rid]
            batch_in = {k: torch.from_numpy(v).to(dev) for k, v in batch_rows.items()}
            caches, tok, active, rem, first, out, n_emit = eng.admit_decode(
                params, caches, tok, active, rem, batch_in,
                torch.from_numpy(admit_np).to(dev), torch.from_numpy(new_rem).to(dev))
        else:
            caches, tok, active, rem, out, n_emit = eng.decode(params, caches, tok,
                                                               active, rem)
            first = None

        # ONE host sync per round: the admission point
        out_np = out.cpu().numpy()
        act_np = active.cpu().numpy()
        first_np = first.cpu().numpy() if first is not None else None
        eng.sync_points += 1
        t_round = time.perf_counter() - t0

        for s in range(slots):
            rid = slot_req[s]
            if rid < 0:
                continue
            if first_np is not None and first_np[s] != PAD_TOKEN:
                emitted[rid].append(int(first_np[s]))
            emitted[rid].extend(int(t) for t in out_np[s] if t != PAD_TOKEN)
            if not act_np[s]:
                results[rid] = RequestResult(
                    rid=int(rid), tokens=np.asarray(emitted[rid], np.int32),
                    t_arrive=float(arrivals[rid]), t_done=t_round)
                slot_req[s] = -1
                n_done += 1

    t_total = time.perf_counter() - t0
    lat = np.asarray([r.latency_s for r in results])
    total_tokens = int(sum(len(e) for e in emitted))
    stats = {
        "total_s": t_total,
        "total_tokens": total_tokens,
        "tok_per_s": total_tokens / max(t_total, 1e-9),
        "p50_ms": float(np.percentile(lat, 50) * 1e3),
        "p99_ms": float(np.percentile(lat, 99) * 1e3),
        "dispatches": eng.dispatches - base["dispatches"],
        "admit_dispatches": eng.admit_decode.calls - base["admit"],
        "decode_dispatches": eng.decode.calls - base["decode"],
        "prefill_dispatches": eng.prefill.calls - base["prefill"],
        "sync_points": eng.sync_points,
        "graph_launches": {k: n - base["graphs"][k]
                           for k, n in eng.graph_launches.items()},
    }
    return results, stats


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", default="1x1",
                    help="one card holds the model: only 1x1")
    ap.add_argument("--device", default=None,
                    help="the device (default: the card; 'cpu' runs on the host)")
    ap.add_argument("--serve-window", type=int, default=0,
                    help="windowed-attention serving cap (0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--host-stepped", action="store_true",
                    help="one dispatch per token (the baseline)")
    ap.add_argument("--requests", type=int, default=0,
                    help="continuous-batching mode: serve N requests")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate (req/s); 0 = t=0 burst")
    ap.add_argument("--chunk", type=int, default=4,
                    help="decode chunk between admission points")
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        ap.error(f"--mesh {args.mesh}: the port serves on one card (1x1)")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()

    if args.requests:
        results, stats = serve_continuous(
            cfg, slots=args.batch, prompt_len=args.prompt_len, max_new=args.gen,
            n_requests=args.requests, chunk=args.chunk, arrival_rate=args.rate,
            seed=args.seed, eos_id=args.eos_id, serve_window=args.serve_window,
            device=args.device)
        print(f"served {len(results)} requests ({stats['total_tokens']} tokens)")
        print({k: round(v, 4) if isinstance(v, float) else v for k, v in stats.items()})
        return

    gen, stats = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                       gen_len=args.gen, seed=args.seed, serve_window=args.serve_window,
                       eos_id=args.eos_id, device_resident=not args.host_stepped,
                       device=args.device)
    print("generated tokens (first row):", gen[0][:16])
    print({k: round(v, 4) if isinstance(v, float) else v for k, v in stats.items()})


if __name__ == "__main__":
    main()
