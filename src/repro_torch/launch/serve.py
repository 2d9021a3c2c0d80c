"""Serving — port of ``repro.launch.serve`` (``ServeEngine``, ``serve``).

The greedy-decode control loop runs device-resident: ``chunk`` decode
steps captured into ONE CUDA graph, with the reference's per-slot
masking (EOS, the ``rem`` token budget and cache capacity stop a slot;
a stopped slot's ``pos`` freezes and it emits ``PAD_TOKEN``).  The
host-stepped baseline replays a one-step graph once per token.  Prefill
is ONE graph launch too, one graph per (slots, prompt length, cache
depth): the depth is read on the host before the graph is looked up,
and its SSD scans, flash attention and norms take the hand-written
kernels.  On the CPU the same functions run eagerly.  Attention caches
hold ``prompt_len + max_new`` entries.  ``serve_window`` narrows the
attention windows as the reference's does
(``transformer.layer_window_theta``).  On one
GPU there is no mesh or sharding bundle: the engine calls the model
directly.  ``admit_decode`` and ``serve_continuous`` are not ported yet
(``ROADMAP.md``).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.mesh import resolve_device
from repro_torch.models import Model
from repro_torch.models.nn import tree_leaves, tree_map

#: emission marker for a slot that was not active at a given decode step
PAD_TOKEN = -1
#: the engine's dispatch kinds, each a CUDA-graph launch on the card
DISPATCH_KINDS = ("prefill", "decode", "decode_one")


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
    reference's donated buffers are.  ``replays`` counts the launches;
    ``kernel_launches`` holds the hand-written kernels' launches recorded
    into the graph (each replay runs them again)."""

    def __init__(self, fn: Callable, params, state):
        self.params = params
        self.state = tree_map(torch.clone, state)
        self.replays = 0
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):   # warm-up on scratch copies
            fn(params, *tree_map(torch.clone, state))
        torch.cuda.current_stream().wait_stream(stream)
        self.graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts()
        with torch.cuda.graph(self.graph):
            new_state, self.extras = fn(params, *self.state)
            for dst, src in zip(tree_leaves(self.state), tree_leaves(new_state)):
                if dst is not src:
                    dst.copy_(src)
        self.kernel_launches = {k: n - before[k] for k, n in ops.launch_counts().items()}

    def __call__(self, state):
        for dst, src in zip(tree_leaves(self.state), tree_leaves(state)):
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        self.graph.replay()
        self.replays += 1
        return self.state, self.extras


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

    ``device=None`` means the current CUDA device and raises without a
    GPU; on ``device="cpu"`` the same functions run eagerly.  The first
    call of each graph is set-up: one eager warm-up pass, the capture,
    then the launch.  ``dispatches`` counts calls (a resident serve: 2,
    one of them decode); ``graph_launches`` counts graph replays per
    dispatch kind.  The engine casts the large weights to ``cfg.dtype``
    once per params tree it is given.
    """

    def __init__(self, cfg: ModelConfig, *, slots: int, prompt_len: int,
                 max_new: int, chunk: Optional[int] = None, eos_id: int = -1,
                 serve_window: int = 0, device=None):
        self.device = resolve_device(device, "ServeEngine")
        self.cfg = cfg
        self.slots, self.prompt_len, self.max_new = slots, prompt_len, max_new
        self.eos_id, self.serve_window = int(eos_id), int(serve_window)
        self.model = Model(cfg)
        self.capacity = prompt_len + max_new
        self.chunk = int(chunk) if chunk else max(max_new - 1, 1)
        self.sync_points = 0
        self._cast = None      # (params, params with cast weights)
        self._graphs: Dict[tuple, _Graph] = {}   # by (kind, key...)
        self._retired = dict.fromkeys(DISPATCH_KINDS, 0)  # replays of dropped graphs
        self.prefill = _Counted(self._prefill_fn)
        self.decode = _Counted(self._decode_fn)
        self.decode_one = _Counted(self._decode_one_fn)

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
        return self.prefill.calls + self.decode.calls + self.decode_one.calls

    @property
    def graph_launches(self) -> Dict[str, int]:
        """CUDA-graph launches per dispatch kind (``prefill``, ``decode``,
        ``decode_one``) since the engine was made; all 0 on the CPU."""
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

    def _graphed(self, key: tuple, fn: Callable, params, state):
        """``fn(params, *state)`` as one launch of the graph for ``key``
        (``(kind, ...)``) on the card, or eagerly on the CPU; returns
        ``(new_state, extras)``."""
        if self.device.type != "cuda":
            return fn(params, *state)
        g = self._graphs.get(key)
        if g is None or g.params is not params:
            g = self._graphs[key] = _Graph(fn, params, state)
        return g(state)

    # -- the three dispatch kinds -------------------------------------------------

    def _prefill_fn(self, params, batch_in, caches):
        depth = self.model.prefill_depth(caches)   # host sync: before any capture
        tokens = batch_in["tokens"]

        def step(p, tokens, caches):
            logits, caches = self.model.prefill(p, {"tokens": tokens}, caches,
                                                serve_window=self.serve_window,
                                                depth=depth)
            return (tokens, caches), logits

        (_, caches), logits = self._graphed(("prefill", tuple(tokens.shape), depth), step,
                                            self.cast_params(params), (tokens, caches))
        return logits, caches

    def _decode_fn(self, params, caches, tok, active, rem):
        (caches, tok, active, rem), (out, n) = self._graphed(
            ("decode",), self._decode_loop, self.cast_params(params),
            (caches, tok, active, rem))
        return caches, tok, active, rem, out, n

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
    """Synthetic prompts, token for token those of the reference for the
    same ``numpy.random.RandomState``."""
    tokens = rng.randint(0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    return {"tokens": torch.from_numpy(tokens).to(resolve_device(device,
                                                                 "synthetic_batch"))}


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
