"""Step builders — port of ``repro.launch.steps``.

For a (ModelConfig, ShapeConfig, Mesh) triple this module resolves every
leaf of a step's inputs and outputs (params, optimizer state, batch,
caches) to a spec through the logical rules (:mod:`repro_torch.parallel`)
and returns a :class:`StepBundle`: the step callable, its ``in_specs``
and ``out_specs``, and ``meta`` stand-ins of its inputs
(``input_specs``), which :meth:`StepBundle.trace` runs the step over
with every dot counted (the reference's ``lower()``; the dry run,
:mod:`.dryrun`, reads it).  Each step runs inside ``sharding_ctx(rules,
mesh)``, as the reference's does, so the MoE configs take the
expert-parallel path (``models/moe.py`` ``apply_moe_ep``).

* :func:`build_train_step`: one AdamW step of ``Model.loss``, split as
  the reference's into its two ST queues: ``grad_fn(params, batch) ->
  (grads, metrics)`` (forward and backward) and ``apply_fn(params,
  opt_state, grads) -> (params, opt_state, metrics)`` (clip, schedule,
  AdamW);
* :func:`build_prefill_step`: ``Model.prefill`` into fresh caches;
* :func:`build_serve_step`: ``Model.decode_step`` (``per_seq_pos`` for
  per-slot depths);
* :func:`build_bundle`: the one of the three a shape's kind names.

The port runs on one card: with real tensors the mesh must be ``1x1``
(``make_mesh((1, 1), ("data", "model"), device=...)``), and its device is
where the step runs; a mesh on the ``meta`` device (the production
meshes of :mod:`.mesh`) may have any shape, and its bundles are traced,
not run.  :func:`tp_block_schedule` composes a tensor-parallel block's
ring collectives with other ST programs.

Params and optimizer state are updated IN PLACE (:mod:`repro_torch.optim`)
and returned; a caller keeps passing the same trees.

:func:`persistent_steps` folds N steps into ONE dispatch, and
:func:`pipelined_steps` software-pipelines them (the apply of step i-1
after the gradients of step i, which read the params before that apply:
the reference's staleness-1 semantics).  On CPU tensors a dispatch is an
eager loop.  On the card it is ONE CUDA-graph launch:

* a fixed count: the N steps (forward, backward and AdamW each) captured
  into one graph at the first call, replayed after the batch has been
  copied into its static buffer;
* ``until=`` (e.g. :func:`loss_plateau`): a conditional WHILE node
  (:class:`repro_torch.kernels.graph_loop.GraphLoop`), whose body is one
  step indexed by the device counter ``n_done``: it reads batch
  ``n_done`` of the stack, writes its metrics at ``n_done`` of
  preallocated ``[N]`` buffers, leaves the loss in the loop's reduction
  and the predicate, evaluated on the device, in its ``keep`` flag; the
  ``loop_step`` kernel counts the step and stops the loop.

The first call of a graph is set-up: a warm-up of ``grad_fn`` (which
changes no state), the capture, then the launch.  A graph reads the
params and optimizer state at the addresses it was captured with, so a
call with other tensors captures a new one.  The metrics returned on the
card are the graph's own buffers, overwritten by its next launch (as the
serve engine's outputs are); ``steps_done`` is a device tensor, and
reading it is the one host sync of a dispatch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.synthetic import make_batch_specs
from repro_torch.kernels import graph_loop
from repro_torch.mesh import Mesh
from repro_torch.models import Model
from repro_torch.models.model import map_axes
from repro_torch.models.nn import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, linear_warmup_cosine
from repro_torch.parallel import (
    RULES_DECODE,
    RULES_LONG_DECODE,
    RULES_TRAIN,
    LogicalRules,
    logical_spec_sized,
    shard_shape,
    sharding_ctx,
)

#: the metrics of a train step, each a 0-d float32 tensor
TRAIN_METRICS = ("ce", "loss", "grad_norm", "lr")


def rules_for(shape: ShapeConfig) -> LogicalRules:
    if shape.kind == "train" or shape.kind == "prefill":
        return RULES_TRAIN if shape.kind == "train" else RULES_DECODE
    return RULES_LONG_DECODE if shape.global_batch == 1 else RULES_DECODE


def _tree_specs(tree, axes_tree, rules: LogicalRules, mesh: Mesh):
    """Each leaf's spec, indivisible dims falling back to replicated."""
    return map_axes(lambda ax, t: logical_spec_sized(t.shape, ax, rules, mesh),
                    axes_tree, tree)


def tree_bytes(tree, specs, mesh: Mesh) -> int:
    """Bytes one device of ``mesh`` holds of ``tree`` under ``specs`` (a
    tree of specs shaped like it; a spec ``None`` or ``()`` replicates)."""
    def leaf(spec, t):
        shard = shard_shape(t.shape, spec or (), mesh)
        n = 1
        for d in shard:
            n *= d
        return n * t.element_size()
    return sum(tree_leaves(map_axes(leaf, _spec_tree(specs, tree), tree)))


def _spec_tree(specs, tree):
    """``specs`` with a ``None`` standing for a replicated subtree spelled
    out leaf for leaf (``out_specs``' train metrics)."""
    if specs is None:
        return tree_map(lambda _: (), tree) if isinstance(tree, (dict, list)) else ()
    if isinstance(specs, dict):
        return {k: _spec_tree(specs[k], tree[k]) for k in tree}
    if isinstance(specs, list):
        return [_spec_tree(a, t) for a, t in zip(specs, tree)]
    return specs


def _check_mesh(mesh: Mesh) -> None:
    if mesh.size != 1 and mesh.device.type != "meta":
        raise ValueError(f"the port runs on one card: a bundle with real tensors takes a 1x1 "
                         f"mesh, got {mesh.shape} (a mesh on the meta device may take any "
                         f"shape, for a dry run)")


@dataclasses.dataclass
class StepBundle:
    """A step, its specs and what its multi-step wrappers need: the
    per-step batch shapes (to tell a stacked batch from a broadcast one)
    and, for a train step, the grad / apply split (``step_fn == apply ∘
    grad``).  ``in_specs`` and ``out_specs`` mirror the step's arguments
    and results (a spec ``None``: replicated, the train metrics);
    ``input_specs`` holds ``meta`` stand-ins of the arguments."""

    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Mesh
    model: Model
    step_fn: Callable
    batch_shapes: Dict[str, Tuple[int, ...]]
    grad_fn: Optional[Callable] = None
    apply_fn: Optional[Callable] = None
    rules: Optional[LogicalRules] = None
    in_specs: Any = None
    out_specs: Any = None
    input_specs: Tuple = ()

    def trace(self):
        """Run ``step_fn`` once over the ``meta`` ``input_specs``, every
        dot counted (the reference's ``lower()``): returns ``(outputs,
        DotStats, seconds)`` (:func:`.trace_analysis.trace_dots`)."""
        from .trace_analysis import trace_dots
        return trace_dots(self.step_fn, *self.input_specs)

    def argument_bytes(self) -> int:
        """Bytes of the step's arguments one device of the mesh holds."""
        return tree_bytes(list(self.input_specs), list(self.in_specs), self.mesh)

    def output_bytes(self, outputs) -> int:
        """Bytes of the step's ``outputs`` (of :meth:`trace`) one device
        of the mesh holds."""
        return tree_bytes(list(outputs), list(self.out_specs), self.mesh)


def _rebuild(tree, leaves: List[torch.Tensor]):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _batch_specs(cfg: ModelConfig, shape: ShapeConfig, model: Model, rules, mesh):
    """The step's ``meta`` batch and its specs."""
    batch_axes = make_batch_specs(cfg, shape)
    raw = model.input_specs(shape)
    return raw, {k: logical_spec_sized(v.shape, batch_axes[k], rules, mesh)
                 for k, v in raw.items()}


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                     opt: Optional[AdamWConfig] = None,
                     total_steps: int = 10_000) -> StepBundle:
    if shape.kind != "train":
        raise ValueError(f"build_train_step takes a train shape, got {shape.kind!r}")
    _check_mesh(mesh)
    rules = RULES_TRAIN
    model = Model(cfg)
    opt = opt or AdamWConfig()

    def grad_step(params, batch):
        # grads of aliases of the leaves: the caller's tensors keep their
        # flags, and the in-place apply later needs no autograd bookkeeping.
        # A leaf the loss reaches only through indices (the MoE router's
        # balancing bias, read by top-k) gets zeros, as from jax.grad
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad(), sharding_ctx(rules, mesh):
            loss, metrics = model.loss(_rebuild(params, live), batch)
            grads = torch.autograd.grad(loss, live, allow_unused=True,
                                        materialize_grads=True)
        return _rebuild(params, list(grads)), {k: v.detach() for k, v in metrics.items()}

    def apply_step(params, opt_state, grads):
        lr = linear_warmup_cosine(opt_state["step"], base_lr=opt.lr,
                                  warmup_steps=max(total_steps // 50, 10),
                                  total_steps=total_steps)
        return adamw_update(params, grads, opt_state, opt, lr=lr)

    def train_step(params, opt_state, batch):
        grads, metrics = grad_step(params, batch)
        params, opt_state, opt_metrics = apply_step(params, opt_state, grads)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    params = model.abstract_init()
    param_specs = _tree_specs(params, model.param_axes(), rules, mesh)
    opt_specs = {"m": param_specs, "v": param_specs, "step": ()}
    batch, batch_specs = _batch_specs(cfg, shape, model, rules, mesh)
    batch_shapes = {k: (shape.global_batch, shape.seq_len) for k in make_batch_specs(cfg, shape)}
    return StepBundle(cfg, shape, mesh, model, train_step, batch_shapes,
                      grad_fn=grad_step, apply_fn=apply_step, rules=rules,
                      in_specs=(param_specs, opt_specs, batch_specs),
                      out_specs=(param_specs, opt_specs, None),
                      input_specs=(params, adamw_init(params, opt), batch))


# --------------------------------------------------------------------------
# prefill / decode
# --------------------------------------------------------------------------


def _cache_specs(caches, model: Model, rules: LogicalRules, mesh: Mesh,
                 per_seq_pos: bool = False):
    return _tree_specs(caches, model.cache_axes(per_sequence=per_seq_pos), rules, mesh)


def _logits_spec(cfg: ModelConfig, B: int, rules: LogicalRules, mesh: Mesh):
    return logical_spec_sized((B, cfg.vocab), ("batch", "act_vocab"), rules, mesh)


def build_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                       serve_window: int = 0) -> StepBundle:
    """``Model.prefill`` of a ``[B, S]`` prompt batch into caches of ``S``
    plus the prefix; ``step_fn(params, batch, caches) -> (last_logits,
    caches)``.  The depth the prompt starts at is read from real caches
    (a host sync) and is 0 on ``meta`` ones, the stand-ins' zeroed
    caches."""
    if shape.kind != "prefill":
        raise ValueError(f"build_prefill_step takes a prefill shape, got {shape.kind!r}")
    _check_mesh(mesh)
    rules = RULES_DECODE
    model = Model(cfg)
    params = model.abstract_init()
    param_specs = _tree_specs(params, model.param_axes(), rules, mesh)
    B, S = shape.global_batch, shape.seq_len
    caches = model.init_caches(B, S + model._prefix_len(), device="meta")
    cache_specs = _cache_specs(caches, model, rules, mesh)
    batch, batch_specs = _batch_specs(cfg, shape, model, rules, mesh)

    def prefill_step(params, batch, caches):
        depth = 0 if caches["pos"].device.type == "meta" else None
        with sharding_ctx(rules, mesh):
            return model.prefill(params, batch, caches, serve_window=serve_window,
                                 depth=depth)

    return StepBundle(cfg, shape, mesh, model, prefill_step,
                      {k: tuple(v.shape) for k, v in batch.items()}, rules=rules,
                      in_specs=(param_specs, batch_specs, cache_specs),
                      out_specs=(_logits_spec(cfg, B, rules, mesh), cache_specs),
                      input_specs=(params, batch, caches))


def build_serve_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                     serve_window: int = 0, per_seq_pos: bool = False) -> StepBundle:
    """The decode-step bundle, ``step_fn(params, caches, token) ->
    (logits, caches)`` against caches of ``S`` entries.  ``per_seq_pos=True``
    sizes the caches with a ``[batch]`` position vector (each slot at its
    own depth), as continuous batching needs."""
    if shape.kind != "decode":
        raise ValueError(f"build_serve_step takes a decode shape, got {shape.kind!r}")
    _check_mesh(mesh)
    rules = rules_for(shape)
    model = Model(cfg)
    params = model.abstract_init()
    param_specs = _tree_specs(params, model.param_axes(), rules, mesh)
    B, S = shape.global_batch, shape.seq_len
    caches = model.init_caches(B, S, per_sequence=per_seq_pos, device="meta")
    cache_specs = _cache_specs(caches, model, rules, mesh, per_seq_pos=per_seq_pos)
    token = model.input_specs(shape)["token"]
    token_spec = logical_spec_sized((B,), ("batch",), rules, mesh)

    def serve_step(params, caches, token):
        with sharding_ctx(rules, mesh):
            return model.decode_step(params, caches, token, serve_window=serve_window)

    return StepBundle(cfg, shape, mesh, model, serve_step, {"token": (B,)}, rules=rules,
                      in_specs=(param_specs, cache_specs, token_spec),
                      out_specs=(_logits_spec(cfg, B, rules, mesh), cache_specs),
                      input_specs=(params, caches, token))


def loss_plateau(eps: float = 1e-4, key: str = "loss"):
    """An ``until(metrics, i)`` continue-predicate for
    :func:`persistent_steps`: keep stepping while the last two values of
    ``metrics[key]`` differ by more than ``eps`` (the first two steps
    always run).  ``i`` (the steps done) may be an int or a 0-d device
    tensor; the result is a 0-d bool tensor on ``metrics[key]``'s device,
    so the graphed loop evaluates it without the host."""

    def cond(metrics, i):
        trace = metrics[key]
        i = torch.as_tensor(i, device=trace.device).long().reshape(())
        last = trace.index_select(0, (i - 1).clamp(min=0).reshape(1)).reshape(())
        before = trace.index_select(0, (i - 2).clamp(min=0).reshape(1)).reshape(())
        return torch.logical_or(i < 2, torch.abs(last - before) > eps)

    return cond


def _is_stacked(bundle: StepBundle, n_iters: int, stacked: Optional[bool], batch) -> bool:
    """The stacked-vs-broadcast regime of ``batch``, inferred from the
    per-step shapes as the reference's ``_batch_indexer`` does."""
    if stacked is not None:
        return bool(stacked)
    leaves = [batch[k] for k in sorted(batch)]
    want = [bundle.batch_shapes.get(k) for k in sorted(batch)]
    if all(w is not None for w in want):
        if all(tuple(l.shape) == tuple(w) for l, w in zip(leaves, want)):
            return False
        if all(tuple(l.shape) == (n_iters, *w) for l, w in zip(leaves, want)):
            return True
        raise ValueError("batch shapes match neither the per-step spec nor the "
                         f"stacked (n_iters={n_iters}, ...) spec")
    return bool(leaves) and all(l.dim() >= 1 and l.shape[0] == n_iters for l in leaves)


def _batch_at(batch, is_stacked: bool, i: int):
    return {k: v[i] for k, v in batch.items()} if is_stacked else batch


def _device(tree) -> torch.device:
    return tree_leaves(tree)[0].device


def _record(mets: Dict[str, torch.Tensor], m: Dict[str, torch.Tensor], i: int,
            n_iters: int) -> None:
    """``mets[k][i] = m[k]``, allocating ``[n_iters, ...]`` zeros at first."""
    for k, v in m.items():
        if k not in mets:
            mets[k] = torch.zeros((n_iters, *v.shape), dtype=v.dtype, device=v.device)
        mets[k][i] = v


class _Dispatch:
    """A multi-step ``step_fn``: one eager loop (CPU) or one CUDA-graph
    launch (card) a call.  ``dispatches`` counts the calls, ``captures``
    the graphs built."""

    def __init__(self, eager: Callable, build: Callable):
        self._eager, self._build = eager, build
        self._graphs: Dict[tuple, Any] = {}
        self.dispatches = 0
        self.captures = 0

    def __call__(self, params, opt_state, batch):
        self.dispatches += 1
        if _device(params).type != "cuda":
            return self._eager(params, opt_state, batch)
        key = (tuple(t.data_ptr() for t in tree_leaves((params, opt_state))),
               tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items())))
        graph = self._graphs.get(key)
        if graph is None:
            self._graphs.clear()  # the old tensors are gone: free their graph
            graph = self._graphs[key] = self._build(params, opt_state, batch)
            self.captures += 1
        return graph(params, opt_state, batch)


def _warm_up(bundle: StepBundle, params, batch) -> None:
    """One ``grad_fn`` on a side stream (it changes no state): the lazy
    initialisations a capture must not meet."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        bundle.grad_fn(params, batch)
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    # the warm-up's cached blocks are released: the capture's private
    # pool needs as much again (at mamba2-2.7b, tens of GB)
    torch.cuda.empty_cache()


class _FixedGraph:
    """``body(params, opt_state, static_batch) -> metrics`` (N steps)
    captured into ONE graph over a static copy of the batch."""

    def __init__(self, bundle, body, params, opt_state, batch, is_stacked):
        self.batch = {k: torch.empty_like(v, device=_device(params)) for k, v in batch.items()}
        for k, v in batch.items():
            self.batch[k].copy_(v)
        _warm_up(bundle, params, _batch_at(self.batch, is_stacked, 0))
        self.graph, self.mets = graph_loop.capture(
            lambda: body(params, opt_state, self.batch), keep_graph=False)
        self.replays = 0

    def __call__(self, params, opt_state, batch):
        for k, v in batch.items():
            if self.batch[k].data_ptr() != v.data_ptr():
                self.batch[k].copy_(v)
        self.graph.replay()
        self.replays += 1
        return params, opt_state, self.mets


class _PlateauGraph:
    """Up to N steps in ONE launch of a graph-loop WHILE node (see the
    module docstring): passes A and B are the same step, captured twice
    over one memory pool; the parity selects zero the metrics past
    ``steps_done``."""

    def __init__(self, bundle, until, n_iters, params, opt_state, batch, is_stacked):
        dev = _device(params)
        self.batch = {k: torch.empty_like(v, device=dev) for k, v in batch.items()}
        for k, v in batch.items():
            self.batch[k].copy_(v)
        self.n_done = torch.zeros((), dtype=torch.int32, device=dev)
        self.red = torch.zeros((), dtype=torch.float32, device=dev)
        self.keep = torch.zeros((), dtype=torch.bool, device=dev)
        self.reductions = torch.zeros(n_iters, dtype=torch.float32, device=dev)
        steps = torch.arange(n_iters, device=dev)
        # allocated before the capture: a buffer allocated inside it could
        # take a block that the pass's own temporaries wrote earlier, and
        # every trip would overwrite the metrics of the trips before
        self.mets = {k: torch.zeros(n_iters, dtype=torch.float32, device=dev)
                     for k in TRAIN_METRICS}
        inner = bundle.step_fn

        def one_step():
            idx = self.n_done.reshape(1).long()
            b = ({k: v.index_select(0, idx)[0] for k, v in self.batch.items()}
                 if is_stacked else self.batch)
            _, _, m = inner(params, opt_state, b)
            if set(m) != set(self.mets):
                raise ValueError(f"the step's metrics {sorted(m)} are not "
                                 f"TRAIN_METRICS {sorted(self.mets)}")
            for k, v in m.items():
                self.mets[k].index_copy_(0, idx, v.reshape(1).to(torch.float32))
            self.red.copy_(m["loss"])
            self.keep.copy_(torch.as_tensor(until(self.mets, self.n_done + 1)).reshape(()))

        def finish():
            for v in self.mets.values():
                v.masked_fill_((steps >= self.n_done).reshape(-1, *[1] * (v.dim() - 1)), 0)

        _warm_up(bundle, params, _batch_at(self.batch, is_stacked, 0))
        pass_a, _ = graph_loop.capture(one_step)
        pass_b, _ = graph_loop.capture(one_step, pool=pass_a.pool())
        selects = [graph_loop.capture(finish, pool=pass_a.pool())[0] for _ in range(2)]
        for g in (pass_a, pass_b):
            bad = set(graph_loop.node_types(g)) & set(graph_loop.NOT_IN_A_BODY)
            if bad:
                raise RuntimeError(f"a train step's graph holds {sorted(bad)} nodes, which a "
                                   f"conditional body may not hold")
        self.loop = graph_loop.GraphLoop(pass_a, pass_b, self.red, self.keep,
                                         self.reductions, self.n_done, n_iters,
                                         select_even=selects[0], select_odd=selects[1])
        self.replays = 0

    def __call__(self, params, opt_state, batch):
        for k, v in batch.items():
            if self.batch[k].data_ptr() != v.data_ptr():
                self.batch[k].copy_(v)
        self.loop.launch()
        self.replays += 1
        return params, opt_state, {**self.mets, "steps_done": self.n_done}


def persistent_steps(bundle: StepBundle, n_iters: int, *,
                     until=None, stacked: Optional[bool] = None) -> StepBundle:
    """ONE dispatch for up to ``n_iters`` train steps (see the module
    docstring).  The batch carries a leading ``n_iters`` axis (one slice a
    step) or keeps the per-step shape (the same batch every step);
    ``stacked`` forces the reading.  Metrics come back stacked ``[n_iters,
    ...]`` (zero past the steps run) with ``steps_done``.  With
    ``until(metrics, i)`` the loop keeps stepping while it holds (``i``
    the steps done), up to ``n_iters``."""
    if n_iters < 1:
        raise ValueError(f"n_iters must be >= 1, got {n_iters}")
    inner = bundle.step_fn

    def eager(params, opt_state, batch):
        is_stacked = _is_stacked(bundle, n_iters, stacked, batch)
        mets: Dict[str, torch.Tensor] = {}
        done = 0
        for i in range(n_iters):
            params, opt_state, m = inner(params, opt_state, _batch_at(batch, is_stacked, i))
            _record(mets, m, i, n_iters)
            done = i + 1
            if until is not None and not bool(until(mets, done)):
                break
        mets["steps_done"] = torch.tensor(done, dtype=torch.int32)
        return params, opt_state, mets

    def body(params, opt_state, batch, is_stacked):
        mets: Dict[str, torch.Tensor] = {}
        for i in range(n_iters):
            _, _, m = inner(params, opt_state, _batch_at(batch, is_stacked, i))
            _record(mets, m, i, n_iters)
        mets["steps_done"] = torch.full((), n_iters, dtype=torch.int32,
                                        device=_device(params))
        return mets

    def build(params, opt_state, batch):
        is_stacked = _is_stacked(bundle, n_iters, stacked, batch)
        if until is not None:
            return _PlateauGraph(bundle, until, n_iters, params, opt_state, batch, is_stacked)
        return _FixedGraph(bundle, lambda p, o, b: body(p, o, b, is_stacked), params,
                           opt_state, batch, is_stacked)

    return dataclasses.replace(bundle, step_fn=_Dispatch(eager, build))


def build_persistent_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                                n_iters: int, until=None, stacked: Optional[bool] = None,
                                **kwargs) -> StepBundle:
    """:func:`build_train_step`, then up to ``n_iters`` steps a dispatch
    via :func:`persistent_steps`."""
    return persistent_steps(build_train_step(cfg, shape, mesh, **kwargs),
                            n_iters, until=until, stacked=stacked)


def pipelined_steps(bundle: StepBundle, n_iters: int, *,
                    stacked: Optional[bool] = None) -> StepBundle:
    """Software-pipelined multi-step dispatch (the reference's)::

        g_0 = grad(p_0, batch_0)
        for i in 1..n-1:
            g_i = grad(p_{i-1}, batch_i)     # reads the params before ...
            p_i = apply(p_{i-1}, g_{i-1})    # ... this apply writes them
        p_n = apply(p_{n-1}, g_{n-1})

    Step i's gradients are taken at params without step i-1's update
    (staleness 1); ``n_iters=1`` is the plain step.  The apply works in
    place, so the order above is kept on one stream (running the two on
    two streams is speed work for later).  Metrics are stacked as in
    :func:`persistent_steps`: slot i holds step i's grad metrics and the
    metrics of applying step i's gradients."""
    if n_iters < 1:
        raise ValueError(f"n_iters must be >= 1, got {n_iters}")
    if bundle.grad_fn is None or bundle.apply_fn is None:
        raise ValueError("pipelined_steps needs the grad/apply phase split "
                         "(bundle.grad_fn/apply_fn): build the bundle with "
                         "build_train_step")
    grad_fn, apply_fn = bundle.grad_fn, bundle.apply_fn

    def run(params, opt_state, batch, is_stacked, device):
        mets: Dict[str, torch.Tensor] = {}
        g_prev, gmet = grad_fn(params, _batch_at(batch, is_stacked, 0))
        _record(mets, gmet, 0, n_iters)
        for i in range(1, n_iters):
            g_i, gmet = grad_fn(params, _batch_at(batch, is_stacked, i))
            params, opt_state, omet = apply_fn(params, opt_state, g_prev)
            overlap = set(gmet) & set(omet)
            if overlap:
                raise ValueError(f"grad/apply metrics keys collide: {sorted(overlap)}")
            _record(mets, gmet, i, n_iters)
            _record(mets, omet, i - 1, n_iters)
            g_prev = g_i
        params, opt_state, omet = apply_fn(params, opt_state, g_prev)
        _record(mets, omet, n_iters - 1, n_iters)
        mets["steps_done"] = torch.full((), n_iters, dtype=torch.int32, device=device)
        return params, opt_state, mets

    def eager(params, opt_state, batch):
        is_stacked = _is_stacked(bundle, n_iters, stacked, batch)
        params, opt_state, mets = run(params, opt_state, batch, is_stacked, "cpu")
        return params, opt_state, mets

    def build(params, opt_state, batch):
        is_stacked = _is_stacked(bundle, n_iters, stacked, batch)
        body = lambda p, o, b: run(p, o, b, is_stacked, _device(p))[2]
        return _FixedGraph(bundle, body, params, opt_state, batch, is_stacked)

    return dataclasses.replace(bundle, step_fn=_Dispatch(eager, build))


def build_pipelined_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                               n_iters: int, stacked: Optional[bool] = None,
                               **kwargs) -> StepBundle:
    """:func:`build_train_step`, then ``n_iters`` pipelined steps a
    dispatch via :func:`pipelined_steps`."""
    return pipelined_steps(build_train_step(cfg, shape, mesh, **kwargs),
                           n_iters, stacked=stacked)


def build_bundle(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, **kwargs) -> StepBundle:
    """The train, prefill or decode bundle of ``shape``'s kind; a decode of
    ``long_500k`` takes the config's serving window, as the reference's
    does."""
    serve_window = cfg.serve_window if shape.name == "long_500k" else 0
    if shape.kind == "train":
        return build_train_step(cfg, shape, mesh, **kwargs)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, shape, mesh, serve_window=serve_window, **kwargs)
    return build_serve_step(cfg, shape, mesh, serve_window=serve_window, **kwargs)


# -- collective-matmul wiring --------------------------------------------------


def tp_block_schedule(mesh: Mesh, axis: str, m: int, k: int, f: int, *,
                      companions: Sequence[Any] = (), dtype=torch.float32,
                      bidirectional: bool = False, interleave: Any = "round_robin",
                      verify: str = "error", name: Optional[str] = None):
    """A tensor-parallel block's collectives composed INTO one schedule
    with other queues (a halo exchange, pipeline stages): the Megatron MLP
    ST program (:func:`repro_torch.core.collectives.build_tp_block`:
    all-gather-matmul → relu → matmul-reduce-scatter, every ring step a
    trigger→wait channel) fused with ``companions`` (built STPrograms)
    by :func:`repro_torch.core.schedule.compose`, so that the whole step
    runs as ONE dispatch.  Returns ``(schedule_or_program, tp)``, ``tp``
    the :class:`~repro_torch.core.collectives.CollectiveMatmul` with the
    TP program's buffer names and oracles; with no companions the bare TP
    program.  Under composition the TP buffers are named
    ``"{tp.program.name}/{buffer}"``."""
    from repro_torch.core.collectives import build_tp_block
    from repro_torch.core.schedule import compose

    tp = build_tp_block(mesh, axis, m, k, f, dtype, bidirectional=bidirectional,
                        verify="warn")
    if not companions:
        return tp.program, tp
    sched = compose(tp.program, *companions, interleave=interleave, verify=verify,
                    name=name or "tp_block_sched")
    return sched, tp
