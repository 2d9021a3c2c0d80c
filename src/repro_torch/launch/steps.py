"""Train step builders — port of the train half of ``repro.launch.steps``.

:func:`build_train_step` returns a :class:`StepBundle` whose ``step_fn``
is one AdamW step of ``Model.loss``, split as the reference's into its
two ST queues: ``grad_fn(params, batch) -> (grads, metrics)`` (forward
and backward) and ``apply_fn(params, opt_state, grads) -> (params,
opt_state, metrics)`` (clip, schedule, AdamW).  On one card there is no
sharding: ``mesh`` must be ``1x1`` (``make_mesh((1, 1), ("data",
"model"), device=...)``), and its device is where the step runs.

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
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.data.synthetic import make_batch_specs
from repro_torch.kernels import graph_loop
from repro_torch.mesh import Mesh
from repro_torch.models import Model
from repro_torch.models.nn import tree_leaves, tree_map
from repro_torch.optim import AdamWConfig, adamw_update, linear_warmup_cosine

#: the metrics of a train step, each a 0-d float32 tensor
TRAIN_METRICS = ("ce", "loss", "grad_norm", "lr")


@dataclasses.dataclass
class StepBundle:
    """A train step and what its multi-step wrappers need: the per-step
    batch shapes (to tell a stacked batch from a broadcast one) and the
    grad / apply split (``step_fn == apply ∘ grad``)."""

    cfg: ModelConfig
    shape: ShapeConfig
    mesh: Mesh
    model: Model
    step_fn: Callable
    batch_shapes: Dict[str, Tuple[int, ...]]
    grad_fn: Optional[Callable] = None
    apply_fn: Optional[Callable] = None


def _rebuild(tree, leaves: List[torch.Tensor]):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def build_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                     opt: Optional[AdamWConfig] = None,
                     total_steps: int = 10_000) -> StepBundle:
    if shape.kind != "train":
        raise ValueError(f"build_train_step takes a train shape, got {shape.kind!r}")
    if mesh.size != 1:
        raise ValueError(f"the port trains on one card: mesh 1x1 only, got {mesh.shape}")
    model = Model(cfg)
    opt = opt or AdamWConfig()

    def grad_step(params, batch):
        # grads of aliases of the leaves: the caller's tensors keep their
        # flags, and the in-place apply later needs no autograd bookkeeping.
        # A leaf the loss reaches only through indices (the MoE router's
        # balancing bias, read by top-k) gets zeros, as from jax.grad
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        with torch.enable_grad():
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

    batch_shapes = {k: (shape.global_batch, shape.seq_len) for k in make_batch_specs(cfg, shape)}
    return StepBundle(cfg, shape, mesh, model, train_step, batch_shapes,
                      grad_fn=grad_step, apply_fn=apply_step)


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
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.mets = body(params, opt_state, self.batch)
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
        pass_a = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(pass_a):
            one_step()
        pass_b = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(pass_b, pool=pass_a.pool()):
            one_step()
        selects = []
        for _ in range(2):
            g = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(g, pool=pass_a.pool()):
                finish()
            selects.append(g)
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
