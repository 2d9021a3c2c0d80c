"""Logical-axis sharding rules for the production mesh — port of
``repro.parallel.sharding``.

Model code names array dimensions with *logical* axes ("batch", "embed",
"heads", "expert", ...).  A rule table maps logical axes to mesh axes
("pod", "data", "model") per execution regime, and the step bundles
(:mod:`repro_torch.launch.steps`) resolve every parameter, optimizer
state, batch and cache leaf through it.

Regimes, entry for entry the reference's:

``RULES_TRAIN``       — batch over (pod×)data, tensor/expert over model,
                        parameters FSDP-sharded over (pod×)data on their
                        largest non-model dim (ZeRO-3 style).
``RULES_DECODE``      — decode batch over (pod×)data, KV heads over model.
``RULES_LONG_DECODE`` — batch=1: the KV/state *sequence* shards over
                        (pod×)data instead of batch.

A spec is the port's own: a tuple with one entry a dimension, each
``None`` (replicated), a mesh axis name, or a tuple of them (the
reference's ``PartitionSpec`` entries).  :func:`shard_shape` gives the
block of a tensor each device of the mesh would hold.

The port runs on one card, which holds every shard: :func:`act_shard`
and :func:`shard_constraint` resolve and validate a spec and return the
tensor unchanged (they change no value, so the port's models do not call
them).  :func:`sharding_ctx` is the ambient context the bundles open for
each step, as the reference's do; the expert-parallel MoE path
(:func:`repro_torch.models.moe.apply_moe_ep`) reads it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence, Tuple, Union

from repro_torch.mesh import make_mesh  # noqa: F401  (the reference's parallel.make_mesh)

MeshAxes = Union[None, str, Tuple[str, ...]]
#: one entry a dimension (the reference's ``PartitionSpec``)
Spec = Tuple[MeshAxes, ...]


@dataclasses.dataclass(frozen=True)
class LogicalRules:
    """Ordered logical→mesh mapping.  First match wins per logical axis;
    a mesh axis may appear at most once in one spec, so
    :func:`logical_spec` drops later duplicate mesh axes."""

    rules: Tuple[Tuple[str, MeshAxes], ...]
    name: str = "rules"

    def mesh_axes(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        for k, v in self.rules:
            if k == logical:
                return v
        return None

    def replace(self, **updates: MeshAxes) -> "LogicalRules":
        new = [(k, updates.pop(k)) if k in updates else (k, v)
               for k, v in self.rules]
        for k, v in updates.items():
            new.append((k, v))
        return LogicalRules(tuple(new), name=self.name + "*")


def _entry(keep: Tuple[str, ...]) -> MeshAxes:
    if not keep:
        return None
    return keep[0] if len(keep) == 1 else keep


def logical_spec(axes: Sequence[Optional[str]], rules: LogicalRules,
                 mesh=None) -> Spec:
    """Resolve a tuple of logical axis names to a spec.

    Mesh axes already used by an earlier dim are dropped (a mesh axis can
    shard only one dim); mesh axes not present in ``mesh`` are dropped too
    (the same rules serve single-pod and multi-pod meshes)."""
    used = set()
    out = []
    avail = set(mesh.axis_names) if mesh is not None else None
    for ax in axes:
        m = rules.mesh_axes(ax)
        if m is None:
            out.append(None)
            continue
        cand = (m,) if isinstance(m, str) else tuple(m)
        keep = tuple(a for a in cand if a not in used and (avail is None or a in avail))
        used.update(keep)
        out.append(_entry(keep))
    return tuple(out)


def logical_spec_sized(shape: Sequence[int], axes: Sequence[Optional[str]],
                       rules: LogicalRules, mesh) -> Spec:
    """Like :func:`logical_spec` but drops mesh axes a dimension cannot
    divide: a 50 280-entry vocab cannot shard 16 ways, so it stays
    replicated; for a tuple assignment such as ``("pod", "data")`` the
    longest divisible prefix is kept."""
    if len(shape) != len(axes):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} differ in rank")
    used = set()
    avail = dict(mesh.shape)
    out = []
    for dim, ax in zip(shape, axes):
        m = rules.mesh_axes(ax)
        if m is None:
            out.append(None)
            continue
        cand = (m,) if isinstance(m, str) else tuple(m)
        cand = tuple(a for a in cand if a in avail and a not in used)
        chosen: Tuple[str, ...] = ()
        for k in range(len(cand), 0, -1):
            size = 1
            for a in cand[:k]:
                size *= avail[a]
            if dim % size == 0:
                chosen = cand[:k]
                break
        used.update(chosen)
        out.append(_entry(chosen))
    return tuple(out)


def _axes_of(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The block of a ``shape`` tensor that each device of ``mesh`` holds
    under ``spec``: every dimension divided by the product of the sizes of
    its mesh axes.  Raises where a spec names an axis the mesh lacks,
    names one axis twice, or does not divide its dimension."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {tuple(shape)}")
    sizes = dict(mesh.shape)
    seen = set()
    out = []
    for i, dim in enumerate(shape):
        n = 1
        for a in _axes_of(spec[i] if i < len(spec) else None):
            if a not in sizes:
                raise ValueError(f"spec {spec} names mesh axis {a!r}, not in "
                                 f"{tuple(sizes)}")
            if a in seen:
                raise ValueError(f"spec {spec} shards two dimensions over {a!r}")
            seen.add(a)
            n *= sizes[a]
        if dim % n:
            raise ValueError(f"dimension {i} of {tuple(shape)} does not divide by {n} "
                             f"(spec {spec})")
        out.append(dim // n)
    return tuple(out)


def shard_constraint(x, axes: Sequence[Optional[str]], rules: Optional[LogicalRules],
                     mesh=None):
    """Activation sharding hint: resolves and validates ``axes`` against
    ``x``, and returns ``x`` (one card holds every shard)."""
    if rules is None:
        return x
    if len(axes) != x.dim():
        raise ValueError(f"axes {tuple(axes)} do not name the {x.dim()} dims of "
                         f"{tuple(x.shape)}")
    logical_spec(axes, rules, mesh)
    return x


# --------------------------------------------------------------------------
# the ambient sharding context the step bundles open for each step
# --------------------------------------------------------------------------

_ctx = threading.local()


@contextlib.contextmanager
def sharding_ctx(rules: LogicalRules, mesh):
    """``(rules, mesh)`` as the ambient context while the block runs.  It is
    the thread's own: autograd runs a CUDA backward, and with it a
    checkpoint's recompute, in a thread of its own, so a checkpointed
    layer carries the context of its forward into the recompute
    (``models/transformer.py`` ``apply_stack``)."""
    prev = getattr(_ctx, "val", None)
    _ctx.val = (rules, mesh)
    try:
        yield
    finally:
        _ctx.val = prev


def current_ctx():
    """``(rules, mesh)`` of the ambient sharding context, or None."""
    return getattr(_ctx, "val", None)


def act_shard(x, *axes: Optional[str]):
    """Constrain an activation to its logical axes under the ambient
    context (a no-op outside one): resolves the spec, indivisible dims
    falling back to replicated, checks that it divides ``x``, and returns
    ``x`` unchanged."""
    ctx = current_ctx()
    if ctx is None:
        return x
    rules, mesh = ctx
    shard_shape(x.shape, logical_spec_sized(x.shape, axes, rules, mesh), mesh)
    return x


# --------------------------------------------------------------------------
# rule tables (the reference's, entry for entry)
# --------------------------------------------------------------------------

_FSDP = ("pod", "data")  # parameter / optimizer-state sharding axes

RULES_TRAIN = LogicalRules(
    name="train",
    rules=(
        # activations
        ("batch", _FSDP),
        ("seq", None),
        ("act_embed", None),
        ("act_heads", "model"),
        ("act_kv_heads", "model"),
        ("batch_attn", None),
        ("act_mlp", "model"),
        ("act_expert", "model"),
        ("act_vocab", "model"),
        # parameters: tensor-parallel over model; FSDP over (pod, data)
        ("embed", _FSDP),
        ("vocab", "model"),
        ("heads", "model"),
        ("kv_heads", "model"),
        ("head_dim", None),
        ("mlp", "model"),
        ("expert", "model"),
        ("expert_mlp", ("model", "data")),
        ("layers", None),
        ("kv_lora", None),
        ("q_lora", None),
        ("state", None),
        ("conv", None),
        ("frontend", None),
    ),
)

RULES_DECODE = LogicalRules(
    name="decode",
    rules=(
        ("batch", _FSDP),
        ("seq", None),
        ("cache_seq", None),
        ("act_embed", None),
        ("act_heads", "model"),
        ("act_kv_heads", "model"),
        ("batch_attn", ("pod", "data", "model")),
        ("act_mlp", "model"),
        ("act_expert", "model"),
        ("act_vocab", "model"),
        ("embed", None),           # serving: parameters replicated over data,
        ("vocab", "model"),        # sharded over model only
        ("heads", "model"),
        ("kv_heads", "model"),
        ("head_dim", None),
        ("mlp", "model"),
        ("expert", "model"),
        ("expert_mlp", None),
        ("layers", None),
        ("kv_lora", None),
        ("q_lora", None),
        ("state", None),
        ("conv", None),
        ("frontend", None),
    ),
)

# batch=1 long-context: shard the cache sequence dim over (pod, data)
RULES_LONG_DECODE = dataclasses.replace(
    RULES_DECODE.replace(batch=None, cache_seq=_FSDP), name="long_decode")
