"""The port's sharding rules (``repro_torch.parallel``) and the specs of
its step bundles against the JAX package's, on the CPU.

* the three rule tables, entry for entry;
* ``logical_spec`` and ``logical_spec_sized`` against the reference's
  functions (which read only a mesh's ``.shape`` and ``.axis_names``, so
  a stand-in object serves both packages) on every leaf of
  ``param_axes()``, of the AdamW state, of the batch and of
  ``cache_axes()`` (both ``per_sequence`` values), for all ten configs at
  full size × the four shapes × both production meshes, under each
  table;
* ``Model.param_axes()`` equal to the reference's ``abstract_init()[1]``,
  and the parameter shapes equal;
* each bundle's per-device argument bytes equal to the sum over the
  reference's specs of the reference's own abstract inputs.
"""

import functools

import jax
import numpy as np
import pytest

import repro.parallel.sharding as jsh
from repro.configs.base import ARCH_IDS, SHAPES as JSHAPES
from repro.configs.base import get_config as jget
from repro.data.synthetic import make_batch_specs as jbatch_specs
from repro.models import Model as JModel
from repro_torch import parallel as sh
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES
from repro_torch.data.synthetic import make_batch_specs
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import Model
from repro_torch.models.nn import tree_map

RULES = ("RULES_TRAIN", "RULES_DECODE", "RULES_LONG_DECODE")


class StandIn:
    """What the two packages' spec functions read of a mesh."""

    def __init__(self, mesh):
        self.shape = dict(mesh.shape)
        self.axis_names = tuple(mesh.axis_names)


MESHES = {mp: make_production_mesh(multi_pod=mp) for mp in (False, True)}


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """(shapes, axes) of the reference's ``abstract_init``."""
    return JModel(jget(arch)).abstract_init()


def _pairs(axes, shapes):
    """[(axes, shape)] of two aligned trees (dicts, lists; tuples are leaves)."""
    if isinstance(axes, dict):
        return [p for k in axes for p in _pairs(axes[k], shapes[k])]
    if isinstance(axes, list):
        return [p for a, s in zip(axes, shapes) for p in _pairs(a, s)]
    return [(tuple(axes), tuple(shapes.shape))]


def _norm(tree):
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_norm(v) for v in tree]
    return tuple(tree)


def test_rule_tables_entry_for_entry():
    for name in RULES:
        want, got = getattr(jsh, name), getattr(sh, name)
        assert got.name == want.name and got.rules == want.rules, name
    got, want = sh.RULES_TRAIN.replace(seq="data"), jsh.RULES_TRAIN.replace(seq="data")
    assert (got.name, got.rules) == (want.name, want.rules)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_equal_the_reference(arch):
    jshapes, jaxes = _reference(arch)
    model = Model(get_config(arch))
    assert _norm(model.param_axes()) == _norm(jaxes)
    got = tree_map(lambda t: tuple(t.shape), model.abstract_init())
    assert _norm(got) == _norm(jax.tree.map(lambda s: tuple(s.shape), jshapes))


def _leaves(arch, shape_name):
    """(axes, shape) of every leaf a step of the shape holds: parameters,
    the AdamW moments (the parameters' axes), the batch, and the caches
    with a scalar and with a per-slot ``pos``."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    model = Model(cfg)
    params = model.abstract_init()
    out = _pairs(model.param_axes(), params) * 3 + [((), ())]   # params, m, v, step
    batch_axes = make_batch_specs(cfg, shape)
    out += [(batch_axes[k], tuple(v.shape)) for k, v in model.input_specs(shape).items()
            if k in batch_axes]
    out.append((("batch",), (shape.global_batch,)))
    for per_seq in (False, True):
        caches = model.init_caches(shape.global_batch, shape.seq_len + model._prefix_len(),
                                   per_sequence=per_seq, device="meta")
        out += _pairs(model.cache_axes(per_sequence=per_seq), caches)
    return out


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_specs_equal_the_reference_on_every_leaf(arch):
    n = 0
    for shape_name in SHAPES:
        leaves = _leaves(arch, shape_name)
        for mp, mesh in MESHES.items():
            stand_in = StandIn(mesh)
            for name in RULES:
                rules, jrules = getattr(sh, name), getattr(jsh, name)
                for axes, shape in leaves:
                    want = tuple(jsh.logical_spec_sized(shape, axes, jrules, stand_in))
                    assert sh.logical_spec_sized(shape, axes, rules, mesh) == want, \
                        (arch, shape_name, mp, name, axes, shape)
                    assert sh.logical_spec(axes, rules, mesh) == \
                        tuple(jsh.logical_spec(axes, jrules, stand_in))
                    n += 1
    assert n > 1000


def _jax_bytes(sds_tree, axes_tree, rules, mesh) -> int:
    """Bytes a device holds of the reference's abstract tree under its own
    specs."""
    stand_in, total = StandIn(mesh), 0
    leaves = jax.tree.leaves(sds_tree)
    axes = jax.tree.leaves(axes_tree, is_leaf=lambda x: isinstance(x, tuple))
    assert len(leaves) == len(axes)
    for sd, ax in zip(leaves, axes):
        spec = tuple(jsh.logical_spec_sized(sd.shape, ax, rules, stand_in))
        n = 1
        for i, d in enumerate(sd.shape):
            entry = spec[i] if i < len(spec) else None
            div = 1
            for a in (() if entry is None else (entry,) if isinstance(entry, str) else entry):
                div *= mesh.shape[a]
            assert d % div == 0
            n *= d // div
        total += n * np.dtype(sd.dtype).itemsize
    return total


def _reference_argument_bytes(arch, shape_name, mesh) -> int:
    """The reference bundle's arguments, each leaf at its own spec: its
    ``abstract_init``, the AdamW state, ``input_specs`` and caches."""
    from repro.launch.steps import rules_for
    from repro.optim import AdamWConfig, adamw_init
    cfg, shape = jget(arch), JSHAPES[shape_name]
    model = JModel(cfg)
    params, axes = _reference(arch)
    rules = rules_for(shape)
    total = _jax_bytes(params, axes, rules, mesh)
    raw = model.input_specs(shape)
    if shape.kind == "decode":
        total += _jax_bytes(raw["token"], ("batch",), rules, mesh)
    else:
        batch_axes = jbatch_specs(cfg, shape)
        total += sum(_jax_bytes(v, batch_axes[k], rules, mesh) for k, v in raw.items())
    if shape.kind == "train":
        opt = jax.eval_shape(lambda p: adamw_init(p, AdamWConfig()), params)
        total += 2 * _jax_bytes(opt["m"], axes, rules, mesh) + 4
        return total
    B, S = shape.global_batch, shape.seq_len
    max_len = S + model._prefix_len() if shape.kind == "prefill" else S
    caches = jax.eval_shape(lambda: model.init_caches(B, max_len))
    return total + _jax_bytes(caches, model.cache_axes(), rules, mesh)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_per_device_equal_the_reference_specs(arch):
    for shape_name in SHAPES:
        for mesh in MESHES.values():
            bundle = steps.build_bundle(get_config(arch), SHAPES[shape_name], mesh)
            assert bundle.argument_bytes() == _reference_argument_bytes(arch, shape_name,
                                                                        mesh), \
                (arch, shape_name, mesh.shape)


def test_shard_shape_and_constraints():
    mesh = MESHES[True]
    assert sh.shard_shape((64, 48, 7), (("pod", "data"), "model", None), mesh) == (2, 3, 7)
    with pytest.raises(ValueError, match="does not divide"):
        sh.shard_shape((40,), ("model",), mesh)
    with pytest.raises(ValueError, match="two dimensions"):
        sh.shard_shape((16, 16), ("data", "data"), mesh)
    with pytest.raises(ValueError, match="not in"):
        sh.shard_shape((16,), ("expert",), mesh)
    import torch
    x = torch.empty(64, 48, device="meta")
    assert sh.act_shard(x, "batch", "act_mlp") is x            # no context
    with sh.sharding_ctx(sh.RULES_TRAIN, mesh):
        assert sh.current_ctx() == (sh.RULES_TRAIN, mesh)
        assert sh.act_shard(x, "batch", "act_mlp") is x
        assert sh.shard_constraint(x, ("batch", None), sh.RULES_TRAIN, mesh) is x
        with pytest.raises(ValueError):
            sh.act_shard(x, "batch")
    assert sh.current_ctx() is None
