"""Sharding rules: logical axes → mesh axes (pod, data, model)."""

from .sharding import (
    RULES_DECODE,
    RULES_LONG_DECODE,
    RULES_TRAIN,
    LogicalRules,
    Spec,
    act_shard,
    current_ctx,
    logical_spec,
    logical_spec_sized,
    make_mesh,
    shard_constraint,
    shard_shape,
    sharding_ctx,
)

__all__ = [
    "LogicalRules", "Spec", "RULES_TRAIN", "RULES_DECODE", "RULES_LONG_DECODE",
    "logical_spec", "logical_spec_sized", "shard_shape", "act_shard", "current_ctx",
    "sharding_ctx", "make_mesh", "shard_constraint",
]
