"""Logical-axis sharding rules and DTensor placements (mirrors
``src/repro/sharding``)."""

from .rules import (  # noqa: F401
    DEFAULT_RULES,
    PartitionSpec,
    batch_sharding,
    batch_spec,
    constrain_batch,
    mesh_axes,
    param_shardings,
    param_specs,
    place_params,
    placements,
    resolve_spec,
    rules_for,
    shard_batch,
    shard_batch_spec,
)
