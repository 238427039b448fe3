"""Distributed training (port of ``repro.distributed``): the logical-axis
sharding rules of a device mesh (``sharding``), GPipe pipeline
parallelism over a mesh axis (``pipeline``) and int8 gradient
compression with error feedback (``compress``). The reference's
``hlo_cost`` and ``roofline`` parse XLA HLO and have no counterpart."""
from repro_torch.distributed.sharding import (  # noqa: F401
    ShardingRules,
    activation_spec,
    constrain,
    default_rules,
    param_pspecs,
    shard_map,
    use_rules,
)
