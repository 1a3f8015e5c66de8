"""Distribution layer of the port (counterpart of ``repro.distributed``):
logical-axis sharding rules on DTensor, collectives and fault tolerance.

Params carry *logical* axis names (("embed", "mlp"), ...); a
:class:`ShardingRules` table maps logical names to mesh axes and yields
the DTensor placements of any param/activation tree. The same model code
therefore runs unsharded and on a ``DeviceMesh`` of any shape unchanged:
only the rules differ.
"""
from repro_torch.distributed.sharding import (ShardingRules, FSDP_RULES,
                                              SERVING_RULES, TP_RULES,
                                              logical_to_sharding,
                                              tree_shardings,
                                              shard_batch_spec)
from repro_torch.distributed.fault_tolerance import (InjectedFault,
                                                     LoopReport,
                                                     ResilientLoop,
                                                     StepWatchdog,
                                                     elastic_reshard)

__all__ = [
    "ShardingRules", "FSDP_RULES", "SERVING_RULES", "TP_RULES",
    "logical_to_sharding", "tree_shardings", "shard_batch_spec",
    "InjectedFault", "LoopReport", "ResilientLoop", "StepWatchdog",
    "elastic_reshard",
]
