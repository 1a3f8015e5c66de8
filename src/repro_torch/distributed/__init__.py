"""Distribution of the port (counterpart of ``repro.distributed``). Only
fault tolerance is ported so far; sharding, collectives and
``elastic_reshard`` come with the distribution slice."""
from repro_torch.distributed.fault_tolerance import (InjectedFault,
                                                     LoopReport,
                                                     ResilientLoop,
                                                     StepWatchdog)

__all__ = ["InjectedFault", "LoopReport", "ResilientLoop", "StepWatchdog"]
