"""AARC core of the port — the paper's contribution, backend-generic.

Graph-Centric Scheduler (Algorithm 1) + Priority Configurator
(Algorithm 2) over decoupled resource configurations, plus the BO and
MAFF baselines, copied from ``repro.core`` (numpy and plain Python, so
that traces equal the reference's bit for bit), and the fleet engine's
fast-plane sweep on the card (:mod:`repro_torch.core.engine`).
"""
from repro_torch.core.backend import (BaseBackend, CallableBackend,
                                      RuntimeBackend, as_backend)
from repro_torch.core.cost import DEFAULT_PRICING, PricingModel, workflow_cost
from repro_torch.core.critical_path import (SubPath, find_critical_path,
                                            find_detour_subpath, runtime_sum)
from repro_torch.core.dag import Node, Workflow
from repro_torch.core.env import (Environment, ExecutionError, Sample,
                                  SearchTrace)
from repro_torch.core.priority import Operation, priority_configuration
from repro_torch.core.resources import (BASE_CONFIG, ResourceConfig,
                                        coupled_config, quantize_cpu,
                                        quantize_mem)
from repro_torch.core.scheduler import (GraphCentricScheduler,
                                        ScheduleResult, schedule)

__all__ = [
    "BaseBackend", "CallableBackend", "RuntimeBackend", "as_backend",
    "DEFAULT_PRICING", "PricingModel", "workflow_cost",
    "SubPath", "find_critical_path", "find_detour_subpath", "runtime_sum",
    "Node", "Workflow",
    "Environment", "ExecutionError", "Sample", "SearchTrace",
    "Operation", "priority_configuration",
    "BASE_CONFIG", "ResourceConfig", "coupled_config",
    "quantize_cpu", "quantize_mem",
    "GraphCentricScheduler", "ScheduleResult", "schedule",
]
