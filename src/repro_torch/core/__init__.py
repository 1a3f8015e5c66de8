"""AARC core of the port — the paper's contribution, backend-generic.

Graph-Centric Scheduler (Algorithm 1) + Priority Configurator
(Algorithm 2) over decoupled resource configurations, plus the BO and
MAFF baselines, the Searcher protocol and the Input-Aware plugin
(§IV-D), copied from ``repro.core`` (numpy and plain Python, so that
traces equal the reference's bit for bit).

Execution is unified behind
:class:`repro_torch.core.backend.RuntimeBackend`: the
:class:`Environment` every searcher samples through and the
discrete-event :class:`repro_torch.core.engine.FleetEngine` (many
concurrent workflow instances on a finite-capacity cluster, its
contention-free replay plane swept on the CUDA card by default) share
one backend protocol — the single-workflow search path is the engine's
degenerate case (fleet of 1, infinite capacity, zero cold start).
Portfolio campaigns (:mod:`repro_torch.core.campaign`) and adaptive
budget campaigns (:mod:`repro_torch.core.adaptive`) search every cell
through the lockstep grid runner (:mod:`repro_torch.core.gridsearch`,
whose ``run_grid_search`` is exported here too) and replay what they
found through the engine, on the card by default, and the online
control plane (:mod:`repro_torch.core.online`, with the shared-cluster
placement of :mod:`repro_torch.core.placement` and the joint autoscaler
of :mod:`repro_torch.core.autoscale`) serves a portfolio through
drift-triggered reconfiguration, its contention-free replays swept on
the card by default too.
"""
from repro_torch.core.autoscale import (AutoscaleSpec, ScaleResult,
                                        ScaleSearcher)
from repro_torch.core.backend import (BaseBackend, CallableBackend,
                                      RuntimeBackend, as_backend)
from repro_torch.core.campaign import (Campaign, CampaignReport,
                                       CampaignSpec, CampaignTask,
                                       PortfolioSpec, ReplayMetrics,
                                       ReplaySpec, TaskResult, run_campaign)
from repro_torch.core.cost import DEFAULT_PRICING, PricingModel, workflow_cost
from repro_torch.core.critical_path import (SubPath, find_critical_path,
                                            find_detour_subpath, runtime_sum)
from repro_torch.core.dag import Node, Workflow
from repro_torch.core.engine import (ClusterModel, ColdStartModel, FleetCarry,
                                     FleetEngine, FleetReport,
                                     INFINITE_CLUSTER, InstanceResult,
                                     NO_COLD_START, PoissonArrivals,
                                     ReplicaModel, TraceArrivals,
                                     arrival_times, run_fleet)
from repro_torch.core.env import (Environment, ExecutionError, Sample,
                                  SearchTrace)
from repro_torch.core.input_aware import InputAwareEngine, InputClass
from repro_torch.core.priority import Operation, priority_configuration
from repro_torch.core.resources import (BASE_CONFIG, ResourceConfig,
                                        coupled_config, quantize_cpu,
                                        quantize_mem)
from repro_torch.core.scheduler import (GraphCentricScheduler,
                                        ScheduleResult, schedule)
from repro_torch.core.search import (AARCSearcher, BOSearcher, MAFFSearcher,
                                     ResumeState, SEARCHERS, SearchResult,
                                     Searcher, make_searcher, retune_state)
from repro_torch.core.gridsearch import run_grid_search
from repro_torch.core.adaptive import (AdaptiveCampaign, AdaptiveReport,
                                       AdaptiveSpec, GrantScorer,
                                       run_adaptive)
from repro_torch.core.online import (OnlineController, OnlineReport,
                                     OnlineSpec, ReconfigRecord, ServingCell,
                                     run_online)

__all__ = [
    "BaseBackend", "CallableBackend", "RuntimeBackend", "as_backend",
    "DEFAULT_PRICING", "PricingModel", "workflow_cost",
    "SubPath", "find_critical_path", "find_detour_subpath", "runtime_sum",
    "Node", "Workflow",
    "AutoscaleSpec", "ScaleResult", "ScaleSearcher",
    "ClusterModel", "ColdStartModel", "FleetCarry", "FleetEngine",
    "FleetReport", "INFINITE_CLUSTER", "InstanceResult", "NO_COLD_START",
    "PoissonArrivals", "ReplicaModel", "TraceArrivals", "arrival_times",
    "run_fleet",
    "Environment", "ExecutionError", "Sample", "SearchTrace",
    "InputAwareEngine", "InputClass",
    "Operation", "priority_configuration",
    "BASE_CONFIG", "ResourceConfig", "coupled_config",
    "quantize_cpu", "quantize_mem",
    "GraphCentricScheduler", "ScheduleResult", "schedule",
    "AARCSearcher", "BOSearcher", "MAFFSearcher", "ResumeState",
    "SEARCHERS", "SearchResult", "Searcher", "make_searcher",
    "retune_state",
    "run_grid_search",
    "Campaign", "CampaignReport", "CampaignSpec", "CampaignTask",
    "PortfolioSpec", "ReplayMetrics", "ReplaySpec", "TaskResult",
    "run_campaign",
    "AdaptiveCampaign", "AdaptiveReport", "AdaptiveSpec", "GrantScorer",
    "run_adaptive",
    "OnlineController", "OnlineReport", "OnlineSpec",
    "ReconfigRecord", "ServingCell", "run_online",
]
