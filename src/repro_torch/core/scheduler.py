"""Algorithm 1 — Overall Scheduling (the Graph-Centric Scheduler).

Given a workflow ``G`` and an end-to-end latency SLO:

  1. assign the over-provisioned base configuration to every function,
  2. execute once to weight the DAG and extract the critical path,
  3. Priority-Configure the critical path against the full SLO,
  4. enumerate detour sub-paths; for each, the sub-SLO is the runtime
     window between its critical-path anchors (minus already-scheduled
     functions, which are popped from the sub-path),
  5. Priority-Configure each sub-path against its sub-SLO,
  6. return the final per-function configuration map.

The port's copy of ``src/repro/core/scheduler.py`` (lines 1-116), numpy
and plain Python as there, so that its float operations run in the same
order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.core.critical_path import (find_critical_path, find_detour_subpath,
                                            runtime_sum)
from repro_torch.core.dag import Workflow
from repro_torch.core.env import Environment
from repro_torch.core.gridsearch import (ExecuteRequest, GridPlan, drive_plan)
from repro_torch.core.priority import (FUNC_TRIAL, INITIAL_STEP, MAX_TRAIL,
                                       priority_plan)
from repro_torch.core.resources import BASE_CONFIG, ResourceConfig


@dataclasses.dataclass
class ScheduleResult:
    configs: Dict[str, ResourceConfig]
    critical_path: List[str]
    e2e_runtime: float
    cost: float
    n_samples: int


class GraphCentricScheduler:
    """Drives the whole AARC configuration search (Fig. 4 steps 1-7)."""

    def __init__(self, env: Environment, *, max_trail: int = MAX_TRAIL,
                 func_trial: int = FUNC_TRIAL,
                 initial_step: float = INITIAL_STEP,
                 base_config: ResourceConfig = BASE_CONFIG,
                 batch_size: int = 1):
        self.env = env
        self.max_trail = max_trail
        self.func_trial = func_trial
        self.initial_step = initial_step
        self.base_config = base_config
        self.batch_size = batch_size

    def schedule(self, wf: Workflow, slo: float) -> ScheduleResult:
        """Sequential driver over :meth:`schedule_plan`."""
        return drive_plan(GridPlan(self.env, self.schedule_plan(wf, slo)))

    def schedule_plan(self, wf: Workflow, slo: float):
        """Algorithm 1 as a sans-IO plan generator (see
        :mod:`repro_torch.core.gridsearch`): every sample is requested via
        ``yield``, so the sequential and lockstep drivers execute the
        identical decision sequence."""
        env = self.env
        # -- assign base configuration (Alg 1 line 2-4)
        for node in wf:
            node.config = self.base_config.copy()
        wf.reset_flags()

        # -- execute to find critical path (Alg 1 line 5-6)
        base_sample = yield ExecuteRequest(wf=wf, slo=slo, note="aarc:base")
        if not base_sample.feasible:
            raise ValueError(
                f"SLO {slo}s infeasible even at base config "
                f"(e2e={base_sample.e2e_runtime:.2f}s)")
        critical_path = find_critical_path(wf)

        g_configs: Dict[str, ResourceConfig] = {}

        # -- configure the critical path (Alg 1 line 7-9)
        configs = yield from priority_plan(
            wf, critical_path, slo, env, global_slo=slo,
            max_trail=self.max_trail, func_trial=self.func_trial,
            initial_step=self.initial_step, batch_size=self.batch_size)
        g_configs.update(configs)

        # -- compute configs for subpaths (Alg 1 line 10-21)
        subpaths = find_detour_subpath(wf, critical_path)
        for sp in subpaths:
            sub_slo = runtime_sum(wf, critical_path, sp.start, sp.end)
            pending: List[str] = []
            for name in sp.interior:               # Alg 1 line 13-18
                node = wf.nodes[name]
                if node.scheduled:
                    sub_slo -= node.runtime        # popped, budget shrinks
                else:
                    pending.append(name)
            if not pending:
                continue
            configs = yield from priority_plan(
                wf, pending, sub_slo, env, global_slo=slo,
                max_trail=self.max_trail, func_trial=self.func_trial,
                initial_step=self.initial_step, batch_size=self.batch_size)
            g_configs.update(configs)

        # any node untouched by every path keeps the base config
        for node in wf:
            g_configs.setdefault(node.name, node.config.copy())

        final = yield ExecuteRequest(wf=wf, slo=slo, note="aarc:final")
        return ScheduleResult(configs=g_configs, critical_path=critical_path,
                              e2e_runtime=final.e2e_runtime, cost=final.cost,
                              n_samples=env.trace.n_samples)


def schedule(wf: Workflow, slo: float, env: Environment, **kw) -> ScheduleResult:
    """Functional entry point mirroring ``schedule(G, SLO)`` in the paper."""
    return GraphCentricScheduler(env, **kw).schedule(wf, slo)
