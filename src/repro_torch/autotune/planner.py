"""Planner: run AARC (or a baseline) over a model's stage graph and
emit an actionable per-stage plan (chips + remat level).

The port's copy of ``src/repro/autotune/planner.py`` (lines 1-79), over
the H100 stage oracle (:class:`~repro_torch.autotune.oracle.GPUStageOracle`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.autotune.oracle import (OracleConfig, GPUStageOracle,
                                         make_gpu_env)
from repro_torch.autotune.stages import build_stage_graph
from repro_torch.core.baselines.bo import bo_search
from repro_torch.core.baselines.maff import maff_search
from repro_torch.core.resources import MEM_MAX_MB, ResourceConfig
from repro_torch.core.scheduler import GraphCentricScheduler


@dataclasses.dataclass
class StagePlan:
    chips: int
    act_budget_frac: float
    remat: str                   # derived: none | dots | full


@dataclasses.dataclass
class PlanResult:
    method: str
    stages: Dict[str, StagePlan]
    step_time: float             # modeled end-to-end step latency
    cost: float                  # chip-second + memory cost units
    n_samples: int
    search_runtime: float        # modeled profiling wall time


def _to_plan(configs: Dict[str, ResourceConfig],
             oracle: GPUStageOracle, wf) -> Dict[str, StagePlan]:
    plans = {}
    for name, cfg in configs.items():
        node = wf.nodes[name]
        frac = cfg.mem / MEM_MAX_MB
        remat = "none" if frac > 0.8 else ("dots" if frac > 0.35 else "full")
        plans[name] = StagePlan(chips=oracle.chips(node),
                                act_budget_frac=frac, remat=remat)
    return plans


def plan(cfg, shape, slo_seconds: float, *, method: str = "aarc",
         oracle_cfg: OracleConfig = OracleConfig(),
         group_units: Optional[int] = None,
         max_trail: int = 64, seed: int = 0) -> PlanResult:
    """Configure (cfg, shape)'s stage graph against a step-time SLO."""
    wf = build_stage_graph(cfg, shape, group_units=group_units)
    env = make_gpu_env(oracle_cfg)
    oracle = GPUStageOracle(oracle_cfg)

    if method == "aarc":
        result = GraphCentricScheduler(env, max_trail=max_trail).schedule(
            wf, slo_seconds)
        configs, cost = result.configs, result.cost
        step_time, n = result.e2e_runtime, result.n_samples
    elif method == "bo":
        best = bo_search(wf, slo_seconds, env, n_rounds=max_trail, seed=seed)
        if best is None:
            raise ValueError("BO found no feasible configuration")
        configs, cost = best.configs, best.cost
        step_time, n = best.e2e_runtime, env.trace.n_samples
    elif method == "maff":
        best = maff_search(wf, slo_seconds, env)
        if best is None:
            raise ValueError("MAFF found no feasible configuration")
        configs, cost = best.configs, best.cost
        step_time, n = best.e2e_runtime, env.trace.n_samples
    else:
        raise ValueError(f"unknown method {method!r}")

    return PlanResult(method=method,
                      stages=_to_plan(configs, oracle, wf),
                      step_time=step_time, cost=cost, n_samples=n,
                      search_runtime=env.trace.total_search_runtime)
