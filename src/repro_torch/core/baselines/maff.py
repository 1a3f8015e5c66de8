"""MAFF baseline (Zubko et al. [14]), adapted to workflows per §IV-A(b).

MAFF is *memory-centric gradient descent* with AWS-style coupling: vCPU
is allocated proportionally (1 core per 1024 MB of memory), so the
search walks a 1-D coupled axis per function. It iteratively shrinks
memory while cost decreases; "if a workflow's SLO is violated, the
process reverts to the previous step and terminates" — which is exactly
why it gets stuck in local optima on CPU-heavy / memory-light
workloads (ML Pipeline) where the coupled axis cannot express
(high cpu, low mem) points.

The port's copy of ``src/repro/core/baselines/maff.py`` (lines 1-109),
numpy and plain Python as there, so that its float operations run in the
same order.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

from repro_torch.core.dag import Workflow
from repro_torch.core.env import Environment, Sample
from repro_torch.core.gridsearch import ExecuteRequest, GridPlan, drive_plan
from repro_torch.core.resources import (MEM_MAX_MB, ResourceConfig,
                                        coupled_config, quantize_mem)


def maff_search(wf: Workflow, slo: float, env: Environment, *,
                shrink: float = 0.4, min_rel_step: float = 0.02,
                max_samples: int = 200,
                start_configs: Optional[Dict[str, ResourceConfig]] = None,
                fallback_to_base: bool = True) -> Optional[Sample]:
    """Coupled memory descent, one function at a time.

    For each function (in topological order): repeatedly multiply its
    memory by ``(1 - shrink)`` (cpu follows the 1-per-1024MB coupling);
    on SLO violation or cost increase revert and halve the shrink step;
    terminate the function's descent once the step falls below
    ``min_rel_step`` — MAFF's per-function gradient descent with step
    decay. Returns the best feasible sample.

    ``start_configs`` warm-starts the descent from a known
    configuration (e.g. AARC's best for the same cell, or a config
    transferred from a structurally identical workflow) instead of the
    coupled base; a start that violates the SLO on *this* response
    surface falls back to the coupled base rather than aborting.
    ``fallback_to_base=False`` disables that retry (and its extra base
    sample) — resumed searches use it to keep a hard sample budget.

    Sequential driver over :func:`maff_plan`.
    """
    return drive_plan(GridPlan(env, maff_plan(
        wf, slo, env, shrink=shrink, min_rel_step=min_rel_step,
        max_samples=max_samples, start_configs=start_configs,
        fallback_to_base=fallback_to_base)))


def maff_plan(wf: Workflow, slo: float, env: Environment, *,
              shrink: float = 0.4, min_rel_step: float = 0.02,
              max_samples: int = 200,
              start_configs: Optional[Dict[str, ResourceConfig]] = None,
              fallback_to_base: bool = True):
    """The MAFF descent as a sans-IO plan generator (see
    :mod:`repro_torch.core.gridsearch`): every workflow execution is
    requested via ``yield``, so the sequential and lockstep drivers run
    the identical descent. ``env`` is consulted read-only (trace sample
    counters and the final ``best_feasible`` lookup)."""
    if not env.trace.capture_configs:
        raise ValueError(
            "MAFF reads the winning configuration back from the trace "
            "(best_feasible().configs); capture_configs=False would "
            "silently return empty configs")
    if start_configs is not None:
        wf.apply_configs(start_configs)
    else:
        # start from the coupled base configuration
        for node in wf:
            node.config = coupled_config(MEM_MAX_MB)
    sample = yield ExecuteRequest(wf=wf, slo=slo, note="maff:base")
    if not sample.feasible and start_configs is not None and fallback_to_base:
        # transferred start infeasible here — retry from the base
        for node in wf:
            node.config = coupled_config(MEM_MAX_MB)
        sample = yield ExecuteRequest(wf=wf, slo=slo, note="maff:base")
    if not sample.feasible:
        return None
    prev_cost = sample.cost

    n = env.trace.n_samples
    for name in wf.topological_order():
        node = wf.nodes[name]
        step = shrink
        while step >= min_rel_step and env.trace.n_samples - n < max_samples:
            old_cfg, old_rt = node.config, node.runtime
            new_mem = quantize_mem(node.config.mem * (1.0 - step))
            if new_mem >= node.config.mem - 1e-9:       # at the lattice floor
                break
            node.config = coupled_config(new_mem)
            sample = yield ExecuteRequest(wf=wf, slo=slo, note=f"maff:{name}")
            if (sample.error
                    or not math.isfinite(sample.e2e_runtime)
                    or sample.e2e_runtime > slo
                    or sample.cost >= prev_cost):
                node.config, node.runtime = old_cfg, old_rt
                step *= 0.5                              # revert + decay
            else:
                prev_cost = sample.cost

    best = env.trace.best_feasible()
    if best is not None:
        wf.apply_configs(best.configs)
    return best
