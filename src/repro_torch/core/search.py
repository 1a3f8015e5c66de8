"""Unified Searcher protocol over the configuration-search stack.

AARC's Graph-Centric Scheduler, the Bayesian-Optimization baseline and
the MAFF baseline were three bespoke entry points with three different
result shapes. This module puts them behind one interface:

  * :class:`Searcher` — ``search(wf, slo) -> SearchResult`` plus a
    ``name``; any object satisfying it plugs into the campaign runner,
    the benchmarks, and the tests unchanged,
  * :class:`SearchResult` — per-search record: the found configuration,
    its end-to-end latency / cost / feasibility, and the shared
    trace-derived bookkeeping (modeled search time = Σ trial wall time,
    search cost = Σ sampled execution cost, sample count, actual
    wall-clock) every searcher reports identically,
  * :data:`SEARCHERS` / :func:`make_searcher` — a registry so campaign
    specs and CLIs can name searchers as strings.

Adding a new searcher: implement ``search`` (measure candidates
through the :class:`repro_torch.core.env.Environment` you are given so the
trace bookkeeping stays comparable) and ``resume``, set a ``name``,
and register the class in :data:`SEARCHERS`.

Resumable budgets (the adaptive-campaign layer): every ``search``
attaches a :class:`ResumeState` to its result, and
``resume(state, extra_budget)`` re-enters the search with up to
``extra_budget`` additional trace samples, returning a *cumulative*
:class:`SearchResult` (same environment, same trace, updated best).
``resume(state, 0)`` is a guaranteed no-op. Resumption mutates the
state's environment/workflow in place, so resumable cells should be
driven through an environment *factory* — a shared ``Environment``
instance would have its trace reset by the next ``search`` call.

Each concrete searcher takes an *environment factory* — a zero-arg
callable returning a fresh :class:`Environment` — so one searcher
instance can sweep many workflows with isolated traces (an
:class:`Environment` instance is also accepted and reused with its
trace reset per search). With ``batch_size=1`` every searcher's trace
is bit-for-bit the trace of its legacy entry point; larger batches
route candidate evaluation through the vectorized paths
(:meth:`Environment.execute_candidates`, Algorithm 2's batched probe
rounds).

The port's copy of ``src/repro/core/search.py``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import (Callable, Dict, Optional, Protocol, Type, Union,
                    runtime_checkable)

from repro_torch.core.baselines.bo import BayesianOptimizer
from repro_torch.core.baselines.maff import maff_plan
from repro_torch.core.cost import workflow_cost
from repro_torch.core.critical_path import find_critical_path
from repro_torch.core.dag import Workflow
from repro_torch.core.env import Environment, Sample, SearchTrace
from repro_torch.core.gridsearch import (CellEligibility, GridCell, GridPlan,
                                         GridReport, GridResume, drive_plan,
                                         grid_eligibility, run_grid_search)
from repro_torch.core.priority import (FUNC_TRIAL, INITIAL_STEP, MAX_TRAIL,
                                 priority_plan)
from repro_torch.core.resources import BASE_CONFIG, ResourceConfig
from repro_torch.core.scheduler import GraphCentricScheduler

__all__ = [
    "SearchResult", "ResumeState", "Searcher", "AARCSearcher", "BOSearcher",
    "MAFFSearcher", "SEARCHERS", "make_searcher", "retune_state",
    # re-exported lockstep grid plane (implemented in core.gridsearch)
    "run_grid_search", "grid_eligibility", "GridCell", "GridResume",
    "GridReport", "CellEligibility",
]


@dataclasses.dataclass
class SearchResult:
    """What one configuration search produced, searcher-agnostic."""

    searcher: str                        # registry name of the searcher
    workflow: str                        # wf.name
    slo: float
    configs: Dict[str, ResourceConfig]   # found per-function configuration
    e2e_runtime: float                   # latency under ``configs``
    cost: float                          # one-execution cost under ``configs``
    feasible: bool                       # SLO met by ``configs``
    n_samples: int
    search_time: float                   # modeled Σ trial wall time (Fig. 5a)
    search_cost: float                   # Σ sampled execution cost (Fig. 5b)
    wall_time_s: float                   # actual wall-clock spent searching
    trace: SearchTrace
    best: Optional[Sample] = None        # cheapest feasible trace sample
    note: str = ""                       # e.g. infeasibility diagnostics
    state: Optional["ResumeState"] = None  # continuation handle (resume)

    def summary(self) -> Dict[str, object]:
        """Flat row for benchmark JSON emission."""
        return {
            "searcher": self.searcher, "workflow": self.workflow,
            "slo_s": self.slo, "feasible": self.feasible,
            "e2e_s": self.e2e_runtime, "cost": self.cost,
            "n_samples": self.n_samples, "search_time_s": self.search_time,
            "search_cost": self.search_cost, "wall_time_s": self.wall_time_s,
        }


@dataclasses.dataclass
class ResumeState:
    """Continuation handle for a resumable search.

    Holds everything ``Searcher.resume`` needs to keep sampling where
    the previous ``search``/``resume`` call stopped: the environment
    (whose trace keeps accumulating), the searched workflow with its
    current configs/runtimes, and the last cumulative result.
    ``payload`` carries searcher-specific machinery (e.g. the live
    :class:`BayesianOptimizer` with its GP history).
    """

    searcher: str
    env: Environment
    wf: Workflow
    slo: float
    result: SearchResult
    payload: object = None


@runtime_checkable
class Searcher(Protocol):
    """Anything that can configure a workflow against an SLO."""

    name: str

    def search(self, wf: Workflow, slo: float) -> SearchResult:
        """Find a per-function configuration for ``wf`` under ``slo``."""
        ...

    def resume(self, state: ResumeState, extra_budget: int) -> SearchResult:
        """Continue a previous search with up to ``extra_budget`` more
        trace samples; ``extra_budget <= 0`` returns the state's result
        unchanged (no sampling)."""
        ...


EnvLike = Union[Environment, Callable[[], Environment]]


class _EnvSearcher:
    """Shared env-factory handling + SearchResult assembly."""

    name = "base"

    def __init__(self, env: EnvLike):
        self._env_source = env

    def _fresh_env(self) -> Environment:
        if isinstance(self._env_source, Environment):
            self._env_source.reset_trace()
            return self._env_source
        return self._env_source()

    def _result(self, env: Environment, wf: Workflow, slo: float,
                configs: Dict[str, ResourceConfig], e2e: float, cost: float,
                feasible: bool, wall: float, note: str = "") -> SearchResult:
        return SearchResult(
            searcher=self.name, workflow=wf.name, slo=slo, configs=configs,
            e2e_runtime=e2e, cost=cost, feasible=feasible,
            n_samples=env.trace.n_samples,
            search_time=env.trace.total_search_runtime,
            search_cost=env.trace.total_search_cost,
            wall_time_s=wall, trace=env.trace,
            best=env.trace.best_feasible(), note=note)

    def _attach(self, res: SearchResult, env: Environment, wf: Workflow,
                slo: float, payload: object = None) -> SearchResult:
        res.state = ResumeState(searcher=self.name, env=env, wf=wf, slo=slo,
                                result=res, payload=payload)
        return res


def _base_configs(wf: Workflow) -> Dict[str, ResourceConfig]:
    """Safe over-provisioned fallback when a search finds nothing."""
    return {name: BASE_CONFIG.copy() for name in wf.nodes}


class AARCSearcher(_EnvSearcher):
    """Algorithm 1 + 2 behind the Searcher protocol."""

    name = "aarc"

    def __init__(self, env: EnvLike, *, max_trail: int = MAX_TRAIL,
                 func_trial: int = FUNC_TRIAL,
                 initial_step: float = INITIAL_STEP, batch_size: int = 1):
        super().__init__(env)
        self.max_trail = max_trail
        self.func_trial = func_trial
        self.initial_step = initial_step
        self.batch_size = batch_size

    def search(self, wf: Workflow, slo: float) -> SearchResult:
        return drive_plan(self.plan(wf, slo))

    def plan(self, wf: Workflow, slo: float) -> GridPlan:
        """The search as a lockstep-drivable plan (see
        :mod:`repro_torch.core.gridsearch`); :meth:`search` drives it
        sequentially, so both drivers run one decision sequence."""
        env = self._fresh_env()
        return GridPlan(env, self._search_plan(env, wf, slo))

    def _search_plan(self, env: Environment, wf: Workflow, slo: float):
        t0 = time.perf_counter()
        scheduler = GraphCentricScheduler(
            env, max_trail=self.max_trail, func_trial=self.func_trial,
            initial_step=self.initial_step, batch_size=self.batch_size)
        try:
            res = yield from scheduler.schedule_plan(wf, slo)
        except ValueError as exc:       # SLO infeasible even at base config
            return self._attach(
                self._result(env, wf, slo, _base_configs(wf),
                             math.inf, math.inf, False,
                             time.perf_counter() - t0, note=str(exc)),
                env, wf, slo)
        return self._attach(
            self._result(env, wf, slo, res.configs, res.e2e_runtime,
                         res.cost, res.e2e_runtime <= slo + 1e-9,
                         time.perf_counter() - t0),
            env, wf, slo)

    def resume(self, state: ResumeState, extra_budget: int) -> SearchResult:
        """Run another Algorithm-2 pass over the *current* critical path
        (recomputed from the measured runtimes, which may have shifted
        under the deallocations already accepted), spending at most
        ``extra_budget`` samples. Deallocation is monotone-cost: the
        resumed configuration is never worse than the state's."""
        return drive_plan(self.plan_resume(state, extra_budget))

    def plan_resume(self, state: ResumeState,
                    extra_budget: int) -> GridPlan:
        return GridPlan(state.env, self._resume_plan(state, extra_budget))

    def _resume_plan(self, state: ResumeState, extra_budget: int):
        if extra_budget <= 0:
            return state.result
        prior = state.result
        if not prior.feasible and not math.isfinite(prior.e2e_runtime):
            # the SLO is unreachable even at the over-provisioned base
            # config — extra budget cannot help a deterministic backend
            return prior
        env, wf, slo = state.env, state.wf, state.slo
        t0 = time.perf_counter()
        path = find_critical_path(wf)
        yield from priority_plan(
            wf, path, slo, env, global_slo=slo, max_trail=extra_budget,
            func_trial=self.func_trial, initial_step=self.initial_step,
            batch_size=self.batch_size)
        e2e = wf.end_to_end_latency()
        cost = workflow_cost(env.pricing, wf)
        wall = prior.wall_time_s + (time.perf_counter() - t0)
        res = self._result(env, wf, slo, wf.configs(), e2e, cost,
                           e2e <= slo + 1e-9, wall)
        return self._attach(res, env, wf, slo)


class BOSearcher(_EnvSearcher):
    """Joint-space GP/EI baseline behind the Searcher protocol."""

    name = "bo"

    def __init__(self, env: EnvLike, *, n_rounds: int = 100, seed: int = 0,
                 batch_size: int = 1, **bo_kwargs):
        super().__init__(env)
        self.n_rounds = n_rounds
        self.seed = seed
        self.batch_size = batch_size
        self.bo_kwargs = bo_kwargs

    def search(self, wf: Workflow, slo: float) -> SearchResult:
        return drive_plan(self.plan(wf, slo))

    def plan(self, wf: Workflow, slo: float) -> GridPlan:
        env = self._fresh_env()
        return GridPlan(env, self._search_plan(env, wf, slo))

    def _search_plan(self, env: Environment, wf: Workflow, slo: float):
        t0 = time.perf_counter()
        opt = BayesianOptimizer(wf, slo, env, seed=self.seed,
                                batch_size=self.batch_size, **self.bo_kwargs)
        best = yield from opt.run_plan(self.n_rounds)
        wall = time.perf_counter() - t0
        return self._attach(self._bo_result(env, wf, slo, best, wall),
                            env, wf, slo, payload=opt)

    def _bo_result(self, env: Environment, wf: Workflow, slo: float,
                   best: Optional[Sample], wall: float) -> SearchResult:
        if best is None:
            return self._result(env, wf, slo, _base_configs(wf), math.inf,
                                math.inf, False, wall,
                                note="no feasible sample")
        return self._result(env, wf, slo, best.configs, best.e2e_runtime,
                            best.cost, True, wall)

    def resume(self, state: ResumeState, extra_budget: int) -> SearchResult:
        """Continue the GP/EI loop for ``extra_budget`` more evaluated
        samples — the surrogate keeps its whole history, so resumed
        rounds start from the posterior the budget already paid for."""
        return drive_plan(self.plan_resume(state, extra_budget))

    def plan_resume(self, state: ResumeState,
                    extra_budget: int) -> GridPlan:
        return GridPlan(state.env, self._resume_plan(state, extra_budget))

    def _resume_plan(self, state: ResumeState, extra_budget: int):
        if extra_budget <= 0:
            return state.result
        opt: BayesianOptimizer = state.payload
        env, wf, slo = state.env, state.wf, state.slo
        t0 = time.perf_counter()
        best = yield from opt.run_plan(opt.evaluated + extra_budget)
        wall = state.result.wall_time_s + (time.perf_counter() - t0)
        return self._attach(self._bo_result(env, wf, slo, best, wall),
                            env, wf, slo, payload=opt)


class MAFFSearcher(_EnvSearcher):
    """Coupled memory-descent baseline behind the Searcher protocol.

    ``start_configs`` warm-starts the descent (see
    :func:`repro_torch.core.baselines.maff.maff_search`); the default is the
    legacy coupled base config, bit-for-bit.
    """

    name = "maff"

    def __init__(self, env: EnvLike, *, shrink: float = 0.4,
                 min_rel_step: float = 0.02, max_samples: int = 200,
                 start_configs: Optional[Dict[str, ResourceConfig]] = None):
        super().__init__(env)
        self.shrink = shrink
        self.min_rel_step = min_rel_step
        self.max_samples = max_samples
        self.start_configs = start_configs

    def search(self, wf: Workflow, slo: float) -> SearchResult:
        return drive_plan(self.plan(wf, slo))

    def plan(self, wf: Workflow, slo: float) -> GridPlan:
        env = self._fresh_env()
        return GridPlan(env, self._search_plan(env, wf, slo))

    def _search_plan(self, env: Environment, wf: Workflow, slo: float):
        t0 = time.perf_counter()
        best = yield from maff_plan(wf, slo, env, shrink=self.shrink,
                                    min_rel_step=self.min_rel_step,
                                    max_samples=self.max_samples,
                                    start_configs=self.start_configs)
        wall = time.perf_counter() - t0
        return self._attach(self._maff_result(env, wf, slo, best, wall),
                            env, wf, slo)

    def _maff_result(self, env: Environment, wf: Workflow, slo: float,
                     best: Optional[Sample], wall: float) -> SearchResult:
        if best is None:
            return self._result(env, wf, slo, _base_configs(wf), math.inf,
                                math.inf, False, wall,
                                note="infeasible at coupled base config")
        return self._result(env, wf, slo, best.configs, best.e2e_runtime,
                            best.cost, True, wall)

    def resume(self, state: ResumeState, extra_budget: int) -> SearchResult:
        """Restart the memory descent from the best configuration found
        so far with a fresh (full) shrink step and at most
        ``extra_budget`` samples (one is reserved for the re-anchoring
        base execution). The cumulative trace keeps the global best, so
        the resumed result is never worse than the state's."""
        return drive_plan(self.plan_resume(state, extra_budget))

    def plan_resume(self, state: ResumeState,
                    extra_budget: int) -> GridPlan:
        return GridPlan(state.env, self._resume_plan(state, extra_budget))

    def _resume_plan(self, state: ResumeState, extra_budget: int):
        if extra_budget <= 0 or not state.result.feasible:
            # infeasible means the coupled base violates the SLO — on a
            # deterministic backend no amount of budget changes that
            return state.result
        prior = state.result
        env, wf, slo = state.env, state.wf, state.slo
        t0 = time.perf_counter()
        # no fallback retry: the re-anchoring base execution is the one
        # sample reserved out of the grant, so resume spends at most
        # extra_budget samples even on a stochastic backend
        best = yield from maff_plan(wf, slo, env, shrink=self.shrink,
                                    min_rel_step=self.min_rel_step,
                                    max_samples=max(0, extra_budget - 1),
                                    start_configs=prior.configs,
                                    fallback_to_base=False)
        wall = prior.wall_time_s + (time.perf_counter() - t0)
        if best is None:
            # only possible when stochastic noise made the incumbent
            # replay infeasible: keep the incumbent, charge the sample
            res = self._result(env, wf, slo, prior.configs,
                               prior.e2e_runtime, prior.cost, True, wall)
            return self._attach(res, env, wf, slo)
        return self._attach(self._maff_result(env, wf, slo, best, wall),
                            env, wf, slo)


def retune_state(state: ResumeState, *, slo: Optional[float] = None,
                 input_scale: Optional[float] = None,
                 reset_to_base: bool = True) -> int:
    """Re-aim a resumable search at shifted serving conditions.

    An online control plane (the reference's ``core/online.py``, not
    yet ported) observes drift *while serving* and routes an
    incremental grant through ``Searcher.resume``; before resuming, the
    continuation has to reflect the world the grant is meant to fix:

      * ``slo`` retargets the continuation — typically an *effective*
        SLO tightened by the queueing/cold-start overhead observed live,
        so the re-searched configuration keeps headroom under
        contention. Searchers that re-derive from ``state.slo`` (AARC,
        MAFF) pick it up; BO keeps its construction-time objective,
      * ``input_scale`` repoints the state's backend at the drifted
        input-class mix (backends without the knob ignore it),
      * ``reset_to_base`` restores the over-provisioned base config so
        a deallocation search (AARC) re-descends under the new response
        surface instead of being wedged at an incumbent that now
        violates the SLO (deallocation can never *add* resources).

    The workflow is then re-measured once under the new conditions so
    cached node runtimes — and with them AARC's critical path and the
    continuation's feasibility bookkeeping — are live rather than
    pre-drift. That re-measure charges ONE full-workflow sample to the
    state's trace; the number of samples spent is returned so grant
    ledgers stay exact (``allocated == spent + remaining``)."""
    if slo is not None:
        state.slo = slo
    if input_scale is not None and hasattr(state.env.backend, "input_scale"):
        state.env.backend.input_scale = input_scale
    if reset_to_base:
        for node in state.wf:
            node.config = BASE_CONFIG.copy()
    before = state.env.trace.n_samples
    sample = state.env.execute(state.wf, state.slo, note="retune")
    res = state.result
    res.slo = state.slo
    res.configs = state.wf.configs()
    res.e2e_runtime = sample.e2e_runtime
    res.cost = sample.cost
    res.feasible = sample.feasible
    return state.env.trace.n_samples - before


#: registry: campaign specs / CLIs name searchers as strings
SEARCHERS: Dict[str, Type] = {
    AARCSearcher.name: AARCSearcher,
    BOSearcher.name: BOSearcher,
    MAFFSearcher.name: MAFFSearcher,
}


def make_searcher(name: str, env: EnvLike, **kwargs) -> Searcher:
    """Instantiate a registered searcher by name."""
    try:
        cls = SEARCHERS[name]
    except KeyError:
        # wrapper searchers register themselves on import; importing
        # them here (not at module top) keeps core.search free of a
        # circular dependency on core.autoscale / core.faults
        import repro_torch.core.autoscale  # noqa: F401
        import repro_torch.core.faults     # noqa: F401
        try:
            cls = SEARCHERS[name]
        except KeyError:
            raise ValueError(
                f"unknown searcher {name!r}; choose from {sorted(SEARCHERS)}")
    return cls(env, **kwargs)
