"""Portfolio campaigns: generator → searchers → fleet replay.

A *campaign* evaluates searchers at fleet scale instead of one
hand-built workflow per script:

  1. **portfolio** — generate N seed-reproducible workflows
     (:mod:`repro_torch.serverless.generator` topology families,
     affinity profiles) from one master seed,
  2. **SLO grid** — each workflow is searched against a grid of SLOs
     derived from its base-config latency (slack factors),
  3. **search** — every registered
     :class:`repro_torch.core.search.Searcher` configures every
     (workflow, SLO) task; traces capture modeled search time / cost /
     sample counts,
  4. **fleet replay** — each found configuration is replayed through
     the discrete-event :class:`repro_torch.core.engine.FleetEngine`
     under Poisson load on a (optionally finite) cluster, reporting
     realized SLO attainment, latency percentiles, and fleet cost.

The result is one table: per searcher, how much search time bought how
much SLO attainment at what cost — the paper's Fig. 5 comparison, but
over hundreds of generated scenarios instead of three workflows.

All randomness (workflow structure, response surfaces, SLO grid,
arrival processes) derives from ``CampaignSpec.seed``, so campaigns
are exactly reproducible.

The port's copy of ``src/repro/core/campaign.py``, with one addition:
``device``. Every replay engine a campaign builds gets it, so on the
default :class:`ReplaySpec` (infinite cluster, no cold start) each
replay's contention-free plane sweeps on that device
(:func:`repro_torch.core.engine.fast_plane_sweep`). ``device=None``
means the CUDA card, as for :class:`FleetEngine`: without a card the
first such replay raises, and nothing falls back. The sweep is fp64 and
equals the numpy sweep bit for bit, so reports do not depend on the
device.
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dag import Workflow
from repro_torch.core.engine import (ClusterModel, ColdStartModel, FleetCarry,
                                     FleetEngine, INFINITE_CLUSTER,
                                     NO_COLD_START, PoissonArrivals,
                                     ReplicaModel)
from repro_torch.core.env import Environment
from repro_torch.core.search import (GridCell, SearchResult, Searcher,
                                     make_searcher, run_grid_search)
from repro_torch.device import DeviceLike

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class PortfolioSpec:
    """What workflows a campaign sweeps."""

    n_workflows: int = 16
    kinds: Sequence[str] = ("chain", "fan", "diamond", "layered")
    #: approximate node count per generated workflow
    size: int = 8
    #: SLO grid: each slack × the workflow's base-config latency
    slo_slacks: Sequence[float] = (1.5,)


@dataclasses.dataclass(frozen=True)
class ReplaySpec:
    """How each found configuration is replayed through the fleet."""

    n_instances: int = 32
    rate: float = 0.2                    # Poisson arrivals / second
    cluster: ClusterModel = INFINITE_CLUSTER
    cold_start: ColdStartModel = NO_COLD_START


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    portfolio: PortfolioSpec = PortfolioSpec()
    replay: ReplaySpec = ReplaySpec()
    searchers: Sequence[str] = ("aarc", "bo", "maff")
    #: per-searcher constructor kwargs, keyed by registry name
    searcher_kwargs: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class CampaignTask:
    """One (generated workflow, SLO) cell of the sweep."""

    index: int
    kind: str
    wf_seed: int
    slo: float
    slack: float
    n_nodes: int
    template: Workflow               # pristine template; copied per searcher


@dataclasses.dataclass
class ReplayMetrics:
    slo_attainment: float
    p50_s: float
    p99_s: float
    total_cost: float
    total_queue_delay_s: float

    def row(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class TaskResult:
    task: CampaignTask
    search: SearchResult
    replay: Optional[ReplayMetrics]

    def row(self) -> Dict[str, object]:
        out = {"task": self.task.index, "kind": self.task.kind,
               "wf_seed": self.task.wf_seed, "n_nodes": self.task.n_nodes,
               "slack": self.task.slack}
        out.update(self.search.summary())
        if self.replay is not None:
            out.update({f"replay_{k}": v for k, v in self.replay.row().items()})
        return out


@dataclasses.dataclass
class CampaignReport:
    spec: CampaignSpec
    results: List[TaskResult]
    wall_time_s: float

    def by_searcher(self) -> Dict[str, List[TaskResult]]:
        out: Dict[str, List[TaskResult]] = {}
        for r in self.results:
            out.setdefault(r.search.searcher, []).append(r)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-searcher aggregates over the whole campaign, including
        search-time deltas relative to the slowest searcher."""
        per: Dict[str, Dict[str, float]] = {}
        for name, rows in self.by_searcher().items():
            n = len(rows)
            feas = [r for r in rows if r.search.feasible]
            att = [r.replay.slo_attainment for r in rows
                   if r.replay is not None]
            cost = [r.replay.total_cost for r in rows if r.replay is not None]
            per[name] = {
                "n_tasks": n,
                "feasible_rate": len(feas) / n if n else float("nan"),
                "total_search_time_s": sum(r.search.search_time for r in rows),
                "total_search_cost": sum(r.search.search_cost for r in rows),
                "total_samples": sum(r.search.n_samples for r in rows),
                "total_wall_s": sum(r.search.wall_time_s for r in rows),
                "mean_slo_attainment": (sum(att) / len(att)) if att
                else float("nan"),
                "mean_replay_cost": (sum(cost) / len(cost)) if cost
                else float("nan"),
                "workflows_per_s": (n / sum(r.search.wall_time_s
                                            for r in rows))
                if rows else float("nan"),
            }
        # search-time reduction vs the slowest searcher (the paper's
        # headline metric, generalized across the portfolio)
        finite = {k: v["total_search_time_s"] for k, v in per.items()
                  if math.isfinite(v["total_search_time_s"])}
        if finite:
            worst = max(finite.values())
            for name, agg in per.items():
                t = agg["total_search_time_s"]
                agg["search_time_reduction_vs_worst"] = (
                    1.0 - t / worst if worst > 0 else 0.0)
        return per

    def totals(self) -> Dict[str, float]:
        """Portfolio-wide aggregates across every (task, searcher) row —
        the probe-budget / attainment axes the adaptive scheduler is
        compared against."""
        rows = self.results
        att = [r.replay.slo_attainment for r in rows if r.replay is not None]
        cost = [r.replay.total_cost for r in rows if r.replay is not None]
        return {
            "n_results": len(rows),
            "total_samples": sum(r.search.n_samples for r in rows),
            "total_search_time_s": sum(r.search.search_time for r in rows),
            "total_search_cost": sum(r.search.search_cost for r in rows),
            "feasible_rate": (sum(r.search.feasible for r in rows)
                              / len(rows)) if rows else float("nan"),
            "mean_slo_attainment": (sum(att) / len(att)) if att
            else float("nan"),
            "mean_replay_cost": (sum(cost) / len(cost)) if cost
            else float("nan"),
        }

    def to_rows(self) -> List[Dict[str, object]]:
        return [r.row() for r in self.results]


def _build_workflow(kind: str, size: int, seed: int) -> Workflow:
    """Map (family, size) onto the generator's per-family parameters."""
    from repro_torch.serverless import generator as gen

    if kind == "chain":
        return gen.chain_workflow(max(1, size), seed=seed)
    if kind == "fan":
        return gen.fan_workflow(max(1, size - 2), seed=seed)
    if kind == "diamond":
        return gen.diamond_workflow(max(1, size // 4), seed=seed)
    if kind == "layered":
        return gen.layered_workflow(max(2, size),
                                    n_layers=max(2, size // 3), seed=seed)
    raise ValueError(f"unknown workflow kind {kind!r}")


def _default_env_factory() -> Environment:
    from repro_torch.serverless.platform import make_env

    return make_env()


class Campaign:
    """Runs a :class:`CampaignSpec` end to end.

    ``env_factory`` builds the :class:`Environment` each search samples
    through (default: a fresh analytic simulated platform); replay uses
    the same backend/pricing so searched and replayed latencies agree.
    ``device`` is where every replay engine sweeps its contention-free
    plane (``None``: the CUDA card).
    """

    def __init__(self, spec: CampaignSpec = CampaignSpec(), *,
                 env_factory: Optional[Callable[[], Environment]] = None,
                 device: DeviceLike = None):
        self.spec = spec
        self.env_factory = env_factory or _default_env_factory
        self.device = device
        #: cached default-spec replay engine (pricing/backend/cluster
        #: are fixed per campaign; see :meth:`_replay_engine`)
        self._engine: Optional[FleetEngine] = None
        #: (plane, reasons) combinations already logged — replay
        #: fallbacks are reported once each, not once per replay
        self._fallback_logged: set = set()

    # -- portfolio -----------------------------------------------------
    def tasks(self) -> List[CampaignTask]:
        """The (workflow × SLO) grid, reproducible from the master seed."""
        from repro_torch.serverless.generator import suggest_slo

        p = self.spec.portfolio
        rng = np.random.default_rng(self.spec.seed)
        wf_seeds = rng.integers(0, 2**31 - 1, size=p.n_workflows)
        tasks: List[CampaignTask] = []
        idx = 0
        for i in range(p.n_workflows):
            kind = p.kinds[i % len(p.kinds)]
            wf = _build_workflow(kind, p.size, int(wf_seeds[i]))
            for slack in p.slo_slacks:
                # generated names (f"{kind}-{seed}") are NOT unique
                # across the grid: the same workflow appears once per
                # SLO slack, and seed collisions are possible. Each
                # cell gets its own template copy with a grid-unique
                # tenant id, so cells packed into one shared engine
                # can never alias each other's warm containers or
                # queue ledgers (Workflow.identity keys both).
                tpl = wf.copy()
                tpl.tenant = f"cell{idx}.{wf.name}"
                tasks.append(CampaignTask(
                    index=idx, kind=kind, wf_seed=int(wf_seeds[i]),
                    slo=suggest_slo(wf, slack=slack), slack=slack,
                    n_nodes=len(wf), template=tpl))
                idx += 1
        return tasks

    def searchers(self) -> List[Searcher]:
        return [make_searcher(name, self.env_factory,
                              **self.spec.searcher_kwargs.get(name, {}))
                for name in self.spec.searchers]

    def arrival_seeds(self, n_tasks: int) -> List[int]:
        """Per-task replay arrival seeds — independent of the workflow
        seeds but derived from the same master seed, so any scheduler
        (uniform sweep or adaptive) replaying task ``i`` sees the
        bit-identical arrival process."""
        rng = np.random.default_rng(self.spec.seed + 1)
        return [int(s) for s in rng.integers(0, 2**31 - 1, size=n_tasks)]

    # -- replay --------------------------------------------------------
    def replay(self, task: CampaignTask, result: SearchResult,
               arrival_seed: int) -> ReplayMetrics:
        """Replay one found configuration through the fleet engine under
        Poisson load; infeasible searches fall back to the searcher's
        reported (safe, over-provisioned) configuration."""
        return self.replay_configs(task, result.configs, arrival_seed)

    def replay_configs(self, task: CampaignTask,
                       configs: Dict[str, "ResourceConfig"],
                       arrival_seed: int, *,
                       rate: Optional[float] = None,
                       n_instances: Optional[int] = None,
                       cluster: Optional[ClusterModel] = None,
                       cold_start: Optional[ColdStartModel] = None,
                       env: Optional[Environment] = None,
                       start: float = 0.0,
                       carry: Optional["FleetCarry"] = None,
                       scale: Optional["ReplicaModel"] = None,
                       faults=None, resilience=None
                       ) -> ReplayMetrics:
        """Replay an *explicit* per-function configuration — the
        challenger-evaluation hook: the online control plane validates
        a candidate reconfiguration against the live arrival seed (and
        the live load/cold-start conditions, via the keyword overrides
        and a conditions-tuned ``env``) before atomically swapping it
        in. ``start``/``carry`` replay from a live fleet state (the
        backlog and warm pool the challenger would inherit) instead of
        an empty cluster; ``scale`` replays under replica-bounded
        admission (the joint autoscaling challenger gate);
        ``faults``/``resilience`` replay under the live fault stream
        with the candidate's recovery policies (the failure-bound
        challenger gate). Defaults reproduce :meth:`replay` exactly."""
        return self.replay_configs_many(
            task, [configs], arrival_seed, rate=rate,
            n_instances=n_instances, cluster=cluster, cold_start=cold_start,
            env=env, start=start, carry=carry, scale=scale,
            faults=faults, resilience=resilience)[0]

    def replay_configs_many(self, task: CampaignTask,
                            config_sets: Sequence[Dict[str, "ResourceConfig"]],
                            arrival_seed: int, *,
                            rate: Optional[float] = None,
                            n_instances: Optional[int] = None,
                            cluster: Optional[ClusterModel] = None,
                            cold_start: Optional[ColdStartModel] = None,
                            env: Optional[Environment] = None,
                            start: float = 0.0,
                            carry: Optional["FleetCarry"] = None,
                            scale: Optional["ReplicaModel"] = None,
                            faults=None, resilience=None
                            ) -> List[ReplayMetrics]:
        """Replay C candidate config-maps on the same arrival seed as
        one batched :meth:`FleetEngine.run_many` evaluation (the
        incumbent-vs-challenger hot path) — bit-identical to C
        :meth:`replay_configs` calls on a deterministic backend."""
        r = self.spec.replay
        engine = self._replay_engine(
            env,
            cluster if cluster is not None else r.cluster,
            cold_start if cold_start is not None else r.cold_start,
            scale, faults, resilience)
        n = n_instances if n_instances is not None else r.n_instances
        arrivals = PoissonArrivals(rate if rate is not None else r.rate,
                                   n, seed=arrival_seed, start=start)
        elig = engine.batch_eligibility(task.template, config_sets)
        if not elig["vectorized"]:
            # silent serialization is how batched replay regressions
            # hide — surface the routing once per distinct cause
            key = (elig["plane"], tuple(elig["reasons"]))
            if key not in self._fallback_logged:
                self._fallback_logged.add(key)
                logger.info(
                    "replay_configs_many: %s plane for task %d: %s",
                    elig["plane"], task.index,
                    "; ".join(elig["reasons"]) or "no reason reported")
        reports = engine.run_many(task.template, list(config_sets),
                                  [arrivals.times()], carry=carry)
        return [ReplayMetrics(
            slo_attainment=report.slo_attainment(task.slo),
            p50_s=report.p50, p99_s=report.p99,
            total_cost=report.total_cost,
            total_queue_delay_s=report.total_queue_delay)
            for report in reports]

    def _replay_engine(self, env: Optional[Environment],
                       cluster: ClusterModel,
                       cold_start: ColdStartModel,
                       scale: Optional["ReplicaModel"] = None,
                       faults=None, resilience=None
                       ) -> FleetEngine:
        """The engine replays run through. Pricing/backend/cluster are
        fixed per campaign, so the default-spec engine is built ONCE
        and reused across every replay of the run (the engine keeps no
        state between runs). Overridden conditions — including a
        :class:`ReplicaModel` (replica assignments change per
        challenger) or a fault model / resilience policy set (both
        change per epoch and per challenger) — get a per-call engine; a *stateful* (stochastic)
        backend is never cached so each replay still sees a fresh noise
        stream, exactly like the historical fresh-env-per-replay path."""
        default = (env is None and scale is None and faults is None
                   and resilience is None
                   and cluster == self.spec.replay.cluster
                   and cold_start == self.spec.replay.cold_start)
        if default and self._engine is not None:
            return self._engine
        env = env if env is not None else self.env_factory()
        engine = FleetEngine(env.backend, pricing=env.pricing,
                             cluster=cluster, cold_start=cold_start,
                             scale=scale, faults=faults,
                             resilience=resilience, device=self.device)
        if default and getattr(env.backend, "deterministic", False):
            self._engine = engine
        return engine

    # -- the pipeline --------------------------------------------------
    def run(self, *, with_replay: bool = True,
            progress: Optional[Callable[[str], None]] = None,
            search_plane: str = "grid") -> CampaignReport:
        """Search every (task, searcher) cell, then replay.

        ``search_plane="grid"`` (the default) advances all cells in
        lockstep through
        :func:`repro_torch.core.search.run_grid_search`, fusing each
        round's probes across cells into single backend evaluations;
        per-cell traces are bit-identical to
        ``search_plane="sequential"`` (the legacy one-cell-at-a-time
        loop), which remains available for A/B timing.
        """
        if search_plane not in ("grid", "sequential"):
            raise ValueError(
                f"unknown search_plane {search_plane!r}; "
                "choose 'grid' or 'sequential'")
        t0 = time.perf_counter()
        tasks = self.tasks()
        searchers = self.searchers()
        arrival_seeds = self.arrival_seeds(len(tasks))
        cells: List[GridCell] = []
        owners: List[Tuple[CampaignTask, Searcher]] = []
        for task in tasks:
            for searcher in searchers:
                cells.append(GridCell(searcher=searcher,
                                      wf=task.template.copy(), slo=task.slo))
                owners.append((task, searcher))
        if search_plane == "grid":
            search_results = run_grid_search(cells).results
        else:
            search_results = [c.searcher.search(c.wf, c.slo) for c in cells]
        results: List[TaskResult] = []
        for (task, searcher), res in zip(owners, search_results):
            replay = (self.replay(task, res, int(arrival_seeds[task.index]))
                      if with_replay else None)
            results.append(TaskResult(task=task, search=res, replay=replay))
            if progress is not None:
                progress(f"{searcher.name} {task.kind}#{task.index} "
                         f"feasible={res.feasible} "
                         f"samples={res.n_samples}")
        return CampaignReport(spec=self.spec, results=results,
                              wall_time_s=time.perf_counter() - t0)


def run_campaign(spec: CampaignSpec = CampaignSpec(), *,
                 env_factory: Optional[Callable[[], Environment]] = None,
                 with_replay: bool = True,
                 search_plane: str = "grid",
                 device: DeviceLike = None) -> CampaignReport:
    """Functional entry point: ``run_campaign(CampaignSpec(...))``."""
    return Campaign(spec, env_factory=env_factory, device=device).run(
        with_replay=with_replay, search_plane=search_plane)
