"""Online serving control plane: drift-triggered reconfiguration of a
live fleet.

AARC configures a workflow once, at deploy time; the SLO-compliance
claim only holds while load and input distribution match what the
searcher probed. This module closes the loop *while serving*:

  1. **deploy** — every (workflow, SLO) cell of a generated portfolio
     is configured by one searcher (default AARC) and validated by a
     fleet replay on the campaign's arrival seeds; that validated
     attainment is the cell's **baseline** and detection target,
  2. **serve** — the fleet runs in bounded time epochs through
     :class:`repro_torch.core.engine.FleetEngine`. Epochs are *resumable*:
     each run starts from the previous epoch's :class:`FleetCarry`
     (warm containers + in-flight capacity), so the fleet is never
     restarted cold at a boundary. Arrival rate, input-class mix and
     the cold-start regime follow a seeded
     :class:`repro_torch.serverless.generator.DriftSchedule`,
  3. **detect** — per cell, a sliding window over the last ``window``
     served instances estimates live attainment; drift is declared
     when the window's *upper* confidence bound falls below the
     baseline minus ``target_margin`` (i.e. the cell is below target
     with statistical confidence, not just wobbling),
  4. **reconfigure** — drifted cells are ranked by the shared
     :class:`repro_torch.core.adaptive.GrantScorer` and receive incremental
     search grants routed through the existing
     ``Searcher.resume``/``ResumeState`` machinery:
     :func:`repro_torch.core.search.retune_state` first re-aims the
     continuation at the live conditions (drifted ``input_scale``, an
     *effective* SLO tightened by the queueing/cold-start overhead
     observed in the window, base-config reset so deallocation can
     re-descend) at the cost of one re-measure sample, then ``resume``
     spends the rest of the grant,
  5. **validate & swap** — the challenger configuration and the
     incumbent are both replayed on the epoch's *live* arrival seed
     under the live conditions
     (:meth:`repro_torch.core.campaign.Campaign.replay_configs`); the
     challenger is swapped in — atomically, at the epoch boundary —
     only if it validates strictly better (or equal attainment at
     lower fleet cost). A reconfiguration can therefore never lower a
     cell's validated attainment,
  6. **account** — every grant lands in a deterministic
     reconfiguration ledger; the sample budget satisfies
     ``allocated == spent + remaining`` at all times, and
     :meth:`OnlineReport.to_payload` is byte-stable across runs of one
     master seed (wall-clock never enters the payload).

``OnlineSpec.mode`` selects the control policy over the *same* serving
loop, which is what makes the comparisons exact:

  * ``"drift"``       — the control plane above (default),
  * ``"never"``       — a static, configure-once fleet (the paper's
    deployment model). With an empty :class:`DriftSchedule`, a
    ``"drift"`` run is bit-identical to this — the detector stays
    silent and the serving path is shared code,
  * ``"every_epoch"`` — naive adaptation: a full re-search of every
    cell at every epoch boundary, swapped in unconditionally. The
    probe-budget comparator for the benchmark's ≤50%-of-naive bar.

The port's copy of ``src/repro/core/online.py``, with one addition:
``device``. :class:`OnlineController` and :func:`run_online` hand it to
the inner :class:`repro_torch.core.campaign.Campaign`, whose engines run
the deploy and challenger replays, and to every
:class:`repro_torch.core.engine.FleetEngine` the controller builds (the
Erlang probe, the serving epochs, the packed fleet). Only a replay on an
infinite cluster without cold starts, replica pools, faults,
interference or a collected carry takes the contention-free plane, and
that plane sweeps on ``device`` (``None``: the CUDA card, raising
without one at the first such sweep; nothing falls back). The sweep is
fp64 and equals the numpy sweep bit for bit, so reports and payloads do
not depend on the device.
"""
from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.adaptive import GrantScorer
from repro_torch.core.autoscale import (AutoscaleSpec, classify_saturation,
                                        grant_replicas, pool_capacity_factor)
from repro_torch.core.campaign import (Campaign, CampaignSpec, CampaignTask,
                                       PortfolioSpec, ReplayMetrics,
                                       ReplaySpec)
from repro_torch.core.critical_path import find_critical_path
from repro_torch.core.engine import (ClusterModel, ColdStartModel, FleetCarry,
                                     FleetEngine, PoissonArrivals,
                                     ReplicaModel)
from repro_torch.core.env import Environment
from repro_torch.core.faults import (FaultModel, ResilienceModel,
                                     ResilienceSpec, classify_failures,
                                     degrade_policies, grant_policies)
from repro_torch.core.placement import (PlacementPlan, PlacementSpec,
                                        TenantCell, plan_placement,
                                        scale_cluster)
from repro_torch.core.resources import ResourceConfig
from repro_torch.core.search import (GridCell, SearchResult, Searcher,
                                     make_searcher, retune_state,
                                     run_grid_search)
from repro_torch.device import DeviceLike
from repro_torch.serverless.generator import DriftSchedule, EpochConditions

#: control policies (see module docstring)
MODES = ("drift", "never", "every_epoch")


@dataclasses.dataclass(frozen=True)
class OnlineSpec:
    """One online serving run: portfolio + drift + control policy."""

    portfolio: PortfolioSpec = PortfolioSpec(n_workflows=4, size=6,
                                             slo_slacks=(2.0,))
    #: per-epoch serving load: ``n_instances`` arrivals at ``rate``
    #: (scaled by the drift schedule) on ``cluster`` with ``cold_start``
    replay: ReplaySpec = ReplaySpec()
    searcher: str = "aarc"
    searcher_kwargs: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    seed: int = 0
    n_epochs: int = 8
    drift: DriftSchedule = DriftSchedule()
    mode: str = "drift"
    #: shared-cluster serving: pack every cell into ONE fleet engine
    #: behind an affinity-aware placement (see
    #: :mod:`repro_torch.core.placement`). ``None`` keeps the historical
    #: per-cell private-quota serving. When set, the packed cluster is
    #: ``placement.cluster`` or the per-cell ``replay.cluster`` scaled
    #: by the number of cells (equal total capacity), and challenger
    #: validation replays *inside* the packed cluster so cross-cell
    #: interference gates every swap.
    placement: Optional[PlacementSpec] = None
    #: joint autoscaling: serve replica-bounded (every function runs
    #: behind a replica pool, provisioning billed replica-seconds),
    #: classify drift capacity-bound vs config-bound from the fleet's
    #: saturation diagnostics, and route grants to the scale actuator
    #: (replicas + cluster capacity) or the config actuator per
    #: ``AutoscaleSpec.actuators`` — challengers are validated over
    #: ``(config, replicas)`` jointly. ``None`` (the default) keeps the
    #: historical config-only serving path bit-identically (no
    #: :class:`ReplicaModel` is ever constructed).
    autoscale: Optional[AutoscaleSpec] = None
    #: live fault injection: every serving epoch and every challenger
    #: validation runs under this fault model, reseeded per epoch so
    #: each epoch draws a fresh (but deterministic) fault stream while
    #: challenger-vs-incumbent validation *inside* an epoch replays the
    #: same paired draws. ``None`` (the default) keeps the fault-free
    #: serving path bit-identically (the engine never constructs a
    #: fault stream).
    faults: Optional[FaultModel] = None
    #: recovery-policy actuator (requires ``faults``): cells serve
    #: behind per-function ladder policies
    #: (:func:`repro_torch.core.faults.policy_ladder`), drift misses classify
    #: as *failure-bound* off the fleet's failure diagnostics — checked
    #: before the capacity/config split — and grants climb the recovery
    #: ladder (or degrade it off the critical path when attainment
    #: collapses under an outage) as reconfigure candidates validated
    #: jointly with config/scale actions. ``None`` serves with no
    #: recovery (and, without ``faults``, keeps byte-identity).
    resilience: Optional[ResilienceSpec] = None
    # -- drift detection ----------------------------------------------
    #: sliding-window length (served instances) per cell
    window: int = 48
    #: observations required before the detector may fire
    min_observations: int = 12
    #: one-sided confidence multiplier on the window's binomial s.e.
    confidence_z: float = 1.64
    #: detection target = deploy-validated baseline − this margin
    target_margin: float = 0.05
    #: epochs a cell sits out after receiving a grant
    cooldown_epochs: int = 1
    #: consecutive rejected challengers before a cell stops receiving
    #: grants (re-armed when the drift schedule enters a new regime)
    max_failed_grants: int = 3
    # -- grant routing ------------------------------------------------
    #: hard cap on online probe samples across the whole run
    total_budget: int = 256
    #: samples per reconfiguration grant (incl. the retune re-measure)
    grant_budget: int = 16
    #: drifted cells granted per epoch (score-ordered)
    grants_per_epoch: int = 4
    #: shared UCB scorer (one implementation with core.adaptive)
    scorer: GrantScorer = GrantScorer()
    #: validation-replay horizon (arrivals); default 2× the serving
    #: epoch so a challenger that merely *postpones* saturation (drains
    #: the backlog, then drowns again) is caught before the swap
    validation_instances: Optional[int] = None
    #: quantile of observed per-instance queue+cold overhead subtracted
    #: from the SLO when retuning (headroom for contention)
    headroom_quantile: float = 0.9
    #: never tighten the effective SLO below this fraction of the SLO
    slo_floor_frac: float = 0.3
    attainment_tol: float = 1e-9

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(
                f"unknown mode {self.mode!r}; choose from {MODES}")
        if self.grant_budget < 2:
            # one sample is consumed by the retune re-measure; a grant
            # must leave the searcher at least one sample to spend, or
            # the "challenger" would just be the base-config reset
            raise ValueError("grant_budget must be >= 2 (retune + search)")
        if self.resilience is not None and self.faults is None:
            # the engine treats resilience as inert without faults; at
            # the spec level that is a misconfiguration, not a no-op
            raise ValueError("resilience requires faults (the recovery "
                             "actuator answers injected failures)")


@dataclasses.dataclass
class ReconfigRecord:
    """One grant in the reconfiguration ledger."""

    epoch: int
    cell: int
    granted: int
    spent: int
    accepted: bool
    validated_before: float      # incumbent attainment on the live seed
    validated_after: float       # what the swap (or rejection) kept
    cost_before: float
    cost_after: float
    effective_slo: float
    note: str = ""

    def row(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ServingCell:
    """One (workflow, SLO) cell of the live fleet."""

    index: int
    task: CampaignTask
    arrival_seed: int                        # deploy-validation seed
    searcher: Optional[Searcher] = None
    result: Optional[SearchResult] = None    # live search continuation
    #: incumbent serving configuration (the atomic-swap target)
    configs: Dict[str, ResourceConfig] = dataclasses.field(
        default_factory=dict)
    baseline: float = 0.0                    # deploy-validated attainment
    baseline_cost: float = math.inf
    validated: float = 0.0                   # latest validated attainment
    validated_cost: float = math.inf
    window: Deque[bool] = dataclasses.field(
        default_factory=collections.deque)
    overheads: Deque[float] = dataclasses.field(
        default_factory=collections.deque)
    carry: Optional[FleetCarry] = None
    clock: float = 0.0
    #: joint-autoscaling state (``None`` unless ``OnlineSpec.autoscale``
    #: is set): per-function replica pools, the cell's cluster-capacity
    #: factor, and the latest serving epoch's saturation diagnostics
    replicas: Optional[Dict[str, int]] = None
    cluster_scale: float = 1.0
    queue_share: float = 0.0
    #: recovery-policy state (``None`` unless ``OnlineSpec.resilience``
    #: is set): per-function ladder levels, the solo-runtime scale the
    #: ladder's timeouts/hedges key off, and the latest epoch's failed
    #: attempt count (the failure-bound classification observable)
    policy_levels: Optional[Dict[str, int]] = None
    runtimes: Dict[str, float] = dataclasses.field(default_factory=dict)
    failures: int = 0
    saturation: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    deploy_spent: int = 0
    spent: int = 0                           # online probe samples
    grants: int = 0
    last_gain: float = 0.0
    failed_grants: int = 0                   # consecutive, per regime
    regime: int = 0
    cooldown: int = 0
    note: str = ""

    def live_attainment(self) -> float:
        if not self.window:
            return float("nan")
        return sum(self.window) / len(self.window)

    def row(self) -> Dict[str, object]:
        row = {
            "cell": self.index, "task": self.task.index,
            "kind": self.task.kind, "wf_seed": self.task.wf_seed,
            "n_nodes": self.task.n_nodes, "slo_s": self.task.slo,
            "baseline": self.baseline, "validated": self.validated,
            "validated_cost": self.validated_cost,
            "deploy_spent": self.deploy_spent, "spent": self.spent,
            "grants": self.grants, "failed_grants": self.failed_grants,
            "configs": sorted((n, c.cpu, c.mem)
                              for n, c in self.configs.items()),
            "note": self.note,
        }
        if self.replicas is not None:
            # joint-autoscaling cells only: keeps autoscale-off payloads
            # (BENCH_online.json) byte-identical to the pre-replica rows
            row["replicas"] = sorted(self.replicas.items())
            row["cluster_scale"] = self.cluster_scale
        if self.policy_levels is not None:
            # resilience cells only: fault-free payloads stay pinned
            row["policy_levels"] = sorted(self.policy_levels.items())
        return row


@dataclasses.dataclass
class OnlineReport:
    spec: OnlineSpec
    cells: List[ServingCell]
    #: per-(cell, epoch) serving rows — identical across control modes
    #: whenever no swap fired (the static-equivalence pin)
    epochs: List[Dict[str, object]]
    reconfigs: List[ReconfigRecord]
    budget: Dict[str, int]                   # {"total", "spent", "remaining"}
    deploy_spent: int
    n_validations: int
    wall_time_s: float
    #: packed-serving audit (only when ``spec.placement`` is set):
    #: solver method/score, heavy spread, multiplier count, cluster
    placement: Optional[Dict[str, object]] = None

    def epoch_attainment(self) -> List[float]:
        """Mean live attainment across cells, per epoch."""
        per: Dict[int, List[float]] = {}
        for row in self.epochs:
            per.setdefault(int(row["epoch"]), []).append(
                float(row["attainment"]))
        return [sum(v) / len(v) for _, v in sorted(per.items())]

    def mean_attainment(self, epochs: Optional[range] = None) -> float:
        att = self.epoch_attainment()
        if epochs is not None:
            att = [att[e] for e in epochs if 0 <= e < len(att)]
        return (sum(att) / len(att)) if att else float("nan")

    def to_payload(self) -> Dict[str, object]:
        """JSON-ready, *deterministic* snapshot: everything derives from
        the master seed (wall-clock is excluded), so two runs of one
        spec emit byte-identical payloads."""
        s = self.spec
        payload: Dict[str, object] = {
            "spec": {
                "mode": s.mode, "searcher": s.searcher, "seed": s.seed,
                "n_epochs": s.n_epochs,
                "n_workflows": s.portfolio.n_workflows,
                "kinds": list(s.portfolio.kinds),
                "size": s.portfolio.size,
                "slo_slacks": list(s.portfolio.slo_slacks),
                "n_instances": s.replay.n_instances,
                "rate": s.replay.rate,
                "drift": [dataclasses.asdict(e) for e in s.drift.events],
                "window": s.window, "confidence_z": s.confidence_z,
                "target_margin": s.target_margin,
                "total_budget": s.total_budget,
                "grant_budget": s.grant_budget,
            },
            "budget": dict(self.budget),
            "deploy_spent": self.deploy_spent,
            "n_validations": self.n_validations,
            "epoch_attainment": self.epoch_attainment(),
            "mean_attainment": self.mean_attainment(),
            "epochs": list(self.epochs),
            "reconfigs": [r.row() for r in self.reconfigs],
            "cells": [c.row() for c in self.cells],
        }
        if s.autoscale is not None:
            a = s.autoscale
            payload["spec"]["autoscale"] = {
                "actuators": list(a.actuators),
                "max_replicas": a.max_replicas,
                "grant_width": a.grant_width,
                "max_cluster_scale": a.max_cluster_scale,
                "provision_frac": a.provision_frac,
                "provision_floor": a.provision_floor,
                "queue_share_threshold": a.queue_share_threshold,
                "min_overhead_frac": a.min_overhead_frac,
            }
        if s.faults is not None:
            f = s.faults
            payload["spec"]["faults"] = {
                "default_transient": f.default_transient,
                "transient": sorted(
                    (str(k), v) for k, v in f.transient.items()),
                "straggler_prob": f.straggler_prob,
                "straggler_factor": f.straggler_factor,
                "cold_fail": f.cold_fail,
                "outages": [dataclasses.asdict(o) for o in f.outages],
                "outage_fail": f.outage_fail,
                "seed": f.seed,
            }
        if s.resilience is not None:
            rs = s.resilience
            payload["spec"]["resilience"] = {
                "max_retries": rs.max_retries,
                "backoff_s": rs.backoff_s,
                "timeout_factor": rs.timeout_factor,
                "hedge_factor": rs.hedge_factor,
                "grant_width": rs.grant_width,
                "min_failures": rs.min_failures,
                "degrade_attainment_frac": rs.degrade_attainment_frac,
            }
        if s.placement is not None:
            p = s.placement
            payload["spec"]["placement"] = {
                "n_bins": p.n_bins, "affinity": p.affinity,
                "chatty_io_s": p.chatty_io_s,
                "colocate_bonus": p.colocate_bonus,
                "remote_penalty": p.remote_penalty,
                "interference_penalty": p.interference_penalty,
                "heavy_profile": p.heavy_profile,
                "local_moves": p.local_moves, "seed": p.seed,
            }
            payload["placement"] = dict(self.placement or {})
        return payload


class OnlineController:
    """Runs an :class:`OnlineSpec` end to end.

    Wraps a uniform :class:`repro_torch.core.campaign.Campaign` for the task
    grid and the validation replays, so every control mode sees
    bit-identical workflows, SLOs, arrival seeds and drift conditions —
    the serving loop is shared code and only the policy differs.

    ``device`` is where every replay engine of the run sweeps its
    contention-free plane (``None``: the CUDA card).
    """

    def __init__(self, spec: OnlineSpec = OnlineSpec(), *,
                 env_factory: Optional[Callable[[], Environment]] = None,
                 device: DeviceLike = None):
        self.spec = spec
        self.scorer = spec.scorer
        self.device = device
        self._campaign = Campaign(
            CampaignSpec(portfolio=spec.portfolio, replay=spec.replay,
                         searchers=(spec.searcher,),
                         searcher_kwargs=dict(spec.searcher_kwargs),
                         seed=spec.seed),
            env_factory=env_factory, device=device)
        self.env_factory = self._campaign.env_factory
        # -- shared-cluster (packed) serving state --------------------
        #: the accepted placement (None => per-cell private quotas)
        self._plan: Optional[PlacementPlan] = None
        #: the packed fleet's cross-epoch state and clock (per-cell
        #: ``carry``/``clock`` are unused in packed mode)
        self._packed_carry: Optional[FleetCarry] = None
        self._packed_clock: float = 0.0
        self._cells: List[ServingCell] = []
        #: the current epoch's reseeded fault model (None when fault
        #: injection is off, or before the first epoch — deploy-time
        #: baselines validate fault-free)
        self._live_faults: Optional[FaultModel] = None

    # -- conditions ----------------------------------------------------
    def _serving_env(self, cond: EpochConditions) -> Environment:
        """A fresh environment pointed at the epoch's input-class mix
        (backends without the ``input_scale`` knob serve the baseline
        mix — the drift still shifts load/cold-start)."""
        env = self.env_factory()
        if cond.input_scale != 1.0 and hasattr(env.backend, "input_scale"):
            env.backend.input_scale = cond.input_scale
        return env

    def _cold_model(self, cond: EpochConditions) -> ColdStartModel:
        base = self.spec.replay.cold_start
        if cond.cold_delay_s is None and cond.cold_keep_alive_s is None:
            return base
        return ColdStartModel(
            delay_s=base.delay_s if cond.cold_delay_s is None
            else cond.cold_delay_s,
            keep_alive_s=base.keep_alive_s if cond.cold_keep_alive_s is None
            else cond.cold_keep_alive_s)

    # -- joint autoscaling (spec.autoscale) ---------------------------
    def _cell_scale(self, cell: ServingCell,
                    replicas: Optional[Dict[str, int]] = None
                    ) -> Optional[ReplicaModel]:
        """The cell's replica actuator as an engine-side model (keys
        tenant-qualified so packed fleets never alias); ``None`` when
        autoscaling is off — the engine then runs bit-identically to
        the pre-replica serving path."""
        aspec = self.spec.autoscale
        if aspec is None:
            return None
        replicas = replicas if replicas is not None else cell.replicas
        if replicas is None:
            return None
        ident = cell.task.template.identity
        return aspec.replica_model(
            {(ident, n): r for n, r in replicas.items()})

    def _cell_cluster(self, cell: ServingCell,
                      factor: Optional[float] = None) -> ClusterModel:
        """The cell's serving cluster: the per-cell quota grown by the
        scale actuator's capacity factor."""
        f = factor if factor is not None else cell.cluster_scale
        base = self.spec.replay.cluster
        return base if f == 1.0 else scale_cluster(base, f)

    # -- fault injection / recovery policy (spec.faults/.resilience) --
    def _epoch_faults(self, epoch: int) -> Optional[FaultModel]:
        """The epoch's fault model: the spec's model reseeded per epoch
        so each epoch draws a fresh stream, while every validation
        replay *inside* the epoch shares the serving stream's seed —
        challenger vs. incumbent stays a paired fault experiment."""
        f = self.spec.faults
        if f is None:
            return None
        return dataclasses.replace(f, seed=f.seed + epoch)

    def _cell_resilience(self, cell: ServingCell,
                         levels: Optional[Dict[str, int]] = None
                         ) -> Optional[ResilienceModel]:
        """The cell's recovery actuator as an engine-side model (keys
        tenant-qualified so packed fleets never alias policies);
        ``None`` when the resilience actuator is off."""
        rspec = self.spec.resilience
        if rspec is None:
            return None
        levels = levels if levels is not None else cell.policy_levels
        if levels is None:
            return None
        ident = cell.task.template.identity
        model = rspec.resilience_model(levels, cell.runtimes)
        return ResilienceModel(policies={
            (ident, n): p for n, p in model.policies.items()})

    def _packed_resilience(self, override: Optional[
            Tuple[int, Dict[str, int]]] = None
            ) -> Optional[ResilienceModel]:
        """The packed fleet's recovery actuator: the union of every
        cell's ladder levels under tenant-qualified keys (``override``
        swaps cell ``index``'s levels for a challenger's)."""
        rspec = self.spec.resilience
        if rspec is None:
            return None
        policies: Dict[object, object] = {}
        for cell in self._cells:
            levels = cell.policy_levels or {}
            if override is not None and cell.index == override[0]:
                levels = override[1]
            ident = cell.task.template.identity
            model = rspec.resilience_model(levels, cell.runtimes)
            for name, p in model.policies.items():
                policies[(ident, name)] = p
        return ResilienceModel(policies=policies)

    def _failure_bound(self, cell: ServingCell) -> bool:
        """Is the cell's drift *failure-bound* (failed attempts in the
        serving window) rather than capacity-/config-bound? Checked
        before the capacity/config split: a failed attempt inflates
        neither queue delay nor cold overhead, so a failure-driven miss
        looks deceptively config-bound to ``classify_saturation`` and
        would waste grants on a re-search that cannot help."""
        rspec = self.spec.resilience
        if rspec is None:
            return False
        total, _ = classify_failures(cell.saturation)
        return total >= rspec.min_failures

    def _observe_saturation(self, cell: ServingCell, report) -> None:
        """Record the serving epoch's saturation diagnostics on the
        cell — the observables drift classification reads."""
        cell.saturation = report.saturation()
        cold = float(sum(report.cold_delays.tolist()))
        _, cell.queue_share = classify_saturation(cell.saturation, cold)

    def _capacity_bound(self, cell: ServingCell) -> bool:
        """Is the cell's drift capacity-bound (queue-delay dominated,
        with material overhead) rather than config-bound? Scale-only
        ablations route every grant to the scale actuator."""
        aspec = self.spec.autoscale
        if aspec is None or "scale" not in aspec.actuators:
            return False
        if self._failure_bound(cell):
            # failure-bound drift routes to the recovery actuator, not
            # the replica pools — growing capacity cannot stop a fault
            return False
        if "config" not in aspec.actuators:
            return True
        if cell.queue_share < aspec.queue_share_threshold:
            return False
        if not cell.overheads:
            return False
        ov = sorted(cell.overheads)
        q = ov[min(len(ov) - 1,
                   int(self.spec.headroom_quantile * (len(ov) - 1)))]
        return q >= aspec.min_overhead_frac * cell.task.slo

    # -- deploy --------------------------------------------------------
    def _deploy(self, tasks: List[CampaignTask],
                arrival_seeds: List[int]) -> List[ServingCell]:
        spec = self.spec
        cells: List[ServingCell] = []
        # deploy-time search runs all cells in lockstep — one fused
        # backend evaluation per probe round across the whole portfolio
        # (traces bit-identical to per-task sequential searches)
        searchers = [make_searcher(spec.searcher, self.env_factory,
                                   **spec.searcher_kwargs.get(
                                       spec.searcher, {}))
                     for _ in tasks]
        grid = run_grid_search(
            [GridCell(searcher=s, wf=task.template.copy(), slo=task.slo)
             for s, task in zip(searchers, tasks)])
        for task, searcher, res in zip(tasks, searchers, grid.results):
            validated = self._campaign.replay(task, res,
                                              arrival_seeds[task.index])
            cell = ServingCell(
                index=task.index, task=task,
                arrival_seed=arrival_seeds[task.index],
                searcher=searcher, result=res,
                configs={n: c.copy() for n, c in res.configs.items()},
                baseline=validated.slo_attainment,
                baseline_cost=validated.total_cost,
                validated=validated.slo_attainment,
                validated_cost=validated.total_cost,
                window=collections.deque(maxlen=spec.window),
                overheads=collections.deque(maxlen=spec.window),
                deploy_spent=res.n_samples,
                note="" if res.feasible else f"deploy infeasible: {res.note}")
            if spec.autoscale is not None:
                # replica-bounded serving starts at pools sized to the
                # offered load (Erlang-style) on capacity that fits
                # them; scale grants grow both when drift shifts load
                cell.replicas = self._initial_pools(cell)
                cell.cluster_scale = pool_capacity_factor(
                    cell.replicas, cell.configs, spec.replay.cluster,
                    max_scale=spec.autoscale.max_cluster_scale)
            if spec.resilience is not None:
                # every cell starts with no recovery — the controller
                # *learns* policy online from failure-bound misses; the
                # ladder's timeout/hedge scale reads the searched
                # workflow's cached node runtimes (the deploy search
                # measured them)
                src = res.state.wf if res.state is not None \
                    else task.template
                cell.policy_levels = {n: 0 for n in task.template.nodes}
                cell.runtimes = {
                    name: (float(node.runtime)
                           if math.isfinite(node.runtime) else 0.0)
                    for name, node in src.nodes.items()}
            cells.append(cell)
        return cells

    def _erlang_pools(self, cell: ServingCell, rate: float,
                      cond: "EpochConditions") -> Dict[str, int]:
        """Erlang-style pool sizing against an offered load: one probe
        instance measures each function's runtime at the incumbent
        configs under ``cond``'s input scale, and every pool is sized
        ``ceil(rate * runtime / deploy_utilization)`` — the
        proportional controller. A pool offered more than one erlang
        per replica queues without bound, so additive +1 nudges can
        never catch a multiplicative load shift before the backlog
        compounds."""
        aspec = self.spec.autoscale
        assert aspec is not None
        wf = cell.task.template.copy()
        wf.apply_configs(cell.configs)
        ident = cell.task.template.identity
        env = self._serving_env(cond)
        probe = FleetEngine(
            env.backend, pricing=env.pricing,
            scale=aspec.replica_model(
                {(ident, n): 1 for n in wf.nodes}),
            device=self.device).run([wf], [0.0])
        sat = probe.saturation()
        pools: Dict[str, int] = {}
        for name in wf.nodes:
            busy = sat.get(f"{ident}/{name}", {}).get("busy_s", 0.0)
            pools[name] = max(1, min(
                aspec.max_replicas,
                math.ceil(rate * busy / aspec.deploy_utilization)))
        return pools

    def _initial_pools(self, cell: ServingCell) -> Dict[str, int]:
        """Deploy-time pool sizing at the nominal arrival rate —
        skipping this would make epoch 0 capacity-bound for a reason no
        drift caused (the scale actuator answers *load shifts*, not the
        deploy-time rate)."""
        return self._erlang_pools(cell, self.spec.replay.rate,
                                  EpochConditions())

    # -- serving -------------------------------------------------------
    def _serve_epoch(self, cell: ServingCell, epoch: int,
                     cond: EpochConditions, seed: int) -> Dict[str, object]:
        spec = self.spec
        r = spec.replay
        rate = r.rate * cond.rate_scale
        times = PoissonArrivals(rate, r.n_instances, seed=seed,
                                start=cell.clock).times()
        env = self._serving_env(cond)
        engine = FleetEngine(env.backend, pricing=env.pricing,
                             cluster=self._cell_cluster(cell),
                             cold_start=self._cold_model(cond),
                             scale=self._cell_scale(cell),
                             faults=self._live_faults,
                             resilience=self._cell_resilience(cell),
                             device=self.device)
        instances = []
        for _ in range(r.n_instances):
            wf = cell.task.template.copy()
            wf.apply_configs(cell.configs)
            instances.append(wf)
        report = engine.run(instances, times, carry=cell.carry,
                            collect_carry=True)
        # epochs are back-to-back: the next epoch starts at the nominal
        # end of this arrival window (deterministic, not arrival-max)
        cell.clock += r.n_instances / rate
        cell.carry = report.carry.pruned(cell.clock)
        slo = cell.task.slo
        # SoA report views: uid order == arrival order, no per-instance
        # object materialization on the serving hot path
        hits = (~report.failed_mask) & (report.latencies <= slo)
        overheads = report.queue_delays + report.cold_delays
        cold_total = float(sum(report.cold_delays.tolist()))
        for hit, overhead in zip(hits.tolist(), overheads.tolist()):
            cell.window.append(hit)
            cell.overheads.append(overhead if math.isfinite(overhead)
                                  else slo)
        row = {
            "epoch": epoch, "cell": cell.index,
            "attainment": report.slo_attainment(slo),
            "p50_s": report.p50, "p99_s": report.p99,
            "cost": report.total_cost,
            "queue_delay_s": report.total_queue_delay,
            "cold_delay_s": cold_total,
            "rate_scale": cond.rate_scale,
            "input_scale": cond.input_scale,
        }
        if self.spec.autoscale is not None:
            # autoscale runs only: extra keys would break the pinned
            # byte-identity of autoscale-off payloads
            self._observe_saturation(cell, report)
            row["queue_share"] = cell.queue_share
            row["total_replicas"] = sum((cell.replicas or {}).values())
            row["cluster_scale"] = cell.cluster_scale
        if spec.faults is not None:
            # fault runs only: fault-free payloads stay byte-identical
            if spec.autoscale is None:
                self._observe_saturation(cell, report)
            cell.failures, _ = classify_failures(cell.saturation)
            row["failed"] = int(report.failed_mask.sum())
            row["fault_failures"] = cell.failures
            row["retries"] = report.total_retries
            row["timeouts"] = report.total_timeouts
            row["hedges"] = report.total_hedges
        return row

    # -- shared-cluster (packed) serving -------------------------------
    def _build_plan(self, cells: List[ServingCell]) -> PlacementPlan:
        """Place all cells into the packed cluster at deploy time.
        The campaign grid already gives every cell's template a unique
        tenant id; :func:`plan_placement` re-validates (duplicate
        identities raise — the warm-pool collision guard) and scores
        the placement off the deploy-time incumbent configurations."""
        pspec = self.spec.placement
        assert pspec is not None
        cluster = pspec.cluster if pspec.cluster is not None else \
            scale_cluster(self.spec.replay.cluster, max(1, len(cells)))
        tenant_cells = [TenantCell(template=cell.task.template,
                                   configs=cell.configs,
                                   slo=cell.task.slo)
                        for cell in cells]
        return plan_placement(tenant_cells, pspec, cluster)

    def _packed_scale(self, override: Optional[Tuple[int, Dict[str, int]]]
                      = None) -> Optional[ReplicaModel]:
        """The packed fleet's replica actuator: the union of every
        cell's pools under tenant-qualified keys (``override`` swaps
        cell ``index``'s pools for a challenger's assignment)."""
        aspec = self.spec.autoscale
        if aspec is None:
            return None
        pools: Dict[object, int] = {}
        for cell in self._cells:
            replicas = cell.replicas or {}
            if override is not None and cell.index == override[0]:
                replicas = override[1]
            ident = cell.task.template.identity
            for name, r in replicas.items():
                pools[(ident, name)] = r
        return aspec.replica_model(pools)

    def _packed_engine(self, cond: EpochConditions,
                       env: Optional[Environment] = None,
                       scale_override: Optional[Tuple[int, Dict[str, int]]]
                       = None,
                       resilience_override: Optional[
                           Tuple[int, Dict[str, int]]] = None
                       ) -> FleetEngine:
        env = env if env is not None else self._serving_env(cond)
        plan = self._plan
        return FleetEngine(env.backend, pricing=env.pricing,
                           cluster=plan.cluster,
                           cold_start=self._cold_model(cond),
                           interference=plan.multipliers,
                           scale=self._packed_scale(scale_override),
                           faults=self._live_faults,
                           resilience=self._packed_resilience(
                               resilience_override),
                           device=self.device)

    def _repack(self) -> None:
        """Re-pack the shared cluster after an accepted capacity grant:
        the packed pool grows to the mean of the cells' capacity
        factors (:func:`placement.scale_cluster`), and the placement is
        re-solved off the current incumbents so interference
        multipliers track the new bin layout."""
        pspec = self.spec.placement
        if pspec is None or not self._cells:
            return
        base = pspec.cluster if pspec.cluster is not None else \
            scale_cluster(self.spec.replay.cluster, max(1, len(self._cells)))
        factor = sum(c.cluster_scale for c in self._cells) / len(self._cells)
        cluster = base if factor == 1.0 else scale_cluster(base, factor)
        tenant_cells = [TenantCell(template=cell.task.template,
                                   configs=cell.configs,
                                   slo=cell.task.slo)
                        for cell in self._cells]
        self._plan = plan_placement(tenant_cells, pspec, cluster)

    def _packed_fleet(self, cells: List[ServingCell], seeds: List[int],
                      n: int, rate: float, start: float,
                      override: Optional[Tuple[int, Dict[str,
                                               ResourceConfig]]] = None
                      ) -> Tuple[List[Workflow], np.ndarray]:
        """One instance fleet spanning every tenant: ``n`` arrivals per
        cell at ``rate`` from ``seeds[i]``, templates stamped with the
        incumbent configs (``override`` swaps cell ``index``'s configs
        for a challenger's). uid order is cell-major, which is the
        order the per-tenant report slices recover."""
        wfs: List[Workflow] = []
        times: List[np.ndarray] = []
        for cell, seed in zip(cells, seeds):
            t = PoissonArrivals(rate, n, seed=seed, start=start).times()
            configs = cell.configs
            if override is not None and cell.index == override[0]:
                configs = override[1]
            for _ in range(n):
                wf = cell.task.template.copy()
                wf.apply_configs(configs)
                wfs.append(wf)
            times.append(t)
        return wfs, np.concatenate(times)

    def _packed_baseline(self, cells: List[ServingCell]) -> None:
        """Re-validate deploy baselines *inside* the packed cluster:
        one packed replay on the deploy arrival seeds, sliced per
        tenant. The per-cell private-quota replay that ``_deploy`` ran
        is the wrong detection target under shared capacity — a cell
        would be flagged as drifted at epoch 0 just for sharing."""
        r = self.spec.replay
        report = self._packed_engine(EpochConditions()).run(
            *self._packed_fleet(cells, [c.arrival_seed for c in cells],
                                r.n_instances, r.rate, 0.0))
        for cell in cells:
            sub = report.tenant_slice(cell.task.template.identity)
            cell.baseline = sub.slo_attainment(cell.task.slo)
            cell.baseline_cost = sub.total_cost
            cell.validated = cell.baseline
            cell.validated_cost = cell.baseline_cost

    def _serve_epoch_packed(self, cells: List[ServingCell], epoch: int,
                            cond: EpochConditions,
                            epoch_seeds: np.ndarray
                            ) -> List[Dict[str, object]]:
        """The packed analogue of :meth:`_serve_epoch`: ONE engine run
        serves every tenant's arrivals against the shared cluster
        (placement interference applied per invocation), resumed from
        the packed :class:`FleetCarry`. Per-tenant report slices feed
        the same sliding windows and emit the same epoch-row schema as
        isolated serving, so detection and downstream consumers are
        mode-agnostic."""
        spec = self.spec
        r = spec.replay
        rate = r.rate * cond.rate_scale
        seeds = [int(epoch_seeds[cell.task.index][epoch])
                 for cell in cells]
        engine = self._packed_engine(cond)
        wfs, times = self._packed_fleet(cells, seeds, r.n_instances,
                                        rate, self._packed_clock)
        report = engine.run(wfs, times, carry=self._packed_carry,
                            collect_carry=True)
        self._packed_clock += r.n_instances / rate
        self._packed_carry = report.carry.pruned(self._packed_clock)
        rows: List[Dict[str, object]] = []
        for cell in cells:
            sub = report.tenant_slice(cell.task.template.identity)
            slo = cell.task.slo
            hits = (~sub.failed_mask) & (sub.latencies <= slo)
            overheads = sub.queue_delays + sub.cold_delays
            for hit, overhead in zip(hits.tolist(), overheads.tolist()):
                cell.window.append(hit)
                cell.overheads.append(overhead if math.isfinite(overhead)
                                      else slo)
            cell.clock = self._packed_clock
            row = {
                "epoch": epoch, "cell": cell.index,
                "attainment": sub.slo_attainment(slo),
                "p50_s": sub.p50, "p99_s": sub.p99,
                "cost": sub.total_cost,
                "queue_delay_s": sub.total_queue_delay,
                "cold_delay_s": float(sum(sub.cold_delays.tolist())),
                "rate_scale": cond.rate_scale,
                "input_scale": cond.input_scale,
            }
            if spec.autoscale is not None:
                self._observe_saturation(cell, sub)
                row["queue_share"] = cell.queue_share
                row["total_replicas"] = sum((cell.replicas or {}).values())
                row["cluster_scale"] = cell.cluster_scale
            if spec.faults is not None:
                if spec.autoscale is None:
                    self._observe_saturation(cell, sub)
                cell.failures, _ = classify_failures(cell.saturation)
                row["failed"] = int(sub.failed_mask.sum())
                row["fault_failures"] = cell.failures
                row["retries"] = sub.total_retries
                row["timeouts"] = sub.total_timeouts
                row["hedges"] = sub.total_hedges
            rows.append(row)
        return rows

    def _validate_many_packed(self, cell: ServingCell,
                              config_sets: List[Dict[str, ResourceConfig]],
                              cond: EpochConditions, seed: int,
                              replicas: Optional[Dict[str, int]] = None,
                              levels: Optional[Dict[str, int]] = None
                              ) -> List[ReplayMetrics]:
        """Challenger validation *inside* the packed cluster: each
        candidate config-map for ``cell`` is replayed with every other
        tenant serving its incumbent, from the pruned packed carry —
        so a challenger only swaps in if it survives the cross-cell
        interference it will actually face. All candidate runs share
        the same per-tenant arrival seeds (``seed`` offset by cell
        index), keeping the incumbent-vs-challenger gate a paired
        comparison."""
        spec = self.spec
        r = spec.replay
        n = spec.validation_instances if spec.validation_instances \
            is not None else 2 * r.n_instances
        rate = r.rate * cond.rate_scale
        clock = self._packed_clock
        carry = self._packed_carry.pruned(clock) \
            if self._packed_carry is not None else None
        seeds = [int(seed) + other.index for other in self._cells]
        override = (cell.index, replicas) if replicas is not None else None
        l_override = (cell.index, levels) if levels is not None else None
        out: List[ReplayMetrics] = []
        for configs in config_sets:
            engine = self._packed_engine(cond, scale_override=override,
                                         resilience_override=l_override)
            wfs, times = self._packed_fleet(
                self._cells, seeds, n, rate, clock,
                override=(cell.index, configs))
            report = engine.run(wfs, times, carry=carry)
            sub = report.tenant_slice(cell.task.template.identity)
            out.append(ReplayMetrics(
                slo_attainment=sub.slo_attainment(cell.task.slo),
                p50_s=sub.p50, p99_s=sub.p99,
                total_cost=sub.total_cost,
                total_queue_delay_s=sub.total_queue_delay))
        return out

    # -- detection -----------------------------------------------------
    def _triggered(self, cell: ServingCell) -> bool:
        """Is the cell below target with statistical confidence? Uses
        the window's one-sided upper confidence bound: even the
        optimistic read of live attainment misses the target."""
        n = len(cell.window)
        if n < self.spec.min_observations:
            return False
        p = sum(cell.window) / n
        ucb = p + self.spec.confidence_z * math.sqrt(p * (1.0 - p) / n)
        return ucb < cell.baseline - self.spec.target_margin

    def _effective_slo(self, cell: ServingCell) -> float:
        """SLO tightened by the observed per-instance queue+cold
        overhead (deterministic index quantile), floored so severe
        contention cannot demand the impossible."""
        slo = cell.task.slo
        if not cell.overheads:
            return slo
        ov = sorted(cell.overheads)
        q = ov[min(len(ov) - 1,
                   int(self.spec.headroom_quantile * (len(ov) - 1)))]
        return max(slo - q, self.spec.slo_floor_frac * slo)

    # -- reconfiguration ----------------------------------------------
    def _validate_many(self, cell: ServingCell,
                       config_sets: List[Dict[str, ResourceConfig]],
                       cond: EpochConditions, seed: int,
                       replicas: Optional[Dict[str, int]] = None,
                       cluster_factor: Optional[float] = None,
                       levels: Optional[Dict[str, int]] = None
                       ) -> List[ReplayMetrics]:
        """Replay candidate config-maps on the live arrival seed under
        the live conditions, *from the live fleet state* (the cell's
        carry: backlog + warm pool) — the challenger gate's evidence.
        Without the carry a backlogged incumbent validates clean and no
        challenger could ever beat it. All candidates go through ONE
        batched :meth:`Campaign.replay_configs_many` /
        :meth:`FleetEngine.run_many` evaluation (challenger and
        incumbent share the event skeleton whenever the live state
        permits vectorization). ``replicas``/``cluster_factor`` replay
        under a candidate *scale* action (defaults: the cell's live
        pools and capacity) — the joint challenger gate. Packed mode
        reroutes to :meth:`_validate_many_packed` — the gate's evidence
        is then the shared cluster, not an isolated quota (candidate
        capacity growth applies after acceptance, via the re-pack)."""
        if self._plan is not None:
            return self._validate_many_packed(cell, config_sets, cond,
                                              seed, replicas=replicas,
                                              levels=levels)
        r = self.spec.replay
        carry = cell.carry.pruned(cell.clock) if cell.carry is not None \
            else None
        n = self.spec.validation_instances
        kwargs = dict(
            rate=r.rate * cond.rate_scale,
            n_instances=n if n is not None else 2 * r.n_instances,
            cold_start=self._cold_model(cond),
            start=cell.clock, carry=carry)
        if self.spec.autoscale is not None:
            kwargs["scale"] = self._cell_scale(cell, replicas)
            kwargs["cluster"] = self._cell_cluster(cell, cluster_factor)
        if self.spec.faults is not None:
            # the gate's evidence is the live fault stream: candidates
            # replay under the epoch's reseeded model (one paired
            # stream per run_many plane) with the candidate's recovery
            # policies (defaults: the cell's live levels)
            kwargs["faults"] = self._live_faults
            kwargs["resilience"] = self._cell_resilience(cell, levels)
        env = self._serving_env(cond)
        deterministic = getattr(env.backend, "deterministic", False)
        if not getattr(env.backend, "batch_safe", deterministic):
            # stateful backend with no paired replay-stream contract:
            # the swap gate must stay a *paired* comparison — every
            # candidate gets its own fresh, identically-seeded env so
            # all see the same noise draws, exactly like the historical
            # one-env-per-validation path
            return [self._campaign.replay_configs_many(
                cell.task, [configs], seed,
                env=self._serving_env(cond), **kwargs)[0]
                for configs in config_sets]
        # batch_safe covers the stochastic serving backend too: the
        # replay plane draws ONE (instance, function) noise tensor
        # shared by challenger and incumbent, so the C=2 validation is
        # a paired experiment even on finite clusters with cold starts
        # and live backlog — one run_many call instead of C
        return self._campaign.replay_configs_many(
            cell.task, config_sets, seed, env=env, **kwargs)

    def _validate(self, cell: ServingCell,
                  configs: Dict[str, ResourceConfig],
                  cond: EpochConditions, seed: int) -> ReplayMetrics:
        """Single-candidate view of :meth:`_validate_many`."""
        return self._validate_many(cell, [configs], cond, seed)[0]

    def _reconfigure(self, cell: ServingCell, epoch: int,
                     cond: EpochConditions, seed: int,
                     remaining: int) -> Tuple[ReconfigRecord, int, int]:
        spec = self.spec
        aspec = spec.autoscale
        grant = min(spec.grant_budget, remaining)
        state = cell.result.state
        env = state.env
        before = env.trace.n_samples
        slo_eff = self._effective_slo(cell)

        # -- scale half: capacity-bound drift grows the replica pools
        # of the queue-delay-dominated critical-path functions, and
        # cluster capacity with them (never shrunk, capped)
        old_r = dict(cell.replicas) if cell.replicas is not None else None
        new_r: Optional[Dict[str, int]] = None
        if old_r is not None and self._capacity_bound(cell):
            # proportional first: re-size every pool to the *observed*
            # arrival rate (Erlang sizing — a multiplicative load shift
            # needs a multiplicative answer); when sizing says the
            # pools already fit, fall back to the additive
            # critical-path nudge for residual (burst) queueing
            sized = self._erlang_pools(
                cell, self.spec.replay.rate * cond.rate_scale, cond)
            grown = {n: max(old_r.get(n, 1), sized.get(n, 1))
                     for n in old_r}
            if grown == old_r:
                # steady-state sizing is already met but the queue
                # persists: the carried backlog regenerates itself
                # each epoch (late finishers occupy the cluster, so
                # new arrivals finish late and become the next
                # epoch's occupancy). Draining needs transient
                # over-capacity — double every queue-dominated pool
                # (multiplicative surge); an additive +1 nudge can
                # never outpace an overhang that self-replenishes
                queued = {k.split("/", 1)[-1]
                          for k, v in cell.saturation.items()
                          if v["queue_delay_s"] > 0.0}
                grown = {n: (min(aspec.max_replicas, 2 * r)
                             if n in queued else r)
                         for n, r in old_r.items()}
            if grown == old_r:
                grown = grant_replicas(old_r, cell.saturation,
                                       find_critical_path(state.wf),
                                       width=aspec.grant_width,
                                       max_replicas=aspec.max_replicas)
            if grown != old_r:
                new_r = grown

        # -- resilience half: failure-bound drift climbs the recovery
        # ladder for the highest-failure-share functions; an attainment
        # collapse below the outage threshold instead *degrades*
        # off-critical-path recovery (graceful degradation — recovery
        # spend concentrates where latency accrues)
        rspec = spec.resilience
        old_l = dict(cell.policy_levels) \
            if cell.policy_levels is not None else None
        new_l: Optional[Dict[str, int]] = None
        if old_l is not None and self._failure_bound(cell):
            live = cell.live_attainment()
            if (math.isfinite(live) and rspec is not None
                    and live < rspec.degrade_attainment_frac
                    * cell.baseline):
                shed = degrade_policies(old_l,
                                        find_critical_path(state.wf))
                if shed != old_l:
                    new_l = shed
            if new_l is None:
                grown_l = grant_policies(
                    old_l, cell.saturation, width=rspec.grant_width,
                    max_level=rspec.max_level)
                if grown_l != old_l:
                    new_l = grown_l

        # -- config half: retune + incremental search grant (skipped by
        # the scale-only ablation, which spends no search samples)
        challenger: Optional[Dict[str, ResourceConfig]] = None
        if aspec is None or "config" in aspec.actuators:
            used = retune_state(state, slo=slo_eff,
                                input_scale=cond.input_scale)
            res = cell.searcher.resume(state, grant - used)
            cell.result = res
            challenger = res.configs
        used = env.trace.n_samples - before

        # -- joint validation: every candidate (configs, replicas)
        # action plus the incumbent, paired on one live seed — grouped
        # by scale action so same-scale candidates share one batched
        # replay (the autoscale-off path stays the single historical
        # [challenger, incumbent] call)
        cands: List[Tuple[Dict[str, ResourceConfig],
                          Optional[Dict[str, int]], float,
                          Optional[Dict[str, int]], str]] = []
        if challenger is not None:
            cands.append((challenger, old_r, cell.cluster_scale, old_l,
                          "config"))
        if new_r is not None:
            # capacity follows the candidate's pools AND configs: the
            # same replica assignment needs more cores under a fatter
            # config-map, so each candidate gets its own factor
            def cand_factor(cfg: Dict[str, ResourceConfig]) -> float:
                return pool_capacity_factor(
                    new_r, cfg, self.spec.replay.cluster,
                    max_scale=aspec.max_cluster_scale,
                    floor=cell.cluster_scale)
            if challenger is not None:
                cands.append((challenger, new_r, cand_factor(challenger),
                              old_l, "joint"))
            cands.append((cell.configs, new_r, cand_factor(cell.configs),
                          old_l, "scale"))
        if new_l is not None:
            # the recovery action pairs with both the incumbent and the
            # challenger configs (recovery changes each config's cost
            # and attainment, so the gate judges the joint action)
            cands.append((cell.configs, old_r, cell.cluster_scale, new_l,
                          "policy"))
            if challenger is not None:
                cands.append((challenger, old_r, cell.cluster_scale,
                              new_l, "config+policy"))
        triples = cands + [(cell.configs, old_r, cell.cluster_scale, old_l,
                            "incumbent")]
        metrics: List[Optional[ReplayMetrics]] = [None] * len(triples)
        groups: Dict[object, List[int]] = {}
        for i, (_cfg, r_i, f_i, l_i, _lbl) in enumerate(triples):
            key = (tuple(sorted(r_i.items())) if r_i is not None else None,
                   f_i,
                   tuple(sorted(l_i.items())) if l_i is not None else None)
            groups.setdefault(key, []).append(i)
        for idxs in groups.values():
            out = self._validate_many(
                cell, [triples[i][0] for i in idxs], cond, seed,
                replicas=triples[idxs[0]][1],
                cluster_factor=triples[idxs[0]][2],
                levels=triples[idxs[0]][3])
            for i, m in zip(idxs, out):
                metrics[i] = m
        val_inc = metrics[-1]

        tol = spec.attainment_tol
        target = aspec.target_attainment if aspec is not None else None

        def better(a: ReplayMetrics, b: ReplayMetrics) -> bool:
            if a.slo_attainment > b.slo_attainment + tol:
                return True
            if abs(a.slo_attainment - b.slo_attainment) > tol:
                return False
            if (target is not None and a.slo_attainment < target
                    and b.slo_attainment < target):
                # overload deadlock breaker: when NO candidate attains
                # (deep backlog — every validation replays the same
                # hopeless carry), a cost comparison would forever
                # reject the capacity grant that escapes the overload.
                # The joint gate instead prefers the action that
                # drains the queue; cost discriminates again once the
                # system breathes
                qa = a.total_queue_delay_s
                qb = b.total_queue_delay_s
                if qa < 0.95 * qb:
                    return True
                if qb < 0.95 * qa:
                    return False
            return a.total_cost < b.total_cost - 1e-12

        best_i: Optional[int] = None
        for i in range(len(cands)):
            if best_i is None or better(metrics[i], metrics[best_i]):
                best_i = i
        val_ch = metrics[best_i] if best_i is not None else val_inc
        label = triples[best_i][4] if best_i is not None else "none"
        accept = best_i is not None and better(val_ch, val_inc)
        if accept:
            cfg, rep, factor, lev, _lbl = triples[best_i]
            cell.configs = {n: c.copy() for n, c in cfg.items()}
            if rep is not None:
                grew_capacity = factor != cell.cluster_scale
                cell.replicas = dict(rep)
                cell.cluster_scale = factor
                if grew_capacity and self._plan is not None:
                    self._repack()
            if lev is not None:
                cell.policy_levels = dict(lev)
            cell.validated = val_ch.slo_attainment
            cell.validated_cost = val_ch.total_cost
            cell.last_gain = self.scorer.realized_gain(
                prev_att=val_inc.slo_attainment,
                new_att=val_ch.slo_attainment,
                prev_cost=val_inc.total_cost, new_cost=val_ch.total_cost,
                used=max(1, used))
            cell.failed_grants = 0
            # fresh estimator for the new configuration: mixing
            # pre-swap observations would re-trigger on stale evidence
            cell.window.clear()
            cell.overheads.clear()
        else:
            cell.validated = val_inc.slo_attainment
            cell.validated_cost = val_inc.total_cost
            cell.last_gain = 0.0
            cell.failed_grants += 1
        cell.grants += 1
        cell.spent += used
        cell.cooldown = spec.cooldown_epochs
        kept = val_ch if accept else val_inc
        if aspec is None and rspec is None:
            note = "swap" if accept else "challenger rejected"
        elif accept:
            bits = []
            if aspec is not None:
                total_r = sum(cell.replicas.values()) if cell.replicas \
                    else 0
                bits.append(f"{total_r} replicas, "
                            f"cluster x{cell.cluster_scale:g}")
            if rspec is not None:
                total_l = sum((cell.policy_levels or {}).values())
                bits.append(f"policy levels {total_l}")
            note = f"{label} swap ({', '.join(bits)})"
        else:
            note = "challenger rejected" if cands else \
                "no actuator applicable"
        return ReconfigRecord(
            epoch=epoch, cell=cell.index, granted=grant, spent=used,
            accepted=accept,
            validated_before=val_inc.slo_attainment,
            validated_after=kept.slo_attainment,
            cost_before=val_inc.total_cost, cost_after=kept.total_cost,
            effective_slo=slo_eff, note=note), used, len(triples)

    def _research_cell(self, cell: ServingCell,
                       cond: EpochConditions) -> int:
        """``every_epoch`` policy: full re-search under the epoch's
        conditions, swapped in unconditionally (the naive comparator).

        The re-search aims at the cell's *effective* SLO — the raw SLO
        tightened by the queue/cold overhead observed in the serving
        window, exactly the retargeting ``retune_state`` applies to
        drift grants. Re-searching at the raw SLO was a baseline
        footgun: under a load shift the searcher happily re-finds the
        same binding (cost-optimal, headroom-free) configuration that
        queueing already breaks, so "naive" re-search changed nothing
        (``naive_post == static_post`` in BENCH_online.json) and the
        comparator wasn't measuring adaptation at all. Attainment is
        still judged at the raw SLO everywhere."""
        spec = self.spec
        searcher = make_searcher(
            spec.searcher, lambda: self._serving_env(cond),
            **spec.searcher_kwargs.get(spec.searcher, {}))
        res = searcher.search(cell.task.template.copy(),
                              self._effective_slo(cell))
        cell.configs = {n: c.copy() for n, c in res.configs.items()}
        cell.result = res
        cell.grants += 1
        cell.spent += res.n_samples
        return res.n_samples

    # -- the pipeline --------------------------------------------------
    def run(self, *, progress: Optional[Callable[[str], None]] = None
            ) -> OnlineReport:
        t0 = time.perf_counter()
        spec = self.spec
        tasks = self._campaign.tasks()
        arrival_seeds = self._campaign.arrival_seeds(len(tasks))
        epoch_seeds = np.random.default_rng(spec.seed + 5).integers(
            0, 2**31 - 1, size=(max(1, len(tasks)), max(1, spec.n_epochs)))
        cells = self._deploy(tasks, arrival_seeds)
        self._cells = cells
        if spec.placement is not None:
            # pack the portfolio into one shared cluster and make the
            # packed replay (not the private-quota one) the baseline
            self._plan = self._build_plan(cells)
            self._packed_baseline(cells)
        total = int(spec.total_budget)
        remaining = total
        epochs: List[Dict[str, object]] = []
        reconfigs: List[ReconfigRecord] = []
        n_validations = 0

        for epoch in range(spec.n_epochs):
            cond = spec.drift.conditions(epoch)
            regime = spec.drift.regime(epoch)
            self._live_faults = self._epoch_faults(epoch)
            for cell in cells:
                if regime != cell.regime:
                    # new disturbance: re-arm the detector and the
                    # grant gate, drop stale-regime observations
                    cell.regime = regime
                    cell.failed_grants = 0
                    cell.window.clear()
                    cell.overheads.clear()
                if spec.mode == "every_epoch" and epoch > 0:
                    self._research_cell(cell, cond)
                if self._plan is None:
                    seed = int(epoch_seeds[cell.task.index][epoch])
                    epochs.append(self._serve_epoch(cell, epoch, cond,
                                                    seed))
            if self._plan is not None:
                epochs.extend(self._serve_epoch_packed(cells, epoch,
                                                       cond, epoch_seeds))

            granted_now = set()
            if spec.mode == "drift":
                candidates = []
                for cell in cells:
                    # remaining < 2 could not fund retune + one sample
                    if (cell.cooldown > 0 or remaining < 2
                            or cell.failed_grants >= spec.max_failed_grants
                            or cell.result is None
                            or cell.result.state is None):
                        continue
                    if not self._triggered(cell):
                        continue
                    deficit = cell.baseline - cell.live_attainment()
                    if self.scorer.is_candidate(deficit=deficit,
                                                last_gain=cell.last_gain,
                                                grants=cell.grants):
                        candidates.append(cell)
                candidates.sort(key=lambda c: (-self.scorer.score(
                    deficit=c.baseline - c.live_attainment(),
                    last_gain=c.last_gain, grants=c.grants, t=epoch + 1),
                    c.index))
                for cell in candidates[:spec.grants_per_epoch]:
                    if remaining < 2:
                        break
                    seed = int(epoch_seeds[cell.task.index][epoch])
                    record, used, nvals = self._reconfigure(
                        cell, epoch, cond, seed, remaining)
                    remaining -= used
                    n_validations += nvals
                    granted_now.add(cell.index)
                    reconfigs.append(record)
                    if progress is not None:
                        progress(f"epoch {epoch}: cell {cell.index} "
                                 f"+{used} accepted={record.accepted} "
                                 f"att={record.validated_after:.2f} "
                                 f"remaining={remaining}")
            for cell in cells:
                # a grant set this epoch must survive the decrement, or
                # cooldown_epochs=1 would be a zero-epoch sit-out
                if cell.index not in granted_now and cell.cooldown > 0:
                    cell.cooldown -= 1
            if progress is not None:
                att = [e for e in epochs if e["epoch"] == epoch]
                mean = sum(float(e["attainment"]) for e in att) / len(att)
                progress(f"epoch {epoch}: mean attainment {mean:.3f}")

        spent = sum(c.spent for c in cells)
        if spec.mode == "drift":
            budget = {"total": total, "spent": spent,
                      "remaining": remaining}
        else:
            # never: nothing spent; every_epoch: unbounded by design —
            # the ledger records the realized spend either way
            budget = {"total": spent, "spent": spent, "remaining": 0}
        placement_info = None
        if self._plan is not None:
            plan = self._plan
            placement_info = {
                "method": plan.solution.method,
                "score": plan.solution.score,
                "n_bins": plan.solution.n_bins,
                "heavy_per_bin": plan.solution.heavy_per_bin(
                    plan.constraints),
                "n_chatty": len(plan.constraints.chatty),
                "n_heavy": len(plan.constraints.heavy),
                "n_multipliers": len(plan.multipliers),
                "cluster_cpu": plan.cluster.total_cpu,
                "cluster_mem_mb": plan.cluster.total_mem_mb,
            }
        return OnlineReport(
            spec=spec, cells=cells, epochs=epochs, reconfigs=reconfigs,
            budget=budget, deploy_spent=sum(c.deploy_spent for c in cells),
            n_validations=n_validations,
            wall_time_s=time.perf_counter() - t0,
            placement=placement_info)


def run_online(spec: OnlineSpec = OnlineSpec(), *,
               env_factory: Optional[Callable[[], Environment]] = None,
               progress: Optional[Callable[[str], None]] = None,
               device: DeviceLike = None) -> OnlineReport:
    """Functional entry point: ``run_online(OnlineSpec(...))``."""
    return OnlineController(spec, env_factory=env_factory,
                            device=device).run(progress=progress)
