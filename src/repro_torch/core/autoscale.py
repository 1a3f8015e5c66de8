"""Joint autoscaling + configuration: replicas as a first-class actuator.

AARC's decoupled search actuates per-function ``(cpu, mem)`` only; a
load shift that saturates the fleet is unrecoverable by configuration
alone once the bottleneck function's arrival rate exceeds what one
admission slot can serve at *any* configuration. This module extends
the action space to ``(cpu, mem, replicas)`` plus cluster capacity and
searches it **jointly** under one cost model, following the
simultaneous-autoscaling formulation of arxiv 2310.19013: scaling and
sizing trade off against each other (many small replicas vs fewer
faster ones), so layering an autoscaler on top of a sizer leaves cost
on the table.

Pieces:

  * :class:`AutoscaleSpec` — the joint action space and its policy
    knobs: replica caps, provisioning prices (forwarded to
    :class:`repro_torch.core.engine.ReplicaModel`), the capacity-bound
    classification threshold, and the fleet-evaluation context a
    standalone search replays against,
  * :class:`ScaleSearcher` — a :class:`repro_torch.core.search.Searcher`
    (registry name ``"scale"``) that wraps any inner config searcher
    and alternates **critical-path-guided scale-up** (grant replicas to
    queue-delay-dominated functions on the critical path, read off
    :meth:`FleetReport.saturation`) with **config retuning** (route the
    grant through ``retune_state`` + ``inner.resume`` when the miss is
    runtime-dominated), tracking the best ``(configs, replicas,
    cluster)`` by fleet cost at the attainment target. It exposes the
    standard protocol, so campaigns and ``run_grid_search`` accept it —
    the grid plane serializes it with an explicit "no plan()" reason,
  * :class:`ScaleResult` — :class:`SearchResult` plus the scale half of
    the joint decision (``replicas``, ``cluster_scale``, fleet-replay
    attainment/cost).

The online control plane (:mod:`repro_torch.core.online`) consumes
:class:`AutoscaleSpec` directly: serving runs replica-bounded, drift is
classified capacity-bound vs config-bound from the same saturation
diagnostics, and scale grants become a second drift action validated
jointly with config challengers.

The port's copy of ``src/repro/core/autoscale.py``, numpy and plain
Python as there. :meth:`ScaleSearcher._fleet_eval` builds its engine
without a device, as the reference does: it always passes ``scale=``,
so its replays take the constrained plane on the host and never sweep.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core.critical_path import find_critical_path
from repro_torch.core.engine import (ClusterModel, ColdStartModel,
                                     FleetEngine, FleetReport,
                                     INFINITE_CLUSTER, NO_COLD_START,
                                     PoissonArrivals, ReplicaModel)
from repro_torch.core.placement import scale_cluster
from repro_torch.core.resources import ResourceConfig
from repro_torch.core.search import (SEARCHERS, EnvLike, ResumeState,
                                     SearchResult, _EnvSearcher,
                                     make_searcher, retune_state)

__all__ = ["AutoscaleSpec", "ScaleResult", "ScaleSearcher",
           "classify_saturation", "grant_replicas", "pool_capacity_factor"]

#: the two actuators a grant can be routed to
ACTUATORS = ("config", "scale")


@dataclasses.dataclass(frozen=True)
class AutoscaleSpec:
    """The joint action space and its policy knobs.

    ``actuators`` selects what a grant may touch — ``("config",)`` and
    ``("scale",)`` are the ablations the autoscale benchmark compares
    against the joint default. Provisioning prices are forwarded to
    :class:`ReplicaModel` so every replica-second is billed; the
    ``rate``/``n_instances``/``cluster``/``cold_start``/``arrival_seed``
    block is the fleet context a *standalone* :class:`ScaleSearcher`
    evaluates candidates against (the online controller substitutes the
    live serving context instead).
    """

    actuators: Tuple[str, ...] = ("config", "scale")
    # -- scale actuator bounds ----------------------------------------
    #: per-function replica-pool cap
    max_replicas: int = 8
    #: replicas added per scale grant (distributed +1 at a time to the
    #: highest-queue-delay critical-path functions)
    grant_width: int = 2
    #: cap on cluster-capacity growth (× the base cluster)
    max_cluster_scale: float = 4.0
    # -- provisioning prices (ReplicaModel passthrough) ---------------
    provision_frac: float = 0.25
    provision_floor: float = 0.0
    # -- drift / miss classification ----------------------------------
    #: a miss is capacity-bound when queue delay is at least this share
    #: of the observed queue+cold overhead
    queue_share_threshold: float = 0.5
    #: ... and the overhead itself is at least this fraction of the SLO
    #: (tiny queueing under a big runtime miss is config-bound)
    min_overhead_frac: float = 0.05
    # -- deploy-time pool sizing --------------------------------------
    #: target busy fraction per replica at deploy: pools start at
    #: ``ceil(rate * runtime / deploy_utilization)`` replicas, so
    #: replica-bounded serving is not saturated at epoch 0 by a load no
    #: drift caused (a pool offered more than 1 erlang per replica
    #: queues without bound)
    deploy_utilization: float = 0.5
    # -- standalone search loop ---------------------------------------
    target_attainment: float = 0.95
    max_rounds: int = 10
    #: inner-searcher samples per config-bound round
    config_grant: int = 8
    # -- standalone fleet-evaluation context --------------------------
    rate: float = 0.2
    n_instances: int = 32
    cluster: ClusterModel = INFINITE_CLUSTER
    cold_start: ColdStartModel = NO_COLD_START
    arrival_seed: int = 0

    def __post_init__(self) -> None:
        if not self.actuators or any(a not in ACTUATORS
                                     for a in self.actuators):
            raise ValueError(
                f"actuators must be a non-empty subset of {ACTUATORS}, "
                f"got {self.actuators!r}")
        if self.max_replicas < 1:
            raise ValueError("max_replicas must be >= 1")
        if self.grant_width < 1:
            raise ValueError("grant_width must be >= 1")
        if not self.max_cluster_scale >= 1.0:
            raise ValueError("max_cluster_scale must be >= 1")
        if not 0.0 <= self.queue_share_threshold <= 1.0:
            raise ValueError("queue_share_threshold must be in [0, 1]")
        if not 0.0 < self.deploy_utilization <= 1.0:
            raise ValueError("deploy_utilization must be in (0, 1]")

    def replica_model(self, replicas: Dict[object, int]) -> ReplicaModel:
        """The engine-side actuator for a replica assignment."""
        return ReplicaModel(replicas=dict(replicas),
                            provision_frac=self.provision_frac,
                            provision_floor=self.provision_floor)


@dataclasses.dataclass
class ScaleResult(SearchResult):
    """A :class:`SearchResult` plus the scale half of the joint action."""

    #: per-function replica pools (bare function names)
    replicas: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: cluster-capacity factor (× the spec's base cluster)
    cluster_scale: float = 1.0
    #: fleet-replay metrics of the returned joint action
    fleet_attainment: float = float("nan")
    fleet_cost: float = float("inf")
    #: fleet replays the joint loop spent (NOT search-trace samples)
    fleet_evals: int = 0

    def summary(self) -> Dict[str, object]:
        out = super().summary()
        out.update({
            "replicas": sorted(self.replicas.items()),
            "total_replicas": sum(self.replicas.values()),
            "cluster_scale": self.cluster_scale,
            "fleet_attainment": self.fleet_attainment,
            "fleet_cost": self.fleet_cost,
            "fleet_evals": self.fleet_evals,
        })
        return out


def classify_saturation(saturation: Dict[str, Dict[str, float]],
                        cold_delay_s: float = 0.0) -> Tuple[bool, float]:
    """Capacity-bound vs config-bound from saturation diagnostics.

    Returns ``(capacity_bound, queue_share)`` where ``queue_share`` is
    queue delay's share of the total queue+cold overhead. The caller
    applies its own threshold (and its own overhead-magnitude floor);
    this helper just folds the rows deterministically (sorted keys,
    left-to-right sums).

    The third leg of the miss triage — *failure-bound*, read off the
    same rows' ``failed``/``failure_share`` entries when the engine
    runs a fault model — lives in
    :func:`repro_torch.core.faults.classify_failures`; the online controller
    checks it before the capacity/config split (failed attempts inflate
    neither queue delay nor cold overhead, so a failure-driven miss
    looks deceptively config-bound here)."""
    queue = 0.0
    for key in sorted(saturation):
        queue += saturation[key]["queue_delay_s"]
    overhead = queue + cold_delay_s
    share = (queue / overhead) if overhead > 0.0 else 0.0
    return share > 0.0, share


def grant_replicas(replicas: Dict[str, int],
                   saturation: Dict[str, Dict[str, float]],
                   critical_path: List[str], *,
                   width: int, max_replicas: int) -> Dict[str, int]:
    """Critical-path-guided scale-up: one grant of ``width`` replicas,
    handed +1 at a time to the highest-queue-delay functions on the
    critical path (falling back to any queued function when the path's
    pools are all capped). Saturation keys are ``"identity/name"``;
    ``replicas`` is keyed by bare function name. Returns the grown
    assignment (a copy); equal to the input when every pool is capped.
    """
    by_name: Dict[str, float] = {}
    for key in sorted(saturation):
        name = key.split("/", 1)[-1]
        by_name[name] = by_name.get(name, 0.0) + \
            saturation[key]["queue_delay_s"]
    cp = [n for n in critical_path if n in by_name]
    ranked = sorted(cp, key=lambda n: (-by_name[n], n)) + \
        sorted((n for n in by_name if n not in set(cp)),
               key=lambda n: (-by_name[n], n))
    out = dict(replicas)
    for _ in range(width):
        target = next((n for n in ranked
                       if by_name[n] > 0.0
                       and out.get(n, 1) < max_replicas), None)
        if target is None:
            break
        out[target] = out.get(target, 1) + 1
    return out


def pool_capacity_factor(replicas: Dict[str, int],
                         configs: Dict[str, ResourceConfig],
                         base: ClusterModel, *,
                         max_scale: float, floor: float = 1.0) -> float:
    """Capacity follows the pools: the cluster-scale factor that lets
    every provisioned replica run simultaneously (CPU and memory), so a
    granted replica is never starved by the very quota it was granted
    under. Bounded below by ``floor`` (capacity is never shrunk) and
    above by ``max_scale``; an infinite base dimension needs no growth.
    """
    need = max(1.0, floor)
    if math.isfinite(base.total_cpu) and base.total_cpu > 0:
        cpu = sum(r * configs[n].cpu for n, r in sorted(replicas.items())
                  if n in configs)
        need = max(need, cpu / base.total_cpu)
    if math.isfinite(base.total_mem_mb) and base.total_mem_mb > 0:
        mem = sum(r * configs[n].mem for n, r in sorted(replicas.items())
                  if n in configs)
        need = max(need, mem / base.total_mem_mb)
    return min(max_scale, need)


class ScaleSearcher(_EnvSearcher):
    """Joint ``(cpu, mem, replicas, cluster)`` search over an inner
    config searcher (see module docstring). Registry name ``"scale"``.

    Exposes no ``plan()``: the lockstep grid plane serializes it with
    an explicit reason (its rounds interleave inner-searcher probes
    with whole-fleet replays, which have no per-probe fusion point).
    """

    name = "scale"

    def __init__(self, env: EnvLike, *, inner: str = "aarc",
                 spec: AutoscaleSpec = AutoscaleSpec(),
                 inner_kwargs: Optional[Dict] = None):
        super().__init__(env)
        if inner == self.name:
            raise ValueError("inner searcher cannot be 'scale' itself")
        self.spec = spec
        self.inner_name = inner
        self._inner = make_searcher(inner, env, **(inner_kwargs or {}))

    # -- fleet evaluation ---------------------------------------------
    def _fleet_eval(self, env, template, configs: Dict[str, ResourceConfig],
                    replicas: Dict[str, int],
                    cluster_scale: float) -> FleetReport:
        spec = self.spec
        engine = FleetEngine(
            env.backend, pricing=env.pricing,
            cluster=scale_cluster(spec.cluster, cluster_scale),
            cold_start=spec.cold_start,
            scale=spec.replica_model(replicas))
        times = PoissonArrivals(spec.rate, spec.n_instances,
                                seed=spec.arrival_seed).times()
        return engine.run_many(template, [configs], [times])[0]

    @staticmethod
    def _overhead_slo(report: FleetReport, slo: float) -> float:
        """Effective SLO for a config-bound round: the raw SLO minus
        the p90 per-instance queue+cold overhead (floored at 30 %), so
        the retuned configuration keeps headroom under the contention
        the fleet replay actually observed."""
        ov = sorted((report.queue_delays + report.cold_delays).tolist())
        if not ov:
            return slo
        q = ov[min(len(ov) - 1, int(0.9 * (len(ov) - 1)))]
        return max(slo - (q if math.isfinite(q) else slo), 0.3 * slo)

    # -- the joint loop -----------------------------------------------
    def search(self, wf, slo: float) -> ScaleResult:
        t0 = time.perf_counter()
        spec = self.spec
        inner_res = self._inner.search(wf, slo)
        state = inner_res.state
        env = state.env if state is not None else self._fresh_env()
        configs = {n: c.copy() for n, c in inner_res.configs.items()}
        replicas: Dict[str, int] = {n: 1 for n in wf.nodes}
        cluster_scale = 1.0
        best: Optional[Dict] = None
        evals = 0
        trimming = False
        note = ""

        def better(cand: Dict, incumbent: Optional[Dict]) -> bool:
            if incumbent is None:
                return True
            if cand["feasible"] != incumbent["feasible"]:
                return cand["feasible"]
            if cand["feasible"]:
                return cand["cost"] < incumbent["cost"]
            return (cand["att"], -cand["cost"]) > (incumbent["att"],
                                                   -incumbent["cost"])

        for _ in range(spec.max_rounds):
            report = self._fleet_eval(env, wf, configs, replicas,
                                      cluster_scale)
            evals += 1
            att = report.slo_attainment(slo)
            snap = {
                "configs": {n: c.copy() for n, c in configs.items()},
                "replicas": dict(replicas),
                "cluster_scale": cluster_scale,
                "att": att, "cost": report.total_cost,
                "feasible": att >= spec.target_attainment,
            }
            if better(snap, best):
                best = snap
            elif trimming:
                break                      # the trim lost ground: stop
            if snap["feasible"]:
                # cost-reduction pass: drop one replica from the
                # lowest-utilization over-provisioned pool and re-check
                trimmed = self._trim(report, replicas)
                if trimmed is None:
                    break
                replicas, trimming = trimmed, True
                continue
            trimming = False
            sat = report.saturation()
            cold = float(sum(report.cold_delays.tolist()))
            _, qshare = classify_saturation(sat, cold)
            overhead_p90 = slo - self._overhead_slo(report, slo)
            capacity = ("scale" in spec.actuators
                        and qshare >= spec.queue_share_threshold
                        and overhead_p90 >= spec.min_overhead_frac * slo)
            if "config" not in spec.actuators:
                capacity = "scale" in spec.actuators  # scale-only ablation
            if capacity:
                cp = find_critical_path(state.wf) if state is not None \
                    else list(wf.nodes)
                grown = grant_replicas(replicas, sat, cp,
                                       width=spec.grant_width,
                                       max_replicas=spec.max_replicas)
                if grown != replicas:
                    replicas = grown
                    # capacity tracks pool growth: the cluster grows to
                    # fit the provisioned replicas' aggregate demand so
                    # granted replicas have cores to run on (capped,
                    # never shrunk)
                    cluster_scale = pool_capacity_factor(
                        replicas, configs, spec.cluster,
                        max_scale=spec.max_cluster_scale,
                        floor=cluster_scale)
                    continue
                if "config" not in spec.actuators:
                    note = "every pool capped; scale-only cannot proceed"
                    break
                capacity = False           # pools capped: fall to config
            if not capacity and "config" in spec.actuators \
                    and state is not None:
                retune_state(state, slo=self._overhead_slo(report, slo))
                resumed = self._inner.resume(state, spec.config_grant)
                state = resumed.state if resumed.state is not None else state
                configs = {n: c.copy() for n, c in resumed.configs.items()}
                continue
            note = "no actuator applicable"
            break

        assert best is not None
        res = ScaleResult(
            searcher=self.name, workflow=wf.name, slo=slo,
            configs=best["configs"], e2e_runtime=inner_res.e2e_runtime,
            cost=inner_res.cost, feasible=best["feasible"],
            n_samples=env.trace.n_samples,
            search_time=env.trace.total_search_runtime,
            search_cost=env.trace.total_search_cost,
            wall_time_s=time.perf_counter() - t0, trace=env.trace,
            best=env.trace.best_feasible(),
            note=note or f"joint: {sum(best['replicas'].values())} replicas "
            f"at cluster x{best['cluster_scale']:g}",
            replicas=best["replicas"], cluster_scale=best["cluster_scale"],
            fleet_attainment=best["att"], fleet_cost=best["cost"],
            fleet_evals=evals)
        res.state = ResumeState(searcher=self.name, env=env, wf=state.wf
                                if state is not None else wf, slo=slo,
                                result=res,
                                payload={"replicas": dict(best["replicas"]),
                                         "cluster_scale":
                                         best["cluster_scale"]})
        return res

    @staticmethod
    def _trim(report: FleetReport,
              replicas: Dict[str, int]) -> Optional[Dict[str, int]]:
        """One replica off the lowest-utilization pool with R > 1 and
        mean busy fraction under half its provisioned capacity; ``None``
        when nothing is over-provisioned."""
        sat = report.saturation()
        by_name: Dict[str, Dict[str, float]] = {}
        for key in sorted(sat):
            by_name.setdefault(key.split("/", 1)[-1], sat[key])
        cands = sorted(
            (n for n, r in replicas.items()
             if r > 1 and by_name.get(n, {}).get("utilization", 1.0) < 0.5),
            key=lambda n: (by_name[n]["utilization"], n))
        if not cands:
            return None
        out = dict(replicas)
        out[cands[0]] -= 1
        return out

    def resume(self, state: ResumeState, extra_budget: int) -> SearchResult:
        """Continue the *config* half with ``extra_budget`` more inner
        samples, then re-evaluate the held joint action; the scale half
        resumes from the state's payload (the online controller drives
        scale grants itself)."""
        if extra_budget <= 0:
            return state.result
        res = state.result
        payload = state.payload or {}
        replicas = dict(payload.get("replicas", {}))
        cluster_scale = float(payload.get("cluster_scale", 1.0))
        inner_state = ResumeState(searcher=self.inner_name, env=state.env,
                                  wf=state.wf, slo=state.slo,
                                  result=res, payload=None)
        resumed = self._inner.resume(inner_state, extra_budget)
        configs = {n: c.copy() for n, c in resumed.configs.items()}
        report = self._fleet_eval(state.env, state.wf, configs,
                                  replicas or {n: 1 for n in state.wf.nodes},
                                  cluster_scale)
        res.configs = configs
        if isinstance(res, ScaleResult):
            res.fleet_attainment = report.slo_attainment(state.slo)
            res.fleet_cost = report.total_cost
            res.fleet_evals += 1
            res.feasible = res.fleet_attainment >= self.spec.target_attainment
        res.n_samples = state.env.trace.n_samples
        return res


#: self-registration: ``make_searcher("scale", ...)`` lazy-imports this
#: module and finds the entry (see repro_torch.core.search.make_searcher)
SEARCHERS[ScaleSearcher.name] = ScaleSearcher
