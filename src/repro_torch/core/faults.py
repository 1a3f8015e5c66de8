"""Seeded fault injection + recovery policy as a searched actuator.

AARC's platform model (arXiv 2502.20846) fails only deterministically —
an infeasible config OOMs, everything else completes. Real serverless
fleets also lose invocations to *transient* faults, runtime stragglers,
failed cold-start provisioning, and correlated node outages that take
down every co-placed tenant at once. This module supplies both halves
of that story:

  * :class:`FaultModel` — the seeded fault-injection plane the
    :class:`repro_torch.core.engine.FleetEngine` serves through: per-function
    transient failure rates, straggler runtime inflation, cold-start
    provisioning failures, and node-outage windows keyed to a
    placement map (``node_of`` maps tenants/functions onto placement
    bins; an outage boosts every co-placed function's failure rate to
    ``outage_fail`` for its duration),
  * the **paired fault-stream contract** — :meth:`FaultModel.
    fault_stream` draws ONE ``(lane, channel, attempt, instance,
    function)`` uniform tensor per replay plane (a single rng advance,
    mirroring the stochastic backend's ``replay_noise``), shared by every candidate of a
    ``run_many`` plane. The same configuration in two candidate slots
    therefore draws the *same* faults — batched challenger validation
    stays a paired experiment, and the serial event loop and the
    table-driven constrained plane see bit-identical outcomes,
  * :class:`ResiliencePolicy` / :class:`ResilienceModel` — per-function
    recovery knobs ``(max_retries, timeout_s, backoff_s,
    hedge_delay_s)`` with the same tenant-qualified key resolution as
    :class:`repro_torch.core.engine.ReplicaModel`,
  * :class:`ResilienceSearcher` — recovery policy as part of the
    searched configuration, as the reference's autoscaler does for
    replicas: a
    :class:`repro_torch.core.search.Searcher` (registry name
    ``"resilience"``) wrapping any inner config searcher, granting
    policy-ladder upgrades to the functions whose failure share
    dominates :meth:`FleetReport.saturation`'s failure rows and
    trimming recovery spend off clean functions.

Recovery semantics are inert without a fault model: a
``FleetEngine(resilience=..., faults=None)`` run is bit-identical to a
plain engine (there is nothing to recover from), and ``faults=None``
pins the engine bit-identical to its pre-fault behaviour on all four
replay planes.

The port's copy of ``src/repro/core/faults.py``, numpy and plain Python
as there, so that fault streams, recovery and searches equal the
reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.engine import (ClusterModel, ColdStartModel, FleetEngine,
                               FleetReport, INFINITE_CLUSTER, NO_COLD_START,
                               PoissonArrivals)
from repro_torch.core.resources import ResourceConfig
from repro_torch.core.search import (SEARCHERS, EnvLike, ResumeState, SearchResult,
                               _EnvSearcher, make_searcher, retune_state)

__all__ = ["MAX_ATTEMPTS", "FaultModel", "FaultStream", "OutageWindow",
           "ResiliencePolicy", "ResilienceModel", "NO_RECOVERY",
           "ResilienceSpec", "ResilienceResult", "ResilienceSearcher",
           "classify_failures", "grant_policies", "degrade_policies",
           "policy_ladder"]

#: hard cap on attempt depth per invocation (1 primary + up to
#: ``MAX_ATTEMPTS - 1`` retries) — it sizes the fault stream's attempt
#: axis, so every attempt of every instance has its own pre-drawn
#: uniforms and replay stays deterministic under any admission order
MAX_ATTEMPTS = 8


@dataclasses.dataclass(frozen=True)
class OutageWindow:
    """One correlated node outage: every function placed on ``node``
    (see :attr:`FaultModel.node_of`) fails attempts admitted during
    ``[start_s, end_s)`` with probability :attr:`FaultModel.outage_fail`.
    Attempts already in flight when the outage begins ride it out — the
    blast radius is admission-time, which is what retry backoff (and
    anti-affinity spreading) can actually mitigate."""

    node: int
    start_s: float
    end_s: float

    def __post_init__(self) -> None:
        if self.node < 0:
            raise ValueError(f"outage node must be >= 0, got {self.node}")
        if not (math.isfinite(self.start_s) and self.start_s >= 0.0):
            raise ValueError(f"outage start must be finite and >= 0, "
                             f"got {self.start_s}")
        if not self.end_s > self.start_s:
            raise ValueError(
                f"outage window must have end > start, got "
                f"[{self.start_s}, {self.end_s})")


class FaultStream:
    """One replay plane's pre-drawn fault uniforms.

    ``primary`` and ``hedge`` are ``(3, MAX_ATTEMPTS, instances,
    functions)`` float64 tensors in [0, 1): channel 0 drives transient
    failures, channel 1 stragglers, channel 2 cold-start provisioning
    failures. The hedge lane keeps a hedged attempt's draws independent
    of its primary's without a second rng advance."""

    __slots__ = ("primary", "hedge")

    def __init__(self, primary: np.ndarray, hedge: np.ndarray):
        self.primary = primary
        self.hedge = hedge

    @property
    def max_attempts(self) -> int:
        return int(self.primary.shape[1])


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Seeded fault-injection plane (see module docstring).

    ``transient`` maps a function name — or a ``(tenant identity,
    function name)`` pair for packed fleets — to its per-*attempt*
    transient failure probability (same key resolution as
    :class:`repro_torch.core.engine.ReplicaModel`); unnamed functions fall
    back to ``default_transient``. A transiently failing attempt burns
    its full runtime and cost before failing.

    With probability ``straggler_prob`` an attempt's runtime inflates
    by ``straggler_factor`` (billed accordingly) — the tail a
    per-function ``timeout_s``/``hedge_delay_s`` policy exists to cut.

    When the engine charges a cold start, the container fails to come
    up with probability ``cold_fail``: the attempt burns the
    provisioning delay (zero execution, zero execution cost) and fails.

    ``outages`` + ``node_of`` model correlated node loss via a
    placement map: ``node_of`` keys — ``(identity, name)`` pairs or
    bare tenant identities — map onto placement-bin indices (the
    reference placer's ``PlacementSolution.assignment``), and an
    attempt admitted on an out node during a window fails with
    probability ``outage_fail`` (the max of it and the function's
    transient rate).
    Functions with no node mapping never see outages.

    ``fault_stream`` draws are keyed by the (attempt, instance,
    function) coordinate — NOT call order — so batched replays are
    reproducible paired comparisons across candidates (the contract
    :meth:`repro_torch.core.engine.FleetEngine.run_many` relies on; one rng
    advance per plane, mirroring ``replay_noise``)."""

    transient: Mapping[object, float] = \
        dataclasses.field(default_factory=dict)
    default_transient: float = 0.0
    straggler_prob: float = 0.0
    straggler_factor: float = 4.0
    cold_fail: float = 0.0
    outages: Tuple[OutageWindow, ...] = ()
    node_of: Mapping[object, int] = dataclasses.field(default_factory=dict)
    outage_fail: float = 1.0
    seed: int = 0

    def __post_init__(self) -> None:
        for key, p in self.transient.items():
            if not 0.0 <= float(p) <= 1.0:
                raise ValueError(
                    f"transient rate for {key!r} must be in [0, 1], got {p}")
        for fld in ("default_transient", "cold_fail", "outage_fail",
                    "straggler_prob"):
            v = getattr(self, fld)
            if not 0.0 <= float(v) <= 1.0:
                raise ValueError(f"{fld} must be in [0, 1], got {v}")
        if not (math.isfinite(self.straggler_factor)
                and self.straggler_factor >= 1.0):
            raise ValueError(f"straggler_factor must be >= 1, "
                             f"got {self.straggler_factor}")

    # -- rate resolution ----------------------------------------------
    def rate(self, identity: str, name: str) -> float:
        """Transient failure probability for one function: the
        tenant-qualified key wins over the bare name, which wins over
        ``default_transient``."""
        p = self.transient.get((identity, name))
        if p is None:
            p = self.transient.get(name, self.default_transient)
        return float(p)

    def node_for(self, identity: str, name: str) -> Optional[int]:
        """Placement node of one function (``(identity, name)`` key
        first, then the bare identity), or ``None`` when unplaced."""
        node = self.node_of.get((identity, name))
        if node is None:
            node = self.node_of.get(identity)
        return None if node is None else int(node)

    def outage_active(self, identity: str, name: str, t: float) -> bool:
        """Is an attempt of this function admitted at ``t`` inside an
        outage window of its placement node?"""
        node = self.node_for(identity, name)
        if node is None:
            return False
        for w in self.outages:
            if w.node == node and w.start_s <= t < w.end_s:
                return True
        return False

    def effective_transient(self, identity: str, name: str,
                            t: float) -> float:
        """The per-attempt failure probability at admission time ``t``
        (the function's transient rate, boosted to ``outage_fail``
        inside an outage window of its node)."""
        p = self.rate(identity, name)
        if self.outage_fail > p and self.outage_active(identity, name, t):
            p = self.outage_fail
        return p

    # -- the paired fault-stream contract -----------------------------
    def fault_stream(self, n_instances: int, n_functions: int) -> FaultStream:
        """ONE uniform tensor per replay plane — a single rng advance,
        shared by every candidate of the plane and segmented per
        arrival set exactly like ``replay_noise`` (the engine offsets
        instance rows per seed segment). Same seed + same plane shape
        => byte-identical draws."""
        rng = np.random.default_rng(self.seed)
        u = rng.random((2, 3, MAX_ATTEMPTS, n_instances, n_functions))
        return FaultStream(primary=u[0], hedge=u[1])


# --------------------------------------------------------------------------
# recovery policy
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """One function's recovery knobs — the per-function action the
    :class:`ResilienceSearcher` (and the online controller's policy
    grants) search over.

      * ``max_retries`` — failed attempts are re-queued up to this many
        times; each attempt is charged its full wall time and cost,
      * ``backoff_s`` — retry k waits ``backoff_s * 2**k`` after the
        failed attempt releases its slot (exponential backoff; the wait
        is not queue delay — the slot is free for other work),
      * ``timeout_s`` — an attempt still executing ``timeout_s`` after
        its launch (cold provisioning excluded) is killed, billed for
        the executed ``timeout_s``, and treated as a failed attempt
        (re-queued while retries remain) — the straggler guillotine,
      * ``hedge_delay_s`` — when an attempt is still unresolved
        ``hedge_delay_s`` after admission, a duplicate fires on burst
        capacity (no cluster slot, no cold delay — a standby): the
        earliest success wins, the loser is cancelled at that instant,
        and BOTH legs are billed for their executed runtime. Hedging
        buys tail latency with money.
    """

    max_retries: int = 0
    timeout_s: Optional[float] = None
    backoff_s: float = 0.0
    hedge_delay_s: Optional[float] = None

    def __post_init__(self) -> None:
        if not 0 <= int(self.max_retries) <= MAX_ATTEMPTS - 1:
            raise ValueError(
                f"max_retries must be in [0, {MAX_ATTEMPTS - 1}], "
                f"got {self.max_retries}")
        if self.timeout_s is not None and not self.timeout_s > 0.0:
            raise ValueError(f"timeout_s must be positive, "
                             f"got {self.timeout_s}")
        if not (math.isfinite(self.backoff_s) and self.backoff_s >= 0.0):
            raise ValueError(f"backoff_s must be finite and >= 0, "
                             f"got {self.backoff_s}")
        if self.hedge_delay_s is not None and not self.hedge_delay_s >= 0.0:
            raise ValueError(f"hedge_delay_s must be >= 0, "
                             f"got {self.hedge_delay_s}")


#: the do-nothing policy every unnamed function gets
NO_RECOVERY = ResiliencePolicy()


@dataclasses.dataclass(frozen=True)
class ResilienceModel:
    """Per-function recovery policies for one engine run.

    ``policies`` maps a function name — or a ``(tenant identity,
    function name)`` pair — to its :class:`ResiliencePolicy`; unnamed
    functions fall back to ``default`` (no recovery unless set). Key
    resolution mirrors :meth:`repro_torch.core.engine.ReplicaModel.pool`."""

    policies: Mapping[object, ResiliencePolicy] = \
        dataclasses.field(default_factory=dict)
    default: ResiliencePolicy = NO_RECOVERY

    def policy(self, identity: str, name: str) -> ResiliencePolicy:
        p = self.policies.get((identity, name))
        if p is None:
            p = self.policies.get(name, self.default)
        return p


# --------------------------------------------------------------------------
# failure classification + policy grants (shared with an online controller)
# --------------------------------------------------------------------------

def classify_failures(saturation: Dict[str, Dict[str, float]]
                      ) -> Tuple[int, Dict[str, float]]:
    """Fold :meth:`FleetReport.saturation`'s failure rows into
    ``(total_failed_attempts, failure_share_by_key)`` deterministically
    (sorted keys). The online controller classifies a miss as
    *failure-bound* when the total is non-zero and capacity is not the
    binding constraint — recovery policy, not replicas, is the fix."""
    total = 0
    share: Dict[str, float] = {}
    for key in sorted(saturation):
        total += int(saturation[key].get("failed", 0))
    for key in sorted(saturation):
        f = int(saturation[key].get("failed", 0))
        share[key] = (f / total) if total > 0 else 0.0
    return total, share


def policy_ladder(level: int, runtime_s: float, *, max_retries: int = 3,
                  backoff_s: float = 0.05, timeout_factor: float = 4.0,
                  hedge_factor: float = 2.0) -> ResiliencePolicy:
    """The per-function upgrade ladder a grant climbs, parameterized by
    the function's observed solo runtime:

      * level 0 — :data:`NO_RECOVERY`,
      * levels 1..max_retries — ``k`` retries with exponential backoff,
      * level max_retries+1 — retries + ``timeout_factor x runtime``
        straggler timeout,
      * level max_retries+2 — retries + timeout +
        ``hedge_factor x runtime`` hedging.

    Cheap knobs first: retries only pay when faults strike, timeouts
    only on stragglers, hedges on every slow attempt."""
    if level <= 0:
        return NO_RECOVERY
    rt = max(float(runtime_s), 1e-9)
    retries = min(level, max_retries)
    timeout = timeout_factor * rt if level > max_retries else None
    hedge = hedge_factor * rt if level > max_retries + 1 else None
    return ResiliencePolicy(max_retries=retries, timeout_s=timeout,
                            backoff_s=backoff_s, hedge_delay_s=hedge)


def ladder_level(policy: ResiliencePolicy, *, max_retries: int = 3) -> int:
    """Inverse of :func:`policy_ladder` (for policies it produced)."""
    if policy.max_retries == 0 and policy.timeout_s is None \
            and policy.hedge_delay_s is None:
        return 0
    level = min(policy.max_retries, max_retries)
    if policy.timeout_s is not None:
        level = max_retries + 1
    if policy.hedge_delay_s is not None:
        level = max_retries + 2
    return level


def grant_policies(levels: Dict[str, int],
                   saturation: Dict[str, Dict[str, float]], *,
                   width: int, max_level: int) -> Dict[str, int]:
    """One policy grant: ``width`` ladder upgrades handed +1 level at a
    time to the highest-failure-share functions (saturation keys are
    ``"identity/name"``; ``levels`` is keyed by bare function name).
    Returns the upgraded level map (a copy); equal to the input when no
    failing function has headroom."""
    _, share = classify_failures(saturation)
    by_name: Dict[str, float] = {}
    for key in sorted(share):
        name = key.split("/", 1)[-1]
        by_name[name] = by_name.get(name, 0.0) + share[key]
    ranked = sorted(by_name, key=lambda n: (-by_name[n], n))
    out = dict(levels)
    for _ in range(width):
        target = next((n for n in ranked
                       if by_name[n] > 0.0
                       and out.get(n, 0) < max_level), None)
        if target is None:
            break
        out[target] = out.get(target, 0) + 1
    return out


def degrade_policies(levels: Dict[str, int],
                     critical_path: List[str]) -> Dict[str, int]:
    """Graceful degradation for a detected outage window: functions off
    the critical path shed their expensive recovery (hedges/timeouts
    collapse to at most 1 retry) so the fleet's recovery spend
    concentrates where latency actually accrues. Returns the degraded
    level map (a copy)."""
    cp = set(critical_path)
    return {n: (lvl if n in cp else min(lvl, 1))
            for n, lvl in levels.items()}


# --------------------------------------------------------------------------
# the resilience searcher
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResilienceSpec:
    """The recovery action space and its policy knobs (the
    reference autoscaler's ``AutoscaleSpec`` shape, for the fault
    dimension).

    The ``faults`` model is the environment candidates are evaluated
    under; the ladder knobs bound the per-function policy space; the
    ``rate``/``n_instances``/``cluster``/``cold_start``/``arrival_seed``
    block is the standalone fleet-evaluation context (the online
    controller substitutes the live serving context instead, and uses
    the classification/degradation knobs below)."""

    faults: FaultModel = FaultModel()
    # -- ladder bounds -------------------------------------------------
    max_retries: int = 3
    backoff_s: float = 0.05
    timeout_factor: float = 4.0
    hedge_factor: float = 2.0
    grant_width: int = 2
    # -- standalone search loop ---------------------------------------
    target_attainment: float = 0.95
    max_rounds: int = 12
    #: inner-searcher samples per config-bound round
    config_grant: int = 8
    # -- online classification / degradation knobs --------------------
    #: a drift window is failure-bound once this many failed attempts
    #: accumulate in it
    min_failures: int = 1
    #: live attainment below this fraction of the baseline marks a
    #: concentrated outage — off-critical-path functions degrade
    degrade_attainment_frac: float = 0.5
    #: never tighten the retune SLO below this fraction of the SLO
    #: (severe fault overhead cannot demand the impossible)
    slo_floor_frac: float = 0.3
    #: per-round cap on retune tightening (multiplicative): the
    #: effective SLO shrinks by at most this factor each latency-bound
    #: round, so the search settles at the *loosest* (cheapest)
    #: headroom that reaches the target instead of overshooting to the
    #: floor on the first overhead estimate
    retune_step: float = 0.8
    # -- standalone fleet-evaluation context --------------------------
    rate: float = 0.2
    n_instances: int = 32
    cluster: ClusterModel = INFINITE_CLUSTER
    cold_start: ColdStartModel = NO_COLD_START
    arrival_seed: int = 0

    def __post_init__(self) -> None:
        if not 1 <= self.max_retries <= MAX_ATTEMPTS - 1:
            raise ValueError(
                f"max_retries must be in [1, {MAX_ATTEMPTS - 1}], "
                f"got {self.max_retries}")
        if self.grant_width < 1:
            raise ValueError("grant_width must be >= 1")
        for fld in ("timeout_factor", "hedge_factor"):
            if not getattr(self, fld) > 0.0:
                raise ValueError(f"{fld} must be positive")
        if self.min_failures < 1:
            raise ValueError("min_failures must be >= 1")
        if not 0.0 < self.degrade_attainment_frac <= 1.0:
            raise ValueError("degrade_attainment_frac must be in (0, 1]")
        if not 0.0 < self.retune_step <= 1.0:
            raise ValueError("retune_step must be in (0, 1]")

    @property
    def max_level(self) -> int:
        return self.max_retries + 2

    def ladder(self, level: int, runtime_s: float) -> ResiliencePolicy:
        return policy_ladder(level, runtime_s,
                             max_retries=self.max_retries,
                             backoff_s=self.backoff_s,
                             timeout_factor=self.timeout_factor,
                             hedge_factor=self.hedge_factor)

    def resilience_model(self, levels: Dict[str, int],
                         runtimes: Dict[str, float]) -> ResilienceModel:
        """The engine-side actuator for a ladder-level assignment."""
        return ResilienceModel(policies={
            n: self.ladder(lvl, runtimes.get(n, 0.0))
            for n, lvl in sorted(levels.items()) if lvl > 0})


@dataclasses.dataclass
class ResilienceResult(SearchResult):
    """A :class:`SearchResult` plus the recovery half of the action."""

    #: per-function recovery policies (bare function names)
    policies: Dict[str, ResiliencePolicy] = \
        dataclasses.field(default_factory=dict)
    #: fleet-replay metrics of the returned joint action (under faults)
    fleet_attainment: float = float("nan")
    fleet_cost: float = float("inf")
    #: fleet replays the loop spent (NOT search-trace samples)
    fleet_evals: int = 0

    def summary(self) -> Dict[str, object]:
        out = super().summary()
        out.update({
            "policies": sorted(
                (n, dataclasses.asdict(p))
                for n, p in self.policies.items()),
            "fleet_attainment": self.fleet_attainment,
            "fleet_cost": self.fleet_cost,
            "fleet_evals": self.fleet_evals,
        })
        return out


class ResilienceSearcher(_EnvSearcher):
    """Recovery policy as part of the searched configuration: wraps any
    inner config searcher and alternates **failure-guided policy
    grants** (ladder upgrades to the functions dominating the fleet
    replay's failure rows) with **config retuning** (when the miss is
    runtime-bound, route a grant through ``retune_state`` +
    ``inner.resume``) and a **trim pass** (once feasible, walk
    recovery levels back off functions whose failures stopped),
    tracking the best ``(configs, policies)`` by fleet cost at the
    attainment target — the reference autoscaler's ``ScaleSearcher``
    loop shape, for the fault dimension. Registry name
    ``"resilience"``.

    Exposes no ``plan()``: the lockstep grid plane serializes it (its
    rounds interleave inner probes with whole-fleet fault replays)."""

    name = "resilience"

    def __init__(self, env: EnvLike, *, inner: str = "aarc",
                 spec: ResilienceSpec = ResilienceSpec(),
                 inner_kwargs: Optional[Dict] = None):
        super().__init__(env)
        if inner == self.name:
            raise ValueError("inner searcher cannot be 'resilience' itself")
        self.spec = spec
        self.inner_name = inner
        self._inner = make_searcher(inner, env, **(inner_kwargs or {}))

    # -- fleet evaluation ---------------------------------------------
    def _fleet_eval(self, env, template,
                    configs: Dict[str, ResourceConfig],
                    levels: Dict[str, int],
                    runtimes: Dict[str, float]) -> FleetReport:
        spec = self.spec
        engine = FleetEngine(
            env.backend, pricing=env.pricing, cluster=spec.cluster,
            cold_start=spec.cold_start, faults=spec.faults,
            resilience=spec.resilience_model(levels, runtimes))
        times = PoissonArrivals(spec.rate, spec.n_instances,
                                seed=spec.arrival_seed).times()
        return engine.run_many(template, [configs], [times])[0]

    @staticmethod
    def _solo_runtimes(wf, configs) -> Dict[str, float]:
        """Per-function baseline runtimes under the candidate configs —
        the ladder's timeout/hedge scale. Read off the searched
        workflow's cached node runtimes (the inner search measured
        them); functions without a cached runtime scale off 0 (their
        ladder levels then only add retries)."""
        out: Dict[str, float] = {}
        for name, node in wf.nodes.items():
            rt = getattr(node, "runtime", None)
            out[name] = float(rt) if rt is not None \
                and math.isfinite(rt) else 0.0
        return out

    # -- the policy loop ----------------------------------------------
    def search(self, wf, slo: float) -> ResilienceResult:
        t0 = time.perf_counter()
        spec = self.spec
        inner_res = self._inner.search(wf, slo)
        state = inner_res.state
        env = state.env if state is not None else self._fresh_env()
        configs = {n: c.copy() for n, c in inner_res.configs.items()}
        levels: Dict[str, int] = {n: 0 for n in wf.nodes}
        runtimes = self._solo_runtimes(state.wf if state is not None
                                       else wf, configs)
        best: Optional[Dict] = None
        evals = 0
        trimming = False
        slo_eff = slo
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
            report = self._fleet_eval(env, wf, configs, levels, runtimes)
            evals += 1
            att = report.slo_attainment(slo)
            snap = {
                "configs": {n: c.copy() for n, c in configs.items()},
                "levels": dict(levels),
                "att": att, "cost": report.total_cost,
                "feasible": att >= spec.target_attainment,
            }
            if better(snap, best):
                best = snap
            elif trimming:
                break                      # the trim lost ground: stop
            if snap["feasible"]:
                trimmed = self._trim(report, levels)
                if trimmed is None:
                    break
                levels, trimming = trimmed, True
                continue
            trimming = False
            total_failed, _ = classify_failures(report.saturation())
            if total_failed > 0:
                grown = grant_policies(levels, report.saturation(),
                                       width=spec.grant_width,
                                       max_level=spec.max_level)
                if grown != levels:
                    levels = grown
                    continue
                note = "every failing function at max policy level"
            if state is not None:
                # failure-free (or policy-capped) miss: latency-bound —
                # recovery overhead (retry re-burn, straggler tails,
                # hedge waits) rides on top of the config's solo e2e,
                # and a cost-optimal config is SLO-*binding* (zero
                # headroom), so retuning at the raw SLO would re-find
                # the exact configuration faults already break. Retune
                # under a tightened SLO that reserves the observed
                # overhead as headroom (the ``retune_state`` idiom the
                # online controller applies to queue/cold overhead)
                slo_eff = max(self._headroom_slo(wf, runtimes, report,
                                                 slo),
                              spec.retune_step * slo_eff)
                retune_state(state, slo=slo_eff)
                resumed = self._inner.resume(state, spec.config_grant)
                state = resumed.state if resumed.state is not None \
                    else state
                configs = {n: c.copy() for n, c in resumed.configs.items()}
                runtimes = self._solo_runtimes(state.wf, configs)
                continue
            note = note or "no actuator applicable"
            break

        assert best is not None
        policies = {n: spec.ladder(lvl, runtimes.get(n, 0.0))
                    for n, lvl in sorted(best["levels"].items()) if lvl > 0}
        res = ResilienceResult(
            searcher=self.name, workflow=wf.name, slo=slo,
            configs=best["configs"], e2e_runtime=inner_res.e2e_runtime,
            cost=inner_res.cost, feasible=best["feasible"],
            n_samples=env.trace.n_samples,
            search_time=env.trace.total_search_runtime,
            search_cost=env.trace.total_search_cost,
            wall_time_s=time.perf_counter() - t0, trace=env.trace,
            best=env.trace.best_feasible(),
            note=note or f"resilience: {len(policies)} recovering "
            f"functions at levels {sorted(best['levels'].items())}",
            policies=policies, fleet_attainment=best["att"],
            fleet_cost=best["cost"], fleet_evals=evals)
        res.state = ResumeState(searcher=self.name, env=env,
                                wf=state.wf if state is not None else wf,
                                slo=slo, result=res,
                                payload={"levels": dict(best["levels"]),
                                         "runtimes": dict(runtimes)})
        return res

    def _headroom_slo(self, wf, runtimes: Dict[str, float],
                      report: FleetReport, slo: float) -> float:
        """The retune target: the SLO minus the fleet-observed recovery
        overhead at the attainment-target quantile (overhead = observed
        e2e latency above the configs' solo critical path), floored by
        ``spec.slo_floor_frac``. Deterministic — a sorted-index
        quantile of the replay's latencies."""
        probe = wf.copy()
        for name, node in probe.nodes.items():
            node.runtime = runtimes.get(name, 0.0)
        solo = probe.end_to_end_latency()
        lat = np.sort(report.latencies[np.isfinite(report.latencies)])
        if lat.size == 0:
            return slo
        q = float(lat[min(lat.size - 1,
                          int(self.spec.target_attainment
                              * (lat.size - 1)))])
        overhead = max(0.0, q - solo)
        return max(slo - overhead, self.spec.slo_floor_frac * slo)

    @staticmethod
    def _trim(report: FleetReport,
              levels: Dict[str, int]) -> Optional[Dict[str, int]]:
        """One ladder level off the recovering function with the fewest
        observed failed attempts (clean functions first); ``None`` when
        nothing recovers."""
        _, share = classify_failures(report.saturation())
        by_name: Dict[str, float] = {}
        for key in sorted(share):
            name = key.split("/", 1)[-1]
            by_name[name] = by_name.get(name, 0.0) + share[key]
        cands = sorted((n for n, lvl in levels.items() if lvl > 0),
                       key=lambda n: (by_name.get(n, 0.0), n))
        if not cands:
            return None
        out = dict(levels)
        out[cands[0]] -= 1
        return out

    def resume(self, state: ResumeState, extra_budget: int) -> SearchResult:
        """Continue the *config* half with ``extra_budget`` more inner
        samples, then re-evaluate the held joint action under the fault
        model; the policy half resumes from the state's payload (the
        online controller drives policy grants itself)."""
        if extra_budget <= 0:
            return state.result
        res = state.result
        payload = state.payload or {}
        levels = dict(payload.get("levels", {}))
        runtimes = dict(payload.get("runtimes", {}))
        inner_state = ResumeState(searcher=self.inner_name, env=state.env,
                                  wf=state.wf, slo=state.slo,
                                  result=res, payload=None)
        resumed = self._inner.resume(inner_state, extra_budget)
        configs = {n: c.copy() for n, c in resumed.configs.items()}
        report = self._fleet_eval(state.env, state.wf, configs, levels,
                                  runtimes)
        res.configs = configs
        if isinstance(res, ResilienceResult):
            res.fleet_attainment = report.slo_attainment(state.slo)
            res.fleet_cost = report.total_cost
            res.fleet_evals += 1
            res.feasible = \
                res.fleet_attainment >= self.spec.target_attainment
        res.n_samples = state.env.trace.n_samples
        return res


#: self-registration: ``make_searcher("resilience", ...)`` lazy-imports
#: this module and finds the entry (see repro_torch.core.search.make_searcher)
SEARCHERS[ResilienceSearcher.name] = ResilienceSearcher
