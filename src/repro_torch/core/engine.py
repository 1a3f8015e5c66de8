"""Discrete-event fleet engine: many concurrent workflow instances on
a finite-capacity cluster.

AARC's search machinery measures one workflow at a time; the regime the
paper targets is a FaaS platform serving many concurrent invocations
under shared capacity. This engine executes a *fleet* of workflow
instances against a cluster model:

  * **arrivals** — Poisson or trace-driven instance arrival times,
  * **capacity** — the cluster holds ``total_cpu`` vCPUs and
    ``total_mem_mb`` MB; a function invocation occupies its configured
    ``(cpu, mem)`` from start to finish. When the head of the FIFO
    queue does not fit, it (and everything behind it) waits — queuing
    delay is charged per invocation,
  * **cold starts** — per function name, a finished invocation leaves a
    warm container behind for ``keep_alive_s``; an invocation with no
    warm container pays ``delay_s`` provisioning time (warm containers
    hold no cluster capacity; only running invocations do),
  * **batching** — all invocations that start at one engine step are
    evaluated through ``backend.invoke_batch`` in a single vectorized
    call (and priced in one ``PricingModel.cost_batch`` expression),
    not per-node Python dispatch,
  * **batched replays** — :meth:`FleetEngine.run_many` replays C
    candidate config-maps × S arrival seeds over a shared topology as
    one vectorized evaluation: ONE ``invoke_config_batch``
    response-surface call and ONE ``cost_batch`` pricing expression for
    the whole plane, then either a candidate-vectorized longest-path
    sweep (contention-free fleets; on the CUDA card by default, see
    below) or table-driven replays of the exact event loop (finite
    capacity, cold starts, carry collection) — bit-identical to the
    looped scalar path either way. Stochastic backends join the plane
    through a paired replay-noise stream; only non-``batch_safe``
    backends and empty templates still take the serial fallback,
  * **epoch resumption** — a run can start from a :class:`FleetCarry`
    (warm containers plus still-running invocations from a previous
    bounded epoch) and emit the carry for the next epoch, so an online
    control plane serving back-to-back epochs does not restart the
    fleet cold at every boundary.

Failure semantics mirror :meth:`Environment.execute`: a failing
invocation (OOM) burns its clamped thrash time, the instance is marked
failed/infeasible, and execution continues downstream so charged wall
time matches the single-workflow clamped accounting. A backend without
clamped estimates reports +inf — the instance dies immediately with
infinite latency.

The degenerate case — a fleet of one on an infinite cluster with zero
cold start — reproduces ``Workflow.end_to_end_latency()`` bit-for-bit
(same IEEE ops in the same order), which is how
:meth:`repro_torch.core.env.Environment.execute` runs every search
sample.

The port's copy of ``src/repro/core/engine.py``, numpy and plain Python
as there so that every report equals the reference's bit for bit, with
one change: the fast plane's longest-path sweep. ``plane_backend`` takes
``"torch"`` (the default, the counterpart of the reference's ``"jax"``
plane, a jitted ``lax.scan``) or ``"numpy"``. ``"torch"`` runs
:func:`fast_plane_sweep`, a (C, I, V) fp64 finish tensor on the device
advanced one topological rank at a time with gathers, ``where``,
``amax`` and one add per rank; fp64 add and max are exactly rounded and
max is associative, so it equals :func:`numpy_plane_sweep` (the numpy
plane's noise-free sweep) bit for bit and no report changes with the
plane, only where the sweep runs. ``device=None`` means the CUDA card,
resolved when a sweep first runs, so an engine that never sweeps (every
``run``, and ``Environment``'s degenerate engine) never needs a card.
As in the reference, a noisy plane keeps the numpy sweep.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import math
import weakref
from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np

import torch

from repro_torch.core.backend import BaseBackend, RuntimeBackend, as_backend
from repro_torch.core.cost import DEFAULT_PRICING, PricingModel
from repro_torch.core.dag import Workflow
from repro_torch.core.resources import ResourceConfig
from repro_torch.device import DeviceLike, resolve_device


# --------------------------------------------------------------------------
# arrival processes
# --------------------------------------------------------------------------

class PoissonArrivals:
    """``n`` arrivals at rate ``rate`` (instances/second), seeded."""

    def __init__(self, rate: float, n: int, *, seed: int = 0,
                 start: float = 0.0):
        if rate <= 0.0:
            raise ValueError("arrival rate must be positive")
        self.rate = rate
        self.n = n
        self.seed = seed
        self.start = start

    def times(self) -> np.ndarray:
        rng = np.random.default_rng(self.seed)
        gaps = rng.exponential(1.0 / self.rate, size=self.n)
        return self.start + np.cumsum(gaps)


class TraceArrivals:
    """Replay arrival timestamps from a trace (any float sequence).

    Order is preserved — entry ``i`` is instance ``i``'s arrival, the
    same pairing a raw float sequence gets, so heterogeneous factory
    fleets keep their workflow→timestamp association. The engine does
    not require sorted arrivals."""

    def __init__(self, times: Sequence[float]):
        t = np.asarray(times, dtype=np.float64)
        if t.ndim != 1:
            raise ValueError("trace must be a 1-D sequence of timestamps")
        self._times = t

    def times(self) -> np.ndarray:
        return self._times


ArrivalLike = Union[PoissonArrivals, TraceArrivals, Sequence[float]]


def arrival_times(arrivals: ArrivalLike) -> np.ndarray:
    if hasattr(arrivals, "times"):
        return np.asarray(arrivals.times(), dtype=np.float64)
    return np.asarray(arrivals, dtype=np.float64)


# --------------------------------------------------------------------------
# cluster + cold-start models
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClusterModel:
    """Aggregate CPU/memory capacity shared by all running invocations."""

    total_cpu: float = math.inf
    total_mem_mb: float = math.inf

    @property
    def finite(self) -> bool:
        return math.isfinite(self.total_cpu) or math.isfinite(self.total_mem_mb)


#: the degenerate single-workflow setting
INFINITE_CLUSTER = ClusterModel()


@dataclasses.dataclass(frozen=True)
class ColdStartModel:
    """Provisioning delay for cold containers, warm-container lifetime."""

    delay_s: float = 0.0
    keep_alive_s: float = 600.0


NO_COLD_START = ColdStartModel(delay_s=0.0)


@dataclasses.dataclass(frozen=True)
class ReplicaModel:
    """Per-function replica pools: the autoscaling actuator.

    ``replicas`` maps a function name — or a ``(tenant identity,
    function name)`` pair for packed multi-tenant fleets — to its pool
    size R. A pool bounds the function's *admission concurrency*: at
    most R invocations of that function run at once; further ready
    invocations queue FIFO behind the cluster-capacity queue (same
    stop-at-first-blocked discipline, so there is no overtaking).
    Functions not named fall back to ``default``.

    Provisioned capacity is charged replica-seconds on top of the
    per-invocation bill (see :meth:`PricingModel.replica_cost`): each
    replica of a function sized ``(cpu, mem)`` costs
    ``provision_frac * rate(cpu, mem) + provision_floor`` per second of
    fleet makespan, so scale-out is never free and the joint
    (cpu, mem, replicas) searcher trades fewer-bigger replicas against
    many-smaller ones under one cost model.

    Warm-container pools shard per replica implicitly: deposits happen
    only at invocation finish and claims only at admission, so a pool
    never holds more than R live containers mid-run; a carried-in pool
    from an epoch with a larger R is trimmed to the R latest-expiring
    containers at load. Cold starts are charged per replica spin-up —
    every admission that finds no live warm container pays
    ``ColdStartModel.delay_s`` exactly as before, replica or not.

    ``FleetEngine(scale=None)`` (the default) disables all of this and
    is bit-identical to the pre-replica engine on every plane.
    """

    replicas: Mapping[object, int] = dataclasses.field(default_factory=dict)
    default: int = 1
    provision_frac: float = 0.25
    provision_floor: float = 0.0

    def __post_init__(self):
        for key, r in self.replicas.items():
            if int(r) < 1:
                raise ValueError(
                    f"replica pool for {key!r} must be >= 1, got {r}")
        if self.default < 1:
            raise ValueError(f"default pool must be >= 1, got {self.default}")
        for fld in ("provision_frac", "provision_floor"):
            v = getattr(self, fld)
            if not (math.isfinite(v) and v >= 0.0):
                raise ValueError(f"{fld} must be finite and >= 0, got {v}")

    def pool(self, identity: str, name: str) -> int:
        """Pool size for one function: the tenant-qualified key wins
        over the bare function name, which wins over ``default``."""
        r = self.replicas.get((identity, name))
        if r is None:
            r = self.replicas.get(name, self.default)
        return int(r)


@dataclasses.dataclass
class FleetCarry:
    """Cross-epoch engine state for resumable epoch runs.

    An online control plane serves bounded time epochs back to back;
    restarting the engine cold at every boundary would throw away two
    things a real platform keeps:

      * ``warm`` — the warm-container pool keyed by
        ``(tenant identity, function)`` — ``Workflow.identity``, i.e.
        the tenant id when set and the template name otherwise —
        entries ``[deposit_t, expire_t]`` in absolute simulated time.
        Keying on the tenant identity (not the raw name) is what keeps
        two cells of a packed multi-tenant cluster that serve the same
        generated template name at different configurations from
        silently sharing containers sized for different configs,
      * ``busy`` — ``(finish_t, cpu, mem)`` capacity reservations. On a
        carry returned from a ``collect_carry`` run this is the run's
        *full* invocation log; :meth:`pruned` reduces it to the set
        still in flight at a boundary (``run`` also ignores entries
        that finish before its first arrival, so an unpruned carry
        cannot distort the next run's clock or utilization).

    A run invoked with ``collect_carry=True`` returns its full
    invocation/warm log on ``FleetReport.carry``; callers prune it at
    the next epoch's start time via :meth:`pruned` and feed it back
    through ``FleetEngine.run(..., carry=...)``. The one documented
    approximation: an epoch drains its own queue without seeing the
    *next* epoch's arrivals compete for capacity — the reservation list
    re-enacts the occupancy, not the FIFO interleaving.
    """

    clock: float = 0.0
    warm: Dict[Tuple[str, str], List[List[float]]] = \
        dataclasses.field(default_factory=dict)
    busy: List[Tuple[float, float, float]] = \
        dataclasses.field(default_factory=list)

    def pruned(self, t: float) -> "FleetCarry":
        """The state visible to an epoch starting at ``t``: unexpired
        warm containers (including ones deposited later than ``t`` by
        still-draining invocations — they become claimable mid-epoch)
        and capacity reservations that outlive ``t``.

        Boundary semantics (pinned by tests): a warm container whose
        ``expire_t == t`` is *kept* — it is still claimable at exactly
        ``t``, mirroring the engine's claim condition (``expire >=
        t``); a reservation whose ``finish_t == t`` is *dropped* — its
        capacity is released at ``t`` (the engine equally ignores
        carried reservations with ``finish <= first arrival``), while
        the warm container that invocation deposited survives in
        ``warm``. A container is therefore never double-counted as
        both expired and warm, and never holds phantom capacity across
        a boundary. Pruning preserves the per-tenant keys unchanged."""
        warm = {}
        for key, pool in self.warm.items():
            live = [list(c) for c in pool if c[1] >= t]
            if live:
                warm[key] = live
        return FleetCarry(clock=t, warm=warm,
                          busy=[(f, c, m) for f, c, m in self.busy if f > t])


# --------------------------------------------------------------------------
# results
# --------------------------------------------------------------------------

@dataclasses.dataclass
class InstanceResult:
    uid: int
    arrival: float
    finish: float
    e2e: float                  # finish - arrival (inf if the instance died)
    queue_delay: float          # Σ (start - ready) over its invocations
    cold_delay: float           # Σ cold-start provisioning time
    cost: float
    failed: bool


class FleetReport:
    """Fleet execution results, structure-of-arrays backed.

    Per-instance data lives in parallel float64/bool ndarrays (one slot
    per instance, uid order); :attr:`instances` materializes the legacy
    list of :class:`InstanceResult` objects lazily and caches it, so
    array consumers (the batched replay paths) never pay per-instance
    Python object construction. A report is immutable once built —
    every aggregate accessor (``latencies``/``total_cost``/
    ``total_queue_delay``/``percentile``/``slo_attainment``) is
    computed once and memoized. The arrays returned by the accessors
    are the report's own storage: treat them as read-only.
    """

    def __init__(self, instances: Optional[List[InstanceResult]] = None,
                 makespan: float = 0.0, cpu_utilization: float = 0.0,
                 mem_utilization: float = 0.0,
                 queue_delay_by_function: Optional[Dict[str, float]] = None,
                 carry: Optional[FleetCarry] = None,
                 tenants: Optional[List[str]] = None,
                 busy_by_function: Optional[Dict[str, float]] = None,
                 spinups_by_function: Optional[Dict[str, int]] = None,
                 provision_by_function: Optional[Dict[str, float]] = None,
                 replicas_by_function: Optional[Dict[str, int]] = None,
                 retries_by_function: Optional[Dict[str, int]] = None,
                 timeouts_by_function: Optional[Dict[str, int]] = None,
                 hedges_by_function: Optional[Dict[str, int]] = None,
                 failures_by_function: Optional[Dict[str, int]] = None):
        rows = list(instances) if instances else []
        self._init_common(
            makespan=makespan, cpu_utilization=cpu_utilization,
            mem_utilization=mem_utilization,
            queue_delay_by_function=queue_delay_by_function or {},
            carry=carry, tenants=tenants,
            busy_by_function=busy_by_function,
            spinups_by_function=spinups_by_function,
            provision_by_function=provision_by_function,
            replicas_by_function=replicas_by_function,
            retries_by_function=retries_by_function,
            timeouts_by_function=timeouts_by_function,
            hedges_by_function=hedges_by_function,
            failures_by_function=failures_by_function)
        self.arrivals = np.asarray([r.arrival for r in rows], dtype=np.float64)
        self.finishes = np.asarray([r.finish for r in rows], dtype=np.float64)
        self._e2e = np.asarray([r.e2e for r in rows], dtype=np.float64)
        self.queue_delays = np.asarray([r.queue_delay for r in rows],
                                       dtype=np.float64)
        self.cold_delays = np.asarray([r.cold_delay for r in rows],
                                      dtype=np.float64)
        self.costs = np.asarray([r.cost for r in rows], dtype=np.float64)
        self.failed_mask = np.asarray([r.failed for r in rows], dtype=bool)
        self._instances: Optional[List[InstanceResult]] = rows

    def _init_common(self, *, makespan, cpu_utilization, mem_utilization,
                     queue_delay_by_function, carry, tenants=None,
                     busy_by_function=None, spinups_by_function=None,
                     provision_by_function=None,
                     replicas_by_function=None,
                     retries_by_function=None, timeouts_by_function=None,
                     hedges_by_function=None,
                     failures_by_function=None) -> None:
        self.makespan = makespan             # last event - first arrival
        self.cpu_utilization = cpu_utilization
        self.mem_utilization = mem_utilization
        #: Σ queue delay keyed by "<tenant identity>/<function name>"
        self.queue_delay_by_function = queue_delay_by_function
        #: Σ executed runtime keyed like the queue ledger — the busy
        #: side of the saturation view (see :meth:`saturation`)
        self.busy_by_function: Dict[str, float] = busy_by_function or {}
        #: cold-start container spin-ups per function (cold model on)
        self.spinups_by_function: Dict[str, int] = spinups_by_function or {}
        #: replica-second provisioning charge per function (only when
        #: the engine ran with a :class:`ReplicaModel`)
        self.provision_by_function: Dict[str, float] = \
            provision_by_function or {}
        #: provisioned pool size per function (1 when untracked)
        self.replicas_by_function: Dict[str, int] = \
            replicas_by_function or {}
        #: recovery tallies per function (engine ran with a
        #: :class:`~repro_torch.core.faults.FaultModel`; empty otherwise):
        #: re-queued attempts, attempt timeouts, hedge duplicates
        #: fired, and failed *attempts* (fault-model failures only —
        #: deterministic OOM stays out, it is config-bound)
        self.retries_by_function: Dict[str, int] = retries_by_function or {}
        self.timeouts_by_function: Dict[str, int] = \
            timeouts_by_function or {}
        self.hedges_by_function: Dict[str, int] = hedges_by_function or {}
        self.failures_by_function: Dict[str, int] = \
            failures_by_function or {}
        #: end-of-run warm/busy state (only when ``collect_carry=True``)
        self.carry = carry
        #: per-instance tenant identity (uid order) when the engine ran
        #: a tagged fleet; ``None`` on reports with no tenant tags
        self.tenants: Optional[List[str]] = (list(tenants)
                                             if tenants is not None else None)
        self._sorted: Optional[np.ndarray] = None
        self._total_cost: Optional[float] = None
        self._total_queue_delay: Optional[float] = None
        self._provision_cost: Optional[float] = None
        self._attainment: Dict[float, float] = {}

    @classmethod
    def from_arrays(cls, *, arrival: np.ndarray, finish: np.ndarray,
                    e2e: np.ndarray, queue_delay: np.ndarray,
                    cold_delay: np.ndarray, cost: np.ndarray,
                    failed: np.ndarray, makespan: float,
                    cpu_utilization: float, mem_utilization: float,
                    queue_delay_by_function: Dict[str, float],
                    carry: Optional[FleetCarry] = None,
                    tenants: Optional[List[str]] = None,
                    busy_by_function: Optional[Dict[str, float]] = None,
                    spinups_by_function: Optional[Dict[str, int]] = None,
                    provision_by_function: Optional[Dict[str, float]] = None,
                    replicas_by_function: Optional[Dict[str, int]] = None,
                    retries_by_function: Optional[Dict[str, int]] = None,
                    timeouts_by_function: Optional[Dict[str, int]] = None,
                    hedges_by_function: Optional[Dict[str, int]] = None,
                    failures_by_function: Optional[Dict[str, int]] = None,
                    ) -> "FleetReport":
        """Build a report directly from aligned per-instance arrays
        (uid order) without materializing ``InstanceResult`` objects."""
        self = cls.__new__(cls)
        self._init_common(
            makespan=makespan, cpu_utilization=cpu_utilization,
            mem_utilization=mem_utilization,
            queue_delay_by_function=queue_delay_by_function, carry=carry,
            tenants=tenants, busy_by_function=busy_by_function,
            spinups_by_function=spinups_by_function,
            provision_by_function=provision_by_function,
            replicas_by_function=replicas_by_function,
            retries_by_function=retries_by_function,
            timeouts_by_function=timeouts_by_function,
            hedges_by_function=hedges_by_function,
            failures_by_function=failures_by_function)
        self.arrivals = np.asarray(arrival, dtype=np.float64)
        self.finishes = np.asarray(finish, dtype=np.float64)
        self._e2e = np.asarray(e2e, dtype=np.float64)
        self.queue_delays = np.asarray(queue_delay, dtype=np.float64)
        self.cold_delays = np.asarray(cold_delay, dtype=np.float64)
        self.costs = np.asarray(cost, dtype=np.float64)
        self.failed_mask = np.asarray(failed, dtype=bool)
        self._instances = None
        return self

    def __len__(self) -> int:
        return int(self._e2e.size)

    @property
    def instances(self) -> List[InstanceResult]:
        """Object view of the per-instance arrays (built once, cached)."""
        if self._instances is None:
            self._instances = [
                InstanceResult(
                    uid=i, arrival=float(self.arrivals[i]),
                    finish=float(self.finishes[i]), e2e=float(self._e2e[i]),
                    queue_delay=float(self.queue_delays[i]),
                    cold_delay=float(self.cold_delays[i]),
                    cost=float(self.costs[i]),
                    failed=bool(self.failed_mask[i]))
                for i in range(len(self))
            ]
        return self._instances

    @property
    def latencies(self) -> np.ndarray:
        return self._e2e

    def percentile(self, q: float) -> float:
        """Linear-interpolated percentile that stays inf-safe: dead
        instances (inf latency) make the crossed tail inf, never nan
        (naive interpolation between finite and inf is inf - inf).
        An empty fleet has a well-defined zero-latency tail."""
        if self._sorted is None:
            self._sorted = np.sort(self._e2e)
        lat = self._sorted
        if not lat.size:
            return 0.0
        rank = q / 100.0 * (lat.size - 1)
        lo = int(math.floor(rank))
        hi = int(math.ceil(rank))
        if math.isinf(lat[hi]):
            return float(lat[lo]) if rank == lo else math.inf
        return float(lat[lo] + (lat[hi] - lat[lo]) * (rank - lo))

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)

    def slo_attainment(self, slo: float) -> float:
        """Fraction of instances that finished within ``slo`` seconds
        (vacuously 1.0 for an empty fleet — nothing missed)."""
        if not len(self):
            return 1.0
        hit = self._attainment.get(slo)
        if hit is None:
            ok = int(np.count_nonzero(~self.failed_mask
                                      & (self._e2e <= slo)))
            hit = ok / len(self)
            self._attainment[slo] = hit
        return hit

    def goodput(self, slo: float) -> float:
        """*Successful* work delivered within the SLO — an alias of
        :meth:`slo_attainment` (which already excludes failed
        instances), named for the fault-injection plane where the gap
        to :meth:`completion` is the failure toll."""
        return self.slo_attainment(slo)

    def completion(self, slo: float) -> float:
        """Fraction of instances whose wall clock fit the SLO
        *regardless of failure* (vacuously 1.0 when empty). Under
        faults, ``completion - goodput`` is the share of instances
        that were on time but wrong — work a recovery policy (retries,
        hedging) converts into goodput."""
        if not len(self):
            return 1.0
        return int(np.count_nonzero(self._e2e <= slo)) / len(self)

    @property
    def total_retries(self) -> int:
        """Σ re-queued attempts across the fleet (fault plane)."""
        return sum(self.retries_by_function[k]
                   for k in sorted(self.retries_by_function))

    @property
    def total_timeouts(self) -> int:
        """Σ attempt timeouts across the fleet (fault plane)."""
        return sum(self.timeouts_by_function[k]
                   for k in sorted(self.timeouts_by_function))

    @property
    def total_hedges(self) -> int:
        """Σ hedge duplicates fired across the fleet (fault plane)."""
        return sum(self.hedges_by_function[k]
                   for k in sorted(self.hedges_by_function))

    @property
    def total_failures(self) -> int:
        """Σ failed attempts across the fleet (fault-model failures
        only — deterministic OOM is not counted)."""
        return sum(self.failures_by_function[k]
                   for k in sorted(self.failures_by_function))

    @property
    def total_cost(self) -> float:
        if self._total_cost is None:
            # left-to-right Python-float adds: identical IEEE ops (and
            # bits) to the historical sum over InstanceResult objects
            total = float(sum(self.costs.tolist()))
            if self.provision_by_function:
                # replica-second bill folded in only when replicas were
                # provisioned, so replica-free reports stay bitwise
                # identical to the pre-replica engine
                total += self.provision_cost
            self._total_cost = total
        return self._total_cost

    @property
    def provision_cost(self) -> float:
        """Σ replica-second charges (sorted-key order, deterministic)."""
        if self._provision_cost is None:
            acc = 0.0
            for key in sorted(self.provision_by_function):
                acc += self.provision_by_function[key]
            self._provision_cost = acc
        return self._provision_cost

    def saturation(self) -> Dict[str, Dict[str, float]]:
        """Per-function saturation diagnostics, keyed like the queue
        ledger (``"<tenant identity>/<function name>"``).

        Each row reports ``queue_delay_s`` (Σ admission wait charged to
        the function), ``queue_share`` (its share of the fleet's total
        per-function queue delay — the observable the online controller
        classifies capacity-bound drift with), ``busy_s`` (Σ executed
        runtime), ``replicas`` (provisioned pool size; 1 when the
        engine ran without a :class:`ReplicaModel`), ``utilization``
        (``busy_s / (replicas * makespan)`` — mean busy fraction of the
        provisioned pool), ``spinups`` (cold-start container
        spin-ups), plus the failure rows the fault plane adds:
        ``failed`` (failed attempts under the fault model),
        ``failure_share`` (the function's share of the fleet's failed
        attempts), ``retries``, ``timeouts`` and ``hedges``.

        **Triage** — the online controller classifies a missed SLO
        from these rows:

          * *capacity-bound* — queue-delay-dominated at high pool
            utilization: more replicas help
            (``classify_saturation`` of the reference's
            ``core/autoscale.py``, not yet ported),
          * *config-bound* — low queue, no failures, still slow:
            faster per-function configs help (route the grant to the
            inner config searcher),
          * *failure-bound* — non-zero ``failed`` rows concentrated on
            a few functions: recovery policy helps (retries, timeouts,
            hedging via :func:`repro_torch.core.faults.grant_policies`) or,
            during a detected outage window, graceful degradation of
            off-critical-path functions
            (:func:`repro_torch.core.faults.degrade_policies`)."""
        keys = (set(self.queue_delay_by_function)
                | set(self.busy_by_function)
                | set(self.failures_by_function))
        total_q = 0.0
        for key in sorted(self.queue_delay_by_function):
            total_q += self.queue_delay_by_function[key]
        total_f = 0
        for key in sorted(self.failures_by_function):
            total_f += self.failures_by_function[key]
        out: Dict[str, Dict[str, float]] = {}
        for key in sorted(keys):
            q = self.queue_delay_by_function.get(key, 0.0)
            busy = self.busy_by_function.get(key, 0.0)
            r = int(self.replicas_by_function.get(key, 1))
            f = int(self.failures_by_function.get(key, 0))
            cap = r * self.makespan
            out[key] = {
                "queue_delay_s": q,
                "queue_share": (q / total_q) if total_q > 0.0 else 0.0,
                "busy_s": busy,
                "replicas": r,
                "utilization": (busy / cap) if cap > 0.0 else 0.0,
                "spinups": int(self.spinups_by_function.get(key, 0)),
                "failed": f,
                "failure_share": (f / total_f) if total_f > 0 else 0.0,
                "retries": int(self.retries_by_function.get(key, 0)),
                "timeouts": int(self.timeouts_by_function.get(key, 0)),
                "hedges": int(self.hedges_by_function.get(key, 0)),
            }
        return out

    @property
    def total_queue_delay(self) -> float:
        if self._total_queue_delay is None:
            self._total_queue_delay = float(sum(self.queue_delays.tolist()))
        return self._total_queue_delay

    @property
    def throughput(self) -> float:
        """Completed instances per second of makespan."""
        done = int(np.count_nonzero(np.isfinite(self._e2e)))
        if self.makespan > 0:
            return done / self.makespan
        return float("inf") if done else 0.0

    # -- per-tenant views ----------------------------------------------
    def tenant_slice(self, tenant: str) -> "FleetReport":
        """One tenant's view of a packed multi-tenant run.

        Instance arrays are masked to the tenant's instances (uid order
        preserved) and ``queue_delay_by_function`` is filtered to keys
        prefixed ``"<tenant>/"``, so per-tenant slices partition the
        packed report exactly: concatenating the slices' arrays (and
        summing their queue ledgers) recovers the packed totals.
        Two packed-cluster quantities are *not* attributable per
        tenant and are handled explicitly:

          * ``cpu_utilization``/``mem_utilization`` are copied from the
            packed report — they describe the shared cluster,
          * ``makespan`` is recomputed as the tenant's own span (last
            finite finish − first arrival; 0.0 for an empty or fully
            dead slice), and ``carry`` stays on the packed report
            (warm pools are already tenant-keyed there).

        Raises ``ValueError`` on a report with no tenant tags."""
        if self.tenants is None:
            raise ValueError(
                "report has no tenant tags (engine ran an untagged fleet)")
        mask = np.asarray([t == tenant for t in self.tenants], dtype=bool)
        arrival = self.arrivals[mask]
        finish = self.finishes[mask]
        finite_fin = finish[np.isfinite(finish)]
        makespan = (float(finite_fin.max()) - float(arrival.min())
                    if arrival.size and finite_fin.size else 0.0)
        prefix = tenant + "/"

        def _sub(ledger):
            return {k: v for k, v in ledger.items() if k.startswith(prefix)}

        return FleetReport.from_arrays(
            arrival=arrival, finish=finish, e2e=self._e2e[mask],
            queue_delay=self.queue_delays[mask],
            cold_delay=self.cold_delays[mask], cost=self.costs[mask],
            failed=self.failed_mask[mask], makespan=max(makespan, 0.0),
            cpu_utilization=self.cpu_utilization,
            mem_utilization=self.mem_utilization,
            queue_delay_by_function=_sub(self.queue_delay_by_function),
            busy_by_function=_sub(self.busy_by_function),
            spinups_by_function=_sub(self.spinups_by_function),
            provision_by_function=_sub(self.provision_by_function),
            replicas_by_function=_sub(self.replicas_by_function),
            retries_by_function=_sub(self.retries_by_function),
            timeouts_by_function=_sub(self.timeouts_by_function),
            hedges_by_function=_sub(self.hedges_by_function),
            failures_by_function=_sub(self.failures_by_function),
            tenants=[t for t in self.tenants if t == tenant])

    def by_tenant(self) -> Dict[str, "FleetReport"]:
        """``{tenant: tenant_slice(tenant)}`` in first-appearance
        (uid) order. Raises ``ValueError`` on untagged reports."""
        if self.tenants is None:
            raise ValueError(
                "report has no tenant tags (engine ran an untagged fleet)")
        return {t: self.tenant_slice(t)
                for t in dict.fromkeys(self.tenants)}


# --------------------------------------------------------------------------
# engine internals
# --------------------------------------------------------------------------

_ARRIVAL, _FINISH, _RELEASE, _ABORT, _RETRY = 0, 1, 2, 3, 4


def _stranded_error(entries: Sequence[Tuple[int, str, bool, bool]]
                    ) -> RuntimeError:
    """Diagnostic for the scheduler invariant: only dead instances may
    leave queued work behind when the event heap drains. ``entries``
    rows are ``(uid, function, dead, failed)`` for every stranded queue
    entry of a live instance."""
    detail = "; ".join(
        f"uid {uid} fn {fn!r} (dead={bool(d)}, failed={bool(f)})"
        for uid, fn, d, f in sorted(entries))
    return RuntimeError(
        "scheduler invariant violated: work stranded in the admission "
        f"queue for live instances — {detail}")


class _FaultCtx:
    """Per-run fault-injection bookkeeping shared by the scalar event
    loop and the table-driven replay cells.

    Holds the plane's pre-drawn :class:`~repro_torch.core.faults.FaultStream`
    (draws are keyed by ``(attempt, instance row, function column)`` —
    never by call order — so any admission interleaving replays the
    same outcomes), the per-``(uid, column)`` attempt counters, and the
    recovery tallies that land on :class:`FleetReport`. Both loops
    resolve one admitted attempt through :meth:`resolve` with identical
    float operations, which is what keeps the constrained replay plane
    bit-identical to the scalar loop under faults.

    Pricing is per *leg* through the scalar ``pricing.function_cost``
    in both loops (identical IEEE ops to ``cost_batch`` for vectorizing
    models — see :meth:`FleetEngine._price_batch`): every attempt and
    every hedge leg is billed for the runtime it actually executed
    before succeeding, failing, timing out, or being cancelled."""

    __slots__ = ("faults", "pricing", "primary", "hedge", "offset",
                 "cols", "attempts", "retries", "timeouts", "hedges",
                 "failures", "fault_dead", "_pol", "_policies")

    def __init__(self, faults, resilience, pricing, stream, offset,
                 cols: Optional[Dict[tuple, int]]):
        self.faults = faults
        self.pricing = pricing
        self.primary = stream.primary       # (3, A, instances, functions)
        self.hedge = stream.hedge
        self.offset = int(offset)
        #: ``(identity, name) -> column`` for the scalar loop; table
        #: cells index columns directly and pass ``None``
        self.cols = cols
        self.attempts: Dict[Tuple[int, int], int] = {}
        self.retries: Dict[str, int] = collections.defaultdict(int)
        self.timeouts: Dict[str, int] = collections.defaultdict(int)
        self.hedges: Dict[str, int] = collections.defaultdict(int)
        #: failed *attempts* per function (transient / straggler
        #: timeout / cold-fail / outage — OOM stays config-bound and
        #: is not counted here)
        self.failures: Dict[str, int] = collections.defaultdict(int)
        #: ``(uid, column)`` pairs whose invocation terminally failed
        #: under the fault model — their finish events must not deposit
        #: a warm container (the container crashed)
        self.fault_dead: set = set()
        self._policies = resilience
        self._pol: Dict[tuple, tuple] = {}

    def pol(self, identity: str, name: str) -> tuple:
        """``(max_retries, timeout_s, backoff_s, hedge_delay_s)`` for
        one function (cached; all-defaults when the engine runs without
        a ResilienceModel — faults then fail invocations outright)."""
        key = (identity, name)
        out = self._pol.get(key)
        if out is None:
            if self._policies is None:
                out = (0, None, 0.0, None)
            else:
                p = self._policies.policy(identity, name)
                out = (int(p.max_retries), p.timeout_s,
                       float(p.backoff_s), p.hedge_delay_s)
            self._pol[key] = out
        return out

    def price(self, exec_s: float, cfg) -> float:
        return float(self.pricing.function_cost(float(exec_s), cfg))

    def resolve(self, uid: int, v: int, identity: str, name: str,
                t: float, rt: float, delay: float, cfg):
        """Outcome of one admitted attempt (primary leg + optional
        hedge) at admission instant ``t`` with base runtime ``rt`` and
        cold-start ``delay``.

        Returns ``(dur, ok, legs, n_timeouts, hedged)``: ``dur`` is the
        wall time from admission until the attempt resolves (includes
        ``delay``), ``legs`` is ``[(executed_s, cost), ...]`` in
        primary-then-hedge order (cancel-on-completion: the losing leg
        is billed only up to the winner's finish)."""
        k = self.attempts.get((uid, v), 0)
        a = min(k, self.primary.shape[1] - 1)
        row = self.offset + uid
        P = self.primary
        fm = self.faults
        mr, timeout_s, backoff_s, hedge_delay_s = self.pol(identity, name)
        n_timeouts = 0
        # -- primary leg ----------------------------------------------
        rt_p = rt
        if fm.straggler_prob > 0.0 and P[1, a, row, v] < fm.straggler_prob:
            rt_p = rt * fm.straggler_factor
        timed_p = False
        if delay > 0.0 and fm.cold_fail > 0.0 \
                and P[2, a, row, v] < fm.cold_fail:
            # the container never came up: provisioning time burned,
            # zero execution, zero execution cost
            ok_p, exec_p, end_p = False, 0.0, delay
        else:
            p_eff = fm.effective_transient(identity, name, t)
            ok_p = not (p_eff > 0.0 and P[0, a, row, v] < p_eff)
            exec_p = rt_p
            if timeout_s is not None and rt_p > timeout_s:
                exec_p = timeout_s
                ok_p = False
                timed_p = True
            end_p = delay + exec_p
        # -- hedge leg (burst capacity: no cluster slot, no replica
        # slot, no cold delay — a standby duplicate) -------------------
        if hedge_delay_s is None or not hedge_delay_s < end_p:
            if timed_p:
                n_timeouts += 1
            return end_p, ok_p, [(exec_p, self.price(exec_p, cfg))], \
                n_timeouts, False
        H = self.hedge
        rt_h = rt
        if fm.straggler_prob > 0.0 and H[1, a, row, v] < fm.straggler_prob:
            rt_h = rt * fm.straggler_factor
        p_eff_h = fm.effective_transient(identity, name,
                                         t + hedge_delay_s)
        ok_h = not (p_eff_h > 0.0 and H[0, a, row, v] < p_eff_h)
        exec_h = rt_h
        timed_h = False
        if timeout_s is not None and rt_h > timeout_s:
            exec_h = timeout_s
            ok_h = False
            timed_h = True
        end_h = hedge_delay_s + exec_h
        if ok_p and (not ok_h or end_p <= end_h):
            dur, ok = end_p, True
        elif ok_h:
            dur, ok = end_h, True
        else:
            dur, ok = max(end_p, end_h), False
        # a leg's timeout only *happened* if it fired before resolution
        if timed_p and end_p <= dur:
            n_timeouts += 1
        if timed_h and end_h <= dur:
            n_timeouts += 1
        exec_p_b = min(exec_p, max(dur - delay, 0.0))
        exec_h_b = min(exec_h, max(dur - hedge_delay_s, 0.0))
        legs = [(exec_p_b, self.price(exec_p_b, cfg)),
                (exec_h_b, self.price(exec_h_b, cfg))]
        return dur, ok, legs, n_timeouts, True

    def ledgers(self):
        """``(retries, timeouts, hedges, failures)`` as plain dicts."""
        return (dict(self.retries), dict(self.timeouts),
                dict(self.hedges), dict(self.failures))


#: per-pricing-object detection cache: maps a pricing model to the
#: (method identities, verdict) pair it was detected under, so the
#: verdict survives engine caching but is re-detected the moment a
#: subclass swaps/monkeypatches ``cost_batch``/``function_cost``/``rate``
_PRICING_VERDICTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _pricing_methods(pricing) -> tuple:
    cls = type(pricing)
    return (getattr(cls, "cost_batch", None),
            getattr(cls, "function_cost", None),
            getattr(cls, "rate", None))


def _pricing_vectorizes(pricing) -> bool:
    """May the engine price invocations through ``pricing.cost_batch``?

    Yes when the model provides its own vectorized implementation, or
    when it inherits the base one AND has not overridden the scalar
    ``function_cost``/``rate`` it mirrors — a subclass that customizes
    only the scalar path must not be silently priced with the base
    mu-formula.

    The verdict is cached per *pricing object* (not per engine) and
    keyed on the class's current method identities, so a
    campaign-cached engine whose pricing model is swapped or mutated
    after construction re-detects on the next use instead of serving a
    stale per-engine snapshot."""
    key = _pricing_methods(pricing)
    try:
        cached = _PRICING_VERDICTS.get(pricing)
    except TypeError:            # unhashable/unweakrefable pricing object
        cached = None
    if cached is not None and cached[0] == key:
        return cached[1]
    cost_batch, function_cost, rate = key
    if cost_batch is None:
        verdict = False
    elif cost_batch is not PricingModel.cost_batch:
        verdict = True
    else:
        verdict = (function_cost is PricingModel.function_cost
                   and rate is PricingModel.rate)
    try:
        _PRICING_VERDICTS[pricing] = (key, verdict)
    except TypeError:
        pass
    return verdict


class _FleetState:
    """Structure-of-arrays per-instance bookkeeping for one run.

    Scalar per-instance fields (finish/queue/cold/failed/dead) are
    float64/bool ndarrays indexed by uid instead of per-``_Instance``
    Python objects; graph state that is inherently per-node
    (unfinished-predecessor counts, topological ranks) stays in plain
    dicts. Per-invocation costs are buffered as ``(topo_rank, cost)``
    pairs and reduced per instance at report time in topological-rank
    order — a canonical order shared with the vectorized
    :meth:`FleetEngine.run_many` plane so batched replays are
    bit-identical to the event loop.
    """

    __slots__ = ("wfs", "arrival", "finish", "queue_delay", "cold_delay",
                 "failed", "dead", "remaining", "rank", "cost_items")

    def __init__(self, wfs: Sequence[Workflow], times: np.ndarray):
        n = len(wfs)
        self.wfs = list(wfs)
        self.arrival = np.array(times, dtype=np.float64)
        self.finish = np.zeros(n)
        self.queue_delay = np.zeros(n)
        self.cold_delay = np.zeros(n)
        self.failed = np.zeros(n, dtype=bool)
        self.dead = np.zeros(n, dtype=bool)   # unrecoverable (inf runtime)
        self.remaining = [{m: len(wf.predecessors(m)) for m in wf.nodes}
                          for wf in wfs]      # unfinished-predecessor counts
        self.rank = [{m: k for k, m in enumerate(wf.topological_order())}
                     for wf in wfs]
        self.cost_items: List[List[Tuple[int, float]]] = \
            [[] for _ in range(n)]

    def instance_costs(self) -> np.ndarray:
        """Per-instance cost: executed invocations summed in
        topological-rank order (left-to-right float adds)."""
        return _reduce_costs(self.cost_items, len(self.wfs))


def _reduce_costs(cost_items: List[List[Tuple[int, float]]],
                  n: int) -> np.ndarray:
    """The canonical per-instance cost reduction shared by the scalar
    event loop and the table-driven replay plane: executed invocations
    sorted by topological rank, summed left-to-right."""
    out = np.zeros(n)
    for i, items in enumerate(cost_items):
        items.sort(key=lambda kv: kv[0])
        acc = 0.0
        for _, c in items:
            acc += c
        out[i] = acc
    return out


class _PlannedBackend(BaseBackend):
    """Replays a precomputed ``(runtime, failed)`` plan keyed by node
    identity. The planned/per-cell replay paths use it to drive the
    exact scalar event loop off ONE response-surface call: every
    invocation looks its outcome up in the plan instead of dispatching
    into the real backend again."""

    deterministic = True

    def __init__(self, plan: Dict[int, Tuple[float, bool]]):
        self._plan = plan

    def invoke_batch(self, nodes: Sequence) -> Tuple[np.ndarray, np.ndarray]:
        runtimes = np.empty(len(nodes), dtype=np.float64)
        failed = np.zeros(len(nodes), dtype=bool)
        for i, node in enumerate(nodes):
            rt, bad = self._plan[id(node)]
            runtimes[i] = rt
            failed[i] = bad
        return runtimes, failed


def _sweep_tables(template, order: Sequence[str], col: Dict[str, int]
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(order_idx, pred_idx, pred_mask)``: each rank's node column, and
    its predecessors' columns padded to the widest fan-in. ``template``
    is read only for ``predecessors``."""
    order_idx = np.array([col[name] for name in order], dtype=np.int64)
    max_p = max((len(template.predecessors(n)) for n in order), default=1)
    max_p = max(max_p, 1)
    pred_idx = np.zeros((len(order), max_p), dtype=np.int64)
    pred_mask = np.zeros((len(order), max_p), dtype=bool)
    for k, name in enumerate(order):
        for j, p in enumerate(template.predecessors(name)):
            pred_idx[k, j] = col[p]
            pred_mask[k, j] = True
    return order_idx, pred_idx, pred_mask


def fast_plane_sweep(template, order: Sequence[str], col: Dict[str, int],
                     t_all: np.ndarray, rt: np.ndarray, *,
                     device: DeviceLike = None) -> np.ndarray:
    """Latest finish of every (candidate, instance): ``rt`` is (C, V)
    fp64 runtimes by node column, ``t_all`` the (I,) arrival times.
    Returns a (C, I) fp64 ndarray. ``device=None`` means the CUDA card
    (and raises without one)."""
    dev = resolve_device(device)
    order_idx, pred_idx, pred_mask = _sweep_tables(template, order, col)
    t = torch.as_tensor(np.asarray(t_all, dtype=np.float64), device=dev)
    r = torch.as_tensor(np.asarray(rt, dtype=np.float64), device=dev)
    pidx = torch.as_tensor(pred_idx, device=dev)
    pmask = torch.as_tensor(pred_mask, device=dev)
    fin = torch.zeros((r.shape[0], t.shape[0], r.shape[1]),
                      dtype=torch.float64, device=dev)
    neg_inf = torch.tensor(-np.inf, dtype=torch.float64, device=dev)
    for k, v in enumerate(order_idx.tolist()):
        # a source has no live predecessor: its start is the arrival
        # instant; everything else max-reduces over its predecessors'
        # finishes, the recurrence of the numpy sweep
        pf = torch.where(pmask[k], fin[:, :, pidx[k]], neg_inf)
        start = pf.amax(dim=-1)
        start = torch.where(torch.isneginf(start), t[None, :], start)
        fin[:, :, v] = start + r[:, v, None]
    return fin.amax(dim=2).cpu().numpy()


def numpy_plane_sweep(template, order: Sequence[str], col: Dict[str, int],
                      t_all: np.ndarray, rt: np.ndarray) -> np.ndarray:
    """The plain numpy sweep: :func:`fast_plane_sweep`'s result, as the
    numpy plane (:meth:`FleetEngine._run_many_vectorized`, noise off)
    computes it."""
    finish_by_node: Dict[str, np.ndarray] = {}
    for name in order:
        preds = template.predecessors(name)
        if preds:
            start = finish_by_node[preds[0]]
            for p in preds[1:]:
                start = np.maximum(start, finish_by_node[p])
        else:
            start = t_all[None, :]
        finish_by_node[name] = start + rt[:, col[name]][:, None]
    inst_finish = None
    for arr in finish_by_node.values():
        inst_finish = arr if inst_finish is None \
            else np.maximum(inst_finish, arr)
    return inst_finish


class FleetEngine:
    """Runs fleets of workflow instances through a runtime backend."""

    def __init__(self, backend: RuntimeBackend, *,
                 pricing: PricingModel = DEFAULT_PRICING,
                 cluster: ClusterModel = INFINITE_CLUSTER,
                 cold_start: ColdStartModel = NO_COLD_START,
                 plane_backend: str = "torch",
                 device: DeviceLike = None,
                 interference: Optional[
                     Mapping[Tuple[str, str], float]] = None,
                 scale: Optional[ReplicaModel] = None,
                 faults=None, resilience=None):
        self.backend = as_backend(backend)
        self.pricing = pricing
        self.cluster = cluster
        self.cold_start = cold_start
        #: per-function replica pools (see :class:`ReplicaModel`);
        #: ``None`` disables replica bounds/billing entirely — the
        #: engine is then bit-identical to its pre-replica behaviour
        self.scale = scale
        #: seeded fault-injection plane (a
        #: :class:`repro_torch.core.faults.FaultModel`); ``None`` disables
        #: fault injection entirely — the engine is then bit-identical
        #: to its pre-fault behaviour on all four replay planes
        self.faults = faults
        #: per-function recovery policies (a
        #: :class:`repro_torch.core.faults.ResilienceModel`): retry with
        #: capped attempts + exponential backoff, execution timeout,
        #: request hedging. Inert without ``faults`` — there is nothing
        #: to recover from, so ``resilience`` alone changes no bits
        self.resilience = resilience
        #: planned-cell hook: ``(FaultStream, row offset)`` installed
        #: by a parent ``run_many`` so a shadow engine's cells draw
        #: from the parent plane's ONE fault stream instead of
        #: re-drawing per cell (the paired fault-stream contract)
        self._fault_stream: Optional[Tuple[object, int]] = None
        if plane_backend not in ("numpy", "torch"):
            raise ValueError(
                f"plane_backend must be 'numpy' or 'torch', got "
                f"{plane_backend!r}")
        #: which array engine evaluates the contention-free replay
        #: plane's longest-path sweep; ``"torch"`` runs
        #: :func:`fast_plane_sweep` on ``device`` (``None``: the CUDA
        #: card, resolved at the first sweep) instead of the numpy loop —
        #: same recurrence, same bits
        self.plane_backend = plane_backend
        self.device = device
        #: optional per-invocation runtime multipliers keyed by
        #: ``(tenant identity, function name)`` — the placement layer's
        #: co-location/noisy-neighbour model (the reference's
        #: ``core/placement.py``). Applied to every invocation's
        #: runtime *before* pricing, so slower execution is also billed
        #: longer. ``None``/empty leaves the engine bit-identical to an
        #: interference-free run; a non-empty map routes ``run_many``
        #: to the serial plane (multipliers are an event-loop concept).
        if interference:
            bad = [k for k, v in interference.items()
                   if not (math.isfinite(v) and v > 0.0)]
            if bad:
                raise ValueError(
                    f"interference multipliers must be finite and "
                    f"positive; offending keys: {sorted(bad)}")
            self.interference: Dict[Tuple[str, str], float] = \
                dict(interference)
        else:
            self.interference = {}

    @property
    def _pricing_vectorized(self) -> bool:
        # resolved per use (cached per pricing *object*, see
        # _pricing_vectorizes) so swapping/mutating the pricing model on
        # a cached engine re-detects instead of serving a stale verdict
        return _pricing_vectorizes(self.pricing)

    # -- public API ----------------------------------------------------
    def run(self, workflows: Sequence[Workflow],
            arrivals: ArrivalLike, *,
            carry: Optional[FleetCarry] = None,
            collect_carry: bool = False) -> FleetReport:
        """Execute one instance per workflow object; ``arrivals[i]`` is
        instance ``i``'s submission time. Node runtimes/failed flags are
        written onto the given workflows as invocations complete.

        ``carry`` resumes from a previous epoch's warm-container pool
        and in-flight capacity reservations (see :class:`FleetCarry`);
        ``collect_carry=True`` records this run's end state on
        ``FleetReport.carry`` for the next epoch."""
        times = arrival_times(arrivals)
        if len(times) != len(workflows):
            raise ValueError(
                f"{len(workflows)} workflows but {len(times)} arrival times")
        for wf in workflows:
            self._check_placeable(wf)

        if not len(times):
            # empty fleet: a well-defined empty report (zero cost,
            # NaN-free percentiles/attainment), carry passed through
            out = None
            if collect_carry:
                out = (carry.pruned(carry.clock) if carry is not None
                       else FleetCarry())
            return self._empty_report(carry_out=out)

        if (carry is None and not collect_carry
                and len(workflows) == 1 and not self.cluster.finite
                and self.cold_start.delay_s == 0.0
                and self.scale is None and self.faults is None):
            # degenerate case (every Environment.execute sample): no
            # contention => runtimes are schedule-independent, so skip
            # the event machinery — ONE batch call + longest path
            return self._run_degenerate(workflows[0], float(times[0]))

        state = _FleetState(workflows, times)

        fctx: Optional[_FaultCtx] = None
        if self.faults is not None:
            # function columns in first-seen (wf order, node insertion)
            # order — the exact indexing run_many's candidate arrays
            # use for a homogeneous fleet, so a planned shadow cell and
            # the table loop read the same stream coordinates
            cols: Dict[tuple, int] = {}
            for wf in workflows:
                for name in wf.nodes:
                    key = (wf.identity, name)
                    if key not in cols:
                        cols[key] = len(cols)
            if self._fault_stream is not None:
                stream, f_offset = self._fault_stream
            else:
                stream = self.faults.fault_stream(len(workflows), len(cols))
                f_offset = 0
            fctx = _FaultCtx(self.faults, self.resilience, self.pricing,
                             stream, f_offset, cols)

        seq = itertools.count()
        events: List[Tuple[float, int, int, int, object]] = [
            (float(t), next(seq), _ARRIVAL, uid, None)
            for uid, t in enumerate(times)
        ]
        pending: collections.deque = collections.deque()
        warm: Dict[tuple, List[List[float]]] = collections.defaultdict(list)
        used_cpu = used_mem = 0.0
        #: live admission count per (tenant identity, function) — the
        #: replica bound's denominator (only tracked when scale is on)
        running: Optional[Dict[tuple, int]] = \
            collections.defaultdict(int) if self.scale is not None else None
        inv_log: Optional[List[Tuple[float, float, float]]] = \
            [] if collect_carry else None
        if carry is not None:
            t_min = float(times.min())
            for key, pool in carry.warm.items():
                warm[key] = [list(c) for c in pool]
            self._trim_warm(warm)
            for finish, cpu, mem in carry.busy:
                if finish <= t_min:
                    continue            # released before this run starts
                # a reservation holds capacity until its finish event
                used_cpu += cpu
                used_mem += mem
                events.append((finish, next(seq), _RELEASE, -1, (cpu, mem)))
                if inv_log is not None:
                    inv_log.append((finish, cpu, mem))
        heapq.heapify(events)
        t0 = float(events[0][0]) if events else 0.0
        t_last, cpu_area, mem_area = t0, 0.0, 0.0
        per_fn_queue: Dict[str, float] = collections.defaultdict(float)
        per_fn_busy: Dict[str, float] = collections.defaultdict(float)
        per_fn_spin: Dict[str, int] = collections.defaultdict(int)

        while events:
            t = events[0][0]
            cpu_area += used_cpu * (t - t_last)
            mem_area += used_mem * (t - t_last)
            t_last = t
            while events and events[0][0] == t:
                _, _, kind, uid, name = heapq.heappop(events)
                if kind == _RELEASE:
                    cpu, mem = name
                    used_cpu -= cpu
                    used_mem -= mem
                    continue
                wf = state.wfs[uid]
                if kind == _ABORT:
                    # a failed attempt resolves: its slot frees now;
                    # the re-queue happens at the backoff-delayed
                    # _RETRY event
                    cfg = wf.nodes[name].config
                    used_cpu -= cfg.cpu
                    used_mem -= cfg.mem
                    if running is not None:
                        running[(wf.identity, name)] -= 1
                    continue
                if kind == _RETRY:
                    pending.append((t, uid, name))
                    continue
                if kind == _ARRIVAL:
                    for src in wf.sources():
                        pending.append((t, uid, src))
                    if not len(wf):               # empty workflow: trivial
                        state.finish[uid] = t
                else:
                    node = wf.nodes[name]
                    used_cpu -= node.config.cpu
                    used_mem -= node.config.mem
                    if running is not None:
                        running[(wf.identity, name)] -= 1
                    # an OOM-killed invocation leaves no reusable
                    # container behind; containers are per *function*
                    # (tenant identity + node name), shared across
                    # instances of one tenant but never across
                    # unrelated functions that happen to repeat a node
                    # name — nor across tenants whose containers are
                    # sized for different configs
                    if self.cold_start.delay_s > 0.0 and not node.failed:
                        warm[(wf.identity, name)].append(
                            [t, t + self.cold_start.keep_alive_s])
                    state.finish[uid] = max(state.finish[uid], t)
                    if state.dead[uid]:
                        continue
                    rem = state.remaining[uid]
                    for succ in wf.successors(name):
                        rem[succ] -= 1
                        if rem[succ] == 0:
                            pending.append((t, uid, succ))
            used_cpu, used_mem = self._start_pending(
                t, pending, state, warm, used_cpu, used_mem,
                events, seq, per_fn_queue, per_fn_busy, per_fn_spin,
                inv_log, running, fctx)

        # engine invariant: only dead instances leave work behind
        stranded = [(uid, name, bool(state.dead[uid]),
                     bool(state.failed[uid]))
                    for _, uid, name in pending if not state.dead[uid]]
        if stranded:
            raise _stranded_error(stranded)
        carry_out = None
        if collect_carry:
            carry_out = FleetCarry(
                clock=t_last,
                warm={k: [list(c) for c in pool]
                      for k, pool in warm.items() if pool},
                busy=list(inv_log))
        prov, repl = self._provision_ledgers(
            self._fleet_function_configs(state.wfs), t0, t_last)
        fault_ledgers = fctx.ledgers() if fctx is not None \
            else (None, None, None, None)
        return self._report(state, t0, t_last, cpu_area, mem_area,
                            dict(per_fn_queue), carry_out=carry_out,
                            per_fn_busy=dict(per_fn_busy),
                            per_fn_spin=dict(per_fn_spin),
                            provision_by_fn=prov, replicas_by_fn=repl,
                            fault_ledgers=fault_ledgers)

    def run_many(self, template: Workflow,
                 config_sets: Sequence[Dict[str, "ResourceConfig"]],
                 arrival_sets: Sequence[ArrivalLike], *,
                 carry: Optional[FleetCarry] = None,
                 collect_carry: bool = False) -> List[FleetReport]:
        """Replay C candidate config-maps × S arrival processes over a
        shared topology as one vectorized evaluation.

        Each cell (c, s) is semantically ``run([template.copy() with
        config_sets[c] applied, ...], arrival_sets[s], carry=carry)``
        — one fleet of ``len(arrival_sets[s])`` instances — and the
        returned reports are **bit-identical** to that scalar loop.
        Reports come back candidate-major: ``reports[c * S + s]``.

        Any ``batch_safe`` backend exposing ``invoke_config_batch``
        evaluates the whole C×V response surface in ONE call and prices
        it in ONE ``cost_batch`` expression; the plane the cells then
        replay through depends on what actually binds
        (:meth:`batch_eligibility` reports the routing):

          * **fast** — infinite cluster, cold starts off, no carried
            backlog to re-enact: instances never interact, so the plane
            collapses to a candidate-vectorized longest-path sweep over
            the shared event skeleton (no heap, no per-event Python;
            ``plane_backend="torch"``, the default, runs the sweep on
            the device with :func:`fast_plane_sweep`),
          * **constrained** — finite capacity, cold starts, or
            ``collect_carry``: cells replay the exact scalar event loop
            *table-driven* off the precomputed runtime/cost planes —
            zero backend or pricing calls, zero template copies inside
            the loops,
          * **planned** — the pricing model does not vectorize: cells
            replay through per-instance workflow copies against the
            precomputed runtime plan so custom scalar pricing sees real
            node objects,
          * **serial** — an empty template or a backend that is not
            ``batch_safe`` (opaque/stateful with no replay-stream
            contract) genuinely serializes: the exact looped-``run``
            fallback.

        A stochastic backend that honors the paired replay-stream
        contract (``config_surface`` + ``replay_noise``) is replayed as
        a paired experiment: one noise tensor per plane, keyed by
        (instance, function) and shared across candidates, so the same
        configuration in two candidate slots scores identically.

        Unlike ``run``, the batched paths do not write runtimes back
        onto any workflow (there are no per-instance copies to write
        to); callers that need mutated workflows should use ``run``
        directly.
        """
        config_sets = list(config_sets)
        times_list = [arrival_times(a) for a in arrival_sets]
        if not config_sets or not times_list:
            return []
        for configs in config_sets:
            for name in configs:
                if name not in template.nodes:   # match apply_configs
                    raise KeyError(name)

        plane = self._plan_replay(template, collect_carry)["plane"]
        if plane == "serial":
            return self._run_many_serial(template, config_sets, times_list,
                                         carry, collect_carry)

        nodes, names, cpu, mem = self._candidate_arrays(template, config_sets)
        if any(len(t) for t in times_list):
            self._check_candidates_placeable(template, config_sets, cpu, mem)
        if getattr(self.backend, "deterministic", False):
            # ONE response-surface call for the whole C×V plane
            runtimes, failed = self.backend.invoke_config_batch(
                nodes, cpu, mem)
            noise = None
        else:
            # paired replay-stream contract: noise-free surface plus
            # ONE (instances, functions) noise draw shared by all
            # candidates — a paired experiment across the batch
            runtimes, failed = self.backend.config_surface(nodes, cpu, mem)
            n_total = sum(len(t) for t in times_list)
            noise = self.backend.replay_noise(n_total, len(nodes))
        runtimes = np.asarray(runtimes, dtype=np.float64)
        failed = np.asarray(failed, dtype=bool)
        fstream = None
        if self.faults is not None:
            # paired fault-stream contract, mirroring replay_noise:
            # ONE rng advance per plane, shared by every candidate and
            # segmented per arrival set by instance-row offset — the
            # same configuration in two candidate slots draws the same
            # faults, so challenger validation is a paired experiment
            fstream = self.faults.fault_stream(
                sum(len(t) for t in times_list), len(nodes))

        if plane == "planned":
            return self._run_many_planned(template, config_sets, times_list,
                                          carry, collect_carry, names,
                                          runtimes, failed, noise, fstream)
        if plane == "constrained":
            return self._run_many_constrained(template, config_sets,
                                              times_list, carry,
                                              collect_carry, names, cpu, mem,
                                              runtimes, failed, noise,
                                              fstream)
        return self._run_many_vectorized(template, config_sets, times_list,
                                         carry, names, cpu, mem,
                                         runtimes, failed, noise)

    def _plan_replay(self, template: Workflow, collect_carry: bool) -> dict:
        """Route a ``run_many`` call to its replay plane; shared with
        :meth:`batch_eligibility` so the diagnostic can never disagree
        with the router."""
        backend = self.backend
        deterministic = getattr(backend, "deterministic", False)
        batch_safe = getattr(backend, "batch_safe", deterministic)
        reasons: List[str] = []
        if len(template) == 0:
            reasons.append("empty template (trivial scalar runs)")
        if self.interference:
            reasons.append(
                "interference multipliers active (applied per "
                "invocation inside the event loop)")
        if not batch_safe:
            reasons.append(
                "backend is not batch_safe (stateful/opaque with no "
                "paired replay-stream contract)")
        elif not hasattr(backend, "invoke_config_batch"):
            reasons.append("backend lacks invoke_config_batch")
        elif not deterministic and not (hasattr(backend, "config_surface")
                                        and hasattr(backend,
                                                    "replay_noise")):
            reasons.append(
                "stochastic backend is batch_safe but lacks the "
                "config_surface/replay_noise replay-stream contract")
        if reasons:
            return {"plane": "serial", "reasons": reasons}
        if not self._pricing_vectorized:
            return {"plane": "planned", "reasons": [
                "pricing model does not vectorize (scalar overrides "
                "without a matching cost_batch)"]}
        constrained = []
        if self.cluster.finite:
            constrained.append("finite cluster capacity")
        if self.cold_start.delay_s > 0.0:
            constrained.append("cold starts enabled")
        if self.scale is not None:
            constrained.append(
                "replica pools active (admission-concurrency bounds "
                "are an event-loop concept)")
        if self.faults is not None:
            constrained.append(
                "fault injection active (attempt outcomes and "
                "retry/timeout/hedge recovery are an event-loop concept)")
        if collect_carry:
            constrained.append("collect_carry requested")
        if constrained:
            return {"plane": "constrained", "reasons": constrained}
        return {"plane": "fast", "reasons": []}

    def batch_eligibility(self, template: Workflow,
                          config_sets: Sequence[Dict[str, "ResourceConfig"]],
                          *, collect_carry: bool = False,
                          probe_candidates: bool = False) -> dict:
        """Why would (or wouldn't) :meth:`run_many` vectorize this
        replay? Returns::

            {"plane": "fast" | "constrained" | "planned" | "serial",
             "vectorized": bool,   # fast/constrained plane
             "reasons": [...],     # what routed it off the fast plane
             "serial_candidates": None | [candidate indices]}

        ``reasons`` names the binding constraints (finite cluster, cold
        starts, carry collection, backend gate, pricing model). With
        ``probe_candidates=True`` the response surface is evaluated
        (one ``invoke_config_batch``/``config_surface`` call — counts
        against backend invocation tallies) to also report which
        candidates have unbounded (inf-runtime) failures; on the fast
        plane those cells replay per-cell off the precomputed plan
        instead of the longest-path sweep. Purely diagnostic — no
        fleet is run."""
        config_sets = list(config_sets)
        plan = self._plan_replay(template, collect_carry)
        out = {"plane": plan["plane"],
               "vectorized": plan["plane"] in ("fast", "constrained"),
               "reasons": list(plan["reasons"]),
               "serial_candidates": None}
        if (probe_candidates and config_sets
                and plan["plane"] != "serial"):
            nodes, _, cpu, mem = self._candidate_arrays(template, config_sets)
            if getattr(self.backend, "deterministic", False):
                runtimes, _ = self.backend.invoke_config_batch(
                    nodes, cpu, mem)
            else:
                runtimes, _ = self.backend.config_surface(nodes, cpu, mem)
            bad = [int(i) for i in np.flatnonzero(
                ~np.isfinite(np.asarray(runtimes)).all(axis=1))]
            out["serial_candidates"] = bad
            if bad and plan["plane"] == "fast":
                out["reasons"].append(
                    f"candidates {bad} have unbounded (inf-runtime) "
                    "failures; their cells replay per-cell off the "
                    "precomputed plan")
        return out

    def _candidate_arrays(self, template, config_sets):
        """(nodes, names, cpu, mem): the shared node list plus (C, V)
        config arrays, quantized exactly as ``Workflow.copy`` +
        ``apply_configs`` hand the scalar path."""
        nodes = list(template.nodes.values())
        names = [n.name for n in nodes]
        n_cand, n_nodes = len(config_sets), len(nodes)
        cpu = np.empty((n_cand, n_nodes))
        mem = np.empty((n_cand, n_nodes))
        for ci, configs in enumerate(config_sets):
            for vi, node in enumerate(nodes):
                cfg = configs.get(node.name, node.config).copy()
                cpu[ci, vi] = cfg.cpu
                mem[ci, vi] = cfg.mem
        return nodes, names, cpu, mem

    def _check_candidates_placeable(self, template, config_sets,
                                    cpu, mem) -> None:
        """Raise the scalar path's never-placeable ValueError for the
        first offending candidate (identical message, via the same
        per-workflow check)."""
        if not self.cluster.finite:
            return
        bad = ((cpu > self.cluster.total_cpu)
               | (mem > self.cluster.total_mem_mb))
        for ci in np.flatnonzero(bad.any(axis=1)):
            wf = template.copy()
            wf.apply_configs(config_sets[int(ci)])
            self._check_placeable(wf)

    def _run_many_serial(self, template, config_sets, times_list,
                         carry, collect_carry) -> List[FleetReport]:
        """Exact fallback: the looped-``run`` semantics, one fleet per
        (candidate, arrival set) cell."""
        out: List[FleetReport] = []
        for configs in config_sets:
            for times in times_list:
                out.append(self._run_one_serial(template, configs, times,
                                                carry, collect_carry))
        return out

    def _run_one_serial(self, template, configs, times, carry,
                        collect_carry) -> FleetReport:
        wfs = []
        for _ in range(len(times)):
            wf = template.copy()
            wf.apply_configs(configs)
            wfs.append(wf)
        return self.run(wfs, times, carry=carry, collect_carry=collect_carry)

    def _run_many_planned(self, template, config_sets, times_list, carry,
                          collect_carry, names, runtimes, failed,
                          noise, fstream=None) -> List[FleetReport]:
        """Pricing model doesn't vectorize: replay every cell through
        per-instance workflow copies so custom scalar ``function_cost``
        sees real node objects — but drive the event loops off the
        caller's ONE response-surface call instead of re-dispatching
        into the backend per admission round."""
        counts = [len(t) for t in times_list]
        offsets = [0]
        for c in counts:
            offsets.append(offsets[-1] + c)
        reports: List[FleetReport] = []
        for ci, configs in enumerate(config_sets):
            for si, times in enumerate(times_list):
                reports.append(self._run_one_planned(
                    template, configs, times, carry, collect_carry,
                    names, runtimes[ci], failed[ci], noise, offsets[si],
                    fstream))
        return reports

    def _run_one_planned(self, template, configs, times, carry,
                         collect_carry, names, rt_row, failed_row, noise,
                         offset, fstream=None) -> FleetReport:
        """One cell replayed through the exact scalar event loop, with
        the backend swapped for the precomputed (runtime, failed) plan.
        Bit-identical to ``_run_one_serial`` for surface backends
        (elementwise surface => same floats, same event bookkeeping);
        the vehicle for cells that can't join a vectorized sweep
        (single-instance cells, unbounded-failure candidates,
        non-vectorizing pricing)."""
        col = {name: i for i, name in enumerate(names)}
        wfs = []
        plan: Dict[int, Tuple[float, bool]] = {}
        for i in range(len(times)):
            wf = template.copy()
            wf.apply_configs(configs)
            if noise is None:
                rt_i = rt_row
            else:
                rt_i = np.where(failed_row, rt_row,
                                rt_row * noise[offset + i])
            for name, node in wf.nodes.items():
                v = col[name]
                plan[id(node)] = (float(rt_i[v]), bool(failed_row[v]))
            wfs.append(wf)
        shadow = FleetEngine(_PlannedBackend(plan), pricing=self.pricing,
                             cluster=self.cluster,
                             cold_start=self.cold_start, scale=self.scale,
                             faults=self.faults,
                             resilience=self.resilience)
        if fstream is not None:
            # the cell reads the parent plane's ONE fault stream at its
            # own instance-row offset instead of re-drawing per cell
            shadow._fault_stream = (fstream, offset)
        return shadow.run(wfs, times, carry=carry,
                          collect_carry=collect_carry)

    def _run_many_constrained(self, template, config_sets, times_list,
                              carry, collect_carry, names, cpu, mem,
                              runtimes, failed, noise,
                              fstream=None) -> List[FleetReport]:
        """Finite-capacity / cold-start / carry-collecting cells: the
        exact scalar event loop, table-driven. The whole plane's
        runtimes come from the caller's ONE response-surface call and
        are priced in ONE ``cost_batch`` expression here; the per-cell
        loops then run pure-Python bookkeeping — zero backend or
        pricing calls, zero template copies, zero per-instance object
        churn inside the event loops."""
        topo = self._topology_tables(template, names)
        counts = [len(t) for t in times_list]
        offsets = [0]
        for c in counts:
            offsets.append(offsets[-1] + c)
        if noise is None:
            cost_plane = self.pricing.cost_batch(runtimes, cpu, mem)
        else:
            # failing invocations keep their deterministic thrash time
            # (the same masking StochasticBackend._noise_batch applies)
            rt_full = np.where(failed[:, None, :], runtimes[:, None, :],
                               runtimes[:, None, :] * noise[None, :, :])
            cost_full = self.pricing.cost_batch(rt_full, cpu[:, None, :],
                                                mem[:, None, :])
        reports: List[FleetReport] = []
        for ci in range(len(config_sets)):
            cpu_row = cpu[ci].tolist()
            mem_row = mem[ci].tolist()
            failed_row = failed[ci].tolist()
            if noise is None:
                # instances of one candidate share a row: alias it
                rt_shared = runtimes[ci].tolist()
                cost_shared = cost_plane[ci].tolist()
            for si, times in enumerate(times_list):
                m = counts[si]
                if noise is None:
                    rt_rows = [rt_shared] * m
                    cost_rows = [cost_shared] * m
                else:
                    seg = slice(offsets[si], offsets[si] + m)
                    rt_rows = rt_full[ci, seg].tolist()
                    cost_rows = cost_full[ci, seg].tolist()
                reports.append(self._run_cell_table(
                    template, times, carry, collect_carry, names, topo,
                    cpu_row, mem_row, rt_rows, [failed_row] * m,
                    cost_rows, fstream, offsets[si]))
        return reports

    def _topology_tables(self, template, names):
        """Static per-template tables for the table-driven event loop,
        column-indexed in node insertion order (the order ``names``
        lists and the scalar path walks): topological rank per column,
        successor/predecessor-count/source columns in the exact
        iteration order the scalar loop uses, and per-function
        queue-delay keys."""
        col = {name: i for i, name in enumerate(names)}
        rank_of = [0] * len(names)
        for k, name in enumerate(template.topological_order()):
            rank_of[col[name]] = k
        succs = [[col[s] for s in template.successors(name)]
                 for name in names]
        pred_count = [len(template.predecessors(name)) for name in names]
        sources = [col[s] for s in template.sources()]
        fn_keys = [f"{template.identity}/{name}" for name in names]
        return rank_of, succs, pred_count, sources, fn_keys

    def _run_cell_table(self, template, times, carry, collect_carry,
                        names, topo, cpu_row, mem_row, rt_rows,
                        failed_rows, cost_rows, fstream=None,
                        f_offset=0) -> FleetReport:
        """One (candidate, arrival-set) cell of the constrained plane:
        a faithful mirror of :meth:`run`'s event loop — same heap
        tuples, same tie-breaking sequence numbers, same float
        accumulation order, same FIFO admission with the same-instant
        re-admission round — with every backend/pricing dispatch
        replaced by a table lookup. ``rt_rows``/``failed_rows``/
        ``cost_rows`` hold one row of Python floats per instance
        (aliased to one shared row on deterministic planes)."""
        m = len(times)
        if m == 0:
            out = None
            if collect_carry:
                out = (carry.pruned(carry.clock) if carry is not None
                       else FleetCarry())
            return self._empty_report(carry_out=out)
        rank_of, succs, pred_count, sources, fn_keys = topo
        tname = template.identity
        cold_delay_s = self.cold_start.delay_s
        keep_alive_s = self.cold_start.keep_alive_s
        total_cpu = self.cluster.total_cpu
        total_mem = self.cluster.total_mem_mb
        scale = self.scale
        if scale is not None:
            pool_of = [scale.pool(tname, name) for name in names]
            running = [0] * len(names)
        else:
            pool_of = running = None
        fctx: Optional[_FaultCtx] = None
        cfg_cols = None
        if self.faults is not None and fstream is not None:
            # per-leg pricing needs real config objects; rebuild them
            # once per cell from the candidate row (the same
            # quantized floats the scalar path's node.config holds)
            cfg_cols = [ResourceConfig(cpu=cpu_row[v], mem=mem_row[v])
                        for v in range(len(names))]
            fctx = _FaultCtx(self.faults, self.resilience, self.pricing,
                             fstream, f_offset, None)

        arrival = np.array(times, dtype=np.float64)
        finish = np.zeros(m)
        queue_delay = np.zeros(m)
        cold_delay = np.zeros(m)
        failed_i = np.zeros(m, dtype=bool)
        dead = np.zeros(m, dtype=bool)
        remaining = [list(pred_count) for _ in range(m)]
        cost_items: List[List[Tuple[int, float]]] = [[] for _ in range(m)]

        seq = itertools.count()
        events: List[Tuple[float, int, int, int, object]] = [
            (float(t), next(seq), _ARRIVAL, uid, None)
            for uid, t in enumerate(times)
        ]
        pending: collections.deque = collections.deque()
        warm: Dict[tuple, List[List[float]]] = collections.defaultdict(list)
        used_cpu = used_mem = 0.0
        inv_log: Optional[List[Tuple[float, float, float]]] = \
            [] if collect_carry else None
        if carry is not None:
            t_min = float(arrival.min())
            for key, pool in carry.warm.items():
                warm[key] = [list(c) for c in pool]
            self._trim_warm(warm)
            for fin_t, cpu_r, mem_r in carry.busy:
                if fin_t <= t_min:
                    continue            # released before this run starts
                used_cpu += cpu_r
                used_mem += mem_r
                events.append((fin_t, next(seq), _RELEASE, -1,
                               (cpu_r, mem_r)))
                if inv_log is not None:
                    inv_log.append((fin_t, cpu_r, mem_r))
        heapq.heapify(events)
        t0 = float(events[0][0]) if events else 0.0
        t_last, cpu_area, mem_area = t0, 0.0, 0.0
        per_fn_queue: Dict[str, float] = collections.defaultdict(float)
        per_fn_busy: Dict[str, float] = collections.defaultdict(float)
        per_fn_spin: Dict[str, int] = collections.defaultdict(int)

        while events:
            t = events[0][0]
            cpu_area += used_cpu * (t - t_last)
            mem_area += used_mem * (t - t_last)
            t_last = t
            while events and events[0][0] == t:
                _, _, kind, uid, payload = heapq.heappop(events)
                if kind == _RELEASE:
                    cpu_r, mem_r = payload
                    used_cpu -= cpu_r
                    used_mem -= mem_r
                    continue
                if kind == _ABORT:
                    v = payload
                    used_cpu -= cpu_row[v]
                    used_mem -= mem_row[v]
                    if running is not None:
                        running[v] -= 1
                    continue
                if kind == _RETRY:
                    pending.append((t, uid, payload))
                    continue
                if kind == _ARRIVAL:
                    for v in sources:
                        pending.append((t, uid, v))
                else:
                    v = payload
                    used_cpu -= cpu_row[v]
                    used_mem -= mem_row[v]
                    if running is not None:
                        running[v] -= 1
                    if cold_delay_s > 0.0 and not failed_rows[uid][v] \
                            and (fctx is None
                                 or (uid, v) not in fctx.fault_dead):
                        warm[(tname, names[v])].append(
                            [t, t + keep_alive_s])
                    finish[uid] = max(finish[uid], t)
                    if dead[uid]:
                        continue
                    rem = remaining[uid]
                    for s in succs[v]:
                        rem[s] -= 1
                        if rem[s] == 0:
                            pending.append((t, uid, s))
            # FIFO admission — the _start_pending loop, table-driven
            while True:
                startable: List[Tuple[float, int, int]] = []
                while pending:
                    ready_t, uid, v = pending[0]
                    if dead[uid]:
                        pending.popleft()
                        continue
                    if (used_cpu + cpu_row[v] > total_cpu
                            or used_mem + mem_row[v] > total_mem):
                        break
                    if running is not None:
                        if running[v] >= pool_of[v]:
                            break
                        running[v] += 1
                    pending.popleft()
                    used_cpu += cpu_row[v]
                    used_mem += mem_row[v]
                    startable.append((ready_t, uid, v))
                if not startable:
                    break
                released = False
                for ready_t, uid, v in startable:
                    rt = rt_rows[uid][v]
                    wait = t - ready_t
                    queue_delay[uid] += wait
                    per_fn_queue[fn_keys[v]] += wait
                    if failed_rows[uid][v]:
                        failed_i[uid] = True
                    if not math.isfinite(rt):
                        # unbounded failure: release the slot, trigger
                        # a same-instant re-admission round
                        used_cpu -= cpu_row[v]
                        used_mem -= mem_row[v]
                        if running is not None:
                            running[v] -= 1
                        dead[uid] = True
                        released = True
                        continue
                    if fctx is not None:
                        # fault-injection path — the exact mirror of
                        # the scalar loop's branch in _start_pending
                        fkey = fn_keys[v]
                        delay = 0.0
                        if cold_delay_s > 0.0 and not self._take_warm(
                                (tname, names[v]), t, warm):
                            delay = cold_delay_s
                            per_fn_spin[fkey] += 1
                        cold_delay[uid] += delay
                        rank = rank_of[v]
                        if failed_rows[uid][v]:
                            per_fn_busy[fkey] += rt
                            cost_items[uid].append(
                                (rank, fctx.price(rt, cfg_cols[v])))
                            end = t + delay + rt
                        else:
                            dur, ok, legs, n_to, hedged = fctx.resolve(
                                uid, v, tname, names[v], t, rt, delay,
                                cfg_cols[v])
                            for exec_s, c in legs:
                                per_fn_busy[fkey] += exec_s
                                cost_items[uid].append((rank, c))
                            if n_to:
                                fctx.timeouts[fkey] += n_to
                            if hedged:
                                fctx.hedges[fkey] += 1
                            end = t + dur
                            if not ok:
                                fctx.failures[fkey] += 1
                                kk = fctx.attempts.get((uid, v), 0)
                                mr, _, backoff_s, _ = fctx.pol(
                                    tname, names[v])
                                if kk < mr:
                                    fctx.attempts[(uid, v)] = kk + 1
                                    fctx.retries[fkey] += 1
                                    if inv_log is not None:
                                        inv_log.append((end, cpu_row[v],
                                                        mem_row[v]))
                                    heapq.heappush(events,
                                                   (end, next(seq),
                                                    _ABORT, uid, v))
                                    heapq.heappush(
                                        events,
                                        (end + backoff_s * (2.0 ** kk),
                                         next(seq), _RETRY, uid, v))
                                    continue
                                failed_i[uid] = True
                                fctx.fault_dead.add((uid, v))
                        if inv_log is not None:
                            inv_log.append((end, cpu_row[v], mem_row[v]))
                        heapq.heappush(events,
                                       (end, next(seq), _FINISH, uid, v))
                        continue
                    per_fn_busy[fn_keys[v]] += rt
                    delay = 0.0
                    if cold_delay_s > 0.0 and not self._take_warm(
                            (tname, names[v]), t, warm):
                        delay = cold_delay_s
                        per_fn_spin[fn_keys[v]] += 1
                    cold_delay[uid] += delay
                    cost_items[uid].append((rank_of[v],
                                            cost_rows[uid][v]))
                    if inv_log is not None:
                        inv_log.append((t + delay + rt, cpu_row[v],
                                        mem_row[v]))
                    heapq.heappush(events,
                                   (t + delay + rt, next(seq), _FINISH,
                                    uid, v))
                if not released:
                    break

        stranded = [(uid, names[v], bool(dead[uid]), bool(failed_i[uid]))
                    for _, uid, v in pending if not dead[uid]]
        if stranded:
            raise _stranded_error(stranded)
        carry_out = None
        if collect_carry:
            carry_out = FleetCarry(
                clock=t_last,
                warm={k: [list(c) for c in pool]
                      for k, pool in warm.items() if pool},
                busy=list(inv_log))
        prov = repl = None
        if scale is not None:
            fn_configs = {
                (tname, name): ResourceConfig(cpu=cpu_row[v], mem=mem_row[v])
                for v, name in enumerate(names)}
            prov, repl = self._provision_ledgers(fn_configs, t0, t_last)
        fault_ledgers = fctx.ledgers() if fctx is not None \
            else (None, None, None, None)
        return self._report_arrays(
            arrival=arrival, finish=finish, queue_delay=queue_delay,
            cold_delay=cold_delay, failed=failed_i, dead=dead,
            costs=_reduce_costs(cost_items, m), t0=t0, t_end=t_last,
            cpu_area=cpu_area, mem_area=mem_area,
            per_fn_queue=dict(per_fn_queue), carry_out=carry_out,
            tenants=[tname] * m, per_fn_busy=dict(per_fn_busy),
            per_fn_spin=dict(per_fn_spin), provision_by_fn=prov,
            replicas_by_fn=repl, fault_ledgers=fault_ledgers)

    def _run_many_vectorized(self, template, config_sets, times_list,
                             carry, names, cpu, mem, runtimes, failed,
                             noise) -> List[FleetReport]:
        n_cand = len(config_sets)
        n_seeds = len(times_list)
        counts = [len(t) for t in times_list]
        offsets = [0]
        for c in counts:
            offsets.append(offsets[-1] + c)
        finite = np.isfinite(runtimes).all(axis=1)

        reports: List[Optional[FleetReport]] = [None] * (n_cand * n_seeds)
        # a candidate with an unbounded (inf-runtime) failure kills its
        # instances mid-flight — downstream work never runs, which the
        # longest-path plane cannot express: those cells replay the
        # exact event loop off the precomputed plan (no backend calls)
        for ci in np.flatnonzero(~finite):
            for si, times in enumerate(times_list):
                reports[ci * n_seeds + si] = self._run_one_planned(
                    template, config_sets[ci], times, carry, False,
                    names, runtimes[ci], failed[ci], noise, offsets[si])
        live = np.flatnonzero(finite)
        if not live.size:
            return reports

        rt = runtimes[live]                       # (C', V)
        col = {name: i for i, name in enumerate(names)}
        order = template.topological_order()
        t_all = np.concatenate(times_list) if times_list else \
            np.empty(0)
        cand_failed = failed[live].any(axis=1)

        # per-candidate cost of one instance: executed invocations
        # summed in topological-rank order — the same left-to-right
        # float adds _FleetState.instance_costs performs. On the paired
        # stochastic plane the cost gains an instance axis (noise is
        # per (instance, function), shared across candidates).
        if noise is None:
            node_cost = self.pricing.cost_batch(rt, cpu[live], mem[live])
            cand_cost = np.zeros(live.size)
            for name in order:
                cand_cost = cand_cost + node_cost[:, col[name]]
            rt_col = lambda name: rt[:, col[name]][:, None]
        else:
            rt_eff = np.where(failed[live][:, None, :], rt[:, None, :],
                              rt[:, None, :] * noise[None, :, :])
            node_cost = self.pricing.cost_batch(
                rt_eff, cpu[live][:, None, :], mem[live][:, None, :])
            cand_cost = np.zeros((live.size, t_all.size))
            for name in order:
                cand_cost = cand_cost + node_cost[:, :, col[name]]
            rt_col = lambda name: rt_eff[:, :, col[name]]

        # shared event skeleton: absolute finish of node v for every
        # (candidate, instance) — sources start at the arrival instant,
        # successors at the max of their predecessors' finishes, which
        # is exactly the event-loop recurrence (t + rt per hop)
        start_by_node: Dict[str, np.ndarray] = {}
        if self.plane_backend == "torch" and noise is None:
            inst_finish = fast_plane_sweep(template, order, col, t_all, rt,
                                           device=self.device)
        else:
            finish_by_node: Dict[str, np.ndarray] = {}
            for name in order:
                preds = template.predecessors(name)
                if preds:
                    start = finish_by_node[preds[0]]
                    for p in preds[1:]:
                        start = np.maximum(start, finish_by_node[p])
                else:
                    start = t_all[None, :]
                if noise is not None:
                    # start order drives the busy ledger below: the
                    # scalar loop admits (and accumulates) in
                    # start-event order, which per-instance noise can
                    # decouple from arrival order
                    start_by_node[name] = np.broadcast_to(
                        start, (live.size, t_all.size))
                finish_by_node[name] = start + rt_col(name)
            inst_finish = None
            for arr in finish_by_node.values():
                inst_finish = arr if inst_finish is None \
                    else np.maximum(inst_finish, arr)

        pfq = {f"{template.identity}/{name}": 0.0 for name in names}
        busy = carry.busy if carry is not None else []
        for si, times in enumerate(times_list):
            m = counts[si]
            seg = slice(offsets[si], offsets[si] + m)
            for k, ci in enumerate(live):
                idx = int(ci) * n_seeds + si
                if m == 0:
                    reports[idx] = self._empty_report()
                    continue
                if m == 1:
                    # a fleet of one takes ``run``'s degenerate fast
                    # path, whose float associations (relative
                    # longest-path shifted by the arrival, cost in
                    # node-insertion order) differ from the absolute-
                    # time plane in the last bits — replay the cell off
                    # the plan to keep the bit-identity contract
                    reports[idx] = self._run_one_planned(
                        template, config_sets[ci], times, carry, False,
                        names, runtimes[ci], failed[ci], noise,
                        offsets[si])
                    continue
                t0 = float(times.min())
                t_last = float(inst_finish[k, seg].max())
                # carried-over reservations release inside this run and
                # can be its last event (capacity itself never binds)
                for f, _, _ in busy:
                    if f > t0 and f > t_last:
                        t_last = float(f)
                # per-fn busy ledger: the scalar loop's left-to-right
                # accumulation in admission (= start-event) order. With
                # noise off every instance contributes the same value,
                # so repeated addition reproduces any admission order
                # bit-for-bit; with noise on, instances are summed in
                # start-time order (stable on ties).
                fn_busy: Dict[str, float] = {}
                for name in names:
                    if noise is None:
                        val = float(rt[k, col[name]])
                        acc = 0.0
                        for _ in range(m):
                            acc += val
                    else:
                        vals = rt_eff[k, seg, col[name]]
                        starts = start_by_node[name][k, seg]
                        acc = 0.0
                        for x in vals[np.argsort(starts,
                                                 kind="stable")].tolist():
                            acc += x
                    fn_busy[f"{template.identity}/{name}"] = acc
                zeros = np.zeros(m)
                cost = (np.full(m, cand_cost[k]) if noise is None
                        else cand_cost[k, seg].copy())
                reports[idx] = FleetReport.from_arrays(
                    arrival=np.array(times, dtype=np.float64),
                    finish=inst_finish[k, seg].copy(),
                    e2e=inst_finish[k, seg] - times,
                    queue_delay=zeros, cold_delay=zeros.copy(),
                    cost=cost,
                    failed=np.full(m, bool(cand_failed[k]), dtype=bool),
                    makespan=max(t_last - t0, 0.0),
                    cpu_utilization=0.0, mem_utilization=0.0,
                    queue_delay_by_function=dict(pfq),
                    busy_by_function=fn_busy,
                    tenants=[template.identity] * m)
        return reports

    # -- internals -----------------------------------------------------
    def _run_degenerate(self, wf: Workflow, arrival: float) -> FleetReport:
        """Fleet of 1 / infinite capacity / zero cold start: equivalent
        to the event loop (verified by tests) at scalar-path speed."""
        nodes = list(wf)
        runtimes, failed = self.backend.invoke_batch(nodes)
        if self.interference:
            runtimes = np.asarray(runtimes, dtype=np.float64) * \
                np.asarray([self.interference.get((wf.identity, n.name), 1.0)
                            for n in nodes])
        cost = 0.0
        busy: Dict[str, float] = {}
        for node, rt, bad in zip(nodes, runtimes, failed):
            node.runtime = float(rt)
            node.failed = bool(bad)
            if not node.failed:
                node.fail_reason = ""
            if math.isfinite(node.runtime):
                cost += self.pricing.function_cost(node.runtime, node.config)
                busy[f"{wf.identity}/{node.name}"] = node.runtime
        e2e = wf.end_to_end_latency()
        fin = arrival + e2e
        return FleetReport.from_arrays(
            arrival=np.array([arrival]), finish=np.array([fin]),
            e2e=np.array([e2e]), queue_delay=np.zeros(1),
            cold_delay=np.zeros(1), cost=np.array([cost]),
            failed=np.array([bool(failed.any())]),
            makespan=e2e if math.isfinite(e2e) else 0.0,
            cpu_utilization=0.0, mem_utilization=0.0,
            queue_delay_by_function={}, busy_by_function=busy,
            tenants=[wf.identity])

    def _check_placeable(self, wf: Workflow) -> None:
        for node in wf:
            if (node.config.cpu > self.cluster.total_cpu
                    or node.config.mem > self.cluster.total_mem_mb):
                raise ValueError(
                    f"{wf.name}/{node.name} config {node.config} exceeds "
                    f"cluster capacity ({self.cluster.total_cpu} vCPU, "
                    f"{self.cluster.total_mem_mb} MB) — can never be placed")

    def _trim_warm(self, warm: Dict[tuple, List[List[float]]]) -> None:
        """Shard a carried-in warm pool to the current replica counts:
        a pool larger than its function's pool size R (the previous
        epoch ran with more replicas) keeps only the R latest-expiring
        containers (ties by deposit time), in expiry order. No-op when
        the engine runs without a :class:`ReplicaModel` or no pool
        overflows, so replica-free carries are untouched bit-for-bit."""
        if self.scale is None:
            return
        for key in list(warm):
            pool = warm[key]
            r = self.scale.pool(key[0], key[1])
            if len(pool) > r:
                pool.sort(key=lambda c: (c[1], c[0]))
                del pool[:-r]

    def _fleet_function_configs(self, wfs) -> Dict[tuple, object]:
        """First-seen config per (tenant identity, function) across the
        fleet — the provisioning ledger's sizing basis (wf order, node
        insertion order; deterministic)."""
        seen: Dict[tuple, object] = {}
        for wf in wfs:
            for name, node in wf.nodes.items():
                key = (wf.identity, name)
                if key not in seen:
                    seen[key] = node.config
        return seen

    def _provision_ledgers(self, fn_configs: Dict[tuple, object],
                           t0: float, t_end: float):
        """Replica-second billing for one run: each provisioned pool is
        charged ``pricing.replica_cost`` over the fleet makespan.
        Returns ``(provision_by_function, replicas_by_function)`` keyed
        like the queue ledger, or ``(None, None)`` when the engine runs
        without a :class:`ReplicaModel` (replica-free reports then
        carry no provisioning fields at all)."""
        if self.scale is None:
            return None, None
        makespan = max(t_end - t0, 0.0)
        prov: Dict[str, float] = {}
        repl: Dict[str, int] = {}
        for (ident, name), cfg in fn_configs.items():
            r = self.scale.pool(ident, name)
            fkey = f"{ident}/{name}"
            repl[fkey] = r
            prov[fkey] = self.pricing.replica_cost(
                r, cfg, makespan, frac=self.scale.provision_frac,
                floor=self.scale.provision_floor)
        return prov, repl

    def _take_warm(self, key, t: float,
                   warm: Dict[tuple, List[List[float]]]) -> bool:
        """Claim a live warm container for function ``key`` at ``t``."""
        pool = warm.get(key)
        if not pool:
            return False
        live = [c for c in pool if c[1] >= t]
        warm[key] = live
        for i, c in enumerate(live):
            if c[0] <= t:
                live.pop(i)
                return True
        return False

    def _start_pending(self, t, pending, state: _FleetState, warm,
                       used_cpu, used_mem, events, seq, per_fn_queue,
                       per_fn_busy, per_fn_spin, inv_log=None,
                       running=None, fctx: Optional[_FaultCtx] = None):
        """FIFO admission: start every queued invocation that fits, stop
        at the first that doesn't (no overtaking => no starvation). All
        admitted invocations are evaluated in ONE backend batch call and
        priced in one vectorized ``cost_batch`` expression. A
        :class:`ReplicaModel` adds a second blocking condition with the
        same discipline: the head waits while its function's pool is
        fully busy (``running == R``), and everything behind it waits
        too. If an invocation dies on the spot (infinite runtime, no
        clamped estimate) its freed capacity triggers another admission
        round at the same instant — otherwise work queued behind it
        could strand with no future event to wake the scheduler."""
        while True:
            startable: List[Tuple[float, int, str]] = []
            while pending:
                ready_t, uid, name = pending[0]
                if state.dead[uid]:
                    pending.popleft()
                    continue
                cfg = state.wfs[uid].nodes[name].config
                if (used_cpu + cfg.cpu > self.cluster.total_cpu
                        or used_mem + cfg.mem > self.cluster.total_mem_mb):
                    break
                if running is not None:
                    rkey = (state.wfs[uid].identity, name)
                    if running[rkey] >= self.scale.pool(*rkey):
                        break
                    running[rkey] += 1
                pending.popleft()
                used_cpu += cfg.cpu
                used_mem += cfg.mem
                startable.append((ready_t, uid, name))
            if not startable:
                return used_cpu, used_mem

            nodes = [state.wfs[uid].nodes[name]
                     for _, uid, name in startable]
            runtimes, failed = self.backend.invoke_batch(nodes)
            if self.interference:
                # placement-derived runtime multipliers (co-location /
                # noisy-neighbour), applied before pricing so slowed
                # invocations are billed for their real occupancy
                runtimes = np.asarray(runtimes, dtype=np.float64) * \
                    np.asarray([self.interference.get(
                        (state.wfs[uid].identity, name), 1.0)
                        for _, uid, name in startable])
            # under a fault model every leg is priced individually
            # (attempts differ in executed runtime), so the batched
            # pricing expression is skipped entirely
            costs = self._price_batch(nodes, runtimes) \
                if fctx is None else None

            released = False
            for k, ((ready_t, uid, name), node, rt, bad) in enumerate(zip(
                    startable, nodes, runtimes, failed)):
                rt = float(rt)
                node.runtime = rt
                node.failed = bool(bad)
                if not node.failed:
                    node.fail_reason = ""
                wait = t - ready_t
                state.queue_delay[uid] += wait
                # same scoping as warm containers: heterogeneous fleets
                # must not merge unrelated functions sharing a node name
                fkey = f"{state.wfs[uid].identity}/{name}"
                per_fn_queue[fkey] += wait
                if bad:
                    state.failed[uid] = True
                if not math.isfinite(rt):
                    # unbounded failure (no clamped estimate): the
                    # instance can never finish; release its slot
                    cfg = node.config
                    used_cpu -= cfg.cpu
                    used_mem -= cfg.mem
                    if running is not None:
                        running[(state.wfs[uid].identity, name)] -= 1
                    state.dead[uid] = True
                    released = True
                    continue
                if fctx is not None:
                    # fault-injection path: resolve the attempt through
                    # the plane's pre-drawn stream; recovery semantics
                    # (retry/timeout/hedge) come from the engine's
                    # ResilienceModel
                    identity = state.wfs[uid].identity
                    delay = 0.0
                    if self.cold_start.delay_s > 0.0 and \
                            not self._take_warm((identity, name), t, warm):
                        delay = self.cold_start.delay_s
                        per_fn_spin[fkey] += 1
                    state.cold_delay[uid] += delay
                    rank = state.rank[uid][name]
                    if bad:
                        # OOM: deterministic config failure — retrying
                        # cannot fix an undersized config, so the
                        # clamped thrash burns exactly as without faults
                        per_fn_busy[fkey] += rt
                        state.cost_items[uid].append(
                            (rank, fctx.price(rt, node.config)))
                        end = t + delay + rt
                    else:
                        v = fctx.cols[(identity, name)]
                        dur, ok, legs, n_to, hedged = fctx.resolve(
                            uid, v, identity, name, t, rt, delay,
                            node.config)
                        for exec_s, c in legs:
                            per_fn_busy[fkey] += exec_s
                            state.cost_items[uid].append((rank, c))
                        if n_to:
                            fctx.timeouts[fkey] += n_to
                        if hedged:
                            fctx.hedges[fkey] += 1
                        end = t + dur
                        if not ok:
                            fctx.failures[fkey] += 1
                            kk = fctx.attempts.get((uid, v), 0)
                            mr, _, backoff_s, _ = fctx.pol(identity, name)
                            if kk < mr:
                                # re-queue: slot frees when the attempt
                                # resolves; the retry becomes ready
                                # after exponential backoff
                                fctx.attempts[(uid, v)] = kk + 1
                                fctx.retries[fkey] += 1
                                if inv_log is not None:
                                    inv_log.append((end, node.config.cpu,
                                                    node.config.mem))
                                heapq.heappush(events, (end, next(seq),
                                                        _ABORT, uid, name))
                                heapq.heappush(
                                    events,
                                    (end + backoff_s * (2.0 ** kk),
                                     next(seq), _RETRY, uid, name))
                                continue
                            # retries exhausted: terminal failure — the
                            # instance still completes downstream but
                            # is marked failed (OOM-like semantics, no
                            # warm container left behind)
                            node.failed = True
                            node.fail_reason = "fault: attempts exhausted"
                            state.failed[uid] = True
                            fctx.fault_dead.add((uid, v))
                    if inv_log is not None:
                        inv_log.append((end, node.config.cpu,
                                        node.config.mem))
                    heapq.heappush(events,
                                   (end, next(seq), _FINISH, uid, name))
                    continue
                per_fn_busy[fkey] += rt
                delay = 0.0
                if self.cold_start.delay_s > 0.0 and \
                        not self._take_warm((state.wfs[uid].identity, name),
                                            t, warm):
                    delay = self.cold_start.delay_s
                    per_fn_spin[fkey] += 1
                state.cold_delay[uid] += delay
                state.cost_items[uid].append((state.rank[uid][name],
                                              float(costs[k])))
                if inv_log is not None:
                    inv_log.append((t + delay + rt, node.config.cpu,
                                    node.config.mem))
                heapq.heappush(events,
                               (t + delay + rt, next(seq), _FINISH, uid,
                                name))
            if not released:
                return used_cpu, used_mem

    def _price_batch(self, nodes: Sequence, runtimes: np.ndarray) -> np.ndarray:
        """Vectorized per-invocation pricing for one admission batch
        (falls back to scalar ``function_cost`` for pricing models that
        can't vectorize — same IEEE ops either way)."""
        if not self._pricing_vectorized:
            return np.asarray([self.pricing.function_cost(float(rt), n.config)
                               for n, rt in zip(nodes, runtimes)])
        cost_batch = self.pricing.cost_batch
        n = len(nodes)
        cpu = np.empty(n)
        mem = np.empty(n)
        for i, node in enumerate(nodes):
            cpu[i] = node.config.cpu
            mem[i] = node.config.mem
        return cost_batch(runtimes, cpu, mem)

    def _empty_report(self, carry_out=None) -> FleetReport:
        empty = np.empty(0)
        return FleetReport.from_arrays(
            arrival=empty, finish=empty, e2e=empty, queue_delay=empty,
            cold_delay=empty, cost=empty,
            failed=np.empty(0, dtype=bool), makespan=0.0,
            cpu_utilization=0.0, mem_utilization=0.0,
            queue_delay_by_function={}, carry=carry_out)

    def _report(self, state: _FleetState, t0, t_end, cpu_area, mem_area,
                per_fn_queue, carry_out=None, per_fn_busy=None,
                per_fn_spin=None, provision_by_fn=None,
                replicas_by_fn=None,
                fault_ledgers=(None, None, None, None)) -> FleetReport:
        return self._report_arrays(
            arrival=state.arrival, finish=state.finish,
            queue_delay=state.queue_delay, cold_delay=state.cold_delay,
            failed=state.failed, dead=state.dead,
            costs=state.instance_costs(), t0=t0, t_end=t_end,
            cpu_area=cpu_area, mem_area=mem_area,
            per_fn_queue=per_fn_queue, carry_out=carry_out,
            tenants=[wf.identity for wf in state.wfs],
            per_fn_busy=per_fn_busy, per_fn_spin=per_fn_spin,
            provision_by_fn=provision_by_fn, replicas_by_fn=replicas_by_fn,
            fault_ledgers=fault_ledgers)

    def _report_arrays(self, *, arrival, finish, queue_delay, cold_delay,
                       failed, dead, costs, t0, t_end, cpu_area, mem_area,
                       per_fn_queue, carry_out=None,
                       tenants=None, per_fn_busy=None, per_fn_spin=None,
                       provision_by_fn=None, replicas_by_fn=None,
                       fault_ledgers=(None, None, None, None)
                       ) -> FleetReport:
        """Shared report assembly for the scalar event loop and the
        table-driven cells (identical inf-substitution, utilization and
        makespan arithmetic)."""
        finish_out = np.where(dead, math.inf, finish)
        e2e = np.where(dead, math.inf, finish - arrival)
        makespan = max(t_end - t0, 0.0)
        denom = self.cluster.total_cpu * makespan
        cpu_util = cpu_area / denom if denom > 0 and math.isfinite(denom) \
            else 0.0
        denom = self.cluster.total_mem_mb * makespan
        mem_util = mem_area / denom if denom > 0 and math.isfinite(denom) \
            else 0.0
        retries, timeouts, hedges, failures = fault_ledgers
        return FleetReport.from_arrays(
            arrival=arrival, finish=finish_out, e2e=e2e,
            queue_delay=queue_delay, cold_delay=cold_delay,
            cost=costs, failed=failed | dead,
            makespan=makespan, cpu_utilization=cpu_util,
            mem_utilization=mem_util,
            queue_delay_by_function=per_fn_queue, carry=carry_out,
            tenants=tenants, busy_by_function=per_fn_busy,
            spinups_by_function=per_fn_spin,
            provision_by_function=provision_by_fn,
            replicas_by_function=replicas_by_fn,
            retries_by_function=retries, timeouts_by_function=timeouts,
            hedges_by_function=hedges, failures_by_function=failures)


def run_fleet(env, workflow: Union[Workflow, Callable[[int], Workflow]],
              arrivals: ArrivalLike, *,
              cluster: ClusterModel = INFINITE_CLUSTER,
              cold_start: ColdStartModel = NO_COLD_START,
              faults=None, resilience=None,
              copy: bool = True) -> FleetReport:
    """Run a fleet of instances of ``workflow`` through ``env``'s
    backend and pricing (the same ``Environment`` every searcher uses).

    ``workflow`` is either a template :class:`Workflow` (copied per
    instance when ``copy=True``) or a factory ``index -> Workflow`` for
    heterogeneous fleets.
    """
    times = arrival_times(arrivals)
    if callable(workflow) and not isinstance(workflow, Workflow):
        instances = [workflow(i) for i in range(len(times))]
    elif copy:
        instances = [workflow.copy() for _ in range(len(times))]
    else:
        if len(times) != 1:
            raise ValueError("copy=False only makes sense for a fleet of 1")
        instances = [workflow]
    engine = FleetEngine(env.backend, pricing=env.pricing, cluster=cluster,
                         cold_start=cold_start, faults=faults,
                         resilience=resilience)
    return engine.run(instances, times)
