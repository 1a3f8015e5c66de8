"""Affinity-aware placement for shared-cluster (multi-tenant) serving.

AARC's online plane historically served every (workflow, SLO) cell
against its own private capacity quota. Real FaaS platforms pack all
tenants into ONE cluster, where decoupled CPU/memory sizing only pays
off if *placement* keeps chatty producer->consumer pairs co-located
and memory-bandwidth-heavy functions apart (cf. arxiv 2105.14845 on
per-function decoupled allocation and arxiv 2105.11592 on placement as
a first-class scheduling axis). This module is that placement layer:

  * :class:`TenantCell` — one tenant's deployment unit: a workflow
    template (carrying a unique ``Workflow.identity``), its current
    per-function configuration, and its SLO,
  * :func:`derive_constraints` — reads affinity structure off the
    templates: *chatty* DAG edges (combined ``FunctionSpec.io_time``
    at or above ``chatty_io_s`` — data-movement-dominated hops that
    want to share a warm slice) and *heavy* functions
    (memory-bandwidth-bound by generator ``profile``, falling back to
    a working-set threshold for hand-built specs),
  * :func:`solve_placement` — greedy packing over ``n_bins`` CPU+mem
    bins (equal slices of the shared cluster) followed by seeded
    local-search moves/swaps, under a **hard anti-affinity cap**: no
    bin may hold more than ``ceil(n_heavy / n_bins)`` heavy functions,
  * :func:`round_robin_placement` — the affinity-blind ablation
    (functions dealt to bins in arrival order; chatty edges and the
    heavy cap are ignored at decision time, the interference physics
    still applies),
  * :func:`interference_multipliers` — converts a placement into the
    per-invocation runtime multipliers :class:`FleetEngine` applies
    (``interference=`` keyed by ``(tenant identity, function)``):
    co-located chatty endpoints speed up, split chatty hops charge the
    consumer a remote-transfer penalty, co-resident heavy functions
    slow each other down,
  * :func:`plan_placement` — the one-call bundle the online controller
    uses (validate tenants -> constraints -> solve -> multipliers).

Bins are a *placement* abstraction (nodes of the shared cluster): the
fleet engine still admits against the single aggregate pool, and the
placement decision enters the simulation purely through the
interference multipliers — which is exactly the coupling that makes
the affinity-off ablation measurable.

The port's copy of ``src/repro/core/placement.py``: numpy and plain
Python as there, so that constraints, solutions (the same seeded local
search, the same rng calls in the same order) and multipliers equal the
reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.dag import Workflow
from repro_torch.core.engine import ClusterModel, INFINITE_CLUSTER
from repro_torch.core.resources import ResourceConfig

#: placement key: (tenant identity, function name)
FnKey = Tuple[str, str]


@dataclasses.dataclass(frozen=True)
class PlacementSpec:
    """Knobs of the shared-cluster placement layer.

    ``cluster`` is the packed cluster's aggregate capacity; ``None``
    lets the caller derive it (the online plane multiplies the per-cell
    quota by the number of cells so packed-vs-quota comparisons hold
    total capacity fixed). ``affinity=False`` switches the solver to
    the round-robin ablation — the interference model is unchanged, so
    the two rows differ only by placement quality."""

    n_bins: int = 4
    cluster: Optional[ClusterModel] = None
    affinity: bool = True
    #: an edge whose endpoints' combined ``io_time`` reaches this many
    #: seconds is *chatty* (data movement dominates the hop)
    chatty_io_s: float = 3.0
    #: runtime multiplier bonus for co-located chatty endpoints
    colocate_bonus: float = 0.06
    #: runtime multiplier charged to the consumer of a split chatty edge
    remote_penalty: float = 0.04
    #: per-extra-co-resident-heavy-function slowdown (bandwidth sharing)
    interference_penalty: float = 0.12
    #: generator profile treated as memory-bandwidth-heavy
    heavy_profile: str = "mem_bound"
    #: working-set floor (MB) that marks profile-less specs heavy
    heavy_mem_floor: float = 2048.0
    #: local-search iterations after the greedy pass
    local_moves: int = 128
    seed: int = 0

    def __post_init__(self) -> None:
        if self.n_bins < 1:
            raise ValueError("placement needs n_bins >= 1")
        for knob in ("colocate_bonus", "remote_penalty",
                     "interference_penalty"):
            v = getattr(self, knob)
            if not (0.0 <= v < 1.0):
                raise ValueError(f"{knob} must be in [0, 1), got {v}")


@dataclasses.dataclass
class TenantCell:
    """One tenant's deployment unit inside a packed cluster."""

    template: Workflow
    configs: Dict[str, ResourceConfig]
    slo: float = math.inf

    @property
    def tenant(self) -> str:
        return self.template.identity

    def config_of(self, fn: str) -> ResourceConfig:
        cfg = self.configs.get(fn)
        return cfg if cfg is not None else self.template.nodes[fn].config


@dataclasses.dataclass(frozen=True)
class PlacementConstraints:
    """Affinity structure read off the tenants' templates."""

    #: chatty producer->consumer pairs that want co-location
    chatty: Tuple[Tuple[FnKey, FnKey], ...]
    #: memory-bandwidth-heavy functions that want spreading
    heavy: Tuple[FnKey, ...]

    @property
    def heavy_set(self) -> Set[FnKey]:
        return set(self.heavy)


@dataclasses.dataclass
class PlacementSolution:
    """A function->bin assignment plus its audit trail."""

    assignment: Dict[FnKey, int]
    n_bins: int
    score: float
    method: str                      # "affinity" | "round_robin"

    def bin_of(self, tenant: str, fn: str) -> int:
        return self.assignment[(tenant, fn)]

    def bin_members(self) -> List[List[FnKey]]:
        out: List[List[FnKey]] = [[] for _ in range(self.n_bins)]
        for key, b in self.assignment.items():
            out[b].append(key)
        return out

    def heavy_per_bin(self, constraints: PlacementConstraints) -> List[int]:
        counts = [0] * self.n_bins
        heavy = constraints.heavy_set
        for key, b in self.assignment.items():
            if key in heavy:
                counts[b] += 1
        return counts


@dataclasses.dataclass
class PlacementPlan:
    """What the online controller carries: the accepted placement, the
    constraints it was scored under, and the runtime multipliers the
    fleet engine applies."""

    spec: PlacementSpec
    cluster: ClusterModel
    constraints: PlacementConstraints
    solution: PlacementSolution
    multipliers: Dict[FnKey, float]


# --------------------------------------------------------------------------
# tenancy validation + cluster arithmetic
# --------------------------------------------------------------------------

def pack_cells(cells: Sequence[TenantCell]) -> List[TenantCell]:
    """Validate that the cells can share one engine: every cell must
    carry a distinct ``Workflow.identity`` (warm pools, queue ledgers
    and placement keys are all tenant-keyed). Raises ``ValueError``
    naming the colliding identities otherwise."""
    seen: Dict[str, int] = {}
    dupes: List[str] = []
    for cell in cells:
        ident = cell.tenant
        seen[ident] = seen.get(ident, 0) + 1
        if seen[ident] == 2:
            dupes.append(ident)
    if dupes:
        raise ValueError(
            f"cells sharing one cluster must have unique tenant "
            f"identities; duplicates: {sorted(dupes)} — set "
            f"Workflow.tenant to disambiguate cells serving the same "
            f"template name")
    return list(cells)


def scale_cluster(per_cell: ClusterModel, factor: float) -> ClusterModel:
    """Scale a cluster's capacity by ``factor`` (infinite dimensions
    stay infinite). Integer factors aggregate ``factor`` per-cell
    quotas into one packed pool (the multi-tenant case); fractional
    factors >= 1 grow capacity for autoscaling grants — the scale
    actuator's cluster half (:mod:`repro_torch.core.autoscale`)."""
    if not factor >= 1:
        raise ValueError("need factor >= 1")
    cpu = per_cell.total_cpu
    mem = per_cell.total_mem_mb
    return ClusterModel(
        total_cpu=cpu * factor if math.isfinite(cpu) else cpu,
        total_mem_mb=mem * factor if math.isfinite(mem) else mem)


# --------------------------------------------------------------------------
# constraint derivation
# --------------------------------------------------------------------------

def _is_heavy(node, spec: PlacementSpec) -> bool:
    fn_spec = node.payload
    profile = getattr(fn_spec, "profile", "")
    if profile:
        return profile == spec.heavy_profile
    floor = getattr(fn_spec, "mem_floor", 0.0)
    return float(floor) >= spec.heavy_mem_floor


def derive_constraints(cells: Sequence[TenantCell],
                       spec: PlacementSpec) -> PlacementConstraints:
    """Affinity/anti-affinity structure from ``FunctionSpec`` payloads:
    a DAG edge is *chatty* when its endpoints' combined ``io_time``
    reaches ``spec.chatty_io_s`` (the hop is data-movement-dominated);
    a function is *heavy* when its generator profile matches
    ``spec.heavy_profile`` (working-set fallback for hand-built specs
    with no profile). Nodes with no ``FunctionSpec`` payload contribute
    no constraints — placement degrades to pure load balancing."""
    chatty: List[Tuple[FnKey, FnKey]] = []
    heavy: List[FnKey] = []
    for cell in cells:
        wf = cell.template
        tenant = cell.tenant
        for name in wf.topological_order():
            node = wf.nodes[name]
            if node.payload is not None and _is_heavy(node, spec):
                heavy.append((tenant, name))
            io_u = float(getattr(node.payload, "io_time", 0.0) or 0.0)
            for succ in wf.successors(name):
                io_v = float(getattr(wf.nodes[succ].payload, "io_time",
                                     0.0) or 0.0)
                if io_u + io_v >= spec.chatty_io_s:
                    chatty.append(((tenant, name), (tenant, succ)))
    return PlacementConstraints(chatty=tuple(chatty), heavy=tuple(heavy))


def heavy_cap(n_heavy: int, n_bins: int) -> int:
    """The hard anti-affinity cap: a perfectly spread heavy population
    puts at most ``ceil(n_heavy / n_bins)`` per bin; the solver never
    accepts a bin above it."""
    return max(1, math.ceil(n_heavy / n_bins)) if n_heavy else 0


# --------------------------------------------------------------------------
# scoring
# --------------------------------------------------------------------------

def _bin_loads(assignment: Dict[FnKey, int], demands: Dict[FnKey,
               Tuple[float, float]], n_bins: int) -> Tuple[List[float],
                                                           List[float]]:
    cpu = [0.0] * n_bins
    mem = [0.0] * n_bins
    for key, b in assignment.items():
        c, m = demands[key]
        cpu[b] += c
        mem[b] += m
    return cpu, mem


def score_placement(assignment: Dict[FnKey, int],
                    constraints: PlacementConstraints,
                    demands: Dict[FnKey, Tuple[float, float]],
                    cluster: ClusterModel, spec: PlacementSpec) -> float:
    """Lower is better. Terms, in decreasing weight:

      * capacity overflow — configured demand above a bin's equal
        slice of the cluster (soft: the engine still admits against
        the aggregate pool, but an overflowing bin is a placement
        that cannot actually co-reside),
      * heavy co-residency — one unit of ``interference_penalty`` per
        co-resident heavy *pair* per bin,
      * split chatty edges — ``remote_penalty`` each,
      * load imbalance — population-variance of per-bin CPU load,
        normalized; breaks ties toward balanced packs.
    """
    n_bins = spec.n_bins
    cpu, mem = _bin_loads(assignment, demands, n_bins)
    penalty = 0.0
    cap_cpu = cluster.total_cpu / n_bins
    cap_mem = cluster.total_mem_mb / n_bins
    for b in range(n_bins):
        if math.isfinite(cap_cpu) and cpu[b] > cap_cpu:
            penalty += 100.0 * (cpu[b] - cap_cpu) / cap_cpu
        if math.isfinite(cap_mem) and mem[b] > cap_mem:
            penalty += 100.0 * (mem[b] - cap_mem) / cap_mem
    # partial assignments (the greedy pass scores mid-construction)
    # contribute only the constraints whose endpoints are placed
    heavy_counts = [0] * n_bins
    for key in constraints.heavy:
        b = assignment.get(key)
        if b is not None:
            heavy_counts[b] += 1
    for h in heavy_counts:
        penalty += spec.interference_penalty * (h * (h - 1) / 2.0)
    for u, v in constraints.chatty:
        bu, bv = assignment.get(u), assignment.get(v)
        if bu is not None and bv is not None and bu != bv:
            penalty += spec.remote_penalty
    total_cpu = sum(cpu)
    if total_cpu > 0.0:
        mean = total_cpu / n_bins
        var = sum((c - mean) ** 2 for c in cpu) / n_bins
        penalty += 0.01 * var / (mean * mean)
    return penalty


# --------------------------------------------------------------------------
# solvers
# --------------------------------------------------------------------------

def _demands(cells: Sequence[TenantCell]) -> Dict[FnKey,
                                                  Tuple[float, float]]:
    out: Dict[FnKey, Tuple[float, float]] = {}
    for cell in cells:
        for name in cell.template.topological_order():
            cfg = cell.config_of(name)
            out[(cell.tenant, name)] = (float(cfg.cpu), float(cfg.mem))
    return out


def round_robin_placement(cells: Sequence[TenantCell],
                          spec: PlacementSpec,
                          cluster: Optional[ClusterModel] = None
                          ) -> PlacementSolution:
    """The affinity-blind ablation: functions are dealt to bins in
    deterministic (cell, topological) order, ignoring chatty edges and
    the heavy cap. The interference model still applies to whatever
    this produces — a chain's chatty hops land in different bins, and
    heavy functions pile up wherever the deal puts them."""
    cells = pack_cells(cells)
    cluster = cluster or spec.cluster or INFINITE_CLUSTER
    constraints = derive_constraints(cells, spec)
    demands = _demands(cells)
    assignment: Dict[FnKey, int] = {}
    i = 0
    for cell in cells:
        for name in cell.template.topological_order():
            assignment[(cell.tenant, name)] = i % spec.n_bins
            i += 1
    score = score_placement(assignment, constraints, demands, cluster,
                            spec)
    return PlacementSolution(assignment=assignment, n_bins=spec.n_bins,
                             score=score, method="round_robin")


def solve_placement(cells: Sequence[TenantCell], spec: PlacementSpec,
                    cluster: Optional[ClusterModel] = None
                    ) -> PlacementSolution:
    """Greedy affinity-aware packing + seeded local search.

    Greedy pass: heavy functions first, dealt round-robin to the bins
    with the fewest heavies (hard cap ``ceil(n_heavy / n_bins)`` per
    bin — never exceeded, here or by any local-search move); then the
    remaining functions in decreasing demand order, each to the bin
    that minimizes the marginal :func:`score_placement` (which pulls
    chatty consumers toward their producers and spreads load). Local
    search then tries ``spec.local_moves`` seeded single-function
    moves and pairwise swaps, accepting strict improvements that keep
    the heavy cap intact."""
    cells = pack_cells(cells)
    cluster = cluster or spec.cluster or INFINITE_CLUSTER
    constraints = derive_constraints(cells, spec)
    demands = _demands(cells)
    heavy = constraints.heavy_set
    cap = heavy_cap(len(heavy), spec.n_bins)
    n_bins = spec.n_bins

    assignment: Dict[FnKey, int] = {}
    heavy_counts = [0] * n_bins
    # heavy first: largest working sets to the emptiest heavy bins —
    # deterministic (demand, key) order, bin tie-broken by index
    for key in sorted(heavy, key=lambda k: (-demands[k][1], k)):
        b = min(range(n_bins), key=lambda i: (heavy_counts[i], i))
        assignment[key] = b
        heavy_counts[b] += 1

    rest = [k for k in demands if k not in heavy]
    rest.sort(key=lambda k: (-(demands[k][0] + demands[k][1] / 1024.0), k))
    for key in rest:
        best_b, best_s = 0, math.inf
        for b in range(n_bins):
            assignment[key] = b
            s = score_placement(assignment, constraints, demands,
                                cluster, spec)
            if s < best_s - 1e-12:
                best_b, best_s = b, s
        assignment[key] = best_b

    score = score_placement(assignment, constraints, demands, cluster,
                            spec)
    rng = np.random.default_rng(spec.seed)
    keys = sorted(assignment)
    for _ in range(spec.local_moves):
        if not keys:
            break
        if len(keys) >= 2 and rng.random() < 0.5:
            # pairwise swap
            i, j = rng.choice(len(keys), size=2, replace=False)
            a, b = keys[int(i)], keys[int(j)]
            if assignment[a] == assignment[b]:
                continue
            assignment[a], assignment[b] = assignment[b], assignment[a]
            s = score_placement(assignment, constraints, demands,
                                cluster, spec)
            ok = s < score - 1e-12
            if ok and ((a in heavy) != (b in heavy)):
                hc = PlacementSolution(assignment, n_bins, s,
                                       "tmp").heavy_per_bin(constraints)
                ok = max(hc, default=0) <= cap
            if ok:
                score = s
            else:
                assignment[a], assignment[b] = assignment[b], assignment[a]
        else:
            key = keys[int(rng.integers(len(keys)))]
            old = assignment[key]
            b = int(rng.integers(n_bins))
            if b == old:
                continue
            if key in heavy:
                hc = [0] * n_bins
                for k2 in heavy:
                    hc[assignment[k2]] += 1
                if hc[b] + 1 > cap:
                    continue
            assignment[key] = b
            s = score_placement(assignment, constraints, demands,
                                cluster, spec)
            if s < score - 1e-12:
                score = s
            else:
                assignment[key] = old
    return PlacementSolution(assignment=assignment, n_bins=n_bins,
                             score=score, method="affinity")


# --------------------------------------------------------------------------
# placement -> engine coupling
# --------------------------------------------------------------------------

def interference_multipliers(solution: PlacementSolution,
                             constraints: PlacementConstraints,
                             spec: PlacementSpec) -> Dict[FnKey, float]:
    """Per-invocation runtime multipliers implied by a placement,
    compounded multiplicatively per function:

      * a heavy function sharing its bin with ``h - 1`` other heavies
        runs ``x(1 + interference_penalty * (h - 1))`` (bandwidth
        sharing),
      * both endpoints of a co-located chatty edge run
        ``x(1 - colocate_bonus)`` (the transfer stays on-node),
      * the consumer of a *split* chatty edge runs
        ``x(1 + remote_penalty)`` (cross-node transfer).

    Feed the result to ``FleetEngine(interference=...)`` — the engine
    applies it before pricing, so a bad placement is slower *and* more
    expensive. Keys with multiplier exactly 1.0 are dropped."""
    mult: Dict[FnKey, float] = {}
    heavy_counts = solution.heavy_per_bin(constraints)
    for key in constraints.heavy:
        h = heavy_counts[solution.assignment[key]]
        if h > 1:
            factor = 1.0 + spec.interference_penalty * (h - 1)
            mult[key] = mult.get(key, 1.0) * factor
    for u, v in constraints.chatty:
        if solution.assignment[u] == solution.assignment[v]:
            mult[u] = mult.get(u, 1.0) * (1.0 - spec.colocate_bonus)
            mult[v] = mult.get(v, 1.0) * (1.0 - spec.colocate_bonus)
        else:
            mult[v] = mult.get(v, 1.0) * (1.0 + spec.remote_penalty)
    return {k: v for k, v in mult.items() if v != 1.0}


def plan_placement(cells: Sequence[TenantCell], spec: PlacementSpec,
                   cluster: Optional[ClusterModel] = None
                   ) -> PlacementPlan:
    """Validate -> derive constraints -> solve -> multipliers, in one
    call. ``spec.affinity=False`` swaps the solver for the round-robin
    ablation; everything downstream (interference model, engine
    coupling) is identical."""
    cells = pack_cells(cells)
    cluster = cluster or spec.cluster or INFINITE_CLUSTER
    constraints = derive_constraints(cells, spec)
    if spec.affinity:
        solution = solve_placement(cells, spec, cluster)
    else:
        solution = round_robin_placement(cells, spec, cluster)
    mult = interference_multipliers(solution, constraints, spec)
    return PlacementPlan(spec=spec, cluster=cluster,
                         constraints=constraints, solution=solution,
                         multipliers=mult)
