"""Parameterized random-workflow generator.

The paper evaluates three hand-built workflows; fleet-scale evaluation
needs unbounded scenarios. This module generates seed-reproducible
workflows of four topology families —

  * ``chain``     — f0 -> f1 -> ... -> f(n-1),
  * ``fan``       — source -> {n-2 parallel branches} -> sink
                    (scatter/broadcast, the chatbot/video shape),
  * ``diamond``   — repeated source -> {left, right} -> join blocks,
  * ``layered``   — random layered DAG: every node has >= 1 predecessor
                    in an earlier layer and >= 1 successor in a later
                    one, extra inter-layer edges with probability
                    ``p_edge``;

— populated with :class:`FunctionSpec` response surfaces drawn from
seeded *affinity profiles* (§II-A's three classes plus io-bound), so
generated functions exhibit the same CPU/memory affinity structure the
AARC scheduler exploits. Edges are always added from earlier to later
construction order, which the DAG's incremental topological index
accepts in O(1) — a 1k-node layered DAG builds in linear time.

Every generated workflow is acyclic by construction, every node lies on
a source -> sink path, and the same ``seed`` reproduces the same graph
and the same response surfaces.

The port's copy of ``src/repro/serverless/generator.py``, numpy and
plain Python as there, so that the same seed draws the same graphs,
specs and schedules as the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dag import Workflow
from repro_torch.serverless.function import FunctionSpec


@dataclasses.dataclass(frozen=True)
class AffinityProfile:
    """Uniform sampling ranges for one affinity class of functions."""

    name: str
    cpu_work: Tuple[float, float]
    parallel_frac: Tuple[float, float]
    mem_floor: Tuple[float, float]        # MB
    knee_ratio: Tuple[float, float]       # knee = floor * ratio
    mem_penalty: Tuple[float, float]
    io_time: Tuple[float, float]

    def sample(self, name: str, rng: np.random.Generator) -> FunctionSpec:
        u = rng.uniform
        floor = u(*self.mem_floor)
        return FunctionSpec(
            name=name,
            cpu_work=float(u(*self.cpu_work)),
            parallel_frac=float(u(*self.parallel_frac)),
            mem_floor=float(floor),
            mem_knee=float(floor * u(*self.knee_ratio)),
            mem_penalty=float(u(*self.mem_penalty)),
            io_time=float(u(*self.io_time)),
            profile=self.name,
        )


#: §II-A affinity classes (+ io-bound glue functions)
AFFINITY_PROFILES: Dict[str, AffinityProfile] = {
    "cpu_bound": AffinityProfile(
        "cpu_bound", cpu_work=(40.0, 160.0), parallel_frac=(0.8, 0.95),
        mem_floor=(256.0, 512.0), knee_ratio=(1.2, 1.6),
        mem_penalty=(2.0, 4.0), io_time=(0.3, 1.5)),
    "mem_bound": AffinityProfile(
        "mem_bound", cpu_work=(15.0, 60.0), parallel_frac=(0.3, 0.6),
        mem_floor=(2048.0, 5120.0), knee_ratio=(1.1, 1.4),
        mem_penalty=(3.0, 6.0), io_time=(1.0, 3.0)),
    "balanced": AffinityProfile(
        "balanced", cpu_work=(5.0, 40.0), parallel_frac=(0.4, 0.75),
        mem_floor=(256.0, 1024.0), knee_ratio=(1.2, 1.5),
        mem_penalty=(1.5, 3.0), io_time=(0.5, 2.0)),
    "io_bound": AffinityProfile(
        "io_bound", cpu_work=(0.5, 4.0), parallel_frac=(0.1, 0.4),
        mem_floor=(128.0, 384.0), knee_ratio=(1.2, 1.5),
        mem_penalty=(1.0, 2.0), io_time=(2.0, 6.0)),
}

#: default mix of affinity classes when none is pinned
_PROFILE_MIX: Sequence[Tuple[str, float]] = (
    ("cpu_bound", 0.35), ("balanced", 0.35), ("mem_bound", 0.15),
    ("io_bound", 0.15))


def random_spec(name: str, rng: np.random.Generator,
                profile: Optional[str] = None) -> FunctionSpec:
    """One random FunctionSpec; ``profile`` pins the affinity class."""
    if profile is None:
        names = [p for p, _ in _PROFILE_MIX]
        weights = np.asarray([w for _, w in _PROFILE_MIX])
        profile = str(rng.choice(names, p=weights / weights.sum()))
    return AFFINITY_PROFILES[profile].sample(name, rng)


def _new_workflow(kind: str, seed: int, tenant: Optional[str] = None
                  ) -> Tuple[Workflow, np.random.Generator]:
    # names are only unique per (kind, seed): two cells serving the same
    # generated template in a shared cluster must set distinct tenants
    return Workflow(f"{kind}-{seed}", tenant=tenant), \
        np.random.default_rng(seed)


def _add(wf: Workflow, name: str, rng: np.random.Generator,
         profile: Optional[str]) -> str:
    wf.add_function(name, payload=random_spec(name, rng, profile))
    return name


def chain_workflow(n: int = 6, *, seed: int = 0,
                   profile: Optional[str] = None,
                   tenant: Optional[str] = None) -> Workflow:
    """A sequential pipeline of ``n`` functions."""
    if n < 1:
        raise ValueError("chain needs n >= 1")
    wf, rng = _new_workflow("chain", seed, tenant)
    names = [_add(wf, f"f{i:03d}", rng, profile) for i in range(n)]
    wf.chain(*names)
    return wf


def fan_workflow(width: int = 4, *, seed: int = 0,
                 profile: Optional[str] = None,
                 tenant: Optional[str] = None) -> Workflow:
    """Scatter/gather: source -> ``width`` parallel branches -> sink."""
    if width < 1:
        raise ValueError("fan needs width >= 1")
    wf, rng = _new_workflow("fan", seed, tenant)
    src = _add(wf, "scatter", rng, "io_bound" if profile is None else profile)
    branches = [_add(wf, f"branch{i:03d}", rng, profile)
                for i in range(width)]
    sink = _add(wf, "gather", rng, "io_bound" if profile is None else profile)
    for b in branches:
        wf.add_edge(src, b)
        wf.add_edge(b, sink)
    return wf


def diamond_workflow(n_diamonds: int = 2, *, seed: int = 0,
                     profile: Optional[str] = None,
                     tenant: Optional[str] = None) -> Workflow:
    """``n_diamonds`` chained a -> {b, c} -> d blocks."""
    if n_diamonds < 1:
        raise ValueError("diamond needs n_diamonds >= 1")
    wf, rng = _new_workflow("diamond", seed, tenant)
    prev_join: Optional[str] = None
    for d in range(n_diamonds):
        top = _add(wf, f"d{d}_open", rng, profile)
        left = _add(wf, f"d{d}_left", rng, profile)
        right = _add(wf, f"d{d}_right", rng, profile)
        join = _add(wf, f"d{d}_join", rng, profile)
        for mid in (left, right):
            wf.add_edge(top, mid)
            wf.add_edge(mid, join)
        if prev_join is not None:
            wf.add_edge(prev_join, top)
        prev_join = join
    return wf


def layered_workflow(n_nodes: int = 16, *, n_layers: int = 4,
                     p_edge: float = 0.3, seed: int = 0,
                     profile: Optional[str] = None,
                     tenant: Optional[str] = None) -> Workflow:
    """Random layered DAG. Nodes are split across ``n_layers`` layers
    (each layer non-empty); consecutive-layer edges appear with
    probability ``p_edge``, then every node is guaranteed >= 1
    predecessor in the previous layer and >= 1 successor in the next,
    so the graph is connected source -> sink."""
    if n_nodes < 2:
        raise ValueError("layered needs n_nodes >= 2")
    n_layers = max(1, min(n_layers, n_nodes))
    wf, rng = _new_workflow("layered", seed, tenant)
    # non-empty layer sizes summing to n_nodes
    cuts = np.sort(rng.choice(np.arange(1, n_nodes), size=n_layers - 1,
                              replace=False)) if n_layers > 1 else np.array([], int)
    bounds = [0, *cuts.tolist(), n_nodes]
    layers: List[List[str]] = []
    idx = 0
    for li in range(n_layers):
        layer = []
        for _ in range(bounds[li + 1] - bounds[li]):
            layer.append(_add(wf, f"f{idx:04d}", rng, profile))
            idx += 1
        layers.append(layer)
    for li in range(n_layers - 1):
        upper, lower = layers[li], layers[li + 1]
        mask = rng.random((len(upper), len(lower))) < p_edge
        for i, u in enumerate(upper):
            for j, v in enumerate(lower):
                if mask[i, j]:
                    wf.add_edge(u, v)
        # connectivity guarantees (deterministic given the rng state)
        for i, u in enumerate(upper):
            if not mask[i].any():
                wf.add_edge(u, lower[int(rng.integers(len(lower)))])
        for j, v in enumerate(lower):
            if not wf.predecessors(v):
                wf.add_edge(upper[int(rng.integers(len(upper)))], v)
    return wf


GENERATORS: Dict[str, Callable[..., Workflow]] = {
    "chain": chain_workflow,
    "fan": fan_workflow,
    "diamond": diamond_workflow,
    "layered": layered_workflow,
}


def generate(kind: str = "layered", **kw) -> Workflow:
    """Dispatch by topology family: ``generate("layered", n_nodes=64,
    seed=3)``. See :data:`GENERATORS` for the families."""
    try:
        builder = GENERATORS[kind]
    except KeyError:
        raise ValueError(
            f"unknown workflow kind {kind!r}; choose from {sorted(GENERATORS)}")
    return builder(**kw)


def degree_bucket(wf: Workflow, *, cap: int = 3) -> Tuple:
    """Coarse structural bucket: node count plus the sorted multiset of
    per-node ``(in-degree, out-degree)`` pairs, degrees capped at
    ``cap``.

    Two workflows in one bucket have the same number of functions
    playing the same *local* roles (sources, sinks, joins, fan-outs)
    even when their exact edge sets differ — the approximate matching
    key used to warm-start layered DAGs from near-twin donors when
    :func:`topology_signature` has no exact hit. Capping collapses
    "wide join" vs "wider join" into one role, which is what makes
    random layered DAGs of one (n_nodes, n_layers) family collide."""
    degs = sorted((min(len(wf.predecessors(n)), cap),
                   min(len(wf.successors(n)), cap))
                  for n in wf.nodes)
    return (len(wf), tuple(degs))


def topology_signature(wf: Workflow, *, with_profiles: bool = False
                       ) -> Tuple:
    """Hashable structural fingerprint of a workflow.

    Two workflows share a signature iff they have the same node count
    and the same edge set *under topological rank* (the deterministic
    name-tie-broken order), i.e. they are the same DAG shape — every
    ``chain_workflow(n)`` matches every other regardless of seed, every
    ``fan_workflow(w)`` matches every other, and so on. That is the
    matching key the adaptive campaign uses to warm-start a cell from a
    structurally identical, already-solved workflow.

    ``with_profiles=True`` additionally pins each node's affinity class
    (generator metadata recorded on :class:`FunctionSpec`), giving the
    strict signature under which response surfaces are drawn from the
    same distributions.
    """
    order = wf.topological_order()
    rank = {name: i for i, name in enumerate(order)}
    edges = tuple(sorted((rank[u], rank[v])
                         for u in order for v in wf.successors(u)))
    sig: Tuple = (len(order), edges)
    if with_profiles:
        sig += (tuple(getattr(wf.nodes[n].payload, "profile", "")
                      for n in order),)
    return sig


def transfer_configs(src: Workflow, configs: Dict, dst: Workflow, *,
                     approx: bool = False) -> Dict:
    """Map a per-function configuration across structurally identical
    workflows by topological rank: function ``i`` of ``src``'s order
    donates its config to function ``i`` of ``dst``'s order. Raises
    ``ValueError`` when the two workflows differ structurally (rank
    alignment would be meaningless).

    ``approx=True`` widens the match to the :func:`degree_bucket`
    fallback: workflows that are not edge-identical but have the same
    node count and local-role multiset (e.g. two random layered DAGs of
    one family) still donate by topological rank — a warm-start *guess*
    the receiving searcher refines, not a guarantee of feasibility.
    Structurally distant workflows (different bucket) still raise."""
    if topology_signature(src) != topology_signature(dst):
        if not (approx and degree_bucket(src) == degree_bucket(dst)):
            raise ValueError(
                f"cannot transfer configs: {src.name!r} and {dst.name!r} "
                f"are not structurally "
                f"{'similar' if approx else 'identical'}")
    return {d: configs[s].copy()
            for s, d in zip(src.topological_order(), dst.topological_order())}


# --------------------------------------------------------------------------
# drift schedules (the online control plane's seeded disturbance source)
# --------------------------------------------------------------------------

#: drift kinds a schedule may inject
DRIFT_KINDS = ("load", "input", "coldstart")


@dataclasses.dataclass(frozen=True)
class DriftEvent:
    """One step change in serving conditions, effective from ``epoch``
    onward (until a later event of the same kind supersedes it).

      * ``load``      — arrival-rate multiplier (``magnitude`` × the
        spec's base Poisson rate),
      * ``input``     — input-class mix shift: the backend's
        ``input_scale`` becomes ``magnitude`` (work and working sets
        grow together, §IV-D),
      * ``coldstart`` — provisioning-regime change: cold-start delay
        becomes ``magnitude`` seconds and warm keep-alive becomes
        ``keep_alive_s`` (when given).
    """

    epoch: int
    kind: str
    magnitude: float
    keep_alive_s: Optional[float] = None

    def __post_init__(self) -> None:
        if self.kind not in DRIFT_KINDS:
            raise ValueError(
                f"unknown drift kind {self.kind!r}; choose from {DRIFT_KINDS}")
        if self.epoch < 0:
            raise ValueError("drift epoch must be >= 0")
        if self.kind == "coldstart":
            # a zero provisioning delay is a legal regime
            if self.magnitude < 0:
                raise ValueError("drift magnitude must be >= 0")
        elif self.magnitude <= 0:
            # a zero rate/input multiplier has no serving semantics and
            # would only surface as an arrival-process error mid-epoch
            raise ValueError(f"{self.kind} drift magnitude must be > 0")


@dataclasses.dataclass(frozen=True)
class EpochConditions:
    """Resolved serving conditions for one epoch."""

    rate_scale: float = 1.0
    input_scale: float = 1.0
    cold_delay_s: Optional[float] = None      # None: keep the spec's model
    cold_keep_alive_s: Optional[float] = None

    @property
    def baseline(self) -> bool:
        return (self.rate_scale == 1.0 and self.input_scale == 1.0
                and self.cold_delay_s is None
                and self.cold_keep_alive_s is None)


@dataclasses.dataclass(frozen=True)
class DriftSchedule:
    """A deterministic disturbance script over serving epochs.

    Events are step functions: the latest event of each kind at or
    before an epoch defines that epoch's conditions. An empty schedule
    is the static (no-drift) regime — :func:`conditions` returns the
    baseline for every epoch, which is what makes the online control
    plane's no-drift run bit-identical to a static replay."""

    events: Tuple[DriftEvent, ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "events", tuple(
            sorted(self.events, key=lambda e: (e.epoch, e.kind))))

    @property
    def empty(self) -> bool:
        return not self.events

    def conditions(self, epoch: int) -> EpochConditions:
        cond: Dict[str, object] = {}
        for ev in self.events:                   # sorted by epoch
            if ev.epoch > epoch:
                break
            if ev.kind == "load":
                cond["rate_scale"] = ev.magnitude
            elif ev.kind == "input":
                cond["input_scale"] = ev.magnitude
            else:
                cond["cold_delay_s"] = ev.magnitude
                if ev.keep_alive_s is not None:
                    cond["cold_keep_alive_s"] = ev.keep_alive_s
        return EpochConditions(**cond)

    def regime(self, epoch: int) -> int:
        """How many events have taken effect by ``epoch`` — a counter
        that steps exactly when conditions change, used by the online
        controller to re-arm cells after each new disturbance."""
        return sum(1 for ev in self.events if ev.epoch <= epoch)


def load_shift_schedule(epoch: int, factor: float) -> DriftSchedule:
    """Arrival rate jumps to ``factor``× at ``epoch`` (load drift)."""
    return DriftSchedule((DriftEvent(epoch, "load", factor),))


def input_mix_schedule(epoch: int, scale: float) -> DriftSchedule:
    """Input-class mix shifts so the mean input scale becomes ``scale``
    at ``epoch`` (bigger payloads: more work, bigger working sets)."""
    return DriftSchedule((DriftEvent(epoch, "input", scale),))


def coldstart_schedule(epoch: int, delay_s: float,
                       keep_alive_s: Optional[float] = None) -> DriftSchedule:
    """Provisioning regime changes at ``epoch`` (e.g. a platform update
    makes cold starts slower and containers shorter-lived)."""
    return DriftSchedule((DriftEvent(epoch, "coldstart", delay_s,
                                     keep_alive_s=keep_alive_s),))


def random_drift_schedule(n_epochs: int, *, seed: int = 0,
                          n_events: int = 2,
                          kinds: Sequence[str] = ("load", "input"),
                          load_range: Tuple[float, float] = (1.5, 3.0),
                          input_range: Tuple[float, float] = (1.2, 1.8),
                          cold_range: Tuple[float, float] = (0.5, 3.0)
                          ) -> DriftSchedule:
    """Seeded random disturbance script: ``n_events`` step changes at
    distinct epochs in ``[1, n_epochs)``, kinds cycled from ``kinds``,
    magnitudes drawn uniformly from the per-kind range. The same seed
    reproduces the same schedule, like every other generator here."""
    if n_epochs < 2 or n_events < 1:
        return DriftSchedule()
    rng = np.random.default_rng(seed)
    n_events = min(n_events, n_epochs - 1)
    epochs = sorted(int(e) for e in rng.choice(
        np.arange(1, n_epochs), size=n_events, replace=False))
    ranges = {"load": load_range, "input": input_range,
              "coldstart": cold_range}
    events = []
    for i, epoch in enumerate(epochs):
        kind = kinds[i % len(kinds)]
        events.append(DriftEvent(epoch, kind,
                                 float(rng.uniform(*ranges[kind]))))
    return DriftSchedule(tuple(events))


def suggest_slo(wf: Workflow, *, slack: float = 1.5,
                input_scale: float = 1.0) -> float:
    """An achievable SLO for a generated workflow: ``slack`` x the
    end-to-end latency at the over-provisioned base config (every node
    keeps its default ``ResourceConfig``, which is the base config).
    Evaluates on a copy — the caller's measured runtimes are untouched."""
    from repro_torch.serverless.platform import AnalyticBackend

    probe = wf.copy()
    backend = AnalyticBackend(input_scale=input_scale)
    runtimes, failed = backend.invoke_batch(list(probe))
    if failed.any():
        raise ValueError("workflow OOMs even at the base config")
    for node, rt in zip(probe, runtimes):
        node.runtime = float(rt)
    return slack * probe.end_to_end_latency()
