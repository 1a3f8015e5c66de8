"""Workflow DAG abstraction for AARC.

A workflow is a DAG of *functions* (nodes). Each node owns a mutable
``ResourceConfig`` and, once the workflow has been executed under that
config, a measured ``runtime``. The DAG supports:

  * topological execution against a pluggable runtime oracle
    (``Workflow.execute``) — node weights become measured runtimes,
  * end-to-end latency = longest path (parallel branches overlap),
  * the graph queries used by Algorithm 1 (critical path, detour
    sub-paths) which live in :mod:`repro_torch.core.critical_path`.

The oracle is any callable ``node -> runtime_seconds`` so the same DAG
machinery drives the serverless simulator, a real-measurement backend,
or the TPU roofline backend.

Cycle safety: ``add_edge`` maintains a Pearce–Kelly incremental
topological index. Edges that respect the current order are accepted in
O(1); only order-violating edges trigger a search bounded by the
affected region, so building a 1k-node layered DAG (generator use
case) is linear instead of quadratic while a cycle still raises
``ValueError`` at insertion time.

The port's copy of ``src/repro/core/dag.py`` (lines 1-258), numpy and
plain Python as there, so that its float operations run in the same
order.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Dict, Iterator, List, Optional, Sequence

from repro_torch.core.resources import ResourceConfig

RuntimeOracle = Callable[["Node"], float]


@dataclasses.dataclass
class Node:
    """One function in a serverless workflow (or one stage in a step graph)."""

    name: str
    config: ResourceConfig = dataclasses.field(default_factory=ResourceConfig)
    runtime: float = 0.0          # seconds, measured under ``config``
    scheduled: bool = False       # Algorithm 1's "scheduled" flag
    failed: bool = False          # last invocation under ``config`` errored
    fail_reason: str = ""         # diagnostic from the failing backend
    payload: object = None        # backend-specific (e.g. FunctionSpec)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Node({self.name}, cfg={self.config}, rt={self.runtime:.3f})"


class Workflow:
    """A DAG of named nodes with adjacency maintained both ways."""

    def __init__(self, name: str = "workflow", *,
                 tenant: Optional[str] = None):
        self.name = name
        #: tenant id for shared-cluster serving. Generated workflow
        #: names (``f"{kind}-{seed}"``) are not unique across the cells
        #: of a campaign grid — two (workflow, SLO) cells can serve the
        #: same template at different configurations. Anything keyed by
        #: workflow inside a *shared* engine (warm-container pools,
        #: per-function queue ledgers) must therefore key on
        #: :attr:`identity`, which is the tenant id when set and the
        #: name otherwise.
        self.tenant = tenant
        self.nodes: Dict[str, Node] = {}
        self._succ: Dict[str, List[str]] = {}
        self._pred: Dict[str, List[str]] = {}
        self._ord: Dict[str, int] = {}     # Pearce–Kelly topological index
        self._topo: Optional[List[str]] = None   # cached topological order

    # -- construction -------------------------------------------------
    def add_node(self, node: Node) -> Node:
        if node.name in self.nodes:
            raise ValueError(f"duplicate node {node.name!r}")
        self.nodes[node.name] = node
        self._succ[node.name] = []
        self._pred[node.name] = []
        self._ord[node.name] = len(self._ord)
        self._topo = None
        return node

    def add_function(self, name: str, payload: object = None,
                     config: Optional[ResourceConfig] = None) -> Node:
        return self.add_node(Node(name=name, payload=payload,
                                  config=config or ResourceConfig()))

    def add_edge(self, src: str, dst: str) -> None:
        if src not in self.nodes or dst not in self.nodes:
            raise KeyError(f"unknown edge endpoint {src!r}->{dst!r}")
        if src == dst:
            raise ValueError(f"edge {src}->{dst} would create a cycle")
        if dst in self._succ[src]:
            return
        self._topo = None
        self._succ[src].append(dst)
        self._pred[dst].append(src)
        if self._ord[src] > self._ord[dst]:
            # order violated: repair the affected region, or reject
            try:
                self._reorder(src, dst)
            except ValueError:
                self._succ[src].remove(dst)
                self._pred[dst].remove(src)
                raise

    def _reorder(self, src: str, dst: str) -> None:
        """Pearce–Kelly: restore the topological index after inserting
        ``src``->``dst`` with ord[src] > ord[dst]. Only nodes whose
        index lies in the affected window [ord[dst], ord[src]] are
        visited; finding ``src`` forward of ``dst`` means a cycle."""
        lo, hi = self._ord[dst], self._ord[src]
        fwd: List[str] = []                 # reachable from dst within window
        stack, seen = [dst], set()
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            if cur == src:
                raise ValueError(f"edge {src}->{dst} would create a cycle")
            fwd.append(cur)
            stack.extend(s for s in self._succ[cur] if self._ord[s] <= hi)
        bwd: List[str] = []                 # nodes reaching src within window
        stack, seen = [src], set()
        while stack:
            cur = stack.pop()
            if cur in seen:
                continue
            seen.add(cur)
            bwd.append(cur)
            stack.extend(p for p in self._pred[cur] if self._ord[p] >= lo)
        # reassign the affected indices: everything reaching src first
        # (keeping relative order), then everything reachable from dst
        slots = sorted(self._ord[n] for n in bwd + fwd)
        bwd.sort(key=self._ord.__getitem__)
        fwd.sort(key=self._ord.__getitem__)
        for slot, name in zip(slots, bwd + fwd):
            self._ord[name] = slot

    def chain(self, *names: str) -> None:
        for a, b in zip(names, names[1:]):
            self.add_edge(a, b)

    # -- queries ------------------------------------------------------
    def successors(self, name: str) -> Sequence[str]:
        return tuple(self._succ[name])

    def predecessors(self, name: str) -> Sequence[str]:
        return tuple(self._pred[name])

    def sources(self) -> List[str]:
        return [n for n in self.nodes if not self._pred[n]]

    def sinks(self) -> List[str]:
        return [n for n in self.nodes if not self._succ[n]]

    def __iter__(self) -> Iterator[Node]:
        return iter(self.nodes.values())

    def __len__(self) -> int:
        return len(self.nodes)

    def validate(self) -> None:
        """Full acyclicity check (Kahn). ``add_edge`` already rejects
        cycles incrementally; this re-verifies from scratch, e.g. after
        direct ``_succ``/``_pred`` surgery in tests or ``copy()`` — and
        rebuilds the incremental index so later ``add_edge`` calls see
        a consistent order even after such surgery."""
        self._topo = None
        order = self.topological_order()
        self._ord = {name: i for i, name in enumerate(order)}

    def topological_order(self) -> List[str]:
        """Deterministic (name-tie-broken) topological order. The order
        only depends on graph *structure*, so it is cached between
        structural mutations — ``end_to_end_latency`` is called once per
        search sample and dominates trace bookkeeping otherwise."""
        if self._topo is not None:
            return list(self._topo)
        self._topo = self._compute_topo()
        return list(self._topo)

    def _compute_topo(self) -> List[str]:
        indeg = {n: len(self._pred[n]) for n in self.nodes}
        ready = [n for n, d in indeg.items() if d == 0]
        heapq.heapify(ready)                # deterministic: name order
        order: List[str] = []
        while ready:
            cur = heapq.heappop(ready)
            order.append(cur)
            for s in self._succ[cur]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    heapq.heappush(ready, s)
        if len(order) != len(self.nodes):
            raise ValueError("workflow graph has a cycle")
        return order

    # -- execution ----------------------------------------------------
    def execute(self, oracle: RuntimeOracle) -> float:
        """Execute every node through ``oracle`` and return the
        end-to-end latency (longest weighted path, i.e. parallel
        branches run concurrently as on a real FaaS platform)."""
        for node in self.nodes.values():
            node.runtime = float(oracle(node))
            node.failed = False
            node.fail_reason = ""
        return self.end_to_end_latency()

    def end_to_end_latency(self) -> float:
        """Longest path through the DAG using current node runtimes."""
        finish: Dict[str, float] = {}
        for name in self.topological_order():
            start = max((finish[p] for p in self._pred[name]), default=0.0)
            finish[name] = start + self.nodes[name].runtime
        return max(finish.values(), default=0.0)

    def path_latency(self, path: Sequence[str]) -> float:
        return sum(self.nodes[n].runtime for n in path)

    # -- bookkeeping ---------------------------------------------------
    def configs(self) -> Dict[str, ResourceConfig]:
        return {n.name: n.config.copy() for n in self.nodes.values()}

    def apply_configs(self, configs: Dict[str, ResourceConfig]) -> None:
        for name, cfg in configs.items():
            self.nodes[name].config = cfg.copy()

    def reset_flags(self) -> None:
        for node in self.nodes.values():
            node.scheduled = False
            node.failed = False
            node.fail_reason = ""

    @property
    def identity(self) -> str:
        """Warm-pool / placement identity: the tenant id when set, else
        the workflow name. Two cells of a shared cluster serving the
        same generated template at different configurations must carry
        distinct tenants, or they would silently share warm containers
        sized for different configs."""
        return self.tenant if self.tenant is not None else self.name

    def copy(self) -> "Workflow":
        wf = Workflow(self.name, tenant=self.tenant)
        for node in self.nodes.values():
            wf.add_node(Node(name=node.name, config=node.config.copy(),
                             runtime=node.runtime, scheduled=node.scheduled,
                             failed=node.failed, fail_reason=node.fail_reason,
                             payload=node.payload))
        for src, dsts in self._succ.items():
            for dst in dsts:
                wf._succ[src].append(dst)
                wf._pred[dst].append(src)
        wf._ord = dict(self._ord)
        wf._topo = list(self._topo) if self._topo is not None else None
        return wf
