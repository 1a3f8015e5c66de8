"""Vectorized campaign search plane — lockstep grid search over cells.

A campaign evaluates a grid of (workflow, SLO, searcher) *cells*. The
sequential plane walks them one at a time; every cell's search loop
then pays its own backend dispatch per sample. This module advances
ALL cells in lockstep instead: each searcher exposes its loop as a
**plan** — a generator that yields typed evaluation requests and
receives results — and :func:`run_grid_search` drains one request per
active cell per round, fusing the round's probes into single
response-surface evaluations across cells.

The request protocol (sans-IO: plans never touch the backend):

  * :class:`ExecuteRequest`     — whole-workflow sample
    (:meth:`Environment.execute`),
  * :class:`CandidatesRequest`  — C candidate config maps
    (:meth:`Environment.execute_candidates`),
  * :class:`ProbeRequest`       — measure-only function batch
    (:meth:`Environment.probe_function_batch`),
  * :class:`InvokeRequest`      — one scalar function trial
    (:meth:`Environment.execute_function`),
  * :class:`TrialRequest`       — commit one pre-measured trial
    (:meth:`Environment.apply_function_trial`).

:func:`drive_plan` serves a single plan against its own environment —
this IS the sequential path: ``Searcher.search``/``resume`` drive the
very same generators, so lockstep traces are bit-identical to
sequential traces *by construction* (one implementation, two drivers).

Fusion contract: cells whose backends return equal
``grid_fusion_key()`` values (see :class:`repro_torch.core.backend
.BaseBackend`) share one noise-free ``surface_probe`` per round;
per-cell invocation noise and counters are then applied through each
cell's own backend in the exact shapes the sequential calls would have
used, so stochastic (``batch_safe``) backends stay stream-identical.
A fused row that *fails* (OOM below the working-set floor) is
committed in place: the sequential batch pipeline leaves failed rows
at their deterministic thrash runtime (the noise ``where`` mask skips
them, and the scalar invoke raises *before* its draw), so no rng state
diverges, and the backend's ``surface_floor`` reconstructs the exact
``fail_reason`` strings ``invoke_batch`` / the scalar
``ExecutionError`` would have stamped — no sequential re-serve, no
double evaluation. Cells that cannot join the lockstep at all — searcher
without a plan, cells sharing one Environment (single trace), or a
stochastic backend shared across cells (interleaved draws would
diverge from the sequential stream) — are *serialized* through their
plain ``search()`` with an explicit reason, mirroring
``FleetEngine.batch_eligibility``.

Commit vectorization: structurally identical cells (same node names,
edges, and topological order — the refinement of
``topology_signature`` equality actually required for bit-identity)
additionally share one vectorized longest-path / pricing fold per
round, replacing per-cell Python commits with ``(G, n)`` array folds
that perform the same IEEE operations in the same order.

The port's copy of ``src/repro/core/gridsearch.py``, with one change:
the reference prices both vectorized commits with one left fold, but
a single-function trial's scalar path sums with the builtin ``sum``
(``workflow_cost``), which rounds differently on Python 3.12. Trial
commits here sum as ``sum`` does (:func:`_vec_cost`); whole-workflow
commits keep the left fold of their own scalar path
(:func:`_vec_fold_cost`).
"""
from __future__ import annotations

import dataclasses
import logging
import math
import time
from collections import defaultdict
from typing import (Any, Callable, Dict, Generator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np

from repro_torch.core.dag import Node, Workflow
from repro_torch.core.env import Environment, Sample
from repro_torch.core.resources import ResourceConfig

logger = logging.getLogger(__name__)

#: fuse a backend group only when at least this many cells share it —
#: below the crossover, per-cell serving is cheaper than the fused
#: gather/slice bookkeeping.
MIN_FUSE = 2
#: vectorize a structure group's commits only at this many cells —
#: below it, the per-cell Python commit beats (G, n) array assembly.
MIN_VEC_COMMIT = 4


# ---------------------------------------------------------------------------
# request protocol
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ExecuteRequest:
    """Execute the whole workflow under its current configs."""
    wf: Workflow
    slo: float
    note: str = ""


@dataclasses.dataclass
class CandidatesRequest:
    """Evaluate C candidate config maps for one workflow topology."""
    wf: Workflow
    candidates: Sequence[Dict[str, ResourceConfig]]
    slo: float
    note: str = ""


@dataclasses.dataclass
class ProbeRequest:
    """Measure a batch of function invocations, committing nothing."""
    nodes: Sequence[Node]


@dataclasses.dataclass
class InvokeRequest:
    """Re-invoke one function scalar-path and commit the trial."""
    wf: Workflow
    node: Node
    slo: float
    note: str = ""


@dataclasses.dataclass
class TrialRequest:
    """Commit one pre-measured invocation and record the sample."""
    wf: Workflow
    node: Node
    rt: float
    error: bool
    slo: float
    note: str = ""


Request = Union[ExecuteRequest, CandidatesRequest, ProbeRequest,
                InvokeRequest, TrialRequest]

#: a searcher plan: yields requests, returns its final value
PlanGen = Generator[Request, Any, Any]


@dataclasses.dataclass
class GridPlan:
    """A plan generator bound to the environment that serves it."""
    env: Environment
    gen: PlanGen


def serve_request(env: Environment, req: Request):
    """Serve one request through the sequential Environment paths."""
    if isinstance(req, TrialRequest):
        return env.apply_function_trial(req.wf, req.node, req.rt, req.error,
                                        req.slo, note=req.note)
    if isinstance(req, ExecuteRequest):
        return env.execute(req.wf, req.slo, note=req.note)
    if isinstance(req, ProbeRequest):
        return env.probe_function_batch(req.nodes)
    if isinstance(req, InvokeRequest):
        return env.execute_function(req.wf, req.node, req.slo, note=req.note)
    if isinstance(req, CandidatesRequest):
        return env.execute_candidates(req.wf, req.candidates, req.slo,
                                      note=req.note)
    raise TypeError(f"unknown grid request: {req!r}")


def drive_plan(plan: GridPlan):
    """Run one plan to completion sequentially; return its result.

    This is the scalar driver — ``Searcher.search``/``resume`` route
    through it, so a plan driven here produces the legacy sequential
    trace bit-for-bit (same environment calls in the same order).
    """
    gen, env = plan.gen, plan.env
    try:
        req = next(gen)
        while True:
            req = gen.send(serve_request(env, req))
    except StopIteration as stop:
        return stop.value


# ---------------------------------------------------------------------------
# grid cells and eligibility
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GridCell:
    """One (searcher, workflow, SLO) cell of a search campaign."""
    searcher: Any
    wf: Workflow
    slo: float


@dataclasses.dataclass
class GridResume:
    """One resumed cell: continue ``state`` by ``extra_budget`` samples."""
    searcher: Any
    state: Any                   # repro_torch.core.search.ResumeState
    extra_budget: int


@dataclasses.dataclass
class CellEligibility:
    """Why a cell did (not) join the lockstep plane — mirrors
    ``FleetEngine.batch_eligibility``: ineligible cells run their plain
    sequential search with the reasons recorded instead of silently."""
    index: int
    searcher: str
    workflow: str
    eligible: bool
    fusable: bool                # backend advertises a grid fusion key
    reasons: Tuple[str, ...] = ()


@dataclasses.dataclass
class GridReport:
    """What one lockstep grid search did."""
    results: List[Any]           # SearchResult per cell, input order
    eligibility: List[CellEligibility]
    rounds: int = 0
    fused_evaluations: int = 0   # fused surface calls served
    serialized_cells: int = 0    # cells that ran sequentially
    wall_time_s: float = 0.0


@dataclasses.dataclass
class _Cell:
    """Internal per-cell lockstep state."""
    index: int
    env: Environment
    gen: PlanGen
    fallback: Callable[[], Any]
    fusion_key: Optional[tuple]
    struct_key: Optional[tuple] = None
    nodes: Optional[List[Node]] = None   # cached wf node list (trial commits)
    #: cached (wf_id, surface_tables) — spec constants are immutable,
    #: so whole-workflow fusions need not re-gather them every round
    tables: Optional[Tuple[int, tuple]] = None
    #: True once any failure state (``failed`` / ``fail_reason``) was
    #: stamped on this cell's nodes; until then the vectorized execute
    #: commit can skip the per-node failure resets (they are no-ops)
    fail_dirty: bool = False
    #: incremental whole-workflow config gather:
    #: ``[wf_id, cfgs, cpu_arr, mem_arr, items]`` where ``cfgs`` holds
    #: the node configs the arrays/capture triples were built from.
    #: Searchers replace a node's config rather than mutating it
    #: (``ResourceConfig.copy``/``with_delta``), so between execute
    #: rounds almost every entry is identity-equal and the re-gather
    #: cost drops from O(nodes) attribute reads to O(changes)
    cfg_cache: Optional[list] = None
    pending: Any = None
    started: bool = False


def _structure_key(wf: Workflow) -> tuple:
    """Exact commit-structure key: equal keys guarantee identical node
    naming, insertion order, topological order and predecessor lists —
    what the vectorized (G, n) commit folds actually require. This
    refines ``topology_signature`` equality (which is rank-structural
    and ignores names/insertion order)."""
    topo = tuple(wf.topological_order())
    return (tuple(wf.nodes), topo,
            tuple(tuple(wf.predecessors(name)) for name in topo))


def _cell_label(item: Union[GridCell, GridResume]) -> Tuple[str, str]:
    # identity (tenant id when set, else name) keeps eligibility rows
    # unambiguous when a campaign grid repeats one generated template
    if isinstance(item, GridResume):
        return (item.state.searcher, item.state.wf.identity)
    return (getattr(item.searcher, "name", type(item.searcher).__name__),
            item.wf.identity)


def grid_eligibility(cells: Sequence[Union[GridCell, GridResume, tuple]]
                     ) -> List[CellEligibility]:
    """Dry-run eligibility: which cells would join the lockstep plane
    and why the rest would serialize. Shares the decision logic with
    :func:`run_grid_search` (same checks, no sampling)."""
    items = [_coerce_item(c) for c in cells]
    report, _ = _plan_cells(items)
    return report


def _coerce_item(c) -> Union[GridCell, GridResume]:
    if isinstance(c, (GridCell, GridResume)):
        return c
    searcher, wf, slo = c
    return GridCell(searcher=searcher, wf=wf, slo=slo)


def _plan_cells(items: Sequence[Union[GridCell, GridResume]]
                ) -> Tuple[List[CellEligibility], List[Optional[_Cell]]]:
    """Build plan state for every eligible cell + the eligibility report.

    Ineligible cells get ``None`` in the state list; their reasons are
    in the report and :func:`run_grid_search` serves them through their
    sequential entry point in input order.
    """
    report: List[CellEligibility] = []
    states: List[Optional[_Cell]] = []
    plans: List[Optional[GridPlan]] = []
    reasons_by_idx: Dict[int, List[str]] = defaultdict(list)

    for i, item in enumerate(items):
        searcher = item.searcher
        if isinstance(item, GridResume):
            if not callable(getattr(searcher, "plan_resume", None)):
                reasons_by_idx[i].append(
                    "searcher exposes no plan_resume() (no lockstep "
                    "support)")
                plans.append(None)
                continue
            plans.append(searcher.plan_resume(item.state, item.extra_budget))
        else:
            if not callable(getattr(searcher, "plan", None)):
                reasons_by_idx[i].append(
                    "searcher exposes no plan() (no lockstep support)")
                plans.append(None)
                continue
            plans.append(searcher.plan(item.wf, item.slo))

    # cells sharing one Environment share one trace: lockstep would
    # interleave their samples; cells sharing one *stochastic* backend
    # would interleave rng draws. Both serialize, explainably.
    env_owners: Dict[int, List[int]] = defaultdict(list)
    backend_owners: Dict[int, List[int]] = defaultdict(list)
    for i, plan in enumerate(plans):
        if plan is None:
            continue
        env_owners[id(plan.env)].append(i)
        backend_owners[id(plan.env.backend)].append(i)
    for owners in env_owners.values():
        if len(owners) > 1:
            for i in owners:
                reasons_by_idx[i].append(
                    "cells share one Environment instance (single trace)")
    for owners in backend_owners.values():
        if len(owners) > 1:
            backend = plans[owners[0]].env.backend
            if not getattr(backend, "deterministic", False):
                for i in owners:
                    if not reasons_by_idx[i]:
                        reasons_by_idx[i].append(
                            "stochastic backend shared across cells "
                            "(interleaved draws diverge from the "
                            "sequential stream)")

    for i, item in enumerate(items):
        name, wf_name = _cell_label(item)
        reasons = tuple(reasons_by_idx.get(i, ()))
        plan = plans[i]
        eligible = plan is not None and not reasons
        fusion_key = None
        if eligible:
            fusion_key = getattr(plan.env.backend, "grid_fusion_key",
                                 lambda: None)()
        report.append(CellEligibility(
            index=i, searcher=name, workflow=wf_name, eligible=eligible,
            fusable=fusion_key is not None, reasons=reasons))
        if not eligible:
            states.append(None)
            continue
        if isinstance(item, GridResume):
            fallback = (lambda s=item.searcher, st=item.state,
                        b=item.extra_budget: s.resume(st, b))
        else:
            fallback = (lambda s=item.searcher, w=item.wf,
                        o=item.slo: s.search(w, o))
        states.append(_Cell(index=i, env=plan.env, gen=plan.gen,
                            fallback=fallback, fusion_key=fusion_key))
    return report, states


# ---------------------------------------------------------------------------
# the lockstep driver
# ---------------------------------------------------------------------------

def run_grid_search(cells: Sequence[Union[GridCell, GridResume, tuple]],
                    *, min_fuse: int = MIN_FUSE,
                    progress: Optional[Callable[[int, Any], None]] = None
                    ) -> GridReport:
    """Advance every cell's search in lockstep rounds, fusing each
    round's probes across cells into single response-surface
    evaluations. Per-cell traces are bit-identical to the sequential
    ``Searcher.search``/``resume`` loops (one plan implementation,
    shared commit code, per-cell noise streams).

    ``cells`` mixes :class:`GridCell` (fresh searches),
    :class:`GridResume` (grant continuations) and bare
    ``(searcher, wf, slo)`` tuples. Ineligible cells are served
    sequentially in input order with reasons in the report.
    """
    t0 = time.perf_counter()
    items = [_coerce_item(c) for c in cells]
    report, states = _plan_cells(items)
    results: List[Any] = [None] * len(items)

    fallback_reasons = sorted({e.reasons for e in report if e.reasons})
    if fallback_reasons:
        logger.info(
            "grid search: %d/%d cells serialized: %s",
            sum(1 for e in report if not e.eligible), len(items),
            "; ".join(", ".join(r) for r in fallback_reasons))

    driver = _RoundDriver(min_fuse=min_fuse)
    active: Dict[int, _Cell] = {c.index: c for c in states if c is not None}
    rounds = 0
    while active:
        rounds += 1
        round_reqs: List[Tuple[_Cell, Request]] = []
        for idx in list(active):
            cell = active[idx]
            try:
                if not cell.started:
                    cell.started = True
                    req = next(cell.gen)
                else:
                    req = cell.gen.send(cell.pending)
            except StopIteration as stop:
                results[idx] = stop.value
                del active[idx]
                if progress is not None:
                    progress(idx, stop.value)
                continue
            cell.pending = None
            round_reqs.append((cell, req))
        if round_reqs:
            driver.serve_round(round_reqs)

    serialized = 0
    for i, state in enumerate(states):
        if state is not None:
            continue
        serialized += 1
        item = items[i]
        if isinstance(item, GridResume):
            results[i] = item.searcher.resume(item.state, item.extra_budget)
        else:
            results[i] = item.searcher.search(item.wf, item.slo)
        if progress is not None:
            progress(i, results[i])

    return GridReport(results=results, eligibility=report, rounds=rounds,
                      fused_evaluations=driver.fused_evaluations,
                      serialized_cells=serialized,
                      wall_time_s=time.perf_counter() - t0)


@dataclasses.dataclass
class _FusedSurface:
    """One fused noise-free surface evaluation over a cell group.

    ``floor()`` lazily reconstructs the per-node OOM thresholds (see
    ``AnalyticBackend.surface_floor``) so failed rows can be committed
    in place — with byte-equal failure strings — instead of re-serving
    the whole cell sequentially."""
    cpu: np.ndarray
    mem: np.ndarray
    runtimes: np.ndarray
    failed: np.ndarray
    counts: List[int]
    backend: Any
    tables: Tuple[np.ndarray, ...]
    _floor: Optional[np.ndarray] = None

    def floor(self) -> np.ndarray:
        if self._floor is None:
            self._floor = self.backend.surface_floor(self.tables)
        return self._floor

    def fail_string(self, name: str, i: int) -> str:
        """The exact OOM message ``invoke_batch`` (node name) or the
        scalar ``FunctionSpec.mem_factor`` raise (spec name) would have
        produced for global row ``i``."""
        return (f"{name}: OOM ({self.mem[i]:.0f} MB < working set "
                f"{self.floor()[i]:.0f} MB)")


class _RoundDriver:
    """Serves one lockstep round: groups the round's requests by kind
    and backend fusion key, runs fused surface evaluations, and commits
    per cell (vectorized per structure group where it pays)."""

    def __init__(self, *, min_fuse: int = MIN_FUSE):
        self.min_fuse = max(2, min_fuse)
        self.fused_evaluations = 0
        self._plans: Dict[tuple, _StructPlan] = {}
        #: fusion key -> (group membership, concatenated spec tables)
        self._tables_cache: Dict[tuple, Tuple[tuple, tuple]] = {}

    def _struct_plan(self, key: tuple, wf: Workflow) -> _StructPlan:
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = _StructPlan(wf)
        return plan

    def serve_round(self, round_reqs: Sequence[Tuple[_Cell, Request]]
                    ) -> None:
        buckets: Dict[type, List[Tuple[_Cell, Request]]] = defaultdict(list)
        for cell, req in round_reqs:
            buckets[type(req)].append((cell, req))
        for kind, batch in buckets.items():
            if kind is TrialRequest:
                self._serve_trials(batch)
            elif kind is ExecuteRequest:
                self._serve_executes(batch)
            elif kind is ProbeRequest:
                self._serve_probes(batch)
            elif kind is InvokeRequest:
                self._serve_invokes(batch)
            elif kind is CandidatesRequest:
                self._serve_candidates(batch)
            else:                      # pragma: no cover - defensive
                for cell, req in batch:
                    cell.pending = serve_request(cell.env, req)

    # -- shared fusion plumbing ----------------------------------------
    def _fusion_groups(self, batch: Sequence[Tuple[_Cell, Request]]
                       ) -> Tuple[List[Tuple[_Cell, Request]],
                                  List[List[Tuple[_Cell, Request]]]]:
        """Split a request batch into per-cell leftovers and fusable
        groups of at least ``min_fuse`` cells sharing a fusion key."""
        by_key: Dict[tuple, List[Tuple[_Cell, Request]]] = defaultdict(list)
        singles: List[Tuple[_Cell, Request]] = []
        for cell, req in batch:
            if cell.fusion_key is None:
                singles.append((cell, req))
            else:
                by_key[cell.fusion_key].append((cell, req))
        groups: List[List[Tuple[_Cell, Request]]] = []
        for group in by_key.values():
            if len(group) >= self.min_fuse:
                groups.append(group)
            else:
                singles.extend(group)
        return singles, groups

    def _fused_surface(self, group: Sequence[Tuple[_Cell, Request]],
                       nodes_per: Sequence[Sequence[Node]],
                       whole_wf: bool = False) -> "_FusedSurface":
        """One noise-free surface call for every cell's nodes at their
        CURRENT configs. ``whole_wf`` marks requests over a cell's full
        node list (Execute), whose immutable spec-constant tables are
        cached per cell instead of re-gathered every round."""
        counts = [len(nodes) for nodes in nodes_per]
        rep = group[0][0].env.backend
        if whole_wf:
            parts = []
            cpu_parts = []
            mem_parts = []
            for (cell, req), nodes in zip(group, nodes_per):
                wf_id = id(req.wf)
                if cell.tables is None or cell.tables[0] != wf_id:
                    cell.tables = (wf_id,
                                   cell.env.backend.surface_tables(nodes))
                parts.append(cell.tables[1])
                cache = self._cell_configs(cell, wf_id, nodes)
                cpu_parts.append(cache[2])
                mem_parts.append(cache[3])
            cpu = np.concatenate(cpu_parts)
            mem = np.concatenate(mem_parts)
            if len(parts) == 1:
                tables = parts[0]
            else:
                # spec tables are immutable, so the concatenation only
                # depends on group membership — cache it across rounds
                # (one slot per fusion key; membership shrinks slowly)
                gkey = tuple(id(p) for p in parts)
                slot = group[0][0].fusion_key
                hit = self._tables_cache.get(slot)
                if hit is None or hit[0] != gkey:
                    hit = (gkey, tuple(
                        np.concatenate([p[f] for p in parts])
                        for f in range(len(parts[0]))))
                    self._tables_cache[slot] = hit
                tables = hit[1]
        else:
            all_nodes: List[Node] = []
            for nodes in nodes_per:
                all_nodes.extend(nodes)
            cfgs = [node.config for node in all_nodes]
            cpu = np.asarray([c.cpu for c in cfgs])
            mem = np.asarray([c.mem for c in cfgs])
            tables = rep.surface_tables(all_nodes)
        runtimes, failed = rep.surface_probe(cpu, mem, tables)
        self.fused_evaluations += 1
        return _FusedSurface(cpu=cpu, mem=mem, runtimes=runtimes,
                             failed=failed, counts=counts, backend=rep,
                             tables=tables)

    @staticmethod
    def _cell_configs(cell: _Cell, wf_id: int, nodes: Sequence[Node]) -> list:
        """Refresh (incrementally) the cell's whole-workflow config
        gather: cpu/mem arrays plus the trace-capture triples. Unchanged
        nodes are recognized by config identity (searchers replace
        configs, they don't mutate them); replaced-but-equal configs
        compare by value, so only genuinely changed entries are
        re-read."""
        cache = cell.cfg_cache
        if cache is None or cache[0] != wf_id:
            cfgs = [node.config for node in nodes]
            cell.cfg_cache = cache = [
                wf_id, cfgs,
                np.array([c.cpu for c in cfgs]),
                np.array([c.mem for c in cfgs]),
                [(node.name, c.cpu, c.mem)
                 for node, c in zip(nodes, cfgs)]]
            return cache
        old = cache[1]
        cfgs = [node.config for node in nodes]
        carr, marr, items = cache[2], cache[3], cache[4]
        for j, a in enumerate(cfgs):
            b = old[j]
            if a is b:
                continue
            if a.cpu != b.cpu or a.mem != b.mem:
                carr[j] = a.cpu
                marr[j] = a.mem
                items[j] = (nodes[j].name, a.cpu, a.mem)
        cache[1] = cfgs
        return cache

    @staticmethod
    def _count_invocations(env: Environment, n: int) -> None:
        backend = env.backend
        if hasattr(backend, "invocations"):
            backend.invocations += n

    # -- ExecuteRequest -------------------------------------------------
    def _serve_executes(self, batch: Sequence[Tuple[_Cell, Request]]) -> None:
        singles, groups = self._fusion_groups(batch)
        for cell, req in singles:
            cell.pending = cell.env.execute(req.wf, req.slo, note=req.note)
            cell.fail_dirty = bool(cell.pending.error)
        for group in groups:
            nodes_per = [list(req.wf) for _, req in group]
            fs = self._fused_surface(group, nodes_per, whole_wf=True)
            committed: List[tuple] = []
            off = 0
            for gi, ((cell, req), k) in enumerate(zip(group, fs.counts)):
                sl = slice(off, off + k)
                off += k
                bad = fs.failed[sl]
                self._count_invocations(cell.env, k)
                rt = cell.env.backend.apply_invocation_noise(
                    fs.runtimes[sl], ~bad)
                if bad.any():
                    # failed rows keep their noise-free thrash runtime
                    # (the `ok` mask above skips them, exactly like
                    # ``invoke_batch``); reconstruct its OOM strings and
                    # commit through the shared failure branch
                    nodes = nodes_per[gi]
                    for j in np.flatnonzero(bad):
                        nodes[j].fail_reason = fs.fail_string(
                            nodes[j].name, sl.start + j)
                    cell.fail_dirty = True
                    cell.pending = cell.env.execute_prepared(
                        req.wf, rt, bad, req.slo, note=req.note)
                    continue
                committed.append((cell, req, nodes_per[gi], rt, bad,
                                  fs.cpu[sl], fs.mem[sl]))
            self._commit_executes(committed)

    def _commit_executes(self, committed) -> None:
        """Commit fused whole-workflow results: vectorized longest-path
        and pricing folds per structure group (bit-identical op order),
        per-cell Python commit below the crossover."""
        by_struct: Dict[tuple, list] = defaultdict(list)
        for entry in committed:
            cell = entry[0]
            if cell.struct_key is None:
                cell.struct_key = _structure_key(entry[1].wf)
            by_struct[cell.struct_key].append(entry)
        for sgroup in by_struct.values():
            if len(sgroup) < MIN_VEC_COMMIT:
                for cell, req, _, rt, bad, _, _ in sgroup:
                    cell.pending = cell.env.execute_prepared(
                        req.wf, rt, bad, req.slo, note=req.note)
                    cell.fail_dirty = False
                continue
            self._vec_commit_executes(sgroup)

    def _vec_commit_executes(self, sgroup) -> None:
        """The (G, n) commit: same IEEE ops in the same order as
        ``Environment.execute_prepared`` for all-ok rows (cells with a
        failed row commit through ``execute_prepared``'s own failure
        branch instead)."""
        plan = self._struct_plan(sgroup[0][0].struct_key, sgroup[0][1].wf)
        rts = np.array([e[3] for e in sgroup])
        cpu = np.array([e[5] for e in sgroup])
        mem = np.array([e[6] for e in sgroup])
        for (cell, req, nodes, *_), rvals in zip(sgroup, rts.tolist()):
            if cell.fail_dirty:
                # a previous round left failure state on this cell's
                # nodes; an all-ok commit resets it, like the scalar path
                for node, r in zip(nodes, rvals):
                    node.runtime = r
                    node.failed = False
                    node.fail_reason = ""
                cell.fail_dirty = False
            else:
                # nodes are clean: the failed/fail_reason resets would be
                # no-ops, so only the runtimes need writing
                for node, r in zip(nodes, rvals):
                    node.runtime = r
        e2e = plan.e2e(rts)
        cost = _vec_fold_cost(sgroup[0][0].env.pricing, rts, cpu, mem)
        for gi, (cell, req, *_) in enumerate(sgroup):
            e = float(e2e[gi])
            # the fused-surface gather just refreshed cfg_cache, so the
            # capture triples are current; snapshot them per sample
            cell.pending = cell.env.trace.record(
                e, float(cost[gi]), req.wf, feasible=e <= req.slo,
                note=req.note,
                config_items=(tuple(cell.cfg_cache[4])
                              if cell.env.trace.capture_configs else ()))

    # -- ProbeRequest ---------------------------------------------------
    def _serve_probes(self, batch: Sequence[Tuple[_Cell, Request]]) -> None:
        singles, groups = self._fusion_groups(batch)
        for cell, req in singles:
            cell.pending = cell.env.probe_function_batch(req.nodes)
            if cell.pending[1].any():
                cell.fail_dirty = True
        for group in groups:
            nodes_per = [list(req.nodes) for _, req in group]
            fs = self._fused_surface(group, nodes_per)
            off = 0
            for gi, ((cell, req), k) in enumerate(zip(group, fs.counts)):
                sl = slice(off, off + k)
                off += k
                bad = fs.failed[sl]
                self._count_invocations(cell.env, k)
                rt = cell.env.backend.apply_invocation_noise(
                    fs.runtimes[sl], ~bad)
                if bad.any():
                    # ``invoke_batch`` stamps OOM strings on failed
                    # nodes as a side effect of a probe; replicate it
                    nodes = nodes_per[gi]
                    for j in np.flatnonzero(bad):
                        nodes[j].fail_reason = fs.fail_string(
                            nodes[j].name, sl.start + j)
                    cell.fail_dirty = True
                cell.pending = (np.asarray(rt), bad.copy())

    # -- InvokeRequest --------------------------------------------------
    def _serve_invokes(self, batch: Sequence[Tuple[_Cell, Request]]) -> None:
        singles, groups = self._fusion_groups(batch)
        for cell, req in singles:
            cell.pending = cell.env.execute_function(req.wf, req.node,
                                                     req.slo, note=req.note)
            if cell.pending.error:
                cell.fail_dirty = True
        trials: List[Tuple[_Cell, TrialRequest]] = []
        for group in groups:
            nodes_per = [[req.node] for _, req in group]
            fs = self._fused_surface(group, nodes_per)
            for i, (cell, req) in enumerate(group):
                # the scalar path increments the counter before it can
                # raise, and draws noise (one `_noise_one`) only on ok
                # invocations — failures raise pre-draw, then run the
                # deterministic clamped-thrash estimate, which equals
                # the surface's failed-row runtime bit-for-bit
                self._count_invocations(cell.env, 1)
                if fs.failed[i]:
                    req.node.fail_reason = fs.fail_string(
                        getattr(req.node.payload, "name", req.node.name), i)
                    cell.fail_dirty = True
                    trials.append((cell, TrialRequest(
                        wf=req.wf, node=req.node, rt=float(fs.runtimes[i]),
                        error=True, slo=req.slo, note=req.note)))
                    continue
                rt = cell.env.backend._noise_one(float(fs.runtimes[i]))
                trials.append((cell, TrialRequest(
                    wf=req.wf, node=req.node, rt=rt, error=False,
                    slo=req.slo, note=req.note)))
        if trials:
            self._serve_trials(trials)

    # -- TrialRequest ---------------------------------------------------
    def _serve_trials(self, batch: Sequence[Tuple[_Cell, Request]]) -> None:
        by_struct: Dict[tuple, List[Tuple[_Cell, Request]]] = \
            defaultdict(list)
        singles: List[Tuple[_Cell, Request]] = []
        for cell, req in batch:
            if cell.struct_key is None:
                cell.struct_key = _structure_key(req.wf)
            by_struct[cell.struct_key].append((cell, req))
        for sgroup in by_struct.values():
            if len(sgroup) < MIN_VEC_COMMIT:
                singles.extend(sgroup)
                continue
            self._vec_commit_trials(sgroup)
        for cell, req in singles:
            cell.pending = cell.env.apply_function_trial(
                req.wf, req.node, req.rt, req.error, req.slo, note=req.note)
            if req.error:
                cell.fail_dirty = True

    def _vec_commit_trials(self, sgroup) -> None:
        """Vectorized ``apply_function_trial`` across one structure
        group: per-cell node write, then (G, n) longest-path + pricing
        folds with the scalar path's exact op order."""
        plan = self._struct_plan(sgroup[0][0].struct_key, sgroup[0][1].wf)
        node_rows: List[List[Node]] = []
        for cell, req in sgroup:
            node = req.node
            node.runtime = float(req.rt)
            node.failed = bool(req.error)
            if node.failed:
                cell.fail_dirty = True
            else:
                node.fail_reason = ""
            if cell.nodes is None:
                cell.nodes = list(req.wf.nodes.values())
            node_rows.append(cell.nodes)
        rts = np.array([[nd.runtime for nd in nds] for nds in node_rows])
        cpu = np.array([[nd.config.cpu for nd in nds] for nds in node_rows])
        mem = np.array([[nd.config.mem for nd in nds] for nds in node_rows])
        e2e = plan.e2e(rts)
        cost = _vec_cost(sgroup[0][0].env.pricing, rts, cpu, mem)
        items = _vec_capture(plan.names, cpu, mem)
        for gi, (cell, req) in enumerate(sgroup):
            e = float(e2e[gi])
            feasible = (not req.error) and e <= req.slo
            cell.pending = cell.env.trace.record(
                e, float(cost[gi]), req.wf, feasible=feasible,
                error=req.error, trial_time=float(req.rt), note=req.note,
                config_items=(items[gi] if cell.env.trace.capture_configs
                              else ()))

    # -- CandidatesRequest ----------------------------------------------
    def _serve_candidates(self, batch: Sequence[Tuple[_Cell, Request]]
                          ) -> None:
        singles, groups = self._fusion_groups(batch)
        for cell, req in singles:
            cell.pending = cell.env.execute_candidates(
                req.wf, req.candidates, req.slo, note=req.note)
        for group in groups:
            self._serve_candidates_fused(group)

    def _serve_candidates_fused(self, group) -> None:
        prepared = []
        flat_cpu: List[np.ndarray] = []
        flat_mem: List[np.ndarray] = []
        tables_parts: List[Tuple[np.ndarray, ...]] = []
        for cell, req in group:
            if not req.candidates:
                cell.pending = []
                continue
            names, nodes, cpu, mem, items = cell.env._candidate_arrays(
                req.wf, req.candidates)
            n_cand = cpu.shape[0]
            prepared.append((cell, req, names, cpu, mem, items))
            flat_cpu.append(cpu.ravel())
            flat_mem.append(mem.ravel())
            cell_tables = cell.env.backend.surface_tables(nodes)
            tables_parts.append(tuple(np.tile(arr, n_cand)
                                      for arr in cell_tables))
        if not prepared:
            return
        if len(prepared) == 1:
            cell, req = prepared[0][0], prepared[0][1]
            cell.pending = cell.env.execute_candidates(
                req.wf, req.candidates, req.slo, note=req.note)
            return
        tables = tuple(np.concatenate([part[t] for part in tables_parts])
                       for t in range(len(tables_parts[0])))
        rep = prepared[0][0].env.backend
        rts, failed = rep.surface_probe(np.concatenate(flat_cpu),
                                        np.concatenate(flat_mem), tables)
        self.fused_evaluations += 1
        off = 0
        for cell, req, names, cpu, mem, items in prepared:
            size = cpu.size
            shape = cpu.shape
            rt = rts[off:off + size].reshape(shape)
            bad = failed[off:off + size].reshape(shape)
            off += size
            # the sequential invoke_config_batch draws the full (C, n)
            # noise matrix and discards failed entries via `where` — no
            # failure redo needed, the commit prices the failed mask
            self._count_invocations(cell.env, size)
            rt = cell.env.backend.apply_invocation_noise(rt, ~bad)
            cell.pending = cell.env._candidates_commit(
                req.wf, names, cpu, mem, items, rt, bad, req.slo, req.note)


class _StructPlan:
    """Cached vectorized fold schedule for one commit-structure group.

    The end-to-end fold of ``Workflow.end_to_end_latency`` is a chain
    of ``max`` and ``+`` ops. ``max`` over floats is *exactly*
    associative and commutative (it returns one of its arguments, no
    rounding), so predecessor folds and the final over-nodes fold may
    be re-grouped freely; only the ``start + runtime`` additions must
    keep their per-node placement. That licenses a level-parallel
    schedule — one fancy-indexed gather + ``max`` + add per
    *topological depth* instead of per node — and, for path graphs
    (chains, the common generated template), a single exact
    ``np.add.accumulate`` left fold per group."""

    def __init__(self, wf: Workflow):
        topo = list(wf.topological_order())
        names = list(wf.nodes)
        col = {name: j for j, name in enumerate(names)}
        self.names = names
        depth: Dict[str, int] = {}
        preds = {name: wf.predecessors(name) for name in topo}
        for name in topo:
            ps = preds[name]
            depth[name] = 1 + max((depth[p] for p in ps), default=-1)
        by_depth: Dict[int, List[str]] = defaultdict(list)
        for name in topo:
            by_depth[depth[name]].append(name)
        #: (cols, pred_idx) per level; pred_idx is None for sources,
        #: else an (L, pmax) index matrix padded by repeating the first
        #: predecessor (max-idempotent, so padding is exact)
        self.levels: List[Tuple[np.ndarray, Optional[np.ndarray]]] = []
        for d in sorted(by_depth):
            lnames = by_depth[d]
            cols = np.array([col[x] for x in lnames])
            if d == 0:
                self.levels.append((cols, None))
                continue
            plists = [[col[p] for p in preds[x]] for x in lnames]
            pmax = max(len(pl) for pl in plists)
            pred_idx = np.array([pl + [pl[0]] * (pmax - len(pl))
                                 for pl in plists])
            self.levels.append((cols, pred_idx))
        #: path graph: topo[i]'s only predecessor is topo[i-1]
        self.path_cols: Optional[np.ndarray] = None
        if all(preds[x] == [topo[i]] for i, x in enumerate(topo[1:])) \
                and (not topo or not preds[topo[0]]):
            self.path_cols = np.array([col[x] for x in topo])

    def e2e(self, rts: np.ndarray) -> np.ndarray:
        """(G,) end-to-end latencies from a (G, n) runtime matrix —
        bit-equal to per-cell ``Workflow.end_to_end_latency``."""
        n = rts.shape[1]
        if n == 0:
            return np.zeros(rts.shape[0])
        if self.path_cols is not None:
            finish = np.add.accumulate(rts[:, self.path_cols], axis=1)
            return finish.max(axis=1)
        finish = np.empty_like(rts)
        for cols, pred_idx in self.levels:
            if pred_idx is None:
                finish[:, cols] = 0.0 + rts[:, cols]
            else:
                start = finish[:, pred_idx].max(axis=2)
                finish[:, cols] = start + rts[:, cols]
        return finish.max(axis=1)


def _vec_capture(names: Sequence[str], cpu: np.ndarray, mem: np.ndarray
                 ) -> List[tuple]:
    """Per-cell ``config_items`` captures from (G, n) config arrays —
    value-equal to the per-sample ``env._capture`` walk (the float64
    round-trip through the gather arrays is exact), built with C-level
    ``zip`` instead of per-node attribute access."""
    cpul = cpu.tolist()
    meml = mem.tolist()
    return [tuple(zip(names, cpul[gi], meml[gi]))
            for gi in range(len(cpul))]


def _vec_contrib(pricing, rts: np.ndarray, cpu: np.ndarray,
                 mem: np.ndarray) -> np.ndarray:
    """(G, n) per-node costs — ``PricingModel.function_cost``'s IEEE
    operations, elementwise."""
    return rts * (pricing.mu0 * cpu + pricing.mu1 * mem) + pricing.mu2


def _vec_fold_cost(pricing, rts: np.ndarray, cpu: np.ndarray,
                   mem: np.ndarray) -> np.ndarray:
    """(G,) workflow costs as a whole-workflow sample prices them —
    ``Environment.execute_prepared`` (and the engine's fleet-of-1 path
    behind ``Environment.execute``) adds ``function_cost`` in node order
    with ``cost += ...`` from ``0.0``: a strict left fold.
    ``np.add.accumulate`` is that fold (unlike pairwise ``sum``), so its
    last column carries the scalar loop's exact rounding; the leading
    ``0.0 + c0`` is exact and needs no explicit term."""
    if rts.shape[1] == 0:
        return np.zeros(rts.shape[0])
    return np.add.accumulate(_vec_contrib(pricing, rts, cpu, mem),
                             axis=1)[:, -1]


def _vec_cost(pricing, rts: np.ndarray, cpu: np.ndarray, mem: np.ndarray
              ) -> np.ndarray:
    """(G,) workflow costs as a single-function trial prices them —
    bit-equal to ``workflow_cost`` (``Environment.apply_function_trial``).

    ``workflow_cost`` is the builtin ``sum`` over ``function_cost`` in
    node order. Its terms are exact Python ``float`` objects (a node's
    runtime is stored through ``float(...)``, and ``ResourceConfig``
    quantizes cpu and mem to ``round(...) * step``, a Python float), and
    since Python 3.12 ``sum`` adds exact floats with Neumaier's
    compensated summation (CPython's ``builtin_sum_impl``). Started from
    the integer 0, the first term becomes ``0.0 + x0``; each later term
    ``x`` does ``t = s + x``, adds ``(s - t) + x`` (when ``|s| >= |x|``,
    else ``(x - t) + s``) to the compensation ``c`` and sets ``s = t``;
    the result is ``s + c`` where ``c`` is nonzero and finite. This
    function performs those operations column by column over the (G, n)
    terms. A plain left fold (``np.add.accumulate``) rounds differently
    in the last bit of some sums; whole-workflow samples do use that
    fold (:func:`_vec_fold_cost`), because their scalar path does."""
    if rts.shape[1] == 0:
        return np.zeros(rts.shape[0])
    contrib = _vec_contrib(pricing, rts, cpu, mem)
    s = 0.0 + contrib[:, 0]
    c = np.zeros_like(s)
    with np.errstate(invalid="ignore", over="ignore"):
        for j in range(1, contrib.shape[1]):
            x = contrib[:, j]
            t = s + x
            c += np.where(np.abs(s) >= np.abs(x), (s - t) + x, (x - t) + s)
            s = t
        return np.where((c != 0.0) & np.isfinite(c), s + c, s)
