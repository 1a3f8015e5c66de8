"""Execution environment abstraction + sampling trace.

Every configuration search (AARC, BO, MAFF) measures candidate configs
by *executing the workflow* through an :class:`Environment`. The
environment wraps a :class:`repro_torch.core.backend.RuntimeBackend`
(analytic / stochastic serverless surface, the measured oracle on the
card, the H100 stage roofline) plus the pricing model; the
:class:`SearchTrace` records one row per sample.

:meth:`Environment.execute` runs every sample through the
discrete-event :class:`repro_torch.core.engine.FleetEngine` as the
degenerate case — a fleet of one instance on an infinite cluster with
zero cold start — so the search path and the multi-tenant fleet path
share one execution semantics (and the degenerate case reproduces
``Workflow.end_to_end_latency`` bit-for-bit). The engine is constructed
once per environment and reused across samples; it never sweeps, so it
never needs a card.

Campaign-scale search adds three *batched* evaluation paths, all
routing through ``RuntimeBackend.invoke_batch`` (one numpy call per
round instead of per-sample dispatch):

  * :meth:`execute_batch`           — N whole workflows in one call,
  * :meth:`execute_candidates`      — C candidate config maps for ONE
    workflow topology, vectorized over candidates when the backend
    supports ``invoke_config_batch`` (the analytic surface does),
  * :meth:`probe_function_batch` / :meth:`apply_function_trial` — the
    split measure/commit pair Algorithm 2 uses to drain a whole round
    of same-priority ops as one probe while preserving revert-per-op
    semantics (see :mod:`repro_torch.core.priority`);
    :meth:`execute_function_batch` composes the two for callers that
    accept every trial.

The port's copy of ``src/repro/core/env.py``, numpy and plain Python as
there, so that traces equal the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Callable, Dict, List, Optional, Sequence, Tuple, Union)

import numpy as np

from repro_torch.core.backend import RuntimeBackend, as_backend
from repro_torch.core.cost import DEFAULT_PRICING, PricingModel, workflow_cost
from repro_torch.core.dag import Node, Workflow
from repro_torch.core.resources import ResourceConfig


class ExecutionError(RuntimeError):
    """Raised by a backend when a function fails under its config (OOM)."""


#: compact per-sample config capture: one ``(name, cpu, mem)`` per node.
ConfigItems = Tuple[Tuple[str, float, float], ...]


@dataclasses.dataclass
class Sample:
    index: int
    e2e_runtime: float           # end-to-end workflow latency implied by configs
    cost: float                  # cost of one workflow execution (all functions)
    config_items: ConfigItems    # compact (name, cpu, mem) capture
    feasible: bool               # SLO met and no function error
    error: bool = False          # a function failed (e.g. OOM-killed)
    trial_time: float = 0.0      # wall time this *sample* consumed during search
    note: str = ""

    @property
    def configs(self) -> Dict[str, ResourceConfig]:
        """Per-function configs at record time, reconstructed on demand.

        Stored compactly (``config_items``): a 1k-node workflow searched
        for thousands of samples would otherwise hold thousands of
        dicts of ``ResourceConfig`` objects alive at once.
        """
        return {name: ResourceConfig(cpu=cpu, mem=mem)
                for name, cpu, mem in self.config_items}


def _capture(wf: Workflow) -> ConfigItems:
    return tuple((n.name, n.config.cpu, n.config.mem)
                 for n in wf.nodes.values())


@dataclasses.dataclass
class SearchTrace:
    samples: List[Sample] = dataclasses.field(default_factory=list)
    #: set False to skip per-sample config capture entirely (huge
    #: generated workflows where only aggregate figures matter). NOTE:
    #: searchers that read the winning configuration back from the
    #: trace (BO, MAFF via ``best_feasible().configs``) refuse to run
    #: without capture; AARC gets its configs from the scheduler and
    #: is safe either way.
    capture_configs: bool = True

    def record(self, e2e: float, cost: float, wf: Workflow, feasible: bool,
               error: bool = False, trial_time: Optional[float] = None,
               note: str = "", config_items: Optional[ConfigItems] = None
               ) -> Sample:
        if trial_time is None:
            trial_time = e2e
        if config_items is None:
            config_items = _capture(wf) if self.capture_configs else ()
        s = Sample(index=len(self.samples), e2e_runtime=e2e, cost=cost,
                   config_items=config_items, feasible=feasible, error=error,
                   trial_time=trial_time if math.isfinite(trial_time) else 0.0,
                   note=note)
        self.samples.append(s)
        return s

    @property
    def total_search_runtime(self) -> float:
        """Σ wall time consumed by all samples (Fig. 5a). A full-workflow
        execution costs its end-to-end latency; an AARC trial costs only
        the re-invoked function's runtime."""
        return sum(s.trial_time for s in self.samples)

    @property
    def total_search_cost(self) -> float:
        """Σ execution costs over all samples (Fig. 5b)."""
        return sum(s.cost for s in self.samples if math.isfinite(s.cost))

    @property
    def n_samples(self) -> int:
        return len(self.samples)

    def best_feasible(self) -> Optional[Sample]:
        feas = [s for s in self.samples if s.feasible]
        return min(feas, key=lambda s: s.cost) if feas else None


class Environment:
    """Wraps a runtime backend; executes workflows and logs samples.

    Accepts either a :class:`RuntimeBackend` or a bare ``node -> seconds``
    oracle callable plus an optional ``clamped_oracle`` estimating the
    wall time a *failing* execution burns before the platform kills it
    (a real OOM'd invocation still consumes search time and money).
    Without a clamped estimate, failures are recorded with infinite
    runtime.
    """

    def __init__(self, backend: Union[RuntimeBackend, Callable[[Node], float]],
                 pricing: PricingModel = DEFAULT_PRICING,
                 clamped_oracle: Optional[Callable[[Node], float]] = None,
                 capture_configs: bool = True):
        self.backend = as_backend(backend, clamped_oracle)
        self.pricing = pricing
        self.capture_configs = capture_configs
        self.trace = SearchTrace(capture_configs=capture_configs)
        self._engine = None          # cached degenerate-case FleetEngine

    def reset_trace(self) -> None:
        self.trace = SearchTrace(capture_configs=self.capture_configs)

    @property
    def engine(self):
        """Per-environment degenerate-case engine (fleet of 1, infinite
        cluster, zero cold start), built once and reused — the engine
        keeps no state between runs, so thousand-sample searches stop
        paying per-sample construction."""
        if self._engine is None:
            from repro_torch.core.engine import FleetEngine

            self._engine = FleetEngine(self.backend, pricing=self.pricing)
        return self._engine

    def oracle(self, node: Node) -> float:
        """Single-invocation oracle view of the backend (may raise
        :class:`ExecutionError`), kept for direct callers/tests."""
        return self.backend.invoke(node)

    # -- whole-workflow sampling ---------------------------------------
    def execute(self, wf: Workflow, slo: float, note: str = "") -> Sample:
        """Execute the whole workflow under current configs, log a sample.

        Runs as a fleet-of-1 on an infinite cluster through the
        discrete-event engine — the degenerate case of the fleet path.
        A function-level failure (e.g. OOM below the working set) makes
        the sample infeasible; the failed attempt is charged the
        thrash-until-killed wall time so search budgets stay honest.
        """
        report = self.engine.run([wf], [0.0])
        # array views (no InstanceResult materialization on the
        # per-sample hot path); the degenerate path sums per-function
        # costs in node order, so cost == workflow_cost(...) bit-for-bit
        e2e = float(report.latencies[0])
        cost = float(report.costs[0])
        if report.failed_mask[0]:
            bad = "; ".join(n.fail_reason or n.name for n in wf if n.failed)
            if not self.backend.has_clamped:
                # unbounded failure: charge the per-second rate only
                cost = sum(self.pricing.rate(n.config) for n in wf)
                return self.trace.record(math.inf, cost, wf, feasible=False,
                                         error=True, note=f"error:{bad}")
            return self.trace.record(e2e, cost, wf, feasible=False,
                                     error=True, note=f"error:{bad}")
        return self.trace.record(e2e, cost, wf, feasible=e2e <= slo,
                                 note=note)

    def execute_batch(self, wfs: Sequence[Workflow],
                      slo: Union[float, Sequence[float]],
                      notes: Optional[Sequence[str]] = None) -> List[Sample]:
        """Execute N whole workflows through ONE ``invoke_batch`` call.

        Per-workflow results (runtimes written onto nodes, cost summed
        in node order, failure handling) match what N separate
        :meth:`execute` calls produce for a deterministic backend; only
        the backend dispatch is fused, which is what makes portfolio
        campaigns fast. ``slo`` may be a scalar or one value per
        workflow.
        """
        if notes is None:
            notes = [""] * len(wfs)
        if isinstance(slo, (int, float)):
            slos: Sequence[float] = [float(slo)] * len(wfs)
        else:
            slos = list(slo)
        if not (len(wfs) == len(slos) == len(notes)):
            raise ValueError("workflows / slos / notes length mismatch")
        all_nodes = [n for wf in wfs for n in wf]
        runtimes, failed = self.backend.invoke_batch(all_nodes)
        samples: List[Sample] = []
        i = 0
        for wf, s, note in zip(wfs, slos, notes):
            k = len(wf)
            samples.append(self.execute_prepared(
                wf, runtimes[i:i + k], failed[i:i + k], s, note=note))
            i += k
        return samples

    def execute_prepared(self, wf: Workflow, runtimes: np.ndarray,
                         failed: np.ndarray, slo: float,
                         note: str = "") -> Sample:
        """Commit pre-measured per-node runtimes as one whole-workflow
        sample — the per-workflow half of :meth:`execute_batch`, exposed
        so callers that already hold a (fused) ``invoke_batch`` result
        can skip the backend dispatch. Runtimes are written onto the
        nodes, cost is summed in node order, and failures follow the
        same branch :meth:`execute` takes, so the recorded sample is
        bit-identical to an :meth:`execute` call measuring the same
        values."""
        cost = 0.0
        for node, rt, b in zip(wf, runtimes, failed):
            node.runtime = float(rt)
            node.failed = bool(b)
            if not node.failed:
                node.fail_reason = ""
            if math.isfinite(node.runtime):
                cost += self.pricing.function_cost(node.runtime,
                                                   node.config)
        e2e = wf.end_to_end_latency()
        if failed.any():
            msg = "; ".join(n.fail_reason or n.name for n in wf
                            if n.failed)
            if not self.backend.has_clamped:
                cost = sum(self.pricing.rate(n.config) for n in wf)
                return self.trace.record(
                    math.inf, cost, wf, feasible=False, error=True,
                    note=f"error:{msg}")
            return self.trace.record(
                e2e, cost, wf, feasible=False, error=True,
                note=f"error:{msg}")
        return self.trace.record(e2e, cost, wf, feasible=e2e <= slo,
                                 note=note)

    def execute_candidates(self, wf: Workflow,
                           candidates: Sequence[Dict[str, ResourceConfig]],
                           slo: float, note: str = "") -> List[Sample]:
        """Evaluate C candidate config maps for ONE workflow topology.

        When the backend vectorizes over configurations
        (``invoke_config_batch``, e.g. the analytic surface) the whole
        C×N response-surface evaluation is a single numpy expression
        and the longest-path reduction is vectorized across candidates;
        otherwise candidates fall back to one ``invoke_batch`` per row.
        The workflow's own configs/runtimes are left untouched — this
        is a pure evaluation used by batched BO rounds and campaign
        sweeps.
        """
        n_cand = len(candidates)
        if n_cand == 0:
            return []
        names, nodes, cpu, mem, items = self._candidate_arrays(wf, candidates)

        if hasattr(self.backend, "invoke_config_batch"):
            runtimes, failed = self.backend.invoke_config_batch(
                nodes, cpu, mem)
        else:                       # generic fallback: one row at a time
            runtimes = np.empty((n_cand, len(nodes)))
            failed = np.zeros((n_cand, len(nodes)), dtype=bool)
            saved = [n.config for n in nodes]
            try:
                for ci, cand in enumerate(candidates):
                    for node, name in zip(nodes, names):
                        node.config = cand[name]
                    runtimes[ci], failed[ci] = self.backend.invoke_batch(nodes)
            finally:
                for node, cfg in zip(nodes, saved):
                    node.config = cfg

        return self._candidates_commit(wf, names, cpu, mem, items,
                                       runtimes, failed, slo, note)

    def _candidate_arrays(self, wf: Workflow,
                          candidates: Sequence[Dict[str, ResourceConfig]]
                          ) -> Tuple[List[str], List[Node], np.ndarray,
                                     np.ndarray, List[ConfigItems]]:
        """Validate candidate config maps against ``wf`` and gather them
        into ``(C, n)`` cpu/mem arrays plus per-candidate config-item
        captures — the pure input half of :meth:`execute_candidates`,
        shared with the fused grid-search plane."""
        names = [n.name for n in wf.nodes.values()]
        nodes = list(wf.nodes.values())
        n_cand = len(candidates)
        name_set = set(names)
        cpu = np.empty((n_cand, len(nodes)))
        mem = np.empty((n_cand, len(nodes)))
        items: List[ConfigItems] = []
        for ci, cand in enumerate(candidates):
            if set(cand) != name_set:
                unknown = sorted(set(cand) - name_set)
                missing = sorted(name_set - set(cand))
                raise ValueError(
                    f"candidate {ci} does not match workflow {wf.name!r}: "
                    f"references unknown function(s) {unknown}, missing "
                    f"config(s) for {missing}")
            row = []
            for ni, name in enumerate(names):
                cfg = cand[name]
                cpu[ci, ni] = cfg.cpu
                mem[ci, ni] = cfg.mem
                row.append((name, cfg.cpu, cfg.mem))
            items.append(tuple(row))
        return names, nodes, cpu, mem, items

    def _candidates_commit(self, wf: Workflow, names: List[str],
                           cpu: np.ndarray, mem: np.ndarray,
                           items: List[ConfigItems], runtimes: np.ndarray,
                           failed: np.ndarray, slo: float,
                           note: str) -> List[Sample]:
        """Record measured ``(C, n)`` candidate runtimes — the pure
        output half of :meth:`execute_candidates` (vectorized
        longest-path, pricing, failure branches), shared with the fused
        grid-search plane so fused and per-cell evaluation produce
        bit-identical samples."""
        n_cand = runtimes.shape[0]
        # vectorized longest-path over all candidates at once
        col = {name: i for i, name in enumerate(names)}
        finish: Dict[str, np.ndarray] = {}
        for name in wf.topological_order():
            preds = wf.predecessors(name)
            start = (np.maximum.reduce([finish[p] for p in preds])
                     if preds else 0.0)
            finish[name] = start + runtimes[:, col[name]]
        e2e = np.maximum.reduce(list(finish.values())) if finish else \
            np.zeros(n_cand)

        rate = self.pricing.mu0 * cpu + self.pricing.mu1 * mem
        finite = np.isfinite(runtimes)
        cost = np.where(finite, runtimes * rate + self.pricing.mu2,
                        0.0).sum(axis=1)
        any_failed = failed.any(axis=1)
        if not self.backend.has_clamped and any_failed.any():
            cost = np.where(any_failed, rate.sum(axis=1), cost)
            e2e = np.where(any_failed, math.inf, e2e)

        samples: List[Sample] = []
        for ci in range(n_cand):
            if any_failed[ci]:
                bad = "; ".join(names[ni]
                                for ni in np.flatnonzero(failed[ci]))
                samples.append(self.trace.record(
                    float(e2e[ci]), float(cost[ci]), wf, feasible=False,
                    error=True, note=f"error:{bad}",
                    config_items=items[ci]))
            else:
                ok = float(e2e[ci]) <= slo
                samples.append(self.trace.record(
                    float(e2e[ci]), float(cost[ci]), wf, feasible=ok,
                    note=note, config_items=items[ci]))
        return samples

    # -- single-function sampling (AARC trials) ------------------------
    def execute_function(self, wf: Workflow, node: Node, slo: float,
                         note: str = "") -> Sample:
        """Re-invoke a *single* function under its new config (serverless
        functions are independently invocable); every other node keeps
        its cached runtime. The sample's ``trial_time`` is only this
        invocation's wall time — the heart of AARC's search-time win:
        one AARC trial costs one function run, one BO/MAFF trial costs a
        full workflow execution.

        A failing trial is recorded *against the node*: ``node.failed``
        is set and its runtime becomes the clamped thrash time (or +inf
        without a clamped estimate), so a later ``end_to_end_latency()``
        reflects the failure instead of silently reusing the runtime of
        a config that was never measured.
        """
        try:
            rt = self.backend.invoke(node)
            error = False
            node.fail_reason = ""
        except ExecutionError as exc:
            rt = self.backend.invoke_clamped(node)
            error = True
            node.fail_reason = str(exc)
        return self.apply_function_trial(wf, node, rt, error, slo, note=note)

    def probe_function_batch(self, nodes: Sequence[Node]
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """Measure a batch of function invocations in ONE backend call
        *without* committing runtimes or recording samples. A function's
        runtime depends only on its own config, so independent trials
        can be probed together and then committed/reverted one at a time
        (:meth:`apply_function_trial`) — how batched Algorithm 2 drains
        a whole priority round per numpy call."""
        return self.backend.invoke_batch(nodes)

    def apply_function_trial(self, wf: Workflow, node: Node, rt: float,
                             error: bool, slo: float, note: str = "") -> Sample:
        """Commit one measured invocation onto ``node`` and record the
        resulting whole-workflow sample (``trial_time`` = that
        invocation only). The caller owns accept/revert."""
        node.runtime = float(rt)
        node.failed = bool(error)
        if not node.failed:
            node.fail_reason = ""
        e2e = wf.end_to_end_latency()
        cost = workflow_cost(self.pricing, wf)
        feasible = (not error) and e2e <= slo
        return self.trace.record(e2e, cost, wf, feasible=feasible, error=error,
                                 trial_time=float(rt), note=note)

    def execute_function_batch(self, wf: Workflow, nodes: Sequence[Node],
                               slo: float,
                               notes: Optional[Sequence[str]] = None
                               ) -> List[Sample]:
        """Probe N function trials in one backend call and commit them
        all (no revert): sample ``i`` reflects trials ``0..i`` applied.
        Callers needing accept/reject-per-trial use the
        :meth:`probe_function_batch` / :meth:`apply_function_trial`
        pair directly."""
        if notes is None:
            notes = [""] * len(nodes)
        runtimes, failed = self.probe_function_batch(nodes)
        return [self.apply_function_trial(wf, node, float(rt), bool(bad),
                                          slo, note=note)
                for node, rt, bad, note in zip(nodes, runtimes, failed, notes)]
