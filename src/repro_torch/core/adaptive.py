"""Adaptive campaign scheduler with cross-searcher warm starts.

The uniform campaign (:mod:`repro_torch.core.campaign`) spends its
probe budget identically on every (workflow, SLO, searcher) cell of the
portfolio grid, regardless of which cells are already meeting their
SLOs — the portfolio-scale version of the inefficiency AARC's priority
scheduling attacks *within* a workflow. This module closes that loop:

  1. **seeding pass** — every cell gets a small search budget
     (``seed_trail`` / ``seed_rounds`` / ``seed_samples``), with
     *cross-searcher warm starts*: AARC runs first per task, its
     accepted-trial trace becomes free GP data for the BO cell
     (:class:`repro_torch.core.baselines.bo.BayesianOptimizer`
     ``warm_start``)
     and its best configuration becomes MAFF's starting point; tasks
     whose topology signature matches an already-solved task inherit
     that donor's configuration by topological rank
     (:func:`repro_torch.serverless.generator.transfer_configs`),
  2. **feedback loop** — each cell's found configuration is replayed
     through the fleet engine (same arrival seeds as the uniform
     campaign, bit-for-bit) and cells are scored UCB-style over their
     *attainment deficit* (1 − fleet-replay SLO attainment), the
     *marginal gain* their last grant realized per sample, and an
     exploration bonus; each round the top cell receives an incremental
     grant via ``Searcher.resume(state, extra_budget)`` and is
     re-replayed,
  3. **monotone acceptance** — a resumed configuration replaces the
     cell's incumbent only if it replays at strictly better attainment
     (or equal attainment at lower fleet cost), so per-cell attainment
     is non-decreasing across rounds by construction,
  4. **budget ledger** — a hard sample budget (``total_budget``) is
     decremented by *actual* samples consumed (searchers may spend less
     than granted); the run stops when the budget, the round cap, or
     the candidate pool is exhausted. ``allocated == spent + remaining``
     always.

Everything derives from one master seed (tasks, arrival processes, BO
seeds), so adaptive runs are exactly reproducible —
:meth:`AdaptiveReport.to_payload` is deterministic across runs and
excludes wall-clock times for exactly that reason.

The port's copy of ``src/repro/core/adaptive.py``, with one addition:
``device``, handed to the inner :class:`Campaign`, whose replay engines
sweep on it (``None``: the CUDA card).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.campaign import (Campaign, CampaignSpec, CampaignTask,
                                       PortfolioSpec, ReplayMetrics,
                                       ReplaySpec)
from repro_torch.core.env import Environment
from repro_torch.core.resources import ResourceConfig
from repro_torch.core.search import (GridResume, SearchResult, Searcher,
                                     make_searcher, run_grid_search)
from repro_torch.device import DeviceLike
from repro_torch.serverless.generator import (degree_bucket,
                                              topology_signature,
                                              transfer_configs)


@dataclasses.dataclass(frozen=True)
class GrantScorer:
    """The UCB grant scorer shared by the offline adaptive campaign and
    an online control plane (the reference's ``core/online.py``, not yet
    ported) — ONE
    implementation of "which cell deserves the next search grant":

      * ``score`` — attainment deficit + realized marginal gain of the
        cell's last grant + a ``sqrt(log(1+t)/(1+grants))`` exploration
        bonus,
      * ``is_candidate`` — deficient cells always qualify; attained
        cells only while their last grant still paid
        (``gain_floor``) or, with ``explore_attained``, before their
        first grant (cost-polish mode),
      * ``realized_gain`` — the per-sample gain a grant realized:
        attainment improvement plus ``gain_weight`` × relative fleet
        cost reduction.
    """

    ucb_beta: float = 0.5
    gain_weight: float = 0.5
    gain_floor: float = 1e-6
    attainment_tol: float = 1e-9
    explore_attained: bool = False

    def score(self, *, deficit: float, last_gain: float, grants: int,
              t: int) -> float:
        explore = self.ucb_beta * math.sqrt(
            math.log1p(t) / (1.0 + grants))
        return max(deficit, 0.0) + last_gain + explore

    def is_candidate(self, *, deficit: float, last_gain: float,
                     grants: int) -> bool:
        if deficit > self.attainment_tol:
            return True
        if grants == 0:
            return self.explore_attained
        return last_gain > self.gain_floor

    def realized_gain(self, *, prev_att: float, new_att: float,
                      prev_cost: float, new_cost: float, used: int) -> float:
        if used <= 0:
            return 0.0
        att_gain = max(0.0, new_att - prev_att)
        cost_gain = 0.0
        if math.isfinite(prev_cost) and prev_cost > 0:
            cost_gain = max(0.0, (prev_cost - new_cost) / prev_cost)
        return (att_gain + self.gain_weight * cost_gain) / used


@dataclasses.dataclass(frozen=True)
class AdaptiveSpec:
    """One adaptive campaign: uniform-campaign grid + budget policy."""

    portfolio: PortfolioSpec = PortfolioSpec()
    replay: ReplaySpec = ReplaySpec()
    searchers: Sequence[str] = ("aarc", "bo", "maff")
    #: per-searcher constructor kwargs (budget/warm-start keys are owned
    #: by the scheduler and overridden)
    searcher_kwargs: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    seed: int = 0
    #: hard cap on trace samples across the whole run (seeding + grants)
    total_budget: int = 10_000
    #: seeding budgets: AARC ``max_trail`` per path, BO evaluated
    #: rounds, MAFF descent samples
    seed_trail: int = 8
    seed_rounds: int = 6
    seed_samples: int = 8
    #: samples per adaptive top-up grant
    round_budget: int = 8
    #: cells granted per allocation round. 1 (the default) is the
    #: legacy one-grant-per-round scheduler bit-for-bit; larger values
    #: resume the top-K scored cells *together* through the lockstep
    #: grid plane (:func:`repro_torch.core.search.run_grid_search`), so
    #: one settlement round costs one batched evaluation per probe round
    #: instead of K sequential resumes. The K grants of a round are
    #: scored against the same pre-round state (batch settlement).
    grants_per_round: int = 1
    #: cap on adaptive allocation rounds
    max_rounds: int = 64
    #: UCB exploration weight over sqrt(log(1+t) / (1+grants))
    ucb_beta: float = 0.5
    #: weight of fleet-cost improvement inside a grant's realized gain
    gain_weight: float = 0.5
    #: a cell stays a candidate while its last grant gained more than
    #: this per sample (attainment-deficient cells always qualify)
    gain_floor: float = 1e-6
    attainment_tol: float = 1e-9
    #: seed BO/MAFF from AARC's trace and donor cells (False = cold A/B)
    warm_starts: bool = True
    #: when True, fully-attained cells with no grants yet remain
    #: candidates (cost-polish mode); default saves the budget instead
    explore_attained: bool = False

    def scorer(self) -> GrantScorer:
        """The shared grant scorer this spec parameterizes."""
        return GrantScorer(ucb_beta=self.ucb_beta,
                           gain_weight=self.gain_weight,
                           gain_floor=self.gain_floor,
                           attainment_tol=self.attainment_tol,
                           explore_attained=self.explore_attained)


@dataclasses.dataclass
class CellState:
    """One (task, searcher) cell of the adaptive grid."""

    index: int
    task: CampaignTask
    searcher_name: str
    arrival_seed: int
    searcher: Optional[Searcher] = None
    result: Optional[SearchResult] = None
    #: incumbent fleet-replay metrics (monotone under the accept rule)
    replay: Optional[ReplayMetrics] = None
    best_configs: Optional[Dict[str, ResourceConfig]] = None
    attainment: float = 0.0
    replay_cost: float = math.inf
    history: List[float] = dataclasses.field(default_factory=list)
    spent: int = 0
    grants: int = 0
    last_gain: float = 0.0
    exhausted: bool = False
    warm_source: str = ""
    note: str = ""

    def row(self) -> Dict[str, object]:
        out: Dict[str, object] = {
            "cell": self.index, "task": self.task.index,
            "kind": self.task.kind, "wf_seed": self.task.wf_seed,
            "n_nodes": self.task.n_nodes, "slack": self.task.slack,
            "slo_s": self.task.slo, "searcher": self.searcher_name,
            "warm_source": self.warm_source, "spent": self.spent,
            "grants": self.grants, "exhausted": self.exhausted,
            "attainment": self.attainment,
            "attainment_history": list(self.history),
            "note": self.note,
        }
        if self.result is not None:
            out.update({
                "feasible": self.result.feasible,
                "e2e_s": self.result.e2e_runtime,
                "config_cost": self.result.cost,
                "search_time_s": self.result.search_time,
                "search_cost": self.result.search_cost,
            })
        if self.replay is not None:
            out["replay_cost"] = self.replay.total_cost
        return out


@dataclasses.dataclass
class AdaptiveReport:
    spec: AdaptiveSpec
    cells: List[CellState]
    budget: Dict[str, int]       # {"total", "spent", "remaining"}
    rounds: int
    wall_time_s: float

    def portfolio_attainment(self) -> float:
        """Mean fleet-replay SLO attainment over every cell of the grid
        (unseeded cells count as 0 — the budget did not cover them)."""
        if not self.cells:
            return float("nan")
        return sum(c.attainment for c in self.cells) / len(self.cells)

    def mean_replay_cost(self) -> float:
        """Mean incumbent fleet cost over the replayed cells — the axis
        warm starts improve even when every cell already attains its
        SLO (a better config is cheaper, not just feasible)."""
        cost = [c.replay_cost for c in self.cells
                if c.replay is not None and math.isfinite(c.replay_cost)]
        return (sum(cost) / len(cost)) if cost else float("nan")

    def by_searcher(self) -> Dict[str, List[CellState]]:
        out: Dict[str, List[CellState]] = {}
        for c in self.cells:
            out.setdefault(c.searcher_name, []).append(c)
        return out

    def summary(self) -> Dict[str, Dict[str, float]]:
        per: Dict[str, Dict[str, float]] = {}
        for name, cells in self.by_searcher().items():
            n = len(cells)
            per[name] = {
                "n_cells": n,
                "spent": sum(c.spent for c in cells),
                "grants": sum(c.grants for c in cells),
                "mean_attainment": (sum(c.attainment for c in cells) / n)
                if n else float("nan"),
                "feasible_rate": (sum(bool(c.result and c.result.feasible)
                                      for c in cells) / n) if n
                else float("nan"),
                "total_search_time_s": sum(
                    c.result.search_time for c in cells
                    if c.result is not None),
                "warm_started": sum(bool(c.warm_source) for c in cells),
            }
        return per

    def to_payload(self) -> Dict[str, object]:
        """JSON-ready, *deterministic* snapshot: everything here derives
        from the master seed (no wall-clock), so two runs of the same
        spec emit byte-identical payloads."""
        return {
            "spec": {
                "n_workflows": self.spec.portfolio.n_workflows,
                "kinds": list(self.spec.portfolio.kinds),
                "size": self.spec.portfolio.size,
                "slo_slacks": list(self.spec.portfolio.slo_slacks),
                "searchers": list(self.spec.searchers),
                "seed": self.spec.seed,
                "total_budget": self.spec.total_budget,
                "seed_trail": self.spec.seed_trail,
                "seed_rounds": self.spec.seed_rounds,
                "seed_samples": self.spec.seed_samples,
                "round_budget": self.spec.round_budget,
                "grants_per_round": self.spec.grants_per_round,
                "max_rounds": self.spec.max_rounds,
                "warm_starts": self.spec.warm_starts,
            },
            "budget": dict(self.budget),
            "rounds": self.rounds,
            "portfolio_attainment": self.portfolio_attainment(),
            "mean_replay_cost": self.mean_replay_cost(),
            "per_searcher": self.summary(),
            "cells": [c.row() for c in self.cells],
        }


class AdaptiveCampaign:
    """Runs an :class:`AdaptiveSpec` end to end.

    Wraps a uniform :class:`repro_torch.core.campaign.Campaign` for the
    task grid and the fleet replays, so the adaptive run sees bit-identical
    workflows, SLOs, and arrival processes to the uniform sweep it is
    compared against. ``device`` is where the campaign's replay engines
    sweep (``None``: the CUDA card).
    """

    def __init__(self, spec: AdaptiveSpec = AdaptiveSpec(), *,
                 env_factory: Optional[Callable[[], Environment]] = None,
                 device: DeviceLike = None):
        self.spec = spec
        self.scorer = spec.scorer()
        self._campaign = Campaign(
            CampaignSpec(portfolio=spec.portfolio, replay=spec.replay,
                         searchers=tuple(spec.searchers),
                         searcher_kwargs=dict(spec.searcher_kwargs),
                         seed=spec.seed),
            env_factory=env_factory, device=device)
        self.env_factory = self._campaign.env_factory

    # -- warm-start wiring ---------------------------------------------
    def _make_cell_searcher(
            self, name: str, task: CampaignTask, bo_seed: int,
            aarc_res: Optional[SearchResult],
            donor: Optional[Tuple]) -> Tuple[Searcher, str]:
        """Instantiate the cell's searcher with its seeding budget and
        whatever warm-start material is available: the same task's AARC
        result first, then a structurally identical donor cell."""
        spec = self.spec
        user = dict(spec.searcher_kwargs.get(name, {}))
        warm_src = ""
        aarc_ok = aarc_res is not None and aarc_res.feasible
        if name == "aarc":
            user.pop("max_trail", None)
            return make_searcher(name, self.env_factory,
                                 max_trail=spec.seed_trail, **user), warm_src
        if name == "bo":
            for key in ("n_rounds", "seed", "warm_start", "init_points"):
                user.pop(key, None)
            warm: Sequence = ()
            ipts: List[Dict[str, ResourceConfig]] = []
            if spec.warm_starts and aarc_ok:
                warm = tuple(s for s in aarc_res.trace.samples if s.feasible)
                ipts.append(aarc_res.configs)
                warm_src = "aarc-trace"
            elif spec.warm_starts and donor is not None:
                ipts.append(transfer_configs(donor[0], donor[1],
                                             task.template, approx=donor[3]))
                warm_src = f"donor{'~' if donor[3] else ':'}{donor[2]}"
            return make_searcher(name, self.env_factory,
                                 n_rounds=spec.seed_rounds, seed=bo_seed,
                                 warm_start=warm, init_points=ipts,
                                 **user), warm_src
        if name == "maff":
            for key in ("max_samples", "start_configs"):
                user.pop(key, None)
            start = None
            if spec.warm_starts and aarc_ok:
                start = aarc_res.configs
                warm_src = "aarc-best"
            elif spec.warm_starts and donor is not None:
                start = transfer_configs(donor[0], donor[1], task.template,
                                         approx=donor[3])
                warm_src = f"donor{'~' if donor[3] else ':'}{donor[2]}"
            return make_searcher(name, self.env_factory,
                                 max_samples=spec.seed_samples,
                                 start_configs=start, **user), warm_src
        # unknown/custom searcher: registry kwargs only, no warm hooks
        return make_searcher(name, self.env_factory, **user), warm_src

    # -- feedback ------------------------------------------------------
    def _settle(self, cell: CellState, used: int = 0) -> None:
        """Replay the cell's latest configuration and apply the monotone
        accept rule; record realized gain for the UCB score.

        Challenger validation routes through the campaign's batched
        replay path (:meth:`Campaign.replay_configs_many` →
        :meth:`FleetEngine.run_many` on the campaign's cached engine),
        so every settle is one vectorized fleet evaluation instead of
        a fresh engine + per-event Python replay — including campaigns
        replayed on finite clusters or with cold starts, which the
        engine's constrained plane now replays table-driven off one
        response-surface call (only non-``batch_safe`` backends still
        serialize; :meth:`FleetEngine.batch_eligibility` says why)."""
        res = cell.result
        replay = self._campaign.replay_configs_many(
            cell.task, [res.configs], cell.arrival_seed)[0]
        att, rcost = replay.slo_attainment, replay.total_cost
        tol = self.spec.attainment_tol
        prev_att, prev_cost = cell.attainment, cell.replay_cost
        first = not cell.history
        accept = first or (att > prev_att + tol) or (
            abs(att - prev_att) <= tol and rcost < prev_cost - 1e-12)
        if accept:
            cell.attainment = att
            cell.replay_cost = rcost
            cell.replay = replay
            cell.best_configs = res.configs
        if not first and used > 0:
            cell.last_gain = self.scorer.realized_gain(
                prev_att=prev_att, new_att=cell.attainment,
                prev_cost=prev_cost, new_cost=cell.replay_cost, used=used)
        cell.history.append(cell.attainment)

    def _is_candidate(self, cell: CellState) -> bool:
        if cell.exhausted or cell.result is None or cell.result.state is None:
            return False
        return self.scorer.is_candidate(deficit=1.0 - cell.attainment,
                                        last_gain=cell.last_gain,
                                        grants=cell.grants)

    def _score(self, cell: CellState, t: int) -> float:
        return self.scorer.score(deficit=1.0 - cell.attainment,
                                 last_gain=cell.last_gain,
                                 grants=cell.grants, t=t)

    # -- the pipeline --------------------------------------------------
    def run(self, *, progress: Optional[Callable[[str], None]] = None
            ) -> AdaptiveReport:
        t0 = time.perf_counter()
        spec = self.spec
        tasks = self._campaign.tasks()
        arrival_seeds = self._campaign.arrival_seeds(len(tasks))
        n_cells = len(tasks) * len(spec.searchers)
        bo_seeds = np.random.default_rng(spec.seed + 2).integers(
            0, 2**31 - 1, size=max(1, n_cells))
        total = int(spec.total_budget)
        remaining = total
        cells: List[CellState] = []
        #: structural signature -> (template, configs, task index,
        #: approx) of the first solved cell; warm-starts structurally
        #: identical tasks. ``bucket_donors`` is the degree-sequence
        #: fallback: layered DAGs rarely collide on the exact edge-set
        #: signature, but near-twins of one (n_nodes, role-multiset)
        #: bucket still donate a rank-mapped starting guess.
        donors: Dict[Tuple, Tuple] = {}
        bucket_donors: Dict[Tuple, Tuple] = {}

        # -- seeding pass ---------------------------------------------
        ci = 0
        for task in tasks:
            sig = topology_signature(task.template)
            bucket = degree_bucket(task.template)
            donor = None
            if spec.warm_starts:
                donor = donors.get(sig)
                if donor is None and bucket in bucket_donors:
                    tpl, cfgs, idx, _ = bucket_donors[bucket]
                    donor = (tpl, cfgs, idx, True)
            aarc_res: Optional[SearchResult] = None
            for name in spec.searchers:
                cell = CellState(index=ci, task=task, searcher_name=name,
                                 arrival_seed=arrival_seeds[task.index])
                cells.append(cell)
                ci += 1
                if remaining <= 0:
                    cell.exhausted = True
                    cell.note = "unseeded: budget exhausted"
                    cell.history.append(0.0)
                    continue
                searcher, warm_src = self._make_cell_searcher(
                    name, task, int(bo_seeds[cell.index]), aarc_res, donor)
                res = searcher.search(task.template.copy(), task.slo)
                cell.searcher = searcher
                cell.warm_source = warm_src
                cell.result = res
                cell.spent = res.n_samples
                remaining -= res.n_samples
                self._settle(cell)
                if name == "aarc":
                    aarc_res = res
                if res.feasible and sig not in donors:
                    donors[sig] = (task.template, res.configs, task.index,
                                   False)
                if res.feasible and bucket not in bucket_donors:
                    bucket_donors[bucket] = (task.template, res.configs,
                                             task.index, False)
                if progress is not None:
                    progress(f"seed {name} {task.kind}#{task.index} "
                             f"spent={res.n_samples} "
                             f"att={cell.attainment:.2f} warm={warm_src}")

        # -- adaptive allocation rounds -------------------------------
        rounds = 0
        for t in range(1, spec.max_rounds + 1):
            if remaining <= 0:
                break
            candidates = [c for c in cells if self._is_candidate(c)]
            if not candidates:
                break
            k = max(1, int(spec.grants_per_round))
            picked = sorted(candidates,
                            key=lambda c: (self._score(c, t), -c.index),
                            reverse=True)[:k]
            grants: List[Tuple[CellState, int, int]] = []
            reserve = remaining
            for cell in picked:
                if reserve <= 0:
                    break
                g = min(spec.round_budget, reserve)
                reserve -= g
                grants.append((cell, g, cell.result.n_samples))
            if len(grants) == 1:
                cell, g, _ = grants[0]
                resumed = [cell.searcher.resume(cell.result.state, g)]
            else:
                # batch settlement: the round's grants advance together
                # through the lockstep grid plane — one fused backend
                # evaluation per probe round instead of K resumes
                resumed = run_grid_search(
                    [GridResume(searcher=cell.searcher,
                                state=cell.result.state, extra_budget=g)
                     for cell, g, _ in grants]).results
            rounds += 1
            for (cell, g, before), res in zip(grants, resumed):
                used = res.n_samples - before
                cell.grants += 1
                if used == 0:
                    # the searcher declined the grant (converged /
                    # provably stuck): nothing spent, cell leaves the pool
                    cell.exhausted = True
                    cell.history.append(cell.attainment)
                    continue
                cell.spent += used
                remaining -= used
                cell.result = res
                self._settle(cell, used=used)
                if progress is not None:
                    progress(f"round {t}: {cell.searcher_name} "
                             f"{cell.task.kind}#{cell.task.index} +{used} "
                             f"att={cell.attainment:.2f} "
                             f"remaining={remaining}")

        spent = sum(c.spent for c in cells)
        return AdaptiveReport(
            spec=spec, cells=cells, rounds=rounds,
            budget={"total": total, "spent": spent, "remaining": remaining},
            wall_time_s=time.perf_counter() - t0)


def run_adaptive(spec: AdaptiveSpec = AdaptiveSpec(), *,
                 env_factory: Optional[Callable[[], Environment]] = None,
                 progress: Optional[Callable[[str], None]] = None,
                 device: DeviceLike = None) -> AdaptiveReport:
    """Functional entry point: ``run_adaptive(AdaptiveSpec(...))``."""
    return AdaptiveCampaign(spec, env_factory=env_factory,
                            device=device).run(
        progress=progress)
