"""Bayesian-Optimization baseline (Bilal et al. [8], extended to workflows).

Per §IV-A(b): the decoupled search space is discretized — memory in
64 MB increments over [128, 10240] MB and vCPU in [0.1, 10] — and the
whole workflow is optimized jointly, so the input dimension is
``2 × n_functions``. The surrogate is a Gaussian process with an RBF
kernel; the acquisition is expected improvement over an SLO-penalized
cost objective, optimized by candidate sampling. Self-contained numpy —
no external optimizer dependency.

``batch_size`` enables *batch BO*: each round scores the candidate
pool once and evaluates the top-``q`` acquisition points through
:meth:`repro_torch.core.env.Environment.execute_candidates` — one vectorized
backend call per round instead of point-by-point execution. The GP is
refit with all q results before the next round. ``batch_size=1`` is
the original sequential loop, bit-for-bit.

Cross-run knowledge transfer (the adaptive-campaign layer):

  * ``warm_start`` — trace :class:`repro_torch.core.env.Sample` rows from a
    *prior* search over the same workflow/environment (e.g. AARC's
    accepted trials) become GP training data for free: their objective
    values are recomputed from the recorded latency/cost, so no budget
    is spent re-measuring them. A warm-started run skips the random
    initial design entirely. An *empty* ``warm_start`` is exactly the
    cold optimizer, bit-for-bit.
  * ``init_points`` — per-function configuration maps (e.g. the best
    configuration of a structurally identical workflow) evaluated as
    the first design points in place of random ones.
  * :meth:`run` is *resumable*: the sample budget counts evaluated
    points only, and calling ``run`` again with a larger budget
    continues the search from the existing GP state instead of
    restarting (``Searcher.resume`` uses this).

The port's copy of ``src/repro/core/baselines/bo.py`` (lines 1-274),
numpy and plain Python as there, so that its float operations run in the
same order.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.dag import Workflow
from repro_torch.core.env import Environment, Sample
from repro_torch.core.gridsearch import (CandidatesRequest, ExecuteRequest,
                                         GridPlan, drive_plan)
from repro_torch.core.resources import (CPU_MAX, CPU_MIN, MEM_MAX_MB, MEM_MIN_MB,
                                        ResourceConfig, quantize_cpu, quantize_mem)


def _to_unit(x: np.ndarray) -> np.ndarray:
    """Map raw (cpu, mem) pairs per function into [0, 1]^d."""
    u = np.empty_like(x, dtype=np.float64)
    u[..., 0::2] = (x[..., 0::2] - CPU_MIN) / (CPU_MAX - CPU_MIN)
    u[..., 1::2] = (x[..., 1::2] - MEM_MIN_MB) / (MEM_MAX_MB - MEM_MIN_MB)
    return u


def _rbf(a: np.ndarray, b: np.ndarray, ls: float) -> np.ndarray:
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2 / (ls * ls))


class BayesianOptimizer:
    """GP + expected-improvement search over the decoupled config space."""

    def __init__(self, wf: Workflow, slo: float, env: Environment, *,
                 seed: int = 0, n_init: int = 8, n_candidates: int = 512,
                 lengthscale: float = 0.25, noise: float = 1e-4,
                 slo_penalty: float = 10.0, batch_size: int = 1,
                 warm_start: Optional[Sequence[Sample]] = None,
                 init_points: Optional[Sequence[Dict[str,
                                                     ResourceConfig]]] = None):
        self.wf = wf
        self.batch_size = max(1, batch_size)
        self.slo = slo
        self.env = env
        self.rng = np.random.default_rng(seed)
        self.names = list(wf.nodes)
        self.dim = 2 * len(self.names)
        self.n_init = n_init
        self.n_candidates = n_candidates
        self.ls = lengthscale
        self.noise = noise
        self.slo_penalty = slo_penalty
        self.X: List[np.ndarray] = []
        self.y: List[float] = []
        self.init_points = list(init_points or ())
        self._n_warm = 0
        self._initialized = False
        self._inject_warm(warm_start or ())

    @property
    def evaluated(self) -> int:
        """Samples actually measured through the environment — warm
        points are prior knowledge and never count against the budget."""
        return len(self.y) - self._n_warm

    def _inject_warm(self, warm: Sequence[Sample]) -> None:
        """Seed the GP with prior trace samples, free of charge."""
        for sample in warm:
            if not sample.config_items or not math.isfinite(
                    sample.e2e_runtime):
                continue
            cfg = sample.configs
            if set(cfg) != set(self.names):
                continue
            self.X.append(self._x_from_configs(cfg))
            self.y.append(self._objective(sample))
            self._n_warm += 1

    # -- config <-> vector ---------------------------------------------
    def _apply(self, x: np.ndarray) -> None:
        for i, name in enumerate(self.names):
            self.wf.nodes[name].config = ResourceConfig(
                cpu=quantize_cpu(float(x[2 * i])),
                mem=quantize_mem(float(x[2 * i + 1])))

    def _random_x(self, n: int) -> np.ndarray:
        x = np.empty((n, self.dim))
        x[:, 0::2] = self.rng.uniform(CPU_MIN, CPU_MAX, size=(n, len(self.names)))
        x[:, 1::2] = self.rng.uniform(MEM_MIN_MB, MEM_MAX_MB,
                                      size=(n, len(self.names)))
        return x

    def _objective(self, sample: Sample) -> float:
        """SLO-penalized cost (normalized penalty keeps GP well-scaled)."""
        if not math.isfinite(sample.e2e_runtime):
            finite = [v for v in self.y if math.isfinite(v)]
            return 10.0 * max(finite) if finite else 1e6
        pen = max(0.0, sample.e2e_runtime / self.slo - 1.0)
        if sample.error:                       # OOM-killed invocation
            pen += 3.0
        return sample.cost * (1.0 + self.slo_penalty * pen)

    def _evaluate_plan(self, x: np.ndarray):
        self._apply(x)
        sample = yield ExecuteRequest(wf=self.wf, slo=self.slo, note="bo")
        val = self._objective(sample)
        self.X.append(x.copy())
        self.y.append(val)
        return val

    def _config_map(self, x: np.ndarray) -> dict:
        return {name: ResourceConfig(cpu=quantize_cpu(float(x[2 * i])),
                                     mem=quantize_mem(float(x[2 * i + 1])))
                for i, name in enumerate(self.names)}

    def _x_from_configs(self, configs: Dict[str, ResourceConfig]) -> np.ndarray:
        x = np.empty(self.dim)
        for i, name in enumerate(self.names):
            try:
                cfg = configs[name]
            except KeyError:
                raise ValueError(
                    f"configuration map is missing function {name!r} of "
                    f"workflow {self.wf.name!r}")
            x[2 * i] = cfg.cpu
            x[2 * i + 1] = cfg.mem
        return x

    def _evaluate_batch_plan(self, xs: np.ndarray):
        """Evaluate a whole acquisition batch in ONE backend call."""
        candidates = [self._config_map(x) for x in xs]
        samples = yield CandidatesRequest(wf=self.wf, candidates=candidates,
                                          slo=self.slo, note="bo")
        for x, sample in zip(xs, samples):
            # objective depends on the y-history, so append in order
            val = self._objective(sample)
            self.X.append(np.asarray(x, dtype=np.float64).copy())
            self.y.append(val)

    # -- GP posterior ----------------------------------------------------
    def _posterior(self, cand: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        X = _to_unit(np.stack(self.X))
        y = np.asarray(self.y)
        mu0, sd = y.mean(), max(y.std(), 1e-9)
        yn = (y - mu0) / sd
        K = _rbf(X, X, self.ls) + self.noise * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
        Kc = _rbf(_to_unit(cand), X, self.ls)
        mean = Kc @ alpha
        v = np.linalg.solve(L, Kc.T)
        var = np.clip(1.0 - (v * v).sum(0), 1e-12, None)
        return mean * sd + mu0, np.sqrt(var) * sd

    def _expected_improvement(self, cand: np.ndarray) -> np.ndarray:
        mean, std = self._posterior(cand)
        best = min(self.y)
        z = (best - mean) / std
        # standard normal pdf / cdf without scipy
        pdf = np.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
        cdf = 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))
        return (best - mean) * cdf + std * pdf

    # -- main loop ---------------------------------------------------------
    def run(self, n_rounds: int = 100) -> Optional[Sample]:
        """Search until ``n_rounds`` samples have been *evaluated*.

        Re-entrant: calling ``run`` again with a larger ``n_rounds``
        continues from the current GP state (no re-initialization), so
        a resumed search spends exactly the extra budget.

        Sequential driver over :meth:`run_plan`.
        """
        return drive_plan(GridPlan(self.env, self.run_plan(n_rounds)))

    def run_plan(self, n_rounds: int = 100):
        """The BO loop as a sans-IO plan generator (see
        :mod:`repro_torch.core.gridsearch`): each design point / acquisition
        batch is requested via ``yield``, so the sequential and
        lockstep drivers run the identical GP decision sequence."""
        if not self.env.trace.capture_configs:
            raise ValueError(
                "BO reads the winning configuration back from the trace "
                "(best_feasible().configs); capture_configs=False would "
                "silently return empty configs")
        if not self._initialized:
            self._initialized = True
            yield from self._initial_design_plan(n_rounds)
        while self.evaluated < n_rounds:
            cand = self._random_x(self.n_candidates)
            ei = self._expected_improvement(cand)
            if self.batch_size == 1:
                yield from self._evaluate_plan(cand[int(np.argmax(ei))])
            else:
                q = min(self.batch_size, n_rounds - self.evaluated)
                top = np.argsort(ei)[::-1][:q]       # best-EI first
                yield from self._evaluate_batch_plan(cand[top])
        best = self.env.trace.best_feasible()
        if best is not None:
            self.wf.apply_configs(best.configs)
        return best

    def _initial_design_plan(self, n_rounds: int):
        """Evaluate the initial design: the over-provisioned platform
        default (practitioners start from the known-safe config), then
        any transferred ``init_points``, then random points up to
        ``n_init``. Warm-started runs already own GP data, so they skip
        the safe-base/random design and evaluate only the transferred
        incumbents."""
        ipts = [self._x_from_configs(c) for c in self.init_points]
        if self._n_warm > 0:
            for x in ipts:
                if self.evaluated >= n_rounds:
                    break
                yield from self._evaluate_plan(x)
            return
        base = np.empty(self.dim)
        base[0::2], base[1::2] = CPU_MAX, MEM_MAX_MB
        if self.batch_size == 1:
            yield from self._evaluate_plan(base)
            for x in ipts[:max(0, n_rounds - 1)]:
                yield from self._evaluate_plan(x)
            n_rand = min(self.n_init, n_rounds) - 1 - len(ipts)
            for _ in range(max(0, n_rand)):
                yield from self._evaluate_plan(self._random_x(1)[0])
        else:
            # batch BO: same design points, evaluated q at a time
            n_init = min(self.n_init, n_rounds)
            rows = [base[None, :]] + [x[None, :] for x in ipts]
            n_rand = n_init - 1 - len(ipts)
            if n_rand > 0:
                rows.append(self._random_x(n_rand))
            init = np.concatenate(rows)[:max(1, n_rounds)]
            for lo in range(0, len(init), self.batch_size):
                yield from self._evaluate_batch_plan(
                    init[lo:lo + self.batch_size])


def bo_search(wf: Workflow, slo: float, env: Environment,
              n_rounds: int = 100, seed: int = 0, **kw) -> Optional[Sample]:
    return BayesianOptimizer(wf, slo, env, seed=seed, **kw).run(n_rounds)
