"""Simulated FaaS platform: response surfaces as runtime backends, and
a measured oracle timed on the card.

Backend modes (all implement
:class:`repro_torch.core.backend.RuntimeBackend`):

* **analytic** (:class:`AnalyticBackend`, default) — deterministic
  evaluation of each function's :class:`FunctionSpec` response surface.
  ``invoke_batch`` vectorizes a whole batch of invocations into one
  numpy expression — the fleet engine's hot path — and matches the
  scalar :meth:`FunctionSpec.runtime` bit-for-bit.
* **stochastic** (:class:`StochasticBackend`) — multiplies each
  invocation by log-normal noise (default sigma 2.5 %), used by the
  Table-II style "execute the final configuration 100 times"
  validation runs.
* **measured** (:class:`TorchMeasuredOracle`) — times a real (tiny)
  matmul on the device, scaled by the configured resources,
  demonstrating that the searchers are backend-agnostic (wrapped via
  :class:`repro_torch.core.backend.CallableBackend`).

The port's copy of ``src/repro/serverless/platform.py``:
``AnalyticBackend`` with its replay-plane contract (``config_surface``,
``replay_noise``; lines 34-177), ``StochasticBackend`` (lines 241-321),
``SimulatedPlatform``, ``make_env`` and ``make_scaled_env`` (lines
323-366), and :class:`TorchMeasuredOracle` as the counterpart of
``JaxMeasuredOracle`` (lines 369-392). ``AnalyticBackend`` carries the
reference's ``invocations`` counter and its fused-grid contract
(``grid_fusion_key``, ``surface_tables``, ``surface_probe``,
``surface_floor``, ``apply_invocation_noise``; lines 183-239), which the
lockstep grid runner (:mod:`repro_torch.core.gridsearch`) reads;
``SimulatedPlatform`` has the reference's ``invocations``, ``oracle``
and ``clamped_oracle`` views.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.backend import BaseBackend
from repro_torch.core.cost import DEFAULT_PRICING, PricingModel
from repro_torch.core.dag import Node
from repro_torch.core.env import Environment
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.serverless.function import FunctionSpec


class AnalyticBackend(BaseBackend):
    """Deterministic response-surface backend with vectorized batches."""

    def __init__(self, *, input_scale: float = 1.0):
        self.input_scale = input_scale
        self.invocations = 0
        #: id(node) -> (node, spec-constant row); specs are immutable,
        #: so the gather in :meth:`_spec_arrays` only pays the python
        #: attribute walk once per node (the held reference keeps the
        #: id stable for the cache's lifetime)
        self._spec_rows: Dict[int, tuple] = {}

    has_clamped = True
    #: pure response surface — batching/order never change results, so
    #: the fleet engine may evaluate whole candidate planes at once
    deterministic = True
    #: priority-search batch-size crossover (``priority_plan``): a
    #: scalar surface invoke costs ~2µs while ``invoke_batch`` pays a
    #: ~30µs fixed array round-trip, so rounds up to this width are
    #: cheaper served op-by-op (the reference's measurement)
    scalar_round_max = 16

    def _spec(self, node: Node) -> FunctionSpec:
        spec = node.payload
        if not isinstance(spec, FunctionSpec):
            raise TypeError(f"node {node.name} has no FunctionSpec payload")
        return spec

    # -- scalar path (search trials, legacy oracle callers) -----------
    def invoke(self, node: Node) -> float:
        spec = self._spec(node)
        self.invocations += 1
        rt = spec.runtime(node.config, input_scale=self.input_scale)
        return self._noise_one(rt)

    def invoke_clamped(self, node: Node) -> float:
        """Thrash-until-killed runtime for failing configs (see env.py)."""
        spec = self._spec(node)
        return spec.runtime_clamped(node.config, input_scale=self.input_scale)

    def _noise_one(self, rt: float) -> float:
        return rt

    def _noise_batch(self, rt: np.ndarray, ok: np.ndarray) -> np.ndarray:
        return rt

    def _spec_arrays(self, nodes: Sequence[Node]) -> Tuple[np.ndarray, ...]:
        """Gather the response-surface constants of ``nodes`` (shape (n,))."""
        cache = self._spec_rows
        rows = []
        for node in nodes:
            hit = cache.get(id(node))
            if hit is None or hit[0] is not node:
                spec = self._spec(node)
                hit = (node, (spec.cpu_work, spec.parallel_frac,
                              spec.mem_floor, spec.mem_knee,
                              spec.mem_penalty, spec.io_time,
                              bool(spec.scale_mem)))
                cache[id(node)] = hit
            rows.append(hit[1])
        (cpu_work, pfrac, mem_floor, mem_knee, penalty, io,
         scale_mem) = zip(*rows) if rows else ((),) * 7
        return (np.array(cpu_work), np.array(pfrac), np.array(mem_floor),
                np.array(mem_knee), np.array(penalty), np.array(io),
                np.array(scale_mem, dtype=bool))

    def _surface(self, cpu: np.ndarray, mem: np.ndarray,
                 spec_arrays: Tuple[np.ndarray, ...]
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Evaluate the response surface for any broadcastable config
        arrays (``(n,)`` for one invocation batch, ``(C, n)`` for C
        candidate configurations of the same n functions)."""
        cpu_work, pfrac, mem_floor, mem_knee, penalty, io, scale_mem = \
            spec_arrays
        s = self.input_scale
        eff = np.where(scale_mem, s, 1.0)
        floor = mem_floor * eff
        knee = mem_knee * eff
        failed = mem < floor                            # OOM-killed
        flat = (mem >= knee) | (knee <= floor)          # above the knee
        safe_div = np.where(knee > floor, knee - floor, 1.0)
        frac = np.where(flat | failed, 0.0, (knee - mem) / safe_div)
        mem_factor = 1.0 + penalty * frac
        # failing invocations thrash at the working-set floor
        mem_factor = np.where(failed, 1.0 + penalty, mem_factor)
        amdahl = (1.0 - pfrac) + pfrac / np.maximum(cpu, 1e-6)
        work = cpu_work * s
        runtimes = io + work * amdahl * mem_factor
        runtimes = self._noise_batch(runtimes, ~failed)
        return runtimes, failed

    # -- vectorized path (one engine step == one numpy evaluation) -----
    def invoke_batch(self, nodes: Sequence[Node]) -> Tuple[np.ndarray, np.ndarray]:
        self.invocations += len(nodes)
        cfgs = [node.config for node in nodes]
        cpu = np.array([c.cpu for c in cfgs])
        mem = np.array([c.mem for c in cfgs])
        spec_arrays = self._spec_arrays(nodes)
        runtimes, failed = self._surface(cpu, mem, spec_arrays)
        if failed.any():                # keep the common all-ok path hot
            eff = np.where(spec_arrays[6], self.input_scale, 1.0)
            floor = spec_arrays[2] * eff
            for i in np.flatnonzero(failed):
                nodes[i].fail_reason = (
                    f"{nodes[i].name}: OOM ({mem[i]:.0f} MB < working set "
                    f"{floor[i]:.0f} MB)")
        return runtimes, failed

    def invoke_config_batch(self, nodes: Sequence[Node], cpu: np.ndarray,
                            mem: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """C candidate configurations × n functions in ONE numpy call.

        ``cpu``/``mem`` have shape ``(C, n)`` aligned to ``nodes``; the
        response-surface constants are gathered once and broadcast, so
        the per-node Python cost is amortized over all C candidates (see
        :meth:`repro_torch.core.env.Environment.execute_candidates`).
        """
        self.invocations += int(np.size(cpu))
        return self._surface(np.asarray(cpu, dtype=np.float64),
                             np.asarray(mem, dtype=np.float64),
                             self._spec_arrays(nodes))

    # -- batched-replay plane contract (FleetEngine.run_many) ----------
    def config_surface(self, nodes: Sequence[Node], cpu: np.ndarray,
                       mem: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Noise-*free* response surface for a candidate plane: the
        deterministic part of :meth:`invoke_config_batch`, with no RNG
        state advanced — safe for diagnostics
        (:meth:`FleetEngine.batch_eligibility`) and for the replay
        plane, which re-applies invocation noise from
        :meth:`replay_noise` at the (instance, function) coordinate.
        For the plain analytic backend this *is* ``invoke_config_batch``.
        """
        self.invocations += int(np.size(cpu))
        self._suppress_noise = True
        try:
            return self._surface(np.asarray(cpu, dtype=np.float64),
                                 np.asarray(mem, dtype=np.float64),
                                 self._spec_arrays(nodes))
        finally:
            self._suppress_noise = False

    def replay_noise(self, n_instances: int,
                     n_nodes: int) -> Optional[np.ndarray]:
        """Per-(instance, function) noise factors for one batched
        replay plane; ``None`` means the surface is exact (no noise)."""
        return None

    # -- lockstep grid-search fusion contract (core.gridsearch) --------
    def grid_fusion_key(self) -> Optional[tuple]:
        """Cells over analytic surfaces with the same ``input_scale``
        may share one fused response-surface evaluation per lockstep
        round. Subclasses that override any piece of the batch pipeline
        get ``None`` (per-cell serving) unless they re-opt-in."""
        cls = type(self)
        if (cls.invoke_batch is not AnalyticBackend.invoke_batch
                or cls.invoke_config_batch is not
                AnalyticBackend.invoke_config_batch
                or cls._surface is not AnalyticBackend._surface
                or cls._spec_arrays is not AnalyticBackend._spec_arrays):
            return None
        if not (self.deterministic or self.batch_safe):
            return None
        return ("analytic-surface", float(self.input_scale))

    def surface_tables(self, nodes: Sequence[Node]) -> Tuple[np.ndarray, ...]:
        """Surface constants of ``nodes`` for :meth:`surface_probe` —
        a pure gather (no backend state touched)."""
        return self._spec_arrays(nodes)

    def surface_probe(self, cpu: np.ndarray, mem: np.ndarray,
                      tables: Tuple[np.ndarray, ...]
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Noise-free surface evaluation for a fused cross-cell batch.

        Advances neither the invocation counter nor any rng stream —
        the grid driver accounts each cell's share to that cell's own
        backend (``invocations`` / :meth:`apply_invocation_noise`), so
        per-cell bookkeeping matches the sequential path exactly."""
        self._suppress_noise = True
        try:
            return self._surface(np.asarray(cpu, dtype=np.float64),
                                 np.asarray(mem, dtype=np.float64), tables)
        finally:
            self._suppress_noise = False

    def surface_floor(self, tables: Tuple[np.ndarray, ...]) -> np.ndarray:
        """Per-node OOM thresholds implied by ``tables`` — the working-set
        floors the batch pipeline compares ``mem`` against. Exposed so
        the fused grid plane can reconstruct :meth:`invoke_batch`'s
        failure strings (and the scalar ``ExecutionError`` message,
        which formats the same two floats) without re-serving a failed
        cell through the sequential path."""
        return tables[2] * np.where(tables[6], self.input_scale, 1.0)

    def apply_invocation_noise(self, rt: np.ndarray,
                               ok: np.ndarray) -> np.ndarray:
        """Apply the invocation noise the sequential batch call would
        have drawn for these runtimes (identity on the analytic
        surface; one ``rt.shape`` log-normal draw on the stochastic
        one). Must be called with the same array shape the sequential
        ``invoke_batch``/``invoke_config_batch`` call would have used,
        so the backend's stream advances identically."""
        return self._noise_batch(rt, ok)


class StochasticBackend(AnalyticBackend):
    """Analytic surface x log-normal invocation noise (§IV validation).

    Inherits the full vectorized surface, **including**
    ``invoke_config_batch``: a C×N candidate plane draws its (C, N)
    noise matrix in candidate-major order — the same order a loop of
    scalar ``invoke`` calls (or C ``invoke_batch`` rows) consumes the
    stream — so batched candidate evaluation is bit-identical to the
    scalar path under a fixed seed.

    The RNG is stateful, so the backend is *not* ``deterministic`` —
    but it IS ``batch_safe``: it implements the fleet engine's paired
    replay-stream contract. One :meth:`replay_noise` call per
    ``FleetEngine.run_many`` plane draws an (instances, functions)
    noise tensor from the backend's stream (ONE state advance per
    plane, instance-major), and every invocation of instance *i*'s
    function *v* — whichever candidate, whichever admission round —
    pays factor ``noise[i, v]``. Noise keyed by coordinate instead of
    call order makes batched replays reproducible and **paired**: all
    candidates see identical draws, so a challenger-vs-incumbent
    comparison is a paired experiment, and the same configuration in
    two candidate slots scores identically.

    Fault injection (``FleetEngine(faults=...)``) composes with this
    contract without touching the backend: the engine draws its own
    per-plane fault stream (one seeded rng advance, keyed by the
    ``(attempt, instance, function)`` coordinate — see
    :meth:`repro_torch.core.faults.FaultModel.fault_stream`)
    *independent* of this backend's noise stream, so a stochastic fleet
    under faults still replays as a paired experiment across candidates.
    Caveat: under faults the serial looped-``run`` fallback re-draws
    ``replay_noise`` per cell while a ``run_many`` plane draws once for
    all cells — the same plane-level segmenting ``replay_noise`` itself
    has — so stochastic serial-vs-batched identity holds per plane, not
    across differently shaped planes.
    """

    deterministic = False
    #: stateful, but replay-plane-eligible via the paired-stream
    #: contract (config_surface + replay_noise)
    batch_safe = True
    #: opting into the scalar-round crossover changes which rng draw a
    #: narrow round's trial sees (per-op ``_noise_one`` instead of one
    #: batched probe draw) — statistically equivalent, and the per-op
    #: draw is ~4µs against the probe's ~50µs fixed cost (the
    #: reference's measured break-even ~k=16; 8 leaves margin for the
    #: noise-draw slope)
    scalar_round_max = 8

    def __init__(self, *, noise_sigma: float = 0.025, seed: int = 0,
                 input_scale: float = 1.0):
        super().__init__(input_scale=input_scale)
        self.noise_sigma = noise_sigma
        self.rng = np.random.default_rng(seed)

    def _noise_one(self, rt: float) -> float:
        if self.noise_sigma <= 0.0:
            return rt
        return rt * float(np.exp(self.rng.normal(0.0, self.noise_sigma)))

    def _noise_batch(self, rt: np.ndarray, ok: np.ndarray) -> np.ndarray:
        if self.noise_sigma <= 0.0 or getattr(self, "_suppress_noise",
                                              False):
            return rt
        noise = np.exp(self.rng.normal(0.0, self.noise_sigma, size=rt.shape))
        # failing invocations are charged the deterministic thrash time
        return np.where(ok, rt * noise, rt)

    def replay_noise(self, n_instances: int,
                     n_nodes: int) -> Optional[np.ndarray]:
        """The paired replay-stream contract: one (instances, functions)
        log-normal factor tensor per batched replay plane, drawn
        instance-major from the backend's stream. Candidates share the
        tensor — see the class docstring."""
        if self.noise_sigma <= 0.0:
            return None
        return np.exp(self.rng.normal(0.0, self.noise_sigma,
                                      size=(n_instances, n_nodes)))


class SimulatedPlatform:
    """Convenience wrapper bundling a backend with pricing
    (``SimulatedPlatform().environment()``, as in the reference): the
    analytic surface, or the stochastic one when ``noise_sigma > 0``."""

    def __init__(self, *, input_scale: float = 1.0, noise_sigma: float = 0.0,
                 seed: int = 0, pricing: PricingModel = DEFAULT_PRICING):
        self.input_scale = input_scale
        self.noise_sigma = noise_sigma
        self.pricing = pricing
        if noise_sigma > 0.0:
            self.backend: AnalyticBackend = StochasticBackend(
                noise_sigma=noise_sigma, seed=seed, input_scale=input_scale)
        else:
            self.backend = AnalyticBackend(input_scale=input_scale)

    @property
    def invocations(self) -> int:
        return self.backend.invocations

    def oracle(self, node: Node) -> float:
        return self.backend.invoke(node)

    def clamped_oracle(self, node: Node) -> float:
        """Thrash-until-killed runtime for failing configs (see env.py)."""
        return self.backend.invoke_clamped(node)

    def environment(self) -> Environment:
        return Environment(self.backend, pricing=self.pricing)


def make_env(*, input_scale: float = 1.0, noise_sigma: float = 0.0,
             seed: int = 0, pricing: PricingModel = DEFAULT_PRICING) -> Environment:
    """Convenience: a fresh Environment over a fresh simulated platform."""
    return SimulatedPlatform(input_scale=input_scale, noise_sigma=noise_sigma,
                             seed=seed, pricing=pricing).environment()


def make_scaled_env(scale: float) -> Environment:
    """Factory signature used by the Input-Aware engine (§IV-D)."""
    return make_env(input_scale=scale)


class TorchMeasuredOracle:
    """Measured oracle: times one unit of real work on the device (the
    sum of a ``unit_dim`` x ``unit_dim`` fp32 matmul of ones), scales it
    to the function's nominal work and applies the resource model of
    the configured allocation, as ``JaxMeasuredOracle`` does.

    ``device=None`` means the CUDA card (and raises without one). On the
    card each unit is timed by a pair of CUDA events around it; on the
    CPU by ``time.perf_counter``. No warm-up is added: the first call
    includes the library's first use of the product, as the reference's
    first call includes its compile. A failing configuration (memory
    below the working set) is measured first and then raises
    :class:`~repro_torch.core.env.ExecutionError`, as in the reference.
    """

    def __init__(self, unit_dim: int = 128, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.unit_dim = unit_dim

    def unit(self) -> float:
        """Seconds of one unit of work on the device."""
        a = torch.ones((self.unit_dim, self.unit_dim), dtype=torch.float32,
                       device=self.device)
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            (a @ a).sum()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        (a @ a).sum()
        return time.perf_counter() - t0

    def __call__(self, node: Node) -> float:
        spec: FunctionSpec = node.payload
        measured_unit = self.unit()
        # scale measured unit work to the function's nominal work, then
        # apply the resource model for the configured allocation
        work = measured_unit * 1e3 * spec.cpu_work
        return spec.io_time + work * spec.amdahl(node.config.cpu) * \
            spec.mem_factor(node.config.mem)
