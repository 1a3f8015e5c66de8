"""Simulated FaaS platform: response surfaces as runtime backends, and
a measured oracle timed on the card.

* **analytic** (:class:`AnalyticBackend`) — deterministic
  response-surface evaluation; used by every configuration search
  (deterministic => reproducible search traces). ``invoke_batch``
  evaluates a whole batch of pending invocations in ONE vectorized
  numpy expression and matches the scalar :meth:`FunctionSpec.runtime`
  bit-for-bit.
* **measured** (:class:`TorchMeasuredOracle`) — times a real (tiny)
  matmul on the device, scaled by the configured resources,
  demonstrating that the searchers are backend-agnostic (wrapped via
  :func:`repro_torch.core.backend.as_backend`).

The port's copy of ``src/repro/serverless/platform.py``:
``AnalyticBackend`` (lines 34-240), ``SimulatedPlatform`` and
``make_env`` (lines 323-361) without invocation noise, and
:class:`TorchMeasuredOracle` as the counterpart of ``JaxMeasuredOracle``
(lines 369-392). Left out: ``StochasticBackend`` (so ``noise_sigma``
and ``seed``), ``make_scaled_env``, and the analytic backend's noise
hooks and its fleet-replay and fused-grid contracts (``config_surface``,
``replay_noise``, ``grid_fusion_key``, ``surface_*``,
``apply_invocation_noise``), which only the reference's fleet engine
and grid driver call, and the invocation counters and
``SimulatedPlatform``'s oracle views, which no caller of the port reads.
"""
from __future__ import annotations

import time
from typing import Dict, Sequence, Tuple

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
        #: id(node) -> (node, spec-constant row); specs are immutable,
        #: so the gather in :meth:`_spec_arrays` only pays the python
        #: attribute walk once per node (the held reference keeps the
        #: id stable for the cache's lifetime)
        self._spec_rows: Dict[int, tuple] = {}

    has_clamped = True
    #: pure response surface — batching/order never change results
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
        return spec.runtime(node.config, input_scale=self.input_scale)

    def invoke_clamped(self, node: Node) -> float:
        """Thrash-until-killed runtime for failing configs (see env.py)."""
        spec = self._spec(node)
        return spec.runtime_clamped(node.config, input_scale=self.input_scale)

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
        return runtimes, failed

    # -- vectorized path (one numpy evaluation per batch) --------------
    def invoke_batch(self, nodes: Sequence[Node]) -> Tuple[np.ndarray, np.ndarray]:
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
        response-surface constants are gathered once and broadcast (see
        :meth:`repro_torch.core.env.Environment.execute_candidates`).
        """
        return self._surface(np.asarray(cpu, dtype=np.float64),
                             np.asarray(mem, dtype=np.float64),
                             self._spec_arrays(nodes))


class SimulatedPlatform:
    """Convenience wrapper bundling the analytic backend with pricing
    (``SimulatedPlatform().environment()``, as in the reference)."""

    def __init__(self, *, input_scale: float = 1.0,
                 pricing: PricingModel = DEFAULT_PRICING):
        self.input_scale = input_scale
        self.pricing = pricing
        self.backend = AnalyticBackend(input_scale=input_scale)

    def environment(self) -> Environment:
        return Environment(self.backend, pricing=self.pricing)


def make_env(*, input_scale: float = 1.0,
             pricing: PricingModel = DEFAULT_PRICING) -> Environment:
    """Convenience: a fresh Environment over a fresh simulated platform."""
    return SimulatedPlatform(input_scale=input_scale,
                             pricing=pricing).environment()


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
