"""Pricing model (§IV-A d).

cost_ij = t_ij * (mu0 * cpu_j + mu1 * mem_j) + mu2

The paper sets mu0 = 0.512, mu1 = 0.001, mu2 = 0 and *states* mu1 is
per GB-second. That unit cannot reproduce the paper's own Table II:
at per-GB pricing, memory is ~0.2 % of workflow cost, so the claimed
ML-Pipeline saving (-61.7 % total cost achieved chiefly through a
-87.5 % memory cut) is arithmetically impossible. The numbers *are*
consistent if mu1 = 0.001 is per **MB**-second (memory ≈ 2/3 of the
base-config rate, 10240 MB * 0.001 = 10.24 vs 10 vCPU * 0.512 = 5.12).
We therefore apply mu1 per MB-second and record the discrepancy in
EXPERIMENTS.md §Fidelity.

The port's copy of ``src/repro/core/cost.py`` (lines 1-68), numpy and
plain Python as there, so that its float operations run in the same
order.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

from repro_torch.core.resources import ResourceConfig


@dataclasses.dataclass(frozen=True)
class PricingModel:
    mu0: float = 0.512   # price per vCPU-second
    mu1: float = 0.001   # price per MB-second (see module docstring)
    mu2: float = 0.0     # price per request / orchestration

    def function_cost(self, runtime_s: float, config: ResourceConfig) -> float:
        return runtime_s * self.rate(config) + self.mu2

    def rate(self, config: ResourceConfig) -> float:
        """$ per second at this configuration (excluding mu2)."""
        return self.mu0 * config.cpu + self.mu1 * config.mem

    def cost_batch(self, runtime_s, cpu, mem):
        """Vectorized :meth:`function_cost` over aligned arrays of any
        broadcastable shape. Performs the same IEEE operations in the
        same order as the scalar path, so batched pricing (the fleet
        engine's admission rounds, ``FleetEngine.run_many`` candidate
        planes) is bit-identical to per-invocation calls."""
        return runtime_s * (self.mu0 * cpu + self.mu1 * mem) + self.mu2

    def replica_cost(self, replicas: int, config: ResourceConfig,
                     duration_s: float, *, frac: float = 1.0,
                     floor: float = 0.0) -> float:
        """Provisioning charge for keeping ``replicas`` containers of a
        function sized at ``config`` resident for ``duration_s``.

        Scale-out is never free: each provisioned replica-second is
        billed ``frac`` of the function's running rate (idle capacity
        is cheaper than busy capacity, but reserved) plus a ``floor``
        per-replica-second fixed charge (the container's own daemon /
        keep-resident overhead, independent of its size). Subclasses
        that override :meth:`rate` price replicas consistently."""
        return replicas * duration_s * (frac * self.rate(config) + floor)


DEFAULT_PRICING = PricingModel()


def workflow_cost(pricing: PricingModel, nodes: Iterable) -> float:
    """Total cost of one workflow execution = sum of function costs.

    ``nodes`` is an iterable of objects with ``.runtime`` and ``.config``
    (e.g. :class:`repro_torch.core.dag.Node`).
    """
    return sum(pricing.function_cost(n.runtime, n.config) for n in nodes)
