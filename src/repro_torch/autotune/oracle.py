"""Analytic roofline oracle: StageSpec x ResourceConfig -> seconds, on
H100 physics.

The decoupled knobs (paper §III):

  cpu ∈ [0.1, 10]   — per-stage GPU share: chips = cpu/10 x pod(256).
                      Compute and HBM-bandwidth terms scale with chips
                      (with an Amdahl-style collective tax that grows
                      with chip count — more chips, more all-reduce).
  mem ∈ [128,10240] — per-stage activation budget as a fraction of the
                      full residency: below it, remat recomputes —
                      runtime multiplier up to +35% (full remat), and
                      below the *floor* (params + minimal workspace
                      don't fit) the stage OOMs like a serverless
                      function whose working set exceeds its quota.

Runtime = max(compute, memory, collective) + fixed dispatch latency.
The pod is 256 GPUs in one NVLink domain (the DGX H100 SuperPOD's NVLink
Switch System joins 256), so the collective term runs over NVLink.

The port's counterpart of ``src/repro/autotune/oracle.py`` (lines
1-117): the same runtime, ``clamped``, ``_mem_state`` and ``chips``
formulas, with :data:`~repro_torch.roofline.hw.H100_SXM` as the default
hardware and the NVLink links where the reference has its interconnect's.
"""
from __future__ import annotations

import dataclasses

from repro_torch.autotune.stages import StageSpec
from repro_torch.core.backend import CallableBackend
from repro_torch.core.cost import PricingModel
from repro_torch.core.dag import Node
from repro_torch.core.env import Environment, ExecutionError
from repro_torch.core.resources import CPU_MAX, MEM_MAX_MB
from repro_torch.roofline.hw import H100_SXM, HardwareSpec


@dataclasses.dataclass(frozen=True)
class OracleConfig:
    pod_chips: int = 256
    hw: HardwareSpec = H100_SXM
    dispatch_latency: float = 0.3e-3     # step launch overhead, seconds
    collective_frac: float = 0.08        # payload fraction all-reduced
    remat_max_penalty: float = 0.35
    mfu: float = 0.5                     # attainable fraction of peak


class GPUStageOracle:
    """node -> seconds under the node's decoupled (cpu, mem) config."""

    def __init__(self, cfg: OracleConfig = OracleConfig()):
        self.cfg = cfg

    def chips(self, node: Node) -> int:
        frac = node.config.cpu / CPU_MAX
        return max(int(round(frac * self.cfg.pod_chips)),
                   node.payload.min_chips)

    def _mem_state(self, node: Node):
        """(penalty multiplier, fits) for the activation budget."""
        spec: StageSpec = node.payload
        chips = self.chips(node)
        budget_frac = node.config.mem / MEM_MAX_MB
        # params must fit regardless; activations scale with budget
        per_chip = (spec.param_bytes + spec.act_bytes * budget_frac) / chips
        hbm = self.cfg.hw.hbm_bytes * 0.9
        if spec.param_bytes / chips > hbm:
            return 0.0, False                      # params alone OOM
        if per_chip > hbm:
            # even the requested budget doesn't fit on these chips
            return 0.0, False
        # recompute penalty grows as the budget shrinks below full
        penalty = self.cfg.remat_max_penalty * (1.0 - budget_frac)
        return penalty, True

    def runtime(self, node: Node) -> float:
        spec: StageSpec = node.payload
        chips = self.chips(node)
        penalty, fits = self._mem_state(node)
        if not fits:
            raise ExecutionError(
                f"{spec.name}: working set exceeds HBM at "
                f"{chips} chips / {node.config.mem:.0f} MB budget")
        hw = self.cfg.hw
        compute = spec.flops * (1.0 + penalty) / \
            (chips * hw.peak_flops_bf16 * self.cfg.mfu)
        memory = (spec.param_bytes + spec.act_bytes * (1.0 + penalty)) / \
            (chips * hw.hbm_bandwidth)
        # collective tax: ring all-reduce over the stage's chips
        coll_bytes = spec.param_bytes * self.cfg.collective_frac \
            * 2.0 * (chips - 1) / max(chips, 1)
        collective = coll_bytes / (hw.nvlink_link_bandwidth *
                                   hw.nvlink_links_per_chip)
        return (max(compute, memory) + collective
                + self.cfg.dispatch_latency)

    def __call__(self, node: Node) -> float:
        return self.runtime(node)

    def clamped(self, node: Node) -> float:
        """Wall time a failing configuration burns before abort."""
        spec: StageSpec = node.payload
        chips = self.chips(node)
        hw = self.cfg.hw
        return (spec.param_bytes + spec.act_bytes) / \
            (chips * hw.hbm_bandwidth) + 10 * self.cfg.dispatch_latency

    def backend(self) -> CallableBackend:
        """This oracle as a :class:`repro_torch.core.backend.RuntimeBackend`."""
        return CallableBackend(self, self.clamped)


#: GPU pricing: mu0 per cpu-unit-second (25.6 GPUs), mu1 per "MB"
#: budget-second — the paper's constants, so cost numbers compare.
GPU_PRICING = PricingModel(mu0=0.512, mu1=0.001, mu2=0.0)


def make_gpu_env(oracle_cfg: OracleConfig = OracleConfig()) -> Environment:
    oracle = GPUStageOracle(oracle_cfg)
    return Environment(oracle.backend(), pricing=GPU_PRICING)
