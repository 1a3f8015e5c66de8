"""Serverless function performance model.

Each function's runtime response surface follows the structure observed
in §II-A of the paper (and in Bilal et al. [8]):

  runtime(cpu, mem) = io_time + cpu_work * amdahl(cpu) * mem_factor(mem)

  * ``amdahl(cpu) = (1 - p) + p / cpu`` — a parallelizable fraction
    ``p`` of the compute scales with vCPUs, the rest is serial. This
    produces the paper's CPU affinity: CPU-bound functions (large
    ``p``, large ``cpu_work``) keep speeding up to many cores, while
    light functions flatten immediately.
  * ``mem_factor(mem)`` — 1.0 above the *knee*; grows linearly up to
    ``1 + mem_penalty`` as memory approaches the working-set *floor*
    (paging / GC pressure); **below the floor the invocation OOMs**
    (raises :class:`ExecutionError`), like a real FaaS kill.
  * ``io_time`` — resource-independent (network / remote storage).

``input_scale`` scales the work and the working set together — the
§IV-D input-sensitivity hook (video bitrate × duration).

The port's copy of ``src/repro/serverless/function.py`` (lines 1-102),
numpy and plain Python as there, so that its float operations run in the
same order.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.env import ExecutionError
from repro_torch.core.resources import ResourceConfig


@dataclasses.dataclass(frozen=True)
class FunctionSpec:
    name: str
    cpu_work: float            # seconds of compute at 1 vCPU, nominal input
    parallel_frac: float       # Amdahl parallelizable fraction in [0, 1)
    mem_floor: float           # MB working set; below => OOM
    mem_knee: float            # MB above which memory stops helping
    mem_penalty: float = 1.0   # runtime multiplier reached at the floor
    io_time: float = 0.5       # seconds, resource-independent
    scale_mem: bool = True     # does input size grow the working set?
    profile: str = ""          # affinity class this spec was drawn from
                               # (generator metadata; "" for hand-built)

    def amdahl(self, cpu: float) -> float:
        p = self.parallel_frac
        return (1.0 - p) + p / max(cpu, 1e-6)

    def mem_factor(self, mem: float, input_scale: float = 1.0) -> float:
        floor = self.mem_floor * (input_scale if self.scale_mem else 1.0)
        knee = self.mem_knee * (input_scale if self.scale_mem else 1.0)
        if mem < floor:
            raise ExecutionError(
                f"{self.name}: OOM ({mem:.0f} MB < working set {floor:.0f} MB)")
        if mem >= knee or knee <= floor:
            return 1.0
        frac = (knee - mem) / (knee - floor)
        return 1.0 + self.mem_penalty * frac

    def runtime(self, config: ResourceConfig, input_scale: float = 1.0) -> float:
        work = self.cpu_work * input_scale
        return (self.io_time
                + work * self.amdahl(config.cpu) * self.mem_factor(config.mem,
                                                                   input_scale))

    def runtime_clamped(self, config: ResourceConfig,
                        input_scale: float = 1.0) -> float:
        """Wall time a *failing* invocation burns before the platform
        kills it: the function thrashes at the working-set floor (full
        paging penalty) and is then OOM-killed. Used to charge failed
        samples realistic search time instead of zero."""
        floor = self.mem_floor * (input_scale if self.scale_mem else 1.0)
        mem = max(config.mem, floor)
        work = self.cpu_work * input_scale
        factor = 1.0 + self.mem_penalty if config.mem < floor else \
            self.mem_factor(mem, input_scale)
        return self.io_time + work * self.amdahl(config.cpu) * factor

    # -- closed-form helper used for calibration sanity checks ----------
    def optimal_cpu(self, mu0: float = 0.512, mem_gb: float = 0.5,
                    mu1: float = 0.001, input_scale: float = 1.0) -> float:
        """Unconstrained cost-minimizing vCPU count (memory above knee).

        With ``A = io + w(1-p)`` (serial seconds), ``B = w·p`` (parallel
        core-seconds) and ``R = mu1·mem_gb``:

            cost(c) = (A + B/c)(mu0·c + R)
                    = A·mu0·c + A·R + B·mu0 + B·R/c
            d cost/dc = A·mu0 - B·R/c²  =>  c* = sqrt(B·R / (A·mu0))

        Since R « mu0, c* is tiny: *unconstrained* cost always prefers
        fewer cores and it is the SLO that forces cpu up — exactly the
        dynamic in the paper's Fig. 2 (runtime flat in memory, optimal
        configs sit where the SLO binds).
        """
        w = self.cpu_work * input_scale
        p = self.parallel_frac
        A = self.io_time + w * (1.0 - p)
        B = w * p
        if A <= 0:
            return float("inf")
        return math.sqrt(B * mu1 * mem_gb / (A * mu0))
