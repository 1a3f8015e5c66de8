"""Decoupled resource configurations and the operation lattice.

The paper's central object: a function's resource config is a point
``(cpu, mem)`` in a *decoupled* 2-D lattice (AWS-style coupling forces
``cpu = mem / 1024``; AARC removes that constraint).

Search-space constants follow §IV-A(b) of the paper:
  * memory: 128 MB .. 10240 MB in 64 MB increments,
  * vCPU:   0.1 .. 10 cores (we quantize to 0.1-core steps),
independently of each other.

The port's copy of ``src/repro/core/resources.py`` (lines 1-90), numpy
and plain Python as there, so that its float operations run in the same
order.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

MEM_MIN_MB = 128.0
MEM_MAX_MB = 10240.0
MEM_STEP_MB = 64.0

CPU_MIN = 0.1
CPU_MAX = 10.0
CPU_STEP = 0.1

#: AWS-Lambda-style coupling ratio used by MAFF: 1 vCPU per 1024 MB.
COUPLED_MB_PER_VCPU = 1024.0


def quantize_mem(mem_mb: float) -> float:
    """Snap to the 64 MB lattice, clamped to the legal range."""
    mem_mb = min(max(mem_mb, MEM_MIN_MB), MEM_MAX_MB)
    return round(mem_mb / MEM_STEP_MB) * MEM_STEP_MB


def quantize_cpu(cpu: float) -> float:
    cpu = min(max(cpu, CPU_MIN), CPU_MAX)
    return round(cpu / CPU_STEP) * CPU_STEP


@dataclasses.dataclass
class ResourceConfig:
    """A decoupled (vCPU, memory-MB) allocation for one function."""

    cpu: float = CPU_MAX
    mem: float = MEM_MAX_MB

    def __post_init__(self) -> None:
        self.cpu = quantize_cpu(self.cpu)
        self.mem = quantize_mem(self.mem)

    def copy(self) -> "ResourceConfig":
        return ResourceConfig(cpu=self.cpu, mem=self.mem)

    def with_delta(self, resource: str, delta: float) -> "ResourceConfig":
        """New config with ``resource`` shifted by ``delta`` units.

        ``delta`` is expressed in *steps-of-that-resource*: one cpu unit
        is ``CPU_STEP`` cores; one mem unit is ``MEM_STEP_MB`` MB.
        """
        if resource == "cpu":
            return ResourceConfig(cpu=self.cpu + delta * CPU_STEP, mem=self.mem)
        if resource == "mem":
            return ResourceConfig(cpu=self.cpu, mem=self.mem + delta * MEM_STEP_MB)
        raise ValueError(f"unknown resource {resource!r}")

    def at_floor(self, resource: str) -> bool:
        if resource == "cpu":
            return self.cpu <= CPU_MIN + 1e-9
        if resource == "mem":
            return self.mem <= MEM_MIN_MB + 1e-9
        raise ValueError(f"unknown resource {resource!r}")

    def mem_gb(self) -> float:
        return self.mem / 1024.0

    def as_tuple(self) -> Tuple[float, float]:
        return (self.cpu, self.mem)

    def __str__(self) -> str:
        return f"({self.cpu:.1f} vCPU, {self.mem:.0f} MB)"


def coupled_config(mem_mb: float) -> ResourceConfig:
    """AWS-style coupled configuration: cpu proportional to memory."""
    mem_mb = quantize_mem(mem_mb)
    return ResourceConfig(cpu=mem_mb / COUPLED_MB_PER_VCPU, mem=mem_mb)


#: Over-provisioned base configuration assigned by Algorithm 1 line 2-4.
BASE_CONFIG = ResourceConfig(cpu=CPU_MAX, mem=MEM_MAX_MB)
