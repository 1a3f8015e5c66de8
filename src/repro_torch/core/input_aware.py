"""Input-Aware Configuration Engine Plugin (§IV-D).

Workflow execution can be input-sensitive (Video Analysis: bitrate ×
duration). When the plugin is enabled, the engine:

  1. analyzes the characteristics of representative inputs and sorts
     them into classes (``light`` / ``middle`` / ``heavy`` by default),
  2. invokes the Graph-Centric Scheduler + Priority Configurator once
     per class to pre-compute an optimal configuration table,
  3. at request time classifies the incoming input and dispatches it to
     the class-specific configuration.

The port's copy of ``src/repro/core/input_aware.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.dag import Workflow
from repro_torch.core.env import Environment
from repro_torch.core.resources import ResourceConfig
from repro_torch.core.scheduler import GraphCentricScheduler, ScheduleResult

#: maps an input descriptor (e.g. {"bitrate":..., "duration":...}) to a scalar scale
FeatureFn = Callable[[dict], float]


@dataclasses.dataclass
class InputClass:
    name: str
    upper_scale: float        # inputs with feature scale <= upper_scale land here
    scale: float              # representative scale used for offline profiling


def default_classes() -> List[InputClass]:
    """Heavy tops out at 1.7x nominal: beyond that even the maximal
    (10 vCPU, 10 GB) configuration cannot meet Video Analysis' 600 s
    SLO — the platform would have to reject, not configure."""
    return [InputClass("light", upper_scale=0.5, scale=0.35),
            InputClass("middle", upper_scale=1.25, scale=1.0),
            InputClass("heavy", upper_scale=float("inf"), scale=1.7)]


class InputAwareEngine:
    """Per-input-class configuration tables for an input-sensitive workflow."""

    def __init__(self, make_workflow: Callable[[], Workflow],
                 make_env: Callable[[float], Environment],
                 slo: float, *,
                 feature_fn: Optional[FeatureFn] = None,
                 classes: Optional[Sequence[InputClass]] = None):
        """``make_env(scale)`` builds an environment whose oracle reflects
        inputs of the given scale (the simulator scales each function's
        work); ``feature_fn`` maps a request descriptor to that scale."""
        self.make_workflow = make_workflow
        self.make_env = make_env
        self.slo = slo
        self.feature_fn = feature_fn or (lambda req: float(req.get("scale", 1.0)))
        self.classes = list(classes) if classes is not None else default_classes()
        self.tables: Dict[str, Dict[str, ResourceConfig]] = {}
        self.results: Dict[str, ScheduleResult] = {}

    def profile(self, **scheduler_kw) -> Dict[str, ScheduleResult]:
        """Offline step: run AARC once per input class."""
        for cls in self.classes:
            wf = self.make_workflow()
            env = self.make_env(cls.scale)
            result = GraphCentricScheduler(env, **scheduler_kw).schedule(wf, self.slo)
            self.tables[cls.name] = result.configs
            self.results[cls.name] = result
        return self.results

    def classify(self, request: dict) -> InputClass:
        scale = self.feature_fn(request)
        for cls in self.classes:
            if scale <= cls.upper_scale:
                return cls
        return self.classes[-1]

    def dispatch(self, request: dict) -> Dict[str, ResourceConfig]:
        """Online step: pick the config table for this request's class."""
        if not self.tables:
            raise RuntimeError("call profile() before dispatch()")
        return self.tables[self.classify(request).name]
