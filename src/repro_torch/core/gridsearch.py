"""The search layer's request protocol and its sequential driver.

Each searcher exposes its loop as a **plan** — a generator that yields
typed evaluation requests and receives results (sans-IO: plans never
touch the backend):

  * :class:`ExecuteRequest`     — whole-workflow sample
    (:meth:`Environment.execute`),
  * :class:`CandidatesRequest`  — C candidate config maps
    (:meth:`Environment.execute_candidates`),
  * :class:`ProbeRequest`       — measure-only function batch
    (:meth:`Environment.probe_function_batch`),
  * :class:`InvokeRequest`      — one scalar function trial
    (:meth:`Environment.execute_function`),
  * :class:`TrialRequest`       — commit one pre-measured trial
    (:meth:`Environment.apply_function_trial`).

:func:`drive_plan` serves a single plan against its own environment.

The port's copy of ``src/repro/core/gridsearch.py`` (lines 88-176):
the five request classes, ``GridPlan``, ``serve_request`` and
``drive_plan``. The lockstep grid driver (``run_grid_search`` and its
fused rounds) is not copied.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Generator, Sequence, Union

from repro_torch.core.dag import Node, Workflow
from repro_torch.core.env import Environment
from repro_torch.core.resources import ResourceConfig


@dataclasses.dataclass
class ExecuteRequest:
    """Execute the whole workflow under its current configs."""
    wf: Workflow
    slo: float
    note: str = ""


@dataclasses.dataclass
class CandidatesRequest:
    """Evaluate C candidate config maps for one workflow topology."""
    wf: Workflow
    candidates: Sequence[Dict[str, ResourceConfig]]
    slo: float
    note: str = ""


@dataclasses.dataclass
class ProbeRequest:
    """Measure a batch of function invocations, committing nothing."""
    nodes: Sequence[Node]


@dataclasses.dataclass
class InvokeRequest:
    """Re-invoke one function scalar-path and commit the trial."""
    wf: Workflow
    node: Node
    slo: float
    note: str = ""


@dataclasses.dataclass
class TrialRequest:
    """Commit one pre-measured invocation and record the sample."""
    wf: Workflow
    node: Node
    rt: float
    error: bool
    slo: float
    note: str = ""


Request = Union[ExecuteRequest, CandidatesRequest, ProbeRequest,
                InvokeRequest, TrialRequest]

#: a searcher plan: yields requests, returns its final value
PlanGen = Generator[Request, Any, Any]


@dataclasses.dataclass
class GridPlan:
    """A plan generator bound to the environment that serves it."""
    env: Environment
    gen: PlanGen


def serve_request(env: Environment, req: Request):
    """Serve one request through the sequential Environment paths."""
    if isinstance(req, TrialRequest):
        return env.apply_function_trial(req.wf, req.node, req.rt, req.error,
                                        req.slo, note=req.note)
    if isinstance(req, ExecuteRequest):
        return env.execute(req.wf, req.slo, note=req.note)
    if isinstance(req, ProbeRequest):
        return env.probe_function_batch(req.nodes)
    if isinstance(req, InvokeRequest):
        return env.execute_function(req.wf, req.node, req.slo, note=req.note)
    if isinstance(req, CandidatesRequest):
        return env.execute_candidates(req.wf, req.candidates, req.slo,
                                      note=req.note)
    raise TypeError(f"unknown grid request: {req!r}")


def drive_plan(plan: GridPlan):
    """Run one plan to completion sequentially; return its result.

    This is the scalar driver — ``Searcher.search``/``resume`` route
    through it, so a plan driven here produces the legacy sequential
    trace bit-for-bit (same environment calls in the same order).
    """
    gen, env = plan.gen, plan.env
    try:
        req = next(gen)
        while True:
            req = gen.send(serve_request(env, req))
    except StopIteration as stop:
        return stop.value
