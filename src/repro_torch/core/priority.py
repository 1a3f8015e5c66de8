"""Algorithm 2 — Priority Configuration.

Priority-scheduled, decoupled resource deallocation for a *path* of
sequentially-executed functions under a latency SLO:

  * two ops per function (``cpu`` and ``mem``) enter a max-priority
    queue with priority ``inf`` (untried ops are most promising),
  * popping an op *deallocates* a portion (``step`` fraction) of that
    resource and re-executes the workflow to measure runtime and cost,
  * on SLO violation / cost increase / invocation error the change is
    **reverted**, the step is halved (exponential backoff) and the op
    re-enters with priority 0 until its ``trail`` budget is exhausted,
  * on success the op re-enters keyed by the realized cost reduction,
  * the loop ends when the queue is empty or ``MAX_TRAIL`` samples have
    been consumed.

Batched probing (``batch_size > 1``): a function's runtime depends only
on its *own* config, so ops at the same priority that touch **distinct
functions** can be measured together — one
:meth:`repro_torch.core.env.Environment.probe_function_batch` call (a single
``invoke_batch`` numpy evaluation) per round — and then committed or
reverted one at a time in pop order, preserving revert-per-op
semantics: each trial's accept/reject sees every earlier decision of
the same round, exactly as the scalar loop would. ``batch_size=1``
takes the original scalar path bit-for-bit. Narrow rounds (common
after round one, when realized cost reductions make priorities
distinct) skip the probe machinery and take the scalar invoke path —
the array round-trip costs more than it saves until the round is wide
enough to amortize it. The crossover width is backend-owned
(``scalar_round_max``): simulated backends advertise their measured
break-even point; unknown backends collapse singleton rounds only,
and only when deterministic.

The loop body is implemented once, as :func:`priority_plan` — a
sans-IO generator yielding :mod:`repro_torch.core.gridsearch` requests —
so the sequential entry point below and the lockstep grid driver
execute the identical decision sequence.

The port's copy of ``src/repro/core/priority.py`` (lines 1-305), numpy
and plain Python as there, so that its float operations run in the same
order.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.cost import workflow_cost
from repro_torch.core.dag import Node, Workflow
from repro_torch.core.env import Environment
from repro_torch.core.gridsearch import (GridPlan, InvokeRequest, ProbeRequest,
                                         TrialRequest, drive_plan)
from repro_torch.core.resources import ResourceConfig, quantize_cpu, quantize_mem

#: per-op exponential-backoff budget (paper: FUNC_TRIAL)
FUNC_TRIAL = 3
#: per-path sampling budget (paper: MAX_TRAIL)
MAX_TRAIL = 64
#: initial deallocation portion: remove half of the resource
INITIAL_STEP = 0.5
#: default batch-size crossover when the backend declares none: only
#: singleton rounds collapse to the scalar invoke path, and only on
#: deterministic backends (the pre-crossover behavior). Simulated
#: backends advertise a wider ``scalar_round_max`` — a one-call numpy
#: probe only beats N python invocations once the round is wide enough
#: to amortize the array round-trip (see the ``priority_batched`` case
#: in ``benchmarks/campaign_scale.py``).
SCALAR_ROUND_DEFAULT = 1


@dataclasses.dataclass
class Operation:
    func: str           # node name
    type: str           # "cpu" | "mem"
    step: float         # fraction of the resource to deallocate
    trail: int          # remaining backoff retries


def _deallocated(cfg: ResourceConfig, op: Operation) -> ResourceConfig:
    """Config with a ``step`` portion of ``op.type`` deprived (Table I)."""
    if op.type == "cpu":
        return ResourceConfig(cpu=quantize_cpu(cfg.cpu * (1.0 - op.step)),
                              mem=cfg.mem)
    if op.type == "mem":
        return ResourceConfig(cpu=cfg.cpu,
                              mem=quantize_mem(cfg.mem * (1.0 - op.step)))
    raise ValueError(f"unknown resource type {op.type!r}")


class _MaxPQ:
    """Max-heap with deterministic FIFO tie-breaking."""

    def __init__(self) -> None:
        self._heap: List = []
        self._seq = itertools.count()

    def push(self, op: Operation, priority: float) -> None:
        heapq.heappush(self._heap, (-priority, next(self._seq), op))

    def pop(self) -> Operation:
        return heapq.heappop(self._heap)[2]

    def peek_priority(self) -> float:
        return -self._heap[0][0]

    def __len__(self) -> int:
        return len(self._heap)


def priority_configuration(
    wf: Workflow,
    path: Sequence[str],
    slo: float,
    env: Environment,
    *,
    global_slo: Optional[float] = None,
    max_trail: int = MAX_TRAIL,
    func_trial: int = FUNC_TRIAL,
    initial_step: float = INITIAL_STEP,
    batch_size: int = 1,
) -> Dict[str, ResourceConfig]:
    """Configure the functions along ``path`` so that the path latency
    stays within ``slo`` at minimum cost. Returns the per-function
    configs (also left applied on the workflow nodes).

    ``global_slo`` is the end-to-end SLO used for sample bookkeeping
    (it differs from ``slo`` when configuring a detour sub-path against
    its sub-SLO). ``batch_size`` ops on distinct functions at equal
    priority are probed per backend call (see module docstring);
    ``batch_size=1`` is the scalar loop unchanged.

    This is the sequential driver over :func:`priority_plan`.
    """
    return drive_plan(GridPlan(env, priority_plan(
        wf, path, slo, env, global_slo=global_slo, max_trail=max_trail,
        func_trial=func_trial, initial_step=initial_step,
        batch_size=batch_size)))


def priority_plan(
    wf: Workflow,
    path: Sequence[str],
    slo: float,
    env: Environment,
    *,
    global_slo: Optional[float] = None,
    max_trail: int = MAX_TRAIL,
    func_trial: int = FUNC_TRIAL,
    initial_step: float = INITIAL_STEP,
    batch_size: int = 1,
) -> Iterator:
    """Algorithm 2 as a sans-IO plan generator.

    Yields :class:`~repro_torch.core.gridsearch.InvokeRequest` /
    :class:`~repro_torch.core.gridsearch.ProbeRequest` /
    :class:`~repro_torch.core.gridsearch.TrialRequest` and receives the
    corresponding samples. ``env`` is consulted read-only (pricing and
    the backend's ``deterministic`` flag) — all sampling goes through
    the yielded requests, so the sequential and lockstep drivers run
    this exact decision sequence.
    """
    if global_slo is None:
        global_slo = slo
    path = [p for p in path]
    if not path:
        return {}

    pq = _MaxPQ()
    for name in path:                               # Alg 2 line 3-10
        for rtype in ("cpu", "mem"):
            pq.push(Operation(func=name, type=rtype, step=initial_step,
                              trail=func_trial), priority=math.inf)

    prev_cost = workflow_cost(env.pricing, wf)      # last *accepted* cost

    def decide(op: Operation, node: Node, sample,
               saved: Tuple[ResourceConfig, float, bool, str]) -> float:
        """Alg 2 lines 14-21 acceptance: revert-or-keep one trial.
        Returns the updated last-accepted cost."""
        nonlocal prev_cost
        path_latency = wf.path_latency(path)
        violated = (sample.error                    # invocation failed (OOM)
                    or not math.isfinite(sample.e2e_runtime)
                    or path_latency > slo
                    or sample.e2e_runtime > global_slo
                    or sample.cost >= prev_cost)    # Alg 2 line 14

        if violated:
            node.config = saved[0]                  # revert (allocate(op))
            node.runtime, node.failed = saved[1], saved[2]
            node.fail_reason = saved[3]
            op.trail -= 1
            op.step *= 0.5                          # exponential backoff
            if op.trail > 0:                        # Alg 2 line 16-18
                pq.push(op, priority=0.0)
        else:
            reduced = prev_cost - sample.cost       # Alg 2 line 20-21
            prev_cost = sample.cost
            pq.push(op, priority=reduced)
        return prev_cost

    # batch-size crossover: rounds at or below this width are served by
    # per-op scalar invokes instead of one probe. Backends own the
    # threshold (``scalar_round_max``) because the break-even point is
    # a property of their invoke cost; unknown backends fall back to
    # singleton-only collapse, and only when deterministic — the scalar
    # path and the probe path consume a stochastic backend's rng stream
    # differently, so flipping the route changes which noise each trial
    # sees (statistically equivalent, bitwise different), a choice a
    # backend must opt into explicitly.
    scalar_round_max = getattr(env.backend, "scalar_round_max", None)
    if scalar_round_max is None:
        scalar_round_max = (SCALAR_ROUND_DEFAULT
                            if getattr(env.backend, "deterministic", False)
                            else 0)

    count = 0
    if batch_size <= 1:
        while len(pq) > 0 and count < max_trail:    # Alg 2 line 11
            op = pq.pop()
            node = wf.nodes[op.func]
            old_cfg = node.config
            new_cfg = _deallocated(old_cfg, op)
            if new_cfg.as_tuple() == old_cfg.as_tuple():
                # quantizes to no change (resource at floor / step too
                # small): the op is exhausted, consumes no sample budget.
                continue
            count += 1

            saved = (old_cfg, node.runtime, node.failed, node.fail_reason)
            node.config = new_cfg                   # deallocate(op)
            # AARC re-invokes only the re-configured function; the rest
            # of the path keeps its cached (deterministic) runtimes.
            sample = yield InvokeRequest(
                wf=wf, node=node, slo=global_slo,
                note=f"aarc:{op.func}:{op.type}:-{op.step:.3f}")
            decide(op, node, sample, saved)
    else:
        while len(pq) > 0 and count < max_trail:
            # drain one round: equal-priority ops on distinct functions
            prio = pq.peek_priority()
            round_ops: List[Tuple[Operation, Node, ResourceConfig,
                                  Tuple[ResourceConfig, float, bool, str]]] = []
            deferred: List[Operation] = []          # same-func duplicates
            touched = set()
            while (len(pq) > 0 and len(round_ops) < batch_size
                   and count < max_trail
                   and pq.peek_priority() == prio):
                op = pq.pop()
                if op.func in touched:
                    deferred.append(op)
                    continue
                node = wf.nodes[op.func]
                old_cfg = node.config
                new_cfg = _deallocated(old_cfg, op)
                if new_cfg.as_tuple() == old_cfg.as_tuple():
                    continue                        # exhausted, no budget
                count += 1
                touched.add(op.func)
                saved = (old_cfg, node.runtime, node.failed, node.fail_reason)
                round_ops.append((op, node, new_cfg, saved))
            for op in deferred:
                pq.push(op, priority=prio)
            if not round_ops:
                continue

            if len(round_ops) <= scalar_round_max:
                # narrow round: the probe's array round-trip costs more
                # than it saves — take scalar invokes in pop order,
                # which commit the same trials (invoke ≡ invoke_batch
                # row on deterministic backends, and a function's
                # runtime depends only on its own config, so per-op
                # invocation equals the round's joint probe)
                for op, node, new_cfg, saved in round_ops:
                    node.config = new_cfg           # deallocate(op)
                    sample = yield InvokeRequest(
                        wf=wf, node=node, slo=global_slo,
                        note=f"aarc:{op.func}:{op.type}:-{op.step:.3f}")
                    decide(op, node, sample, saved)
                continue

            # ONE vectorized probe for the whole round. Configs are
            # applied only for the probe and restored right after: a
            # trial's sample must price every *other* function at its
            # last-accepted config, exactly as the scalar loop does.
            for _, node, new_cfg, _ in round_ops:
                node.config = new_cfg
            runtimes, failed = yield ProbeRequest(
                nodes=[node for _, node, _, _ in round_ops])
            for _, node, _, saved in round_ops:
                node.config = saved[0]

            # sequential commit-or-revert in pop order (revert-per-op):
            # trial i sees every earlier decision of the same round
            for (op, node, new_cfg, saved), rt, bad in zip(round_ops,
                                                           runtimes, failed):
                node.config = new_cfg               # deallocate(op)
                sample = yield TrialRequest(
                    wf=wf, node=node, rt=float(rt), error=bool(bad),
                    slo=global_slo,
                    note=f"aarc:{op.func}:{op.type}:-{op.step:.3f}")
                decide(op, node, sample, saved)

    for name in path:
        wf.nodes[name].scheduled = True
    return {name: wf.nodes[name].config.copy() for name in path}
