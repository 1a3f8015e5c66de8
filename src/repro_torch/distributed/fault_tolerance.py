"""Fault tolerance for long-running training (counterpart of
``repro.distributed.fault_tolerance``).

  * ``StepWatchdog``: per-step wall-time tracker; flags stragglers when a
    step exceeds ``threshold x`` the rolling median.
  * ``ResilientLoop``: wraps the train loop: checkpoints every
    ``ckpt_every`` steps, and on a step failure (a device error, an
    injected fault) restores the latest checkpoint and replays. Data is
    keyed by step, so the replay is exact. A sharded state restores onto
    its mesh through ``shardings``.
  * ``elastic_reshard``: moves a TrainState onto a *new* mesh (a grown or
    shrunk device set): each leaf is gathered whole and distributed by
    the Sharding its logical axes give on the new mesh.

The loop catches ``RuntimeError``, and a CUDA error or
``torch.OutOfMemoryError`` is one: a run that injects no fault should
check that ``failures == restores == 0``, or a real fault hides behind a
restore.
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
import time
from typing import Callable, Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.distributed.sharding import ShardingRules, tree_shardings
from repro_torch.tree import tree_map
from repro_torch.training.checkpoint import (latest_step, restore_checkpoint,
                                             save_checkpoint)

Tree = Dict[str, object]


class StepWatchdog:
    """Rolling-median straggler detector."""

    def __init__(self, threshold: float = 3.0, window: int = 32):
        self.threshold = threshold
        self.times = collections.deque(maxlen=window)
        self.straggler_steps: List[int] = []

    def observe(self, step: int, seconds: float) -> bool:
        """Record a step time; True if this step was a straggler."""
        is_straggler = False
        if len(self.times) >= 8:
            med = statistics.median(self.times)
            if seconds > self.threshold * med:
                self.straggler_steps.append(step)
                is_straggler = True
        self.times.append(seconds)
        return is_straggler

    @property
    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0


class InjectedFault(RuntimeError):
    """Raised by test hooks to simulate a node failure mid-step."""


@dataclasses.dataclass
class LoopReport:
    steps_run: int
    failures: int
    restores: int
    stragglers: int
    final_step: int


class ResilientLoop:
    """Checkpoint/restart training loop with failure injection hooks."""

    def __init__(self, step_fn: Callable, state: Tree, *,
                 ckpt_dir: str, ckpt_every: int = 50, keep: int = 3,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 watchdog: Optional[StepWatchdog] = None,
                 shardings: Optional[Tree] = None):
        self.step_fn = step_fn
        self.state = state
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.fault_hook = fault_hook
        self.watchdog = watchdog or StepWatchdog()
        self.shardings = shardings
        self.failures = 0
        self.restores = 0

    def _current_step(self) -> int:
        return int(_whole(self.state["step"]))

    def _wait(self) -> None:
        """Wait for the step's work, as the reference's
        ``block_until_ready``."""
        step = self.state["step"]
        if step.is_cuda:
            torch.cuda.synchronize(step.device)

    def run(self, dataset, until_step: int, *, max_restores: int = 10
            ) -> LoopReport:
        steps_run = 0
        while self._current_step() < until_step:
            step = self._current_step()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)          # may raise InjectedFault
                batch = dataset.batch_at(step)
                t0 = time.perf_counter()
                self.state, metrics = self.step_fn(self.state, batch)
                self._wait()
                self.watchdog.observe(step, time.perf_counter() - t0)
                steps_run += 1
                new_step = self._current_step()
                if new_step % self.ckpt_every == 0:
                    save_checkpoint(self.ckpt_dir, new_step, self.state,
                                    keep=self.keep)
            except RuntimeError as exc:            # InjectedFault is one
                self.failures += 1
                if self.restores >= max_restores:
                    raise RuntimeError(
                        f"exceeded {max_restores} restores") from exc
                if latest_step(self.ckpt_dir) is None:
                    # nothing saved yet: re-init from the step-0 state we
                    # were constructed with (equivalent to job restart)
                    raise
                self.state, _, _ = restore_checkpoint(
                    self.ckpt_dir, like=self.state, shardings=self.shardings)
                self.restores += 1
        # final checkpoint so a following job can resume exactly here
        save_checkpoint(self.ckpt_dir, self._current_step(), self.state,
                        keep=self.keep)
        return LoopReport(steps_run=steps_run, failures=self.failures,
                          restores=self.restores,
                          stragglers=len(self.watchdog.straggler_steps),
                          final_step=self._current_step())


def _whole(x: torch.Tensor) -> torch.Tensor:
    """The full tensor of a DTensor (a collective), else ``x``."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def elastic_reshard(state: Tree, axes: Tree, new_mesh,
                    rules: ShardingRules) -> Tree:
    """Re-place a TrainState onto a different mesh (elastic scaling).

    Each leaf is gathered whole (every rank of its mesh joins) and
    distributed with the Sharding its logical axes give on the new mesh.
    (On a real cluster this is a resharding transfer; the sharding
    *derivation*, the part that must be right, is identical.)
    """
    shardings = tree_shardings(new_mesh, rules, axes, state)
    return tree_map(lambda x, s: distribute_tensor(_whole(x), s.mesh,
                                                   s.placements),
                    state, shardings)
