"""Unified runtime-backend protocol.

Every way the port can "run" a workflow function — the analytic
serverless response surface, the measured oracle timed on the card,
and the H100 stage-roofline model — implements one interface,
:class:`RuntimeBackend`:

  * ``invoke(node)``            — runtime (s) of one invocation under
                                  ``node.config``; raises
                                  :class:`ExecutionError` on failure
                                  (e.g. OOM below the working set),
  * ``invoke_clamped(node)``    — wall time a *failing* invocation
                                  burns before the platform kills it,
  * ``invoke_batch(nodes)``     — vectorized: runtimes for a whole
                                  batch of pending invocations in one
                                  call. Failing invocations report
                                  their clamped thrash time and are
                                  flagged instead of raising.

:class:`Environment` accepts any backend (or a bare oracle callable,
which is wrapped in :class:`CallableBackend`), so the AARC scheduler,
the BO/MAFF baselines and the fleet engine are backend-agnostic.

The port's copy of ``src/repro/core/backend.py`` (lines 36-180).
"""
from __future__ import annotations

from typing import Callable, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np

from repro_torch.core.dag import Node


@runtime_checkable
class RuntimeBackend(Protocol):
    """Protocol implemented by every runtime backend."""

    def invoke(self, node: Node) -> float:
        """One invocation's runtime in seconds; raises ExecutionError."""
        ...

    def invoke_clamped(self, node: Node) -> float:
        """Thrash-until-killed wall time for a failing invocation."""
        ...

    def invoke_batch(self, nodes: Sequence[Node]) -> Tuple[np.ndarray, np.ndarray]:
        """``(runtimes, failed)`` float64/bool arrays, one entry per
        node. Failed invocations report clamped runtime (or +inf when
        the backend cannot estimate thrash time)."""
        ...

    @property
    def has_clamped(self) -> bool:
        """Whether failing invocations get a finite charged runtime."""
        ...


class BaseBackend:
    """Default ``invoke_batch`` / ``has_clamped`` via per-node dispatch.

    Vectorized backends (e.g. the analytic serverless surface) override
    ``invoke_batch`` with a single numpy evaluation. The default
    ``invoke_clamped`` is +inf, so ``has_clamped`` is False until a
    subclass provides a finite thrash-time estimate.

    ``deterministic`` declares that invocations are pure functions of
    the node's config (no RNG/measurement state, so call order and
    batching never change results). ``batch_safe`` is the weaker gate
    the fleet engine's candidate-vectorized replay plane
    (``FleetEngine.run_many``) actually checks: deterministic backends
    qualify outright, and a *stochastic* backend may opt in by
    implementing the paired replay-stream contract
    (``config_surface`` + ``replay_noise``; see
    :class:`repro_torch.serverless.platform.StochasticBackend`) — its
    noise then keys on the (instance, function) coordinate instead of
    call order, so batched replays are reproducible paired comparisons.
    Everything else takes the exact serial fallback. False by default
    — opaque callables must not be assumed pure.

    Fault injection follows the same discipline, engine-side: a
    ``FleetEngine(faults=...)`` draws ONE
    :meth:`repro_torch.core.faults.FaultModel.fault_stream` tensor per
    ``run_many`` plane (a single rng advance, mirroring
    ``replay_noise``) with draws keyed by the ``(attempt, instance,
    function)`` coordinate — never by call order — and shared across
    every candidate of the plane. The backend never sees fault state:
    the paired fault-stream contract is orthogonal to (and composes
    with) the replay-noise contract, so a stochastic backend under
    faults still replays as a paired experiment across candidates.
    """

    has_clamped: bool = False
    deterministic: bool = False

    @property
    def batch_safe(self) -> bool:
        """May ``FleetEngine.run_many`` evaluate whole candidate planes
        against this backend? Deterministic backends qualify; stateful
        ones must override (and honor the replay-stream contract)."""
        return self.deterministic

    def grid_fusion_key(self) -> Optional[tuple]:
        """Lockstep grid-search fusion contract (see
        :mod:`repro_torch.core.gridsearch`).

        Backends whose batch evaluation is a pure *surface* — identical
        results whether nodes are evaluated per-cell or concatenated
        across cells — may return a hashable key here; cells whose
        backends return equal keys have their per-round probe batches
        fused into one evaluation. A fused backend must also provide

          * ``surface_tables(nodes)``  — per-node surface constants,
          * ``surface_probe(cpu, mem, tables)`` — noise-free runtimes +
            failure flags, advancing NO rng/counter state,
          * ``apply_invocation_noise(rt, ok)`` — the per-call noise the
            sequential path would have applied, advancing this
            backend's own stream exactly once per call.

        ``None`` (the default) means requests are served through this
        backend one cell at a time — always correct, never fused.
        """
        return None

    def invoke(self, node: Node) -> float:  # pragma: no cover - abstract
        raise NotImplementedError

    def invoke_clamped(self, node: Node) -> float:
        return float("inf")

    def invoke_batch(self, nodes: Sequence[Node]) -> Tuple[np.ndarray, np.ndarray]:
        from repro_torch.core.env import ExecutionError

        runtimes = np.empty(len(nodes), dtype=np.float64)
        failed = np.zeros(len(nodes), dtype=bool)
        for i, node in enumerate(nodes):
            try:
                runtimes[i] = self.invoke(node)
                node.fail_reason = ""
            except ExecutionError as exc:
                runtimes[i] = self.invoke_clamped(node)
                failed[i] = True
                node.fail_reason = str(exc)
        return runtimes, failed


class CallableBackend(BaseBackend):
    """Adapts the ``node -> seconds`` oracle pair to the
    :class:`RuntimeBackend` protocol (the measured oracle, the stage
    roofline oracle, plain lambdas in tests)."""

    def __init__(self, oracle: Callable[[Node], float],
                 clamped: Optional[Callable[[Node], float]] = None):
        self._oracle = oracle
        self._clamped = clamped

    @property
    def has_clamped(self) -> bool:
        return self._clamped is not None

    def invoke(self, node: Node) -> float:
        return float(self._oracle(node))

    def invoke_clamped(self, node: Node) -> float:
        if self._clamped is None:
            return float("inf")
        return float(self._clamped(node))


def as_backend(oracle_or_backend,
               clamped: Optional[Callable[[Node], float]] = None):
    """Coerce an oracle callable (or pass through a backend)."""
    if hasattr(oracle_or_backend, "invoke_batch"):
        if clamped is not None:
            raise TypeError(
                "clamped_oracle only applies to bare oracle callables; "
                "a RuntimeBackend supplies its own invoke_clamped")
        return oracle_or_backend
    if callable(oracle_or_backend):
        return CallableBackend(oracle_or_backend, clamped)
    raise TypeError(f"not a backend or oracle: {oracle_or_backend!r}")
