"""Slot-based serving engine (counterpart of ``repro.serving.engine``).

One ``decode_step`` advances all slots; admitting a request prefills it
alone and copies its batch-1 cache into the slot's row of the batch
cache, in place, so admission never disturbs the other slots. The
engine runs where its model runs.

Reading what the engine does. Its wall-clock totals are always kept
(``ServeEngine``'s docstring lists them): take them before and after a
stretch of serving, and their differences over the counts give the time
per admission, per decode step and per part of a step, and the mean wait
of a request in the queue. For where the time goes inside a call, turn
the port's spans on around a ``torch.profiler`` run
(:mod:`repro_torch.tracing`): the trace then holds ``rt.admit`` (with the
request's uid), ``rt.readback`` and ``rt.sample`` here, ``rt.prefill`` /
``rt.decode`` and the block spans inside the model, each over the device
work it launched, and :func:`repro_torch.models.moe.read_moe_stats` gives
the MoE dispatch's capacity rows against the pairs routed and taken::

    from torch.profiler import profile
    from repro_torch import tracing
    from repro_torch.models import moe
    moe.reset_moe_stats()
    with profile() as prof:
        tracing.enable()
        try:
            engine.run(queue, max_steps=50)
        finally:
            tracing.disable()
    stats = moe.read_moe_stats()

Off, the spans cost a boolean test each and the MoE counts nothing.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.tracing import span
from repro_torch.serving.scheduler import Request, RequestQueue


@dataclasses.dataclass
class GenerationResult:
    uid: int
    tokens: List[int]


def _insert_slot(cache, slot_cache, slot: int, cache_axes) -> None:
    """Copy a batch-1 cache tree into batch position ``slot`` in place.

    The batch axis of each leaf comes from the model's logical cache axes:
    shape-sniffing would mis-fire when n_slots == 1.
    """
    if isinstance(cache, dict):
        for k in cache:
            _insert_slot(cache[k], slot_cache[k], slot, cache_axes[k])
        return
    if isinstance(cache, list):           # the xLSTM layers' states
        for c, s, a in zip(cache, slot_cache, cache_axes):
            _insert_slot(c, s, slot, a)
        return
    if cache.ndim and "batch" in cache_axes:
        axis = cache_axes.index("batch")
        cache.select(axis, slot).copy_(slot_cache.select(axis, 0))


class ServeEngine:
    """Continuous-batching engine over Model.prefill/decode_step.

    It keeps wall-clock totals of its own work: ``prefill_s`` over
    ``n_prefills`` admissions and ``decode_s`` over ``decode_steps``
    steps. Each ends by reading logits back to the host, which waits for
    the device, so the totals hold the device's time too. A step's time
    is split three ways: ``decode_enqueue_s`` until ``Model.decode_step``
    returns (the host queueing the step's work), ``decode_readback_s``
    reading the logits back (the wait for the device and the copy), and
    the rest, choosing the tokens and sending them to the device.
    ``queue_wait_s`` sums, over the admissions, the time from a request's
    ``RequestQueue.submit`` to the start of its admission.
    """

    def __init__(self, model: Model, params, *, n_slots: int = 4,
                 max_len: int = 256, temperature: float = 0.0, seed: int = 0):
        self.model = model
        self.params = params
        self.device = model.device
        self.n_slots = n_slots
        self.max_len = max_len
        self.temperature = temperature
        self.rng = np.random.default_rng(seed)
        self.cache, self.cache_axes = model.make_cache(n_slots, max_len)
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.last_tokens = torch.zeros((n_slots, 1), dtype=torch.long,
                                       device=self.device)
        self.prefill_s = 0.0
        self.n_prefills = 0
        self.decode_s = 0.0
        self.decode_steps = 0
        self.decode_enqueue_s = 0.0
        self.decode_readback_s = 0.0
        self.queue_wait_s = 0.0

    def _admit(self, req: Request, slot: int, queue_batch: Dict):
        """Prefill one prompt and copy its cache into ``slot``."""
        t0 = time.perf_counter()
        if req.submitted_at is not None:
            self.queue_wait_s += t0 - req.submitted_at
        with span("rt.admit", str(req.uid)):
            prompt = torch.as_tensor(req.prompt, dtype=torch.long,
                                     device=self.device)[None, :]
            logits, slot_cache = self.model.prefill(
                self.params, {"tokens": prompt, **queue_batch},
                max_len=self.max_len)
            _insert_slot(self.cache, slot_cache, slot, self.cache_axes)
            tok = self._sample(logits[0, -1].cpu().numpy())
        self.prefill_s += time.perf_counter() - t0
        self.n_prefills += 1
        self.slots[slot] = req
        req.generated.append(tok)
        self.last_tokens[slot, 0] = tok

    def _sample(self, logits: np.ndarray) -> int:
        if self.temperature <= 0.0:
            return int(np.argmax(logits))
        p = np.exp((logits - logits.max()) / self.temperature)
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    def run(self, queue: RequestQueue, *, extra_inputs=None,
            max_steps: int = 10_000,
            step_duration_s: Optional[float] = None) -> List[GenerationResult]:
        """Drain the queue; returns per-request generated tokens.

        With ``step_duration_s`` set, decode steps define a logical clock
        (``now = steps * step_duration_s``) and requests stamped with
        arrival times are only admitted once they have arrived; the engine
        idles forward to the next arrival when the batch drains early."""
        if step_duration_s is not None and step_duration_s <= 0.0:
            raise ValueError("step_duration_s must be positive")
        extra_inputs = extra_inputs or {}
        results: List[GenerationResult] = []
        steps = 0
        clock = 0.0
        while steps < max_steps:
            now = None if step_duration_s is None else clock
            for slot in range(self.n_slots):
                if self.slots[slot] is None and len(queue):
                    req = queue.pop(now=now)
                    if req is None:       # next request hasn't arrived yet
                        break
                    self._admit(req, slot, extra_inputs)
            if all(s is None for s in self.slots):
                nxt = queue.next_arrival()
                if nxt is not None and step_duration_s is not None:
                    # idling is not decode work: it does not consume the
                    # max_steps budget
                    clock = max(clock, nxt)
                    continue
                break
            t0 = time.perf_counter()
            logits, self.cache = self.model.decode_step(
                self.params, self.cache, self.last_tokens)
            t1 = time.perf_counter()
            with span("rt.readback"):
                lg = logits[:, 0].cpu().numpy()
            t2 = time.perf_counter()
            steps += 1
            if step_duration_s is not None:
                clock += step_duration_s
            with span("rt.sample"):
                new_tokens = np.zeros((self.n_slots, 1), np.int64)
                for slot, req in enumerate(self.slots):
                    if req is None:
                        continue
                    tok = self._sample(lg[slot])
                    req.generated.append(tok)
                    new_tokens[slot, 0] = tok
                    if req.done:
                        results.append(GenerationResult(req.uid,
                                                        req.generated))
                        self.slots[slot] = None
                self.last_tokens = torch.from_numpy(new_tokens).to(
                    self.device)
            self.decode_s += time.perf_counter() - t0
            self.decode_enqueue_s += t1 - t0
            self.decode_readback_s += t2 - t1
            self.decode_steps += 1
        return results
