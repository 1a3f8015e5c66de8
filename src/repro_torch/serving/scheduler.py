"""Request queue + slot assignment (continuous-batching-lite).

The engine owns ``n_slots`` concurrent sequences (the cache batch dim).
Each decode step advances every active slot by one token; finished
slots (EOS or max_tokens) are immediately refilled from the queue with
a single-sequence prefill scattered into the slot — so the batch never
drains, the standard continuous-batching property.

The queue shares the fleet engine's arrival abstraction
(:mod:`repro_torch.core.engine`, which the names below re-export):
``submit_process`` stamps requests with arrival times drawn from a
``PoissonArrivals`` / ``TraceArrivals`` process, and ``pop(now=...)``
only releases requests that have arrived — the same traffic models
drive both the serverless fleet simulation and LLM serving.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, List, Optional, Sequence

import numpy as np

from repro_torch.core.engine import (ArrivalLike, PoissonArrivals,  # noqa: F401
                                     TraceArrivals, arrival_times)


# --------------------------------------------------------------------------
# requests
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (prompt_len,) int32
    max_new_tokens: int = 32
    eos_token: Optional[int] = None
    arrival: float = 0.0             # submission time (0 = immediately)
    # filled by the engine
    generated: List[int] = dataclasses.field(default_factory=list)
    #: ``time.perf_counter()`` when ``RequestQueue.submit`` queued it (the
    #: wall clock, where ``arrival`` is the logical one)
    submitted_at: Optional[float] = dataclasses.field(default=None,
                                                      compare=False)

    @property
    def done(self) -> bool:
        if self.eos_token is not None and self.generated \
                and self.generated[-1] == self.eos_token:
            return True
        return len(self.generated) >= self.max_new_tokens


class RequestQueue:
    def __init__(self):
        self._q: Deque[Request] = collections.deque()
        self._next_uid = 0

    def submit(self, prompt, max_new_tokens: int = 32,
               eos_token: Optional[int] = None,
               arrival: float = 0.0) -> Request:
        req = Request(uid=self._next_uid, prompt=np.asarray(prompt,
                                                            np.int32),
                      max_new_tokens=max_new_tokens, eos_token=eos_token,
                      arrival=arrival, submitted_at=time.perf_counter())
        self._next_uid += 1
        self._q.append(req)
        if len(self._q) > 1 and self._q[-2].arrival > arrival:
            # keep the queue ordered by arrival so pop(now)/next_arrival
            # never block an already-arrived request behind a later one
            # (stable sort preserves FIFO among equal arrivals)
            self._q = collections.deque(sorted(self._q,
                                               key=lambda r: r.arrival))
        return req

    def submit_process(self, arrivals: ArrivalLike, prompts: Sequence,
                       max_new_tokens: int = 32,
                       eos_token: Optional[int] = None) -> List[Request]:
        """Stamp one request per prompt with arrival times from the
        shared arrival process (Poisson, trace, or plain sequence)."""
        times = arrival_times(arrivals)
        if len(times) != len(prompts):
            raise ValueError(
                f"{len(prompts)} prompts but {len(times)} arrival times")
        return [self.submit(p, max_new_tokens=max_new_tokens,
                            eos_token=eos_token, arrival=float(t))
                for p, t in zip(prompts, times)]

    def pop(self, now: Optional[float] = None) -> Optional[Request]:
        """Next request; with ``now`` given, only one that has arrived."""
        if not self._q:
            return None
        if now is not None and self._q[0].arrival > now:
            return None
        return self._q.popleft()

    def next_arrival(self) -> Optional[float]:
        """Arrival time of the queue head (None when empty)."""
        return self._q[0].arrival if self._q else None

    def __len__(self) -> int:
        return len(self._q)
