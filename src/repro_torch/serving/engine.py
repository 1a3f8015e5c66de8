"""Slot-based serving engine (counterpart of ``repro.serving.engine``).

One ``decode_step`` advances all slots; admitting a request prefills it
alone and copies its batch-1 cache into the slot's row of the batch
cache, in place, so admission never disturbs the other slots. The
engine runs where its model runs.

Where the model declares a padded prefill (``Model.pads_prefill``: the
decoder families, with keys and values in the model's type), the engine
is on a CUDA device, no weight is a DTensor and the run passes no extra
inputs, an admission pads its prompt to the next multiple of
``PAD_MULTIPLE`` positions (at most ``max_len``: the prompt's bucket)
and prefills it straight into the slot's rows (``Model.prefill_into``),
its length, real count and slot read from device buffers the engine
writes. The first admission in a bucket runs that eagerly (the warm-up,
serving its request) and then captures it into a CUDA graph, which
every later admission in the bucket replays: one replay in place of the
prefill's thousands of launches. The buckets' graphs share one memory
pool; they never run at once, and each admission reads its logits back
before the next replays.

The engine keeps one cache and one tensor of last tokens for its whole
life and writes both in place, so a decode step always reads and writes
the same storage at the same shapes. On a CUDA device that makes the
step one CUDA graph: the engine runs all its device work on a stream of
its own, its first decode step eagerly (the warm-up a capture needs),
the second is captured there and replayed, and every later step is one
replay in place of the step's thousands of launches. Elsewhere the step
runs eagerly.

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
While tracing is on the engine runs the decode step eagerly, never the
graph, and admits through the unpadded ``Model.prefill``: the model's
``rt.*`` spans and the MoE counters run on the host as the work is
enqueued, so a replay would record neither. The traced steps are the
same work on the same cache, and the graphs serve again once tracing is
off.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import tracing
from repro_torch.models.model import Model
from repro_torch.models.moe import RealTokens
from repro_torch.tracing import span
from repro_torch.serving.scheduler import Request, RequestQueue
from repro_torch.tree import tree_leaves

#: a padded admission's prompt fills a multiple of this many positions
PAD_MULTIPLE = 256


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
    or the graph's replay returns (the host queueing the step's work),
    ``decode_readback_s`` reading the logits back (the wait for the
    device and the copy), and the rest, choosing the tokens and sending
    them to the device.
    ``queue_wait_s`` sums, over the admissions, the time from a request's
    ``RequestQueue.submit`` to the start of its admission. Where the step
    is a CUDA graph, enqueueing it is one replay: ``decode_graph_captures``
    counts the captures (one per engine) and ``decode_graph_replays`` the
    steps that ran as a replay (all but the first, while tracing is off).
    A padded admission adds its prompt's tokens to ``prefill_real_tokens``
    and the positions padding added to ``prefill_pad_tokens``;
    ``prefill_graph_captures`` counts the buckets' captures (one per
    bucket) and ``prefill_graph_replays`` the admissions that ran as a
    replay.
    """

    #: the device types on which a declared padded prefill is taken
    _PAD_DEVICES = ("cuda",)

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
        self.decode_graph_captures = 0
        self.decode_graph_replays = 0
        self.prefill_graph_captures = 0
        self.prefill_graph_replays = 0
        self.prefill_pad_tokens = 0
        self.prefill_real_tokens = 0
        # on a CUDA device: the engine's own stream, where its decode step
        # is warmed up and captured, and the graph with its output logits
        self._graphable = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) \
            if self._graphable else None
        self._warm = False
        self._graph = None
        self._graph_logits = None
        # the padded admission: its device inputs (the real count, the
        # MoE capacity at it, the slot, then the padded prompt), and each
        # bucket's graph with its output logits, all in one memory pool
        self._pads = (self.device.type in self._PAD_DEVICES
                      and model.pads_prefill
                      and not any(isinstance(t, DTensor)
                                  for t in tree_leaves(params)))
        self._inputs = torch.zeros(3 + max_len, dtype=torch.long,
                                   device=self.device) if self._pads else None
        self._prefill_graphs: Dict[int, tuple] = {}
        self._prefill_pool = None

    def _admit(self, req: Request, slot: int, queue_batch: Dict):
        """Prefill one prompt into ``slot``: padded, straight into the
        slot's rows, where the engine pads; else its batch-1 cache copied
        in."""
        t0 = time.perf_counter()
        if req.submitted_at is not None:
            self.queue_wait_s += t0 - req.submitted_at
        with span("rt.admit", str(req.uid)):
            if self._pads and not queue_batch and not tracing.enabled():
                logits = self._admit_padded(req.prompt, slot)
            else:
                prompt = torch.as_tensor(req.prompt, dtype=torch.long,
                                         device=self.device)[None, :]
                logits, slot_cache = self.model.prefill(
                    self.params, {"tokens": prompt, **queue_batch},
                    max_len=self.max_len)
                _insert_slot(self.cache, slot_cache, slot, self.cache_axes)
                logits = logits[0, -1]
            tok = self._sample(logits.cpu().numpy())
        self.prefill_s += time.perf_counter() - t0
        self.n_prefills += 1
        self.slots[slot] = req
        req.generated.append(tok)
        self.last_tokens[slot, 0] = tok

    def _admit_padded(self, prompt, slot: int) -> torch.Tensor:
        """Prefill ``prompt`` padded to its bucket straight into ``slot``;
        returns the logits of its last token (vocab,). The bucket's first
        admission runs eagerly, then (on a CUDA device) captures the same
        call on the engine's stream; every later one replays it."""
        s = len(prompt)
        width = min(-(-s // PAD_MULTIPLE) * PAD_MULTIPLE, self.max_len)
        self.prefill_real_tokens += s
        self.prefill_pad_tokens += width - s
        host = torch.zeros(3 + width, dtype=torch.long)
        host[:3] = torch.tensor([*self.model.real_counts(s), slot])
        host[3:3 + s] = torch.as_tensor(prompt)
        self._inputs[:3 + width].copy_(host)
        done = self._prefill_graphs.get(width)
        if done is not None:
            graph, logits = done
            graph.replay()
            self.prefill_graph_replays += 1
            return logits[0, 0]
        ins = self._inputs

        def prefill():
            return self.model.prefill_into(
                self.params, ins[3:3 + width][None],
                RealTokens(ins[0:1], ins[1:2]), ins[2:3], self.cache)

        logits = prefill()
        if self._graphable:
            if self._prefill_pool is None:
                self._prefill_pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self._prefill_pool,
                                  stream=self._stream):
                out = prefill()
            self._prefill_graphs[width] = (graph, out)
            self.prefill_graph_captures += 1
        return logits[0, 0]

    def _step(self) -> torch.Tensor:
        """The eager decode step: enqueue it and advance the cache's
        lengths in place (``Model.decode_step`` writes the other leaves in
        place and returns the lengths anew); returns the logits (n_slots,
        1, vocab)."""
        logits, out = self.model.decode_step(self.params, self.cache,
                                             self.last_tokens)
        self.cache["length"].copy_(out["length"])
        return logits

    def _decode(self) -> torch.Tensor:
        """Enqueue one decode step of every slot; returns its logits.

        On a CUDA device with tracing off the first step runs eagerly,
        the second captures the step on the engine's stream (through
        ``self.model.decode_step``, as the eager step calls it, into a
        graph with a private memory pool) and every step replays it.
        Capturing runs nothing, so no step is done twice."""
        if not self._graphable or tracing.enabled():
            return self._step()
        if self._graph is None:
            if not self._warm:
                self._warm = True
                return self._step()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self._stream):
                self._graph_logits = self._step()
            self._graph = graph
            self.decode_graph_captures += 1
        self._graph.replay()
        self.decode_graph_replays += 1
        return self._graph_logits

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
        args = (queue, extra_inputs or {}, max_steps, step_duration_s)
        if self._stream is None:
            return self._run(*args)
        # the engine's stream follows the caller's work and the caller's
        # stream follows the engine's
        caller = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(caller)
        try:
            with torch.cuda.stream(self._stream):
                return self._run(*args)
        finally:
            caller.wait_stream(self._stream)

    def _run(self, queue: RequestQueue, extra_inputs: Dict, max_steps: int,
             step_duration_s: Optional[float]) -> List[GenerationResult]:
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
            logits = self._decode()
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
                self.last_tokens.copy_(torch.from_numpy(new_tokens))
            self.decode_s += time.perf_counter() - t0
            self.decode_enqueue_s += t1 - t0
            self.decode_readback_s += t2 - t1
            self.decode_steps += 1
        return results
