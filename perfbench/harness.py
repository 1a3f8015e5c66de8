"""One run of one cell: set-up, the measured window, the traced
sub-window, the end-to-end and per-layer numbers, and the check.

The window drives ``ServeEngine.run(queue, max_steps=1)`` in a loop:
each call admits waiting requests into free slots (``Model.prefill`` and
the slot copy) and runs one ``Model.decode_step``. The harness owns the
queue: it submits each request when it is due (open loop) or when its
client's last one ended (closed loop), and stamps each token when the
call that produced it returns.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import e2e, flops, generator, peaks, spec
from perfbench.devtrace import events_of, reduce

#: share of the window before the traced sub-window opens, and its length
TRACE_AT, TRACE_SHARE, TRACE_MAX_S = 0.4, 0.25, 5.0
#: closed-loop requests drawn per slot (the pool is cycled if a run
#: outlasts it)
POOL_PER_SLOT = 16
#: output tokens of each warm-up request of an open-loop cell
WARM_TOKENS = 4


@dataclasses.dataclass
class Tracked:
    req: object                  # the engine's Request
    timeline: e2e.Timeline
    seen: int = 0
    done_at: Optional[float] = None


@dataclasses.dataclass
class Call:
    """One engine call as the reference replays it: the admissions in
    slot order, whether a decode step ran, the request in each slot
    during that step, and each occupant's attended positions."""
    adm: List
    dec: bool
    occ: List
    contexts: List[int]
    t0: float = 0.0
    t1: float = 0.0


class Session:
    """The program under test, set up for one cell and seed."""

    def __init__(self, cell: spec.CellSpec, seed: int, device,
                 trace: bool = False, faults=()):
        from repro_torch.configs import get_config
        from repro_torch.models.model import Model
        from repro_torch.serving import RequestQueue, ServeEngine
        from perfbench.weights import make_weights
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        conf = cell.config
        self.m = conf["model"]
        self.cfg = get_config(conf["arch"], **overrides(conf))
        check_config(self.cfg, self.m)
        self.model = Model(self.cfg, device=self.device)
        abstract = Model(self.cfg, device="meta").init()
        self.params = make_weights(abstract, seed, self.device)
        self.n_slots = int(cell.data["n_slots"])
        self.max_len = int(cell.data["max_len"])
        self.engine = ServeEngine(self.model, self.params,
                                  n_slots=self.n_slots, max_len=self.max_len,
                                  temperature=0.0, seed=seed)
        self.queue = RequestQueue()
        self.tracked: Dict[int, Tracked] = {}
        self.calls: List[Call] = []
        self.trace = trace
        if trace:
            self._wrap_spans()
        for f in faults:
            FAULTS[f](self)

    # -- the program's calls, with the harness's spans around them ---------

    def _wrap_spans(self):
        from torch.autograd.profiler import record_function
        model = self.model
        for attr, label in (("prefill", "pb.prefill"),
                            ("decode_step", "pb.decode")):
            inner = getattr(model, attr)

            def wrapped(*a, _inner=inner, _label=label, **k):
                with record_function(_label):
                    return _inner(*a, **k)
            setattr(model, attr, wrapped)

    def submit(self, item: generator.Item, arrival: Optional[float]):
        req = self.queue.submit(item.prompt, max_new_tokens=item.max_new_tokens)
        self.tracked[req.uid] = Tracked(req, e2e.Timeline(arrival))
        return req

    def step(self) -> List[Tracked]:
        """One engine call; stamps the new tokens and returns the requests
        it finished."""
        eng = self.engine
        before = [s.uid if s is not None else None for s in eng.slots]
        steps = eng.decode_steps
        t0 = time.perf_counter()
        if self.trace:
            from torch.autograd.profiler import record_function
            with record_function("pb.engine"):
                eng.run(self.queue, max_steps=1)
        else:
            eng.run(self.queue, max_steps=1)
        t1 = time.perf_counter()
        after = [s.uid if s is not None else None for s in eng.slots]
        adm = [(i, u) for i, u in enumerate(after)
               if u is not None and u != before[i]]
        dec = eng.decode_steps > steps
        occ = [a if a is not None else b for a, b in zip(after, before)] \
            if dec else [None] * self.n_slots
        finished, contexts = [], []
        for uid in set(occ) | {u for _, u in adm}:
            if uid is None:
                continue
            tr = self.tracked[uid]
            n = len(tr.req.generated)
            tr.timeline.tokens.extend([t1] * (n - tr.seen))
            tr.seen = n
            if uid in occ:
                contexts.append(len(tr.req.prompt) + n - 1)
            if tr.done_at is None and tr.req.done:
                tr.done_at = t1
                finished.append(tr)
        self.calls.append(Call(adm, dec, occ, contexts, t0, t1))
        return finished

    def busy(self) -> bool:
        return len(self.queue) > 0 or any(s is not None
                                          for s in self.engine.slots)

    def drain(self):
        while self.busy():
            self.step()

    def counters(self) -> Dict[str, float]:
        from repro_torch.kernels.flash_attention import ops as flash_ops
        e = self.engine
        return {"prefill_s": e.prefill_s, "n_prefills": e.n_prefills,
                "decode_s": e.decode_s, "decode_steps": e.decode_steps,
                "flash": flash_ops.launches}


def overrides(conf: Dict) -> Dict:
    """``get_config`` overrides of a configuration file; nested groups
    (``ssm``, ``moe``) are replaced field by field."""
    from repro_torch.configs import get_config
    base = get_config(conf["arch"])
    out = {}
    for k, v in conf.get("overrides", {}).items():
        if isinstance(v, dict):
            v = dataclasses.replace(getattr(base, k), **v)
        out[k] = v
    return out


#: model-file keys and the ModelConfig fields they must equal
_FIELDS = ("n_layers", "d_model", "n_heads", "kv_heads", "head_dim", "d_ff",
           "vocab", "rope_theta", "dtype", "family", "shared_attn_every",
           "shared_attn_d_ff", "attn_impl", "use_ssm_kernel",
           "kv_cache_quant", "norm", "mlp", "qkv_bias", "qk_norm",
           "tie_embeddings")
_NESTED = {"ssm": ("state", "head_dim", "expand", "conv_kernel", "chunk"),
           "moe": ("n_experts", "top_k", "expert_ff", "shared_ff",
                   "norm_topk", "capacity_factor", "dispatch")}


def check_config(cfg, m: Dict):
    """The configuration file must state the model as it is run."""
    bad = [f"{k}: file {m[k]!r}, run {getattr(cfg, k)!r}" for k in _FIELDS
           if k in m and m[k] != getattr(cfg, k)]
    for group, keys in _NESTED.items():
        sub = getattr(cfg, group)
        if (sub is None) != (not m.get(group)):
            bad.append(f"{group}: file {m.get(group)!r}, run {sub!r}")
            continue
        if sub is not None:
            bad += [f"{group}.{k}: file {m[group][k]!r}, run "
                    f"{getattr(sub, k)!r}" for k in keys
                    if m[group][k] != getattr(sub, k)]
    if bad:
        raise ValueError("the configuration file does not state the model "
                         "as run: " + "; ".join(bad))


# --------------------------------------------------------------------------
# faults planted under the timed path (tests of the check)
# --------------------------------------------------------------------------

def _fault_token(s: Session):
    """A served token altered where it is produced."""
    inner, vocab = s.engine._sample, s.cfg.vocab
    s.engine._sample = lambda logits: (inner(logits) + 1) % vocab


def _fault_stale_state(s: Session):
    """A decode step that returns its state unchanged."""
    inner = s.model.decode_step

    def step(params, cache, tokens):
        from repro_torch.models.transformer import tree_map
        old = tree_map(lambda t: t.clone(), cache)
        logits, _ = inner(params, cache, tokens)
        tree_map(lambda t, o: t.copy_(o), cache, old)
        return logits, cache
    s.model.decode_step = step


def _fault_half_batch(s: Session):
    """A decode step that leaves out the second half of the batch."""
    inner = s.model.decode_step

    def step(params, cache, tokens):
        logits, out = inner(params, cache, tokens)
        logits = logits.clone()
        logits[logits.shape[0] // 2:] = 0.0
        return logits, out
    s.model.decode_step = step


FAULTS = {"token": _fault_token, "stale_state": _fault_stale_state,
          "half_batch": _fault_half_batch}


# --------------------------------------------------------------------------
# the run
# --------------------------------------------------------------------------

def open_items(cell: spec.CellSpec, seed: int, seconds: float, vocab: int,
               rate: Optional[float] = None):
    rate = cell.data["rate_per_s"] if rate is None else rate
    n = generator.open_loop_count(rate, seconds)
    return generator.make_requests(
        cell.mix, n, seed, vocab=vocab, rate=rate,
        prompt_multiple=cell.config["prompt_multiple"])


def warm_items(cell: spec.CellSpec, seed: int, vocab: int):
    """Open loop: the longest and the shortest prompt of the mix, a few
    tokens each, so the allocator and every kernel see the window's
    extreme shapes before it opens."""
    mult = cell.config["prompt_multiple"]
    rng = np.random.default_rng([seed, 1])
    lens = {generator.round_prompt(int(cell.mix["prompt"][k]), mult)
            for k in ("max", "min")}
    return [generator.Item(rng.integers(0, vocab, n).astype(np.int32),
                           WARM_TOKENS) for n in sorted(lens, reverse=True)]


def run_window(s: Session, seconds: float, *, items=None, pool=None,
               profile_at=None):
    """Drive the engine for ``seconds``. Open loop: ``items`` by their
    arrival (seconds after the window opens). Closed loop: each finished
    request's client sends the next of ``pool`` at once. Returns (t0,
    t_end, the calls' index range, the profile or None, and at the
    profile's edges the counters, the call indices and the times)."""
    sync(s.device)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    first_call = len(s.calls)
    nxt = 0
    prof = prof_edges = None
    rf = None
    while True:
        now = time.perf_counter()
        if profile_at is not None and prof is None and now >= t0 + profile_at[0]:
            prof, rf = _start_profile()
            prof_edges = [s.counters(), len(s.calls), None, None, now, None]
        elif rf is not None and now >= t0 + profile_at[1]:
            prof_edges[2], prof_edges[3] = s.counters(), len(s.calls)
            _stop_profile(prof, rf)
            prof_edges[5] = time.perf_counter()
            rf = None
        if now >= deadline:
            break
        span = _span(s, "pb.bookkeeping")
        if items is not None:
            while nxt < len(items) and t0 + items[nxt].arrival <= now:
                s.submit(items[nxt], t0 + items[nxt].arrival)
                nxt += 1
        _end(span)
        if not s.busy():
            wake = t0 + items[nxt].arrival if items is not None and \
                nxt < len(items) else deadline
            span = _span(s, "pb.sleep")
            time.sleep(max(0.0, min(wake, deadline) - now))
            _end(span)
            continue
        finished = s.step()
        if pool is not None:
            span = _span(s, "pb.bookkeeping")
            for _ in finished:
                s.submit(pool.next(), None)
            _end(span)
    t_end = max(deadline, s.calls[-1].t1 if len(s.calls) > first_call
                else deadline)
    if rf is not None:
        prof_edges[2], prof_edges[3] = s.counters(), len(s.calls)
        _stop_profile(prof, rf)
        prof_edges[5] = time.perf_counter()
    return t0, t_end, (first_call, len(s.calls)), prof, prof_edges


def _span(s: Session, name: str):
    if not s.trace:
        return None
    from torch.autograd.profiler import record_function
    rf = record_function(name)
    rf.__enter__()
    return rf


def _end(rf):
    if rf is not None:
        rf.__exit__(None, None, None)


def _start_profile():
    from torch.autograd.profiler import record_function
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    rf = record_function("pb.window")
    rf.__enter__()
    return prof, rf


def _stop_profile(prof, rf):
    rf.__exit__(None, None, None)
    prof.stop()


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Pool:
    """A closed loop's requests, handed out in order and cycled."""

    def __init__(self, items):
        self.items, self.i = items, 0

    def next(self):
        item = self.items[self.i % len(self.items)]
        self.i += 1
        return item


def run_cell(cell: spec.CellSpec, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             control: bool = False, faults=()) -> Dict:
    """Everything of one run but the look for a chip and the printing."""
    t_start = time.perf_counter() if t_start is None else t_start
    s = Session(cell, seed, device, trace=trace, faults=faults)
    vocab = s.cfg.vocab
    items = pool = None
    if cell.mix["loop"] == "open":
        items = open_items(cell, seed, seconds, vocab)
        for it in warm_items(cell, seed, vocab):
            s.submit(it, None)
        s.drain()
    else:
        pool = Pool(generator.make_requests(
            cell.mix, POOL_PER_SLOT * s.n_slots, seed, vocab=vocab,
            prompt_multiple=cell.config["prompt_multiple"],
            block=s.n_slots))
        for _ in range(s.n_slots):
            s.submit(pool.next(), None)
        for _ in range(int(cell.data.get("warm_steps", 4))):
            for _ in s.step():
                s.submit(pool.next(), None)
    if trace:                                   # the profiler's own start-up
        prof, rf = _start_profile()
        torch.ones(8, device=s.device).sum().item()
        _stop_profile(prof, rf)
    sync(s.device)
    profile_at = None
    if trace:
        length = min(TRACE_MAX_S, TRACE_SHARE * seconds)
        profile_at = (TRACE_AT * seconds, TRACE_AT * seconds + length)
    before = s.counters()
    t0, t_end, (c0, c1), prof, edges = run_window(
        s, seconds, items=items, pool=pool, profile_at=profile_at)
    sync(s.device)
    after = s.counters()
    setup_s = t0 - t_start
    mem = (torch.cuda.max_memory_allocated(s.device)
           if s.device.type == "cuda" else 0)
    timelines = [tr.timeline for tr in s.tracked.values()]
    win = e2e.window_metrics(timelines, t0, t_end)
    # open loop: the requests due in the window; closed loop: those that
    # were served in it
    if cell.mix["loop"] == "open":
        attempted = sum(1 for tr in s.tracked.values()
                        if tr.timeline.arrival is not None
                        and t0 <= tr.timeline.arrival < t_end)
    else:
        attempted = sum(1 for tr in s.tracked.values()
                        if any(t0 < t <= t_end for t in tr.timeline.tokens))
    e2e_values = {"ttft_p90_ms": win.get("ttft_p90_ms"),
                  "itl_p95_ms": win.get("itl_p95_ms"),
                  "output_tokens_per_s": win["output_tokens_per_s"],
                  "peak_mem_gib": mem / 2 ** 30, "setup_s": setup_s}
    layer_values, breakdown, device_extra = {}, None, {}
    t_read = time.perf_counter()
    if trace:
        spans, dev = events_of(prof)
        tr = reduce(spans, dev)
        lo, hi = edges[0], edges[2]
        outside = {k: (after[k] - before[k]) - (hi[k] - lo[k])
                   for k in ("prefill_s", "n_prefills", "decode_s",
                             "decode_steps")}
        sub = s.calls[edges[1]:edges[3]]
        gaps = e2e.itl_ms(timelines, t0, t_end,
                          outside=(edges[4], edges[5]))
        prompt = {tr_.req.uid: len(tr_.req.prompt)
                  for tr_ in s.tracked.values()}
        ctx = SimpleNamespace(
            cell=cell, model=s.m, engine=outside, trace=tr,
            prefills=[prompt[u] for c in sub for _, u in c.adm],
            decodes=[c.contexts for c in sub if c.dec],
            itl_untraced_ms=gaps,
            launches={"flash": hi["flash"] - lo["flash"]},
            flops=flops, peaks=peaks)
        for m in cell.per_layer:
            v = spec.reader(cell.bench_dir, m["name"])(ctx)
            if v is not None:
                layer_values[m["name"]] = v
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.top_idle()}
        device_extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
    # the check, once the window has closed and the peak is read
    from perfbench import check
    t_check = time.perf_counter()
    readings, compared = check.run(s, cell, seed, t_end, control=control)
    print(f"perfbench: set-up {setup_s:.3f} s, window {t_end - t0:.3f} s, "
          f"trace reduction {t_check - t_read:.3f} s, check "
          f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    limits = cell.data["limits"]
    correct = bool(compared) and check.within(readings, limits)
    control_correct = (bool(compared) and check.within(readings, limits,
                                                       "control_")
                       if control else None)
    failed = sum(1 for own in compared.values()
                 if any(own[k] > lim for k, lim in limits.items()))
    return {"correct": correct, "control_correct": control_correct,
            "attempted": attempted, "failed": failed,
            "e2e": e2e_values, "layer": layer_values, "window": win,
            "breakdown": breakdown, "device_extra": device_extra,
            "memory_peak_bytes": mem, "readings": readings,
            "limits": limits, "n_compared": len(compared),
            "engine": {k: after[k] - before[k] for k in after},
            "calls": c1 - c0}
