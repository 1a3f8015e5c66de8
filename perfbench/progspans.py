"""The program's own spans in a profile of a closed-loop cell: launches per
decode step, the device time of each sublayer's kernels, the idle time
of the device under each span, the MoE dispatch's capacity use, and the
engine's split of a decode step's wall time.

    python3 perfbench/progspans.py --workload <cell> --seed <n> \
        [--seconds 30] [--profile-seconds 5]

The program (``repro_torch.tracing``) names its work with ``rt.*``
ranges while its tracing is on: ``rt.decode`` around a decode step,
``rt.attn`` / ``rt.moe`` / ``rt.mlp`` around a block's sublayers,
``rt.readback`` and ``rt.sample`` in the engine. This tool sets the cell
up as a run of ``run.py`` does, then drives it for ``--seconds``
untraced and for ``--profile-seconds`` under the profiler, in both with
the program's tracing on for a few engine calls, then off for as many,
in turn: the two halves see the same work and the same drift of the
host's speed, so their difference is what the spans cost. Then the
check. It prints the readings as one JSON line, then a summary line.

In a profile the profiler mirrors each range on the device side as an
annotation over the kernels it launched; those are ranges, not device
work, and are kept out of the busy time here. A kernel is given to the
span its launch was made in: the host-side runtime call
(``cudaLaunchKernel`` and its kin) and the kernel share a correlation id.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
if __name__ == "__main__":
    if sys.path and Path(sys.path[0]).resolve() == HERE:
        sys.path.pop(0)
    sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]

from perfbench.devtrace import LABELS, Trace, _union, reduce  # noqa: E402

Span = Tuple[str, int, int]                  # name, start ns, end ns
Op = Tuple[str, int, int, int]               # name, start, end, correlation

#: host-side runtime calls that put work on the device's stream
RUNTIME = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
           "cudaMemsetAsync")


@dataclasses.dataclass
class Events:
    spans: List[Span]        # every user annotation, host side
    device: List[Op]         # device work: kernels, copies, sets
    launches: List[Op]       # the runtime calls that enqueued it
    mirrors: List[Span]      # device-side copies of the annotations


def events_of(prof) -> Events:
    """The events of a finished ``torch.profiler`` profile."""
    return split_events(prof.profiler.kineto_results.events())


def split_events(events) -> Events:
    """Sorts kineto events (anything with ``name``, ``start_ns``,
    ``end_ns``, ``device_type``, ``is_user_annotation`` and
    ``correlation_id``) into spans, device work and launches. A user
    annotation is a span wherever it appears, never device work."""
    from torch.autograd import DeviceType
    out = Events([], [], [], [])
    for e in events:
        name, a, b = e.name(), e.start_ns(), e.end_ns()
        on_device = e.device_type() == DeviceType.CUDA
        if e.is_user_annotation() or name.startswith(("pb.", "rt.")):
            (out.mirrors if on_device else out.spans).append((name, a, b))
        elif on_device:
            out.device.append((name, a, b, e.correlation_id()))
        elif name.startswith(RUNTIME):
            out.launches.append((name, a, b, e.correlation_id()))
    return out


# --------------------------------------------------------------------------
# innermost span at a time
# --------------------------------------------------------------------------

class Innermost:
    """The innermost span open at each time, for spans that nest (one
    thread's ranges): the time line cut into pieces, each owned by one
    span."""

    def __init__(self, spans: List[Span]):
        self.starts: List[int] = []
        self.pieces: List[Tuple[int, int, Span]] = []
        stack: List[Span] = []
        cursor = None
        for s in sorted(spans, key=lambda s: (s[1], -s[2])):
            while stack and stack[-1][2] <= s[1]:
                cursor = self._close(stack.pop(), cursor)
            if stack:
                self._piece(cursor, s[1], stack[-1])
            stack.append(s)
            cursor = s[1]
        while stack:
            cursor = self._close(stack.pop(), cursor)

    def _piece(self, a, b, span):
        if b > a:
            self.starts.append(a)
            self.pieces.append((a, b, span))

    def _close(self, span, cursor):
        self._piece(cursor, span[2], span)
        return max(cursor, span[2])

    def at(self, t: int) -> Optional[Span]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.pieces[i][0] <= t < self.pieces[i][1]:
            return self.pieces[i][2]
        return None


def _within(spans: List[Span], name: str):
    """Occurrences of ``name`` as an index: (sorted starts, spans)."""
    sel = sorted((s for s in spans if s[0] == name), key=lambda s: s[1])
    return [s[1] for s in sel], sel


def _inside(index, t: int) -> Optional[Span]:
    starts, sel = index
    i = bisect.bisect_right(starts, t) - 1
    return sel[i] if i >= 0 and t <= sel[i][2] else None


def short(name: str) -> str:
    return name[3:] if name.startswith("rt.") else name


# --------------------------------------------------------------------------
# the reductions
# --------------------------------------------------------------------------

def window_of(ev: Events) -> Tuple[int, int]:
    ws = [s for s in ev.spans if s[0] == "pb.window"]
    if len(ws) != 1:
        raise ValueError(f"want one pb.window span, found {len(ws)}")
    return ws[0][1], ws[0][2]


def idle_split(ev: Events) -> Dict[str, float]:
    """Seconds the device was idle inside "pb.window", by the harness's
    label (the innermost ``pb.*`` span, as ``devtrace.reduce`` gives it)
    and, after a "/", the innermost ``rt.*`` span open there, if any.
    The parts of one harness label sum to what it alone would read."""
    w0, w1 = window_of(ev)
    busy = _union([(max(a, w0), min(b, w1)) for _, a, b, _ in ev.device
                   if b > w0 and a < w1])
    pb = Innermost([s for s in ev.spans
                    if s[0].startswith("pb.") and s[0] != "pb.window"])
    rt = Innermost([s for s in ev.spans if s[0].startswith("rt.")])
    idle: Dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        outer = pb.at(mid)
        label = LABELS.get(outer[0], outer[0]) if outer else "outside_spans"
        inner = rt.at(mid)
        if inner is not None:
            label += "/" + short(inner[0])
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
    return idle


def harness_trace(ev: Events) -> Trace:
    """``devtrace.reduce`` of the harness's spans and the device work, the
    annotations' device-side mirrors left out."""
    return reduce([s for s in ev.spans if s[0].startswith("pb.")],
                  [(n, a, b) for n, a, b, _ in ev.device])


def per_call(ev: Events, outer: str, keep=None) -> Dict:
    """For the calls spanned by ``outer`` (e.g. "rt.decode", or
    "pb.decode"), those of them ``keep`` accepts if given: how many, their
    mean wall, the runtime launches per call, and per call the device
    milliseconds of the kernels launched under each innermost ``rt.*``
    span inside it (under ``outer``'s own short name where none is
    open), with the three kernels that took most of it."""
    sel = sorted((s for s in ev.spans if s[0] == outer
                  and (keep is None or keep(s))), key=lambda s: s[1])
    n = len(sel)
    if not n:
        return {"calls": 0}
    index = ([s[1] for s in sel], sel)
    rt = Innermost([s for s in ev.spans if s[0].startswith("rt.")])
    home: Dict[int, str] = {}
    launches = 0
    for _, a, _, corr in ev.launches:
        if _inside(index, a) is None:
            continue
        launches += 1
        span = rt.at(a)
        home[corr] = short(span[0] if span is not None else outer)
    device: Dict[str, float] = {}
    by_kernel: Dict[Tuple[str, str], float] = {}
    matched = 0
    for name, a, b, corr in ev.device:
        kind = home.get(corr)
        if kind is not None:
            matched += 1
            ms = (b - a) * 1e-6 / n
            device[kind] = device.get(kind, 0.0) + ms
            key = (kind, name[:100])
            by_kernel[key] = by_kernel.get(key, 0.0) + ms
    top = {kind: [[name, ms] for (k, name), ms in sorted(
        by_kernel.items(), key=lambda kv: -kv[1]) if k == kind][:3]
        for kind in device}
    return {"calls": n, "wall_ms": sum(b - a for _, a, b in sel) * 1e-6 / n,
            "launches_per_call": launches / n,
            "device_ms_per_call": device, "top_kernels_ms": top,
            "device_events_matched": matched}


def traced_calls(ev: Events, outer: str, inner: str):
    """A ``keep`` for :func:`per_call`: the ``outer`` spans that hold an
    ``inner`` one, or (``.off``) those that hold none."""
    index = _within(ev.spans, outer)
    on = {_inside(index, s[1]) for s in ev.spans if s[0] == inner}
    on.discard(None)
    return SimpleNamespace(on=lambda s: s in on, off=lambda s: s not in on)


# --------------------------------------------------------------------------
# the tool
# --------------------------------------------------------------------------

ENGINE_TOTALS = ("prefill_s", "n_prefills", "decode_s", "decode_steps",
                 "decode_enqueue_s", "decode_readback_s", "queue_wait_s")
#: engine calls in a row with the program's tracing on, then as many off
EVERY = 4


def engine_totals(engine) -> Dict[str, float]:
    return {k: getattr(engine, k) for k in ENGINE_TOTALS}


def engine_split(d: Dict) -> Dict[str, Optional[float]]:
    """Per decode step: wall, enqueue, read-back and the rest (sampling);
    per admission: wall and queue wait; in ms; from summed deltas of the
    engine's totals."""
    steps, adm = d["decode_steps"], d["n_prefills"]
    per = lambda s, n: s / n * 1e3 if n else None
    out = {"decode_steps": steps, "admissions": adm,
           "decode_step_ms": per(d["decode_s"], steps),
           "decode_enqueue_ms": per(d["decode_enqueue_s"], steps),
           "decode_readback_ms": per(d["decode_readback_s"], steps),
           "prefill_ms": per(d["prefill_s"], adm),
           "queue_wait_ms": per(d["queue_wait_s"], adm)}
    if steps:
        out["decode_sample_ms"] = per(d["decode_s"] - d["decode_enqueue_s"]
                                      - d["decode_readback_s"], steps)
    return out


def drive(s, pool, seconds: float) -> Dict[bool, Dict]:
    """Closed-loop engine calls for ``seconds``, the program's tracing on
    for ``EVERY`` calls, then off for as many, and so on, so that a drift
    of the host's speed falls on both alike. Returns the engine's split
    (:func:`engine_split`) of the calls with tracing off and on."""
    from repro_torch import tracing
    sums = {on: dict.fromkeys(ENGINE_TOTALS, 0.0) for on in (False, True)}
    deadline = time.perf_counter() + seconds
    i = 0
    try:
        while time.perf_counter() < deadline:
            on = (i // EVERY) % 2 == 1
            (tracing.enable if on else tracing.disable)()
            c0 = engine_totals(s.engine)
            finished = s.step()
            c1 = engine_totals(s.engine)
            for k in ENGINE_TOTALS:
                sums[on][k] += c1[k] - c0[k]
            for _ in finished:
                s.submit(pool.next(), None)
            i += 1
    finally:
        tracing.disable()
    return {on: engine_split(d) for on, d in sums.items()}


def measure(cell, seed: int, seconds: float, profile_s: float, device):
    """The tool's readings of one closed-loop cell and seed: the engine's
    split over ``seconds`` untraced, then one profiled sub-window of
    ``profile_s``, both with the program's tracing on and off in turn,
    then the check."""
    import torch
    from perfbench import check, generator
    from perfbench.harness import (POOL_PER_SLOT, Pool, Session,
                                   _start_profile, _stop_profile, sync)
    from repro_torch.models import moe

    if cell.mix["loop"] != "closed":
        raise ValueError(f"{cell.name}: a closed-loop cell only")
    s = Session(cell, seed, device, trace=True)
    pool = Pool(generator.make_requests(
        cell.mix, POOL_PER_SLOT * s.n_slots, seed, vocab=s.cfg.vocab,
        prompt_multiple=cell.config["prompt_multiple"], block=s.n_slots))
    for _ in range(s.n_slots):
        s.submit(pool.next(), None)
    for _ in range(int(cell.data.get("warm_steps", 4))):
        for _ in s.step():
            s.submit(pool.next(), None)
    prof, rf = _start_profile()                 # the profiler's start-up
    torch.ones(8, device=s.device).sum().item()
    _stop_profile(prof, rf)
    sync(s.device)
    out = {"wall": drive(s, pool, seconds)}
    moe.reset_moe_stats()
    prof, rf = _start_profile()
    try:
        profiled = drive(s, pool, profile_s)
        sync(s.device)
    finally:
        _stop_profile(prof, rf)
    ev = events_of(prof)
    tr = harness_trace(ev)
    w0, w1 = window_of(ev)
    naive = _union([(max(a, w0), min(b, w1)) for _, a, b, *_ in
                    ev.device + ev.mirrors if b > w0 and a < w1])
    dec = traced_calls(ev, "pb.decode", "rt.decode")
    pre = traced_calls(ev, "pb.prefill", "rt.prefill")
    out["profile"] = {
        "engine": profiled, "window_s": tr.window_s, "busy_s": tr.busy_s,
        # the busy time as read with the mirrors taken for device work
        "busy_with_mirrors_s": sum(b - a for a, b in naive) * 1e-9,
        "idle": idle_split(ev),
        "decode": {"on": per_call(ev, "rt.decode"),
                   "on_outer": per_call(ev, "pb.decode", dec.on),
                   "off": per_call(ev, "pb.decode", dec.off)},
        "prefill": {"on": per_call(ev, "rt.prefill"),
                    "off": per_call(ev, "pb.prefill", pre.off)},
        "moe": moe.read_moe_stats()}
    readings, compared = check.run(s, cell, seed, time.perf_counter())
    out["correct"] = bool(compared) and check.within(readings,
                                                     cell.data["limits"])
    out["readings"] = readings
    return out


def summary(res: Dict) -> Dict:
    """The per-layer quantities of one :func:`measure`."""
    off, on = res["wall"][False], res["wall"][True]
    p = res["profile"]
    dec = p["decode"]
    out = {"correct": res["correct"],
           "decode_step_ms_off": off["decode_step_ms"],
           "decode_step_ms_on": on["decode_step_ms"],
           "decode_enqueue_ms": off["decode_enqueue_ms"],
           "decode_readback_ms": off["decode_readback_ms"],
           "decode_sample_ms": off.get("decode_sample_ms"),
           "queue_wait_ms": off["queue_wait_ms"],
           "decode_launches": dec["on"].get("launches_per_call"),
           "decode_launches_tracing_off": dec["off"].get(
               "launches_per_call"),
           "decode_attn_device_ms": dec["on"].get(
               "device_ms_per_call", {}).get("attn"),
           "decode_moe_device_ms": dec["on"].get(
               "device_ms_per_call", {}).get("moe"),
           "profiled_decode_ms_on": dec["on_outer"].get("wall_ms"),
           "profiled_decode_ms_off": dec["off"].get("wall_ms"),
           "idle_share": 100.0 * (1 - p["busy_s"] / p["window_s"])}
    st = p["moe"].get("decode", {})
    if st.get("capacity_rows"):
        out["decode_capacity_use"] = 100.0 * st["taken_pairs"] \
            / st["capacity_rows"]
        out["decode_dropped_share"] = 100.0 * (
            1 - st["taken_pairs"] / st["routed_pairs"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--profile-seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    import torch
    from perfbench import spec
    if not torch.cuda.is_available():
        print("progspans: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(HERE.parent, args.workload)
    res = measure(cell, args.seed, args.seconds, args.profile_seconds,
                  "cuda:0")
    print(json.dumps(res), flush=True)
    print(json.dumps({"workload": cell.name, "seed": args.seed,
                      "device": torch.cuda.get_device_name(0),
                      **summary(res)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
