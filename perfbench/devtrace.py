"""Reduction of a ``torch.profiler`` trace of a short sub-window.

The harness marks its own spans with ``record_function`` ("pb.window"
around the sub-window; "pb.prefill" and "pb.decode" around the model's
calls; "pb.engine" around each engine call; "pb.bookkeeping";
"pb.sleep"). They share the trace's clock with the device events, so
each idle gap of the device is labelled by the innermost span open at
its middle.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

Event = Tuple[str, int, int]          # name, start ns, end ns

LABELS = {"pb.prefill": "prefill", "pb.decode": "decode_step",
          "pb.engine": "engine_other", "pb.bookkeeping": "harness",
          "pb.sleep": "sleep_to_arrival"}


def events_of(prof) -> Tuple[List[Event], List[Event]]:
    """(harness spans, device events) of a finished profile."""
    from torch.autograd import DeviceType
    spans, dev = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start, end = e.start_ns(), e.end_ns()
        if name.startswith("pb."):
            # the harness's spans; on the device side the profiler mirrors
            # each as an annotation, which is no device work
            if e.device_type() != DeviceType.CUDA:
                spans.append((name, start, end))
        elif e.device_type() == DeviceType.CUDA:
            dev.append((name, start, end))
    return spans, dev


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device: List[Event]
    idle_by_label: Dict[str, float]

    def kernels(self, pattern: str) -> Tuple[int, float]:
        """(events, summed seconds) of the device events whose name holds
        ``pattern`` (a kernel's name, as in ``flash_fwd_mma<64>(...)``)."""
        sel = [e for e in self.device if pattern in e[0]]
        return len(sel), sum(b - a for _, a, b in sel) * 1e-9

    def top_ops(self, n: int = 10) -> List[List]:
        by: Dict[str, int] = {}
        for name, a, b in self.device:
            by[name] = by.get(name, 0) + (b - a)
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], ns * 1e-9] for name, ns in rows]

    def top_idle(self, n: int = 10) -> List[List]:
        rows = sorted(self.idle_by_label.items(), key=lambda kv: -kv[1])
        return [[k, v] for k, v in rows[:n]]


def _label(spans: List[Event], t: int) -> str:
    best: Optional[Event] = None
    for s in spans:
        if s[0] == "pb.window" or not s[1] <= t <= s[2]:
            continue
        if best is None or s[2] - s[1] < best[2] - best[1]:
            best = s
    return LABELS.get(best[0], best[0]) if best else "outside_spans"


def reduce(spans: List[Event], device: List[Event]) -> Trace:
    """Busy time, the device events and the idle time by host span, all
    inside the "pb.window" span."""
    windows = [s for s in spans if s[0] == "pb.window"]
    if len(windows) != 1:
        raise ValueError(f"want one pb.window span, found {len(windows)}")
    _, w0, w1 = windows[0]
    dev = [(n, max(a, w0), min(b, w1)) for n, a, b in device
           if b > w0 and a < w1]
    busy = _union([(a, b) for _, a, b in dev])
    idle: Dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    inner = [s for s in spans if s[0] != "pb.window"]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            label = _label(inner, (a + b) // 2)
            idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
    return Trace(window_s=(w1 - w0) * 1e-9,
                 busy_s=sum(b - a for a, b in busy) * 1e-9,
                 device=dev, idle_by_label=idle)
