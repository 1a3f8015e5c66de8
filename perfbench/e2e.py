"""End-to-end arithmetic over one window, on the host's clock.

Each token is stamped when the engine call that produced it returns,
which is when a streaming server would flush it. All numbers are taken
over all the work of the window: no median of chunks.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100) with linear interpolation between the
    order statistics (numpy's default method)."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


@dataclasses.dataclass
class Timeline:
    """One request's life: its scheduled arrival (None for a closed-loop
    request, which is sent when its client is free) and the time each of
    its tokens was delivered."""
    arrival: Optional[float]
    tokens: List[float] = dataclasses.field(default_factory=list)


def ttft_ms(timelines: List[Timeline], t0: float, t_end: float
            ) -> List[float]:
    """First-token time minus scheduled arrival, for every request due in
    [t0, t_end). One still waiting at t_end counts at its elapsed time,
    so a stall cannot hide."""
    out = []
    for tl in timelines:
        if tl.arrival is None or not t0 <= tl.arrival < t_end:
            continue
        first = tl.tokens[0] if tl.tokens and tl.tokens[0] <= t_end else t_end
        out.append((first - tl.arrival) * 1e3)
    return out


def itl_ms(timelines: List[Timeline], t0: float, t_end: float,
           outside: Optional[tuple] = None) -> List[float]:
    """Every gap between consecutive tokens of a request whose later
    token came in (t0, t_end]. The window ends on an engine call's
    return, which stamps every request in a slot, so no request in
    flight has an open gap at the end. With ``outside`` = (a, b), gaps
    with either end in [a, b] are left out."""
    out = []
    for tl in timelines:
        ts = [t for t in tl.tokens if t <= t_end]
        for a, b in zip(ts, ts[1:]):
            if b <= t0 or (outside and (outside[0] <= a <= outside[1]
                                        or outside[0] <= b <= outside[1])):
                continue
            out.append((b - a) * 1e3)
    return out


def tokens_in(timelines: List[Timeline], t0: float, t_end: float) -> int:
    return sum(1 for tl in timelines for t in tl.tokens if t0 < t <= t_end)


def window_metrics(timelines: List[Timeline], t0: float, t_end: float
                   ) -> Dict[str, float]:
    """The window's end-to-end numbers and the sample counts behind them."""
    ttft = ttft_ms(timelines, t0, t_end)
    itl = itl_ms(timelines, t0, t_end)
    out = {"output_tokens_per_s": tokens_in(timelines, t0, t_end)
           / (t_end - t0),
           "n_ttft": len(ttft), "n_itl": len(itl)}
    if ttft:
        out["ttft_p90_ms"] = percentile(ttft, 90)
        out["ttft_p50_ms"] = percentile(ttft, 50)
    if itl:
        out["itl_p95_ms"] = percentile(itl, 95)
        out["itl_p50_ms"] = percentile(itl, 50)
    return out
