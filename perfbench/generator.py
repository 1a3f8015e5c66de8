"""The one traffic generator: every mix is a data file of parameters.

A mix file (``traffic/<mix>.json``) says whether the loop is open
(``"loop": "open"``, arrivals at the cell's rate) or closed (``"loop":
"closed"``, one client per slot, no think time), how an open loop's
gaps between arrivals are drawn (``"arrivals"``: ``exponential``, a
Poisson process, or ``gamma`` with a coefficient of variation ``cv``,
above 1 for bursts), and how prompt and output lengths are drawn.
Lengths and inter-arrival gaps are
stratified: a run of n requests takes the n quantiles at (i + 0.5) / n
of each distribution, and the seed only permutes them (each list on its
own) and draws the prompt ids. So every seed gives the same work in
another order, and two seeds differ no more than two runs of one seed.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class Item:
    """One request as the generator makes it; ``arrival`` is seconds after
    the window opens (open loop) and 0 for a closed-loop client's."""
    prompt: np.ndarray
    max_new_tokens: int
    arrival: float = 0.0


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def _lengths(spec: Dict, n: int) -> np.ndarray:
    """n stratified lengths of one distribution spec, in ascending order."""
    u = _quantiles(n)
    lo, hi = int(spec["min"]), int(spec["max"])
    kind = spec["dist"]
    if kind == "lognormal":
        z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
        vals = np.exp(math.log(spec["median"]) + spec["sigma"] * z)
    elif kind == "uniform":
        vals = lo + u * (hi - lo + 1)
    else:
        raise ValueError(f"unknown length distribution {kind!r}")
    return np.clip(np.floor(vals), lo, hi).astype(np.int64)


def _gaps(spec: Dict, n: int, rate: float) -> np.ndarray:
    """n stratified gaps of mean 1 / rate, in ascending order."""
    u = _quantiles(n)
    kind = spec["dist"]
    if kind == "exponential":
        return -np.log1p(-u) / rate
    if kind == "gamma":
        from scipy.special import gammaincinv
        shape = 1.0 / spec["cv"] ** 2
        return gammaincinv(shape, u) / (shape * rate)
    raise ValueError(f"unknown arrival distribution {kind!r}")


def round_prompt(length: int, multiple: int) -> int:
    """A prompt length the model takes: above ``multiple`` it is rounded
    to the nearest whole multiple (a chunked scan takes at most one chunk
    or whole chunks)."""
    if multiple <= 1 or length <= multiple:
        return int(length)
    return int(max(multiple, round(length / multiple) * multiple))


def max_prompt(mix: Dict, multiple: int) -> int:
    return round_prompt(int(mix["prompt"]["max"]), multiple)


def _blocks(spec: Dict, n: int, block: int, rng) -> np.ndarray:
    """n lengths: each run of ``block`` consecutive ones is the block
    quantiles of the distribution in an order drawn from ``rng``."""
    parts = [rng.permutation(_lengths(spec, block))
             for _ in range(-(-n // block))]
    return np.concatenate(parts)[:n]


def make_requests(mix: Dict, n: int, seed: int, *, vocab: int,
                  prompt_multiple: int = 1, rate: float = 0.0,
                  block: int = 0) -> List[Item]:
    """n requests of a mix. Open loop: arrivals at ``rate`` per second,
    the gaps the n quantiles of the mix's gap distribution; closed loop:
    all 0. With ``block``, the lengths are stratified within each run of
    ``block`` requests, so that a run which serves only the first few
    blocks of a closed loop's pool serves the same work on every seed."""
    rng = np.random.default_rng(seed)
    block = block or n
    prompts = _blocks(mix["prompt"], n, block, rng)
    outputs = _blocks(mix["output"], n, block, rng)
    if mix["loop"] == "open":
        if rate <= 0:
            raise ValueError("an open-loop mix needs a positive rate")
        gaps = rng.permutation(_gaps(mix["arrivals"], n, rate))
        arrivals = np.cumsum(gaps)
    elif mix["loop"] == "closed":
        arrivals = np.zeros(n)
    else:
        raise ValueError(f"unknown loop {mix['loop']!r}")
    items = []
    for p, o, t in zip(prompts, outputs, arrivals):
        length = round_prompt(int(p), prompt_multiple)
        ids = rng.integers(0, vocab, size=length, dtype=np.int64)
        items.append(Item(ids.astype(np.int32), int(o), float(t)))
    return items


def open_loop_count(rate: float, seconds: float) -> int:
    """Requests of an open-loop run: as many as the rate brings in the
    window (stratified gaps sum to about n / rate)."""
    return max(1, int(math.floor(rate * seconds)))
