"""Knee sweep of an open-loop cell: offer a list of rates, one window
each, to one engine in one process, and report completions against
arrivals and whether the backlog grows.

    python3 perfbench/knee.py --workload <cell> --rates 2,3,4,6 \
        --seconds 20 --seed 7

One JSON line per rate: arrivals, completions, the mean number of
requests waiting for admission over each half of the window and at its
end, the engine's wall per prefill and per decode step (how fast this
host drives the card), TTFT p50 / p90, ITL p95 and output tokens/s. A rate keeps up when
on average no more than one request waits for a slot over the window's
second half: there the queue holds no backlog. Past the knee it grows
all through the window; between the two, requests queue behind each
other's prefills and the tail of TTFT swings with the host's speed. The
cell's rate is 0.8 of the highest rate that keeps up. Run it once on the chip when a cell is
defined; the rate goes into ``cells/<cell>.json``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]

from perfbench import e2e, spec  # noqa: E402
from perfbench.harness import (Session, open_items, run_window,  # noqa: E402
                               sync, warm_items)
from perfbench.readers import per_call_ms  # noqa: E402

#: mean requests waiting for a slot over the window's second half, at
#: most, of a rate that keeps up
KEEPS_UP_WAITING = 1.0


def waiting(timelines, t):
    """Requests arrived by t and not yet admitted (no first token)."""
    return sum(1 for tl in timelines
               if tl.arrival is not None and tl.arrival <= t
               and (not tl.tokens or tl.tokens[0] > t))


def mean_waiting(timelines, a, b, n=60):
    return sum(waiting(timelines, a + (b - a) * (i + 0.5) / n)
               for i in range(n)) / n


def sweep(cell, seed, rates, seconds, device):
    s = Session(cell, seed, device)
    vocab = s.cfg.vocab
    for it in warm_items(cell, seed, vocab):
        s.submit(it, None)
    s.drain()
    rows = []
    for rate in rates:
        s.tracked, s.calls = {}, []
        items = open_items(cell, seed, seconds, vocab, rate=rate)
        c0 = s.counters()
        t0, t_end, _, _, _ = run_window(s, seconds, items=items)
        sync(s.device)
        c1 = s.counters()
        tls = [tr.timeline for tr in s.tracked.values()]
        done = sum(1 for tr in s.tracked.values()
                   if tr.done_at is not None and tr.done_at <= t_end)
        arrived = sum(1 for tl in tls if tl.arrival is not None)
        w = e2e.window_metrics(tls, t0, t_end)
        first = mean_waiting(tls, t0, t0 + seconds / 2)
        second = mean_waiting(tls, t0 + seconds / 2, t_end)
        row = {"rate_per_s": rate, "arrivals": arrived, "completed": done,
               "waiting_first_half": first, "waiting_second_half": second,
               "waiting_end": waiting(tls, t_end),
               "keeps_up": second <= KEEPS_UP_WAITING,
               "prefill_ms": per_call_ms(c1["prefill_s"] - c0["prefill_s"],
                                         c1["n_prefills"] - c0["n_prefills"]),
               "decode_step_ms": per_call_ms(
                   c1["decode_s"] - c0["decode_s"],
                   c1["decode_steps"] - c0["decode_steps"]),
               **{k: w.get(k) for k in ("ttft_p50_ms", "ttft_p90_ms",
                                        "itl_p95_ms", "output_tokens_per_s",
                                        "n_ttft")}}
        print(json.dumps(row), flush=True)
        rows.append(row)
        t = time.perf_counter()
        s.drain()
        print(f"knee: drained in {time.perf_counter() - t:.1f} s",
              file=sys.stderr)
    ok = [r["rate_per_s"] for r in rows if r["keeps_up"]]
    knee = max(ok) if ok else None
    print(json.dumps({"workload": cell.name, "knee_per_s": knee,
                      "rate_per_s": None if knee is None else 0.8 * knee}))
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("knee: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(HERE.parent, args.workload)
    sweep(cell, args.seed, [float(r) for r in args.rates.split(",")],
          args.seconds, "cuda:0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
