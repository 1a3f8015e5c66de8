#!/usr/bin/env python3
"""One run of a benchmark cell, as ``perfbench/run.py`` makes it, that also
prints the engine's admission counters over the measured window: the
prefill graphs captured and replayed, the admissions, and the prompt and
pad tokens of the padded admissions.

    PYTHONPATH=src python3 scripts/admission_counters.py \
        --workload granite-moe-3b-a800m.chat-closed --seed 7 --seconds 40

Prints one JSON object: the window's end-to-end metrics, ``correct``, and
the counters' differences across the window (a counter the engine lacks
reads null), with ``replay_share`` (replays over admissions) and
``pad_share`` (pad over prompt and pad tokens). Needs a CUDA device.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: the engine's admission counters read beside the harness's own
COUNTERS = ("prefill_graph_captures", "prefill_graph_replays",
            "prefill_real_tokens", "prefill_pad_tokens")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    args = ap.parse_args(argv)
    from perfbench import harness, spec
    inner = harness.Session.counters

    def counters(self):
        out = inner(self)
        for k in COUNTERS:
            out[k] = getattr(self.engine, k, float("nan"))
        return out

    harness.Session.counters = counters
    cell = spec.load_cell(ROOT, args.workload)
    res = harness.run_cell(cell, args.seed, args.seconds, False,
                           device="cuda:0")
    eng = {k: (None if v != v else v) for k, v in res["engine"].items()}
    n = eng["n_prefills"]
    replays, pad = eng["prefill_graph_replays"], eng["prefill_pad_tokens"]
    out = {"workload": cell.name, "seed": args.seed,
           "correct": res["correct"], "e2e": res["e2e"], "engine": eng,
           "admission_ms": 1e3 * eng["prefill_s"] / n if n else None,
           "replay_share": replays / n if n and replays is not None
           else None,
           "pad_share": pad / (pad + eng["prefill_real_tokens"])
           if pad is not None and pad + eng["prefill_real_tokens"] else None}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
