"""Readings that a cell's correctness limit is set from, on the chip.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 40

For each seed, in one process: one run of the cell as the benchmark
makes it, then the check with the control beside it: the reference put
in the program's place in fp8 (e4m3 products), read at the same
positions of the same prompts and served tokens. One JSON line per
seed: the program's widest and mean logit gaps (``logit_gap``,
``logit_gap_mean``), the control's (``control_*``), and the verdicts of
the cell's own limits on each (``correct``, ``control_correct``): the
control has to read false. The limit lies between the largest program
reading over a dozen seeds and the smallest control reading.
"""
import argparse
import gc
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)
sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]

from perfbench import spec  # noqa: E402
from perfbench.harness import run_cell  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(HERE.parent, args.workload)
    for seed in (int(x) for x in args.seeds.split(",")):
        res = run_cell(cell, seed, args.seconds, False, device="cuda:0",
                       control=bool(args.control))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          **res["readings"], "limits": res["limits"],
                          "correct": res["correct"],
                          "control_correct": res["control_correct"],
                          "n_compared": res["n_compared"],
                          "e2e": res["e2e"]}), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
