"""Run one cell of the serving benchmark on this machine's GPU.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), device, with --trace 1 a breakdown, and
last the numbers the check compared beside their limits (also the last
lines of standard error). Exits non-zero, printing no result, without a
CUDA device (or with fewer than the cell needs), without the program
(``src/repro_torch``) beside it, or if JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0]).resolve() == HERE:
    sys.path.pop(0)                  # this folder's names shadow nothing
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
BUILD = ROOT / "build" / "perfbench"
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def loaded_forbidden(modules=None):
    """The forbidden top-level names among ``modules`` (``sys.modules``),
    each compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def result_line(res, cell, trace: bool, device: dict) -> dict:
    names = cell.per_layer if trace else cell.end_to_end
    values = res["layer"] if trace else res["e2e"]
    metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
               for m in names if values.get(m["name"]) is not None}
    out = {"correct": res["correct"], "attempted": res["attempted"],
           "failed": res["failed"], "metrics": metrics, "device": device}
    if trace:
        out["breakdown"] = res["breakdown"]
    out["check"] = {k: {"value": v, "limit": res["limits"].get(k)}
                    for k, v in res["readings"].items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("perfbench: the program (src/repro_torch) is not here",
              file=sys.stderr)
        return 2
    from perfbench import spec
    cell = spec.load_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} GPUs, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    from perfbench.harness import run_cell
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   device="cuda:0", t_start=T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(res["memory_peak_bytes"]),
              "power_limit": power_limit(), **res["device_extra"]}
    line = result_line(res, cell, bool(args.trace), device)
    w = res["window"]
    print(f"perfbench: {cell.name} seed {args.seed}: {res['calls']} engine "
          f"calls, {res['engine']['n_prefills']} prefills, "
          f"{res['engine']['decode_steps']} decode steps; ttft samples "
          f"{w['n_ttft']}, itl samples {w['n_itl']}, ttft p50 "
          f"{w.get('ttft_p50_ms')} ms, itl p50 {w.get('itl_p50_ms')} ms; "
          f"end-to-end {res['e2e']}; compared {res['n_compared']} requests",
          file=sys.stderr)
    for k, v in line["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
