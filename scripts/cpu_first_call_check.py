#!/usr/bin/env python3
"""How often torch's first multi-threaded MKL elementwise call in a process
(``torch.exp`` on 25,600 elements) comes out at low accuracy, with and
without ``import repro_torch`` first (the package runs one single-element
call at import, so that MKL sets up its dispatch on one thread).

    PYTHONPATH=src python3 scripts/cpu_first_call_check.py [--runs 300]

Each run is a fresh interpreter: it calls ``torch.exp`` twice on the same
tensor and counts as a miss when the first result differs from the second
or sits more than 1e-6 (relative) from numpy's float64 exp. Prints the
misses of each setting and the largest relative error seen. CPU only.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

_RUN = r"""
import sys
if sys.argv[1] == "port":
    import repro_torch
import numpy as np
import torch
x = torch.randn((2, 200, 64), generator=torch.Generator().manual_seed(0)) * 10
first, second = torch.exp(x), torch.exp(x)
ref = np.exp(x.numpy().astype(np.float64))
err = float(np.max(np.abs(first.numpy() - ref) / ref))
print(int(not torch.equal(first, second) or err > 1e-6), err)
"""


def one_run(setting: str):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _RUN, setting], env=env,
                         capture_output=True, text=True, check=True)
    miss, err = out.stdout.split()
    return int(miss), float(err)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=300)
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args(argv)
    with ThreadPoolExecutor(args.workers) as pool:
        for setting in ("torch alone", "port"):
            results = list(pool.map(lambda _: one_run(setting.split()[0]),
                                    range(args.runs)))
            misses = sum(m for m, _ in results)
            worst = max(e for _, e in results)
            print(f"{setting}: {misses} of {args.runs} processes missed; "
                  f"largest relative error of a first call {worst:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
