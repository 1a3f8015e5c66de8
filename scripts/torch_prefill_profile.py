#!/usr/bin/env python3
"""Kernel launches and device time of a warm zamba2-1.2b prefill on a card.

    PYTHONPATH=src python3 scripts/torch_prefill_profile.py [--tokens 512]

Builds full-width, full-depth zamba2-1.2b in bf16 on random weights (seed
0) with the SSD-scan kernels and flash attention, warms one prefill up,
then profiles ``--calls`` prefills of ``--tokens`` tokens with
torch.profiler. Prints the card, host wall time and device-busy time per
call, kernel launches per call, and every kernel row (launches per call,
device ms per call, name); the last line is the same as one JSON object.
It uses only the port's public model API, so pointing PYTHONPATH at
another checkout's ``src`` profiles that tree: two trees compare in one
run on one card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models.model import Model


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=512)
    ap.add_argument("--calls", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_prefill_profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    cfg = get_config("zamba2-1.2b", attn_impl="kernel", use_ssm_kernel=True)
    model = Model(cfg)
    params = model.init(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    prompt = torch.randint(0, cfg.vocab, (1, args.tokens), generator=gen,
                           device="cuda")
    call = lambda: model.prefill(params, {"tokens": prompt}, max_len=1024)
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.calls):
        call()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / args.calls * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.calls):
            call()
        torch.cuda.synchronize()
    n = args.calls
    rows = sorted((r for r in prof.key_averages()
                   if r.device_type == DeviceType.CUDA),
                  key=lambda r: -r.self_device_time_total)
    device_ms = sum(r.self_device_time_total for r in rows) / n / 1e3
    launches = sum(r.count for r in rows) // n
    print(f"{card}; zamba2-1.2b bf16 prefill of {args.tokens} tokens, "
          f"warm, {n} calls: wall {wall_ms:.3f} ms, device busy "
          f"{device_ms:.3f} ms, {launches} kernel launches per call")
    table = [dict(launches=r.count // n,
                  ms=r.self_device_time_total / n / 1e3, name=r.key)
             for r in rows]
    for row in table:
        print(f"  x{row['launches']:<4} {row['ms']:.4f} ms  "
              f"{row['name'][:150]}")
    print(json.dumps(dict(card=card, tokens=args.tokens, wall_ms=wall_ms,
                          device_ms=device_ms, launches_per_call=launches,
                          rows=table)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
