#!/usr/bin/env python3
"""Step time, peak memory, kernel launches and device time of a warm
training step of qwen3-0.6b on a card.

    PYTHONPATH=src python3 scripts/torch_train_profile.py [--remat dots]
        [--microbatches 1] [--batch 8] [--seq 512] [--steps 5]

Builds full-width, full-depth qwen3-0.6b in bf16 on random weights (seed
0) with AdamW state, and trains on one SyntheticDataset batch through
``make_train_step``: two warm steps, ``--steps`` steps timed with CUDA
events (their peak memory beside the state resident before them), then
one step under torch.profiler. Prints the card, the step time, the
device-busy time of the profiled step (the sum of its kernels' times)
and its idle share against the unprofiled step time, its kernel
launches, and the kernel rows longest first; the last line is the same
as one JSON object. It uses only the port's public training API, so
pointing PYTHONPATH at another checkout's ``src`` profiles that tree:
two trees compare in one run on one card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models.model import Model
from repro_torch.training import (AdamWConfig, SyntheticDataset, adamw_init,
                                  make_train_step)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--rows", type=int, default=12,
                    help="kernel rows to print")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    cfg = get_config("qwen3-0.6b", remat=args.remat)
    model = Model(cfg)
    state = adamw_init(model.init(seed=0))
    batch = SyntheticDataset(vocab=cfg.vocab, seq_len=args.seq,
                             global_batch=args.batch).batch_at(0)
    step = make_train_step(model, AdamWConfig(lr=1e-3, warmup_steps=5),
                           microbatches=args.microbatches)
    for _ in range(2):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.steps):
        state, metrics = step(state, batch)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / args.steps
    peak = torch.cuda.max_memory_allocated()
    loss = float(metrics["loss"])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    rows = sorted((r for r in prof.key_averages()
                   if r.device_type == DeviceType.CUDA),
                  key=lambda r: -r.self_device_time_total)
    device_ms = sum(r.self_device_time_total for r in rows) / 1e3
    launches = sum(r.count for r in rows)
    print(f"{card}; qwen3-0.6b bf16 training, {args.batch} x {args.seq} "
          f"tokens, remat {args.remat}, {args.microbatches} microbatch(es): "
          f"step {step_ms:.3f} ms (CUDA events, mean of {args.steps}), "
          f"peak {peak / 2**30:.3f} GiB ({resident / 2**30:.3f} resident), "
          f"loss {loss:.4f}; profiled step: device busy {device_ms:.3f} ms "
          f"(idle share {1 - device_ms / step_ms:.3f}), {launches} kernel "
          f"launches")
    table = [dict(launches=r.count, ms=r.self_device_time_total / 1e3,
                  name=r.key) for r in rows]
    for row in table[:args.rows]:
        print(f"  x{row['launches']:<5} {row['ms']:.3f} ms  "
              f"{row['name'][:120]}")
    print(json.dumps(dict(
        card=card, remat=args.remat, microbatches=args.microbatches,
        batch=args.batch, seq=args.seq, step_ms=step_ms, peak_bytes=peak,
        resident_bytes=resident, loss=loss, device_ms=device_ms,
        idle_share=1 - device_ms / step_ms, launches=launches,
        rows=table[:args.rows])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
