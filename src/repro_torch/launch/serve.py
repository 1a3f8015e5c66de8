"""Serving launcher: continuous-batching engine over a reduced model
(counterpart of ``repro.launch.serve``), on the CUDA card unless
``--device`` names another.

    python -m repro_torch.launch.serve --arch qwen3-0.6b --requests 16 \
        --slots 4 --max-new 24 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCH_IDS, reduced_config
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serving import RequestQueue, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises "
                         "without one)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch)
    model = Model(cfg, device=device)
    params = model.init(seed=0)
    engine = ServeEngine(model, params, n_slots=args.slots,
                         max_len=args.max_len,
                         temperature=args.temperature)

    rng = np.random.default_rng(0)
    queue = RequestQueue()
    extras = {}
    stub = {"audio": "frames", "vlm": "patches"}.get(cfg.family)
    if stub is not None:
        gen = torch.Generator(device=device).manual_seed(1)
        extras[stub] = torch.randn(
            (1, cfg.n_frontend_tokens, cfg.d_model), generator=gen,
            device=device).to(cfg.tdtype)
    for _ in range(args.requests):
        queue.submit(rng.integers(0, cfg.vocab,
                                  size=int(rng.integers(4, 17))),
                     max_new_tokens=args.max_new)

    t0 = time.perf_counter()
    results = engine.run(queue, extra_inputs=extras)
    dt = time.perf_counter() - t0
    toks = sum(len(r.tokens) for r in results)
    print(f"{cfg.name}: served {len(results)} requests, {toks} tokens "
          f"in {dt:.2f}s ({toks / dt:.1f} tok/s, {args.slots} slots, "
          f"{device})")
    for r in results[:4]:
        print(f"  req {r.uid}: {r.tokens[:10]}"
              f"{'...' if len(r.tokens) > 10 else ''}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
