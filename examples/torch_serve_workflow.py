"""Serving example on the port: continuous batching with slot refill on a
reduced qwen3 (the twin of ``examples/serve_workflow.py``), on the CUDA
card unless ``--device cpu``.

    PYTHONPATH=src python examples/torch_serve_workflow.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.configs.registry import reduced_config
from repro_torch.models.model import Model
from repro_torch.serving import RequestQueue, ServeEngine


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    cfg = reduced_config("qwen3-0.6b")
    model = Model(cfg, device=args.device)
    params = model.init(seed=0)
    rng = np.random.default_rng(7)

    engine = ServeEngine(model, params, n_slots=4, max_len=96)
    queue = RequestQueue()
    sizes = []
    for i in range(12):
        plen = int(rng.integers(4, 24))
        sizes.append(plen)
        queue.submit(rng.integers(0, cfg.vocab, size=plen),
                     max_new_tokens=int(rng.integers(8, 20)))

    t0 = time.perf_counter()
    results = engine.run(queue)
    dt = time.perf_counter() - t0
    total = sum(len(r.tokens) for r in results)
    print(f"served {len(results)} requests / {total} tokens in {dt:.2f}s "
          f"({total / dt:.1f} tok/s) with 4 slots on {model.device}, "
          f"prompts {min(sizes)}-{max(sizes)} tokens")
    for r in sorted(results, key=lambda r: r.uid)[:5]:
        print(f"  req {r.uid:2d} -> {len(r.tokens)} tokens: {r.tokens[:8]}...")


if __name__ == "__main__":
    main()
