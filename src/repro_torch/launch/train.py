"""Training launcher of the port (counterpart of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \
        --steps 100 --batch 8 --seq 128 --reduced --device cpu \
        --ckpt-dir /tmp/ck

Without ``--device`` it trains on the CUDA card. ``--reduced`` takes
the laptop-sized same-family config. Fault tolerance (checkpoint and
restart, watchdog) is always on; ``--microbatches`` and ``--remat`` are
the AARC memory knobs, settable directly or via ``--autotune-slo``: the
AARC planner (:func:`repro_torch.autotune.plan`, on the H100 stage
oracle) configures the full config's ``train_4k`` stage graph against
that step-time SLO and the layer trunk takes its most common remat
level.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time

from repro_torch.autotune import plan
from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,
                                 reduced_config)
from repro_torch.distributed.fault_tolerance import (ResilientLoop,
                                                     StepWatchdog)
from repro_torch.models.model import REMAT, Model
from repro_torch.tree import tree_leaves
from repro_torch.training.data import SyntheticDataset
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train_step import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", choices=REMAT)
    ap.add_argument("--reduced", action="store_true",
                    help="laptop-sized same-family config")
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA card if not given")
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--autotune-slo", type=float, default=None,
                    help="step-time SLO: let the AARC planner pick the "
                         "remat level before training")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    cfg = (reduced_config if args.reduced else get_config)(args.arch)
    if args.remat:
        cfg = dataclasses.replace(cfg, remat=args.remat)

    if args.autotune_slo is not None:
        r = plan(get_config(args.arch), SHAPES["train_4k"],
                 args.autotune_slo, method="aarc")
        # adopt the most common per-stage remat level for the layer trunk
        remats = [p.remat for n, p in r.stages.items()
                  if n.startswith("layers")]
        picked = max(set(remats), key=remats.count) if remats else "dots"
        cfg = dataclasses.replace(cfg, remat=picked)
        print(f"autotune: AARC plan -> remat={picked} "
              f"(modeled step {r.step_time * 1e3:.1f} ms, "
              f"cost {r.cost:.2f}, {r.n_samples} samples)")

    model = Model(cfg, device=args.device)
    params = model.init(seed=0)
    n = sum(math.prod(p.shape) for p in tree_leaves(params))
    print(f"{cfg.name}: {n / 1e6:.1f}M params, remat={cfg.remat}, "
          f"device={model.device}")
    state = adamw_init(params)

    ds = SyntheticDataset(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch, family=cfg.family,
                          n_frontend_tokens=cfg.n_frontend_tokens,
                          d_model=cfg.d_model, dtype=cfg.dtype,
                          device=model.device)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 5),
                      total_steps=args.steps)
    raw_step = make_train_step(model, opt, microbatches=args.microbatches)

    t_last = [time.perf_counter()]

    def step_fn(st, batch):
        st2, m = raw_step(st, batch)
        s = int(st2["step"])
        if s % args.log_every == 0 or s == 1:
            now = time.perf_counter()
            dt = (now - t_last[0]) / args.log_every
            t_last[0] = now
            print(f"step {s:5d} loss {float(m['loss']):.4f} "
                  f"lr {float(m['lr']):.2e} gnorm "
                  f"{float(m['grad_norm']):.2f} ({dt * 1e3:.0f} ms/step)")
        return st2, m

    loop = ResilientLoop(step_fn, state, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every,
                         watchdog=StepWatchdog())
    report = loop.run(ds, until_step=args.steps)
    print(f"done: {report.final_step} steps, {report.failures} failures, "
          f"{report.restores} restores, {report.stragglers} stragglers; "
          f"median step {loop.watchdog.median * 1e3:.0f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
