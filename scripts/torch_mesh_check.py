#!/usr/bin/env python3
"""The sharded train, prefill or serve step of every family on a mesh of
several cards, against the single-device step on one card.

    PYTHONPATH=src python3 scripts/torch_mesh_check.py [--mesh 2 2]
        [--device cuda] [--kind train|prefill|decode]

Starts one process per rank (``prod(--mesh)`` of them; with ``cuda``
rank r drives card r over NCCL, with ``cpu`` the ranks use gloo). The
ranks meet through a FileStore under ``build/``, start the group with a
60 s timeout, and are all killed if the run outlives its deadline. On a
("data", "model") mesh of that shape, each rank runs one reduced config
of each family in fp32 from seed-0 weights (for serving, the vision
model's cross-layer gates opened to 0.5 / -0.75) on one seed-0 batch of
4 x 16 tokens, and rank 0 holds the result to the plain step on its own
device:

* ``train`` (the default): ``build_train_step``'s step (FSDP rules)
  against ``make_train_step``: the loss (rtol 1e-4) and the parameters
  (atol 1e-4, rtol 1e-3), the reference's sharded-step tolerances
  (tests/test_distributed.py), and the gradients' global norm (rtol
  1e-4; Adam's first step moves a parameter by about lr whatever its
  gradient);
* ``prefill``: ``build_prefill_step``'s step with the kernel routes on
  (``attn_impl="kernel"``, zamba2 ``use_ssm_kernel=True``: flash
  attention and the SSD passes run on each rank's local shards) against
  ``Model.prefill``: the logits and every cache leaf at atol 1e-4, rtol
  1e-3, and the kernel launches per prefill on each rank;
* ``decode``: that prefill, then 4 greedy steps of ``build_serve_step``'s
  step against ``Model.decode_step``: the logits and the final cache at
  the same tolerances, and the greedy tokens equal.

A family whose sharded step raises is reported with the error, on every
rank alike. Prints one line per family, the card's name and power limit,
and a JSON line last; exits 1 if any family failed or disagreed.
"""
from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: one reduced config of each family (2 layers: one shared-attention
#: application, one sLSTM block, one cross layer), qwen3 also under the
#: full configs' remat "dots"
CASES = {
    "olmo-1b": ("olmo-1b", {}),
    "qwen3-0.6b dots": ("qwen3-0.6b", {"remat": "dots"}),
    "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {}),
    "granite-moe-3b-a800m": ("granite-moe-3b-a800m", {}),
    "zamba2-1.2b": ("zamba2-1.2b", {}),
    "xlstm-350m": ("xlstm-350m", {}),
    "whisper-tiny": ("whisper-tiny", {}),
    "llama-3.2-vision-90b": ("llama-3.2-vision-90b", {}),
}
SEQ, BATCH = 16, 4
#: the serving checks: the cache's depth and the greedy decode steps
MAX_LEN, DECODE_STEPS = 32, 4
GATES = {"gate_attn": 0.5, "gate_mlp": -0.75}
LOSS_RTOL = 1e-4
GRAD_NORM_RTOL = 1e-4
PARAM_TOL = dict(atol=1e-4, rtol=1e-3)
DEADLINE_S = 600


def _within(got, want) -> float:
    """How far ``got`` lies beyond atol + rtol * |want| (<= 0: within)."""
    return float(((got.float() - want.float()).abs() - PARAM_TOL["rtol"]
                  * want.float().abs()).max()) - PARAM_TOL["atol"]


def serve_case(kind, cfg, params, batch, mesh, here):
    """The sharded prefill (and, for ``decode``, DECODE_STEPS greedy serve
    steps) of one case; returns the whole logits and caches, and the
    kernel launches of the prefill on this rank."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.configs.shapes import Shape
    from repro_torch.distributed.sharding import distribute_tree
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch.steps import build_prefill_step, build_serve_step
    from repro_torch.models.transformer import tree_leaves

    whole = lambda t: (t.full_tensor() if isinstance(t, DTensor)
                       else t).clone()
    shape = Shape("s", MAX_LEN, BATCH, "prefill")
    prefill = build_prefill_step(cfg, shape, mesh)
    with torch.no_grad():
        before = (flash_ops.launches, ssd_ops.intra_launches,
                  ssd_ops.inter_launches)
        logits, cache = prefill.step(*prefill.place(params, batch))
        after = (flash_ops.launches, ssd_ops.intra_launches,
                 ssd_ops.inter_launches)
        out = dict(logits=[whole(logits)], launches=[
            b - a for a, b in zip(before, after)])
        if kind == "prefill":
            out["cache"] = [whole(t) for t in tree_leaves(cache)]
            return out
        serve = build_serve_step(
            cfg, Shape("s", MAX_LEN, BATCH, "decode"), mesh)
        p, c = serve.place(params, cache)[:2]
        tokens = out["logits"][-1][:, -1].argmax(-1)[:, None]
        for _ in range(DECODE_STEPS):
            logits, c = serve.step(p, c, distribute_tree(
                tokens, serve.in_shardings[2]))
            out["logits"].append(whole(logits))
            tokens = out["logits"][-1][:, -1].argmax(-1)[:, None]
        out["cache"] = [whole(t) for t in tree_leaves(c)]
    return out


def serve_reference(kind, cfg, params, batch, here):
    """The same on one device, unsharded."""
    import torch

    from repro_torch.models.model import Model
    from repro_torch.models.transformer import tree_leaves

    model = Model(cfg, device=here)
    with torch.no_grad():
        logits, cache = model.prefill(params, batch, max_len=MAX_LEN)
        out = dict(logits=[logits])
        if kind == "decode":
            tokens = logits[:, -1].argmax(-1)[:, None]
            for _ in range(DECODE_STEPS):
                logits, cache = model.decode_step(params, cache, tokens)
                out["logits"].append(logits)
                tokens = logits[:, -1].argmax(-1)[:, None]
        out["cache"] = [t.clone() for t in tree_leaves(cache)]
    return out


def rank_main(rank: int, world: int, shape, device: str, store: str,
              kind: str) -> int:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import reduced_config
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.training import (AdamWConfig, SyntheticDataset,
                                      adamw_init, make_train_step)

    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=dist.FileStore(store, world), rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    here = torch.device(device, rank) if device == "cuda" else \
        torch.device("cpu")
    mesh = init_device_mesh(device, shape, mesh_dim_names=("data", "model"))
    opt = AdamWConfig(lr=1e-3)
    failed = False
    for name, (arch, over) in CASES.items():
        if kind != "train":
            over = dict(over, attn_impl="kernel",
                        use_ssm_kernel=arch == "zamba2-1.2b")
        cfg = reduced_config(arch, n_layers=2, **over)
        params0 = Model(cfg, device=here).init(seed=0)
        if cfg.family == "vlm" and kind != "train":
            for gate, value in GATES.items():
                params0["segments"]["cross"][gate].fill_(value)
        state0 = adamw_init(params0)
        batch = SyntheticDataset(
            vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
            family=cfg.family, n_frontend_tokens=cfg.n_frontend_tokens,
            d_model=cfg.d_model, dtype=cfg.dtype, device=here).batch_at(0)
        row = {"name": name, "kind": kind}
        bundle = None
        t0 = time.perf_counter()
        try:
            if kind == "train":
                bundle = build_train_step(
                    cfg, Shape("t", SEQ, BATCH, "train"), mesh, opt_cfg=opt)
                state, dbatch = bundle.place(state0, batch)
                new, m = bundle.step(state, dbatch)
                loss = float(m["loss"].full_tensor())
                grad_norm = float(m["grad_norm"].full_tensor())
                params = [p.full_tensor()
                          for p in tree_leaves(new["params"])]
            else:
                batch.pop("labels")
                got = serve_case(kind, cfg, params0, batch, mesh, here)
        except Exception as exc:      # recorded, and the run exits 1
            # DTensor refuses an op on every rank alike, before any
            # collective of that op, so the ranks go on together
            where = traceback.extract_tb(exc.__traceback__)
            here_frames = [f for f in where if "repro_torch" in f.filename]
            row.update(ok=False, error=f"{type(exc).__name__}: "
                                       f"{str(exc).splitlines()[0][:300]}",
                       at=[f"{Path(f.filename).name}:{f.lineno} {f.line}"
                           for f in here_frames[-2:]])
            failed = True
            if rank == 0:
                traceback.print_exc()
            # once more under anomaly mode, which prints the forward
            # stack of a backward node that fails
            if kind == "train" and bundle is not None:
                with torch.autograd.detect_anomaly(check_nan=False):
                    try:
                        bundle.step(state, dbatch)
                    except Exception:  # the same error, already recorded
                        pass
        else:
            row["step_s"] = time.perf_counter() - t0
            if kind != "train":
                row["launches_flash_intra_inter"] = got["launches"]
            if rank == 0 and kind != "train":
                want = serve_reference(kind, cfg, params0, batch, here)
                excess = max(_within(a, b) for a, b in zip(
                    got["logits"] + got["cache"],
                    want["logits"] + want["cache"]))
                same = [torch.equal(a[:, -1].argmax(-1), b[:, -1].argmax(-1))
                        for a, b in zip(got["logits"], want["logits"])]
                ok = (excess <= 0 and all(same)
                      and len(got["cache"]) == len(want["cache"]))
                row.update(ok=ok, excess_over_tol=excess,
                           greedy_tokens_equal=all(same),
                           max_abs_logit_diff=max(
                               float((a - b).abs().max()) for a, b in
                               zip(got["logits"], want["logits"])))
                failed = failed or not ok
            elif rank == 0:
                ref, ref_m = make_train_step(Model(cfg, device=here),
                                             opt)(state0, batch)
                rel = abs(loss - float(ref_m["loss"])) / abs(
                    float(ref_m["loss"]))
                g_rel = abs(grad_norm - float(ref_m["grad_norm"])) / abs(
                    float(ref_m["grad_norm"]))
                errs = [float(((a - b).abs() - PARAM_TOL["rtol"]
                               * b.abs()).max())
                        for a, b in zip(params, tree_leaves(ref["params"]))]
                ok = (rel <= LOSS_RTOL and g_rel <= GRAD_NORM_RTOL
                      and max(errs) <= PARAM_TOL["atol"])
                row.update(ok=ok, loss=loss, loss_rel_diff=rel,
                           grad_norm_rel_diff=g_rel, param_excess=max(errs))
                failed = failed or not ok
        if rank == 0:
            print(json.dumps(row), flush=True)
        dist.barrier()
    dist.destroy_process_group()
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", type=int, nargs=2, default=[2, 2])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--kind", choices=("train", "prefill", "decode"),
                    default="train")
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--store", help=argparse.SUPPRESS)
    args = ap.parse_args()
    world = math.prod(args.mesh)
    if args.rank is not None:
        return rank_main(args.rank, world, tuple(args.mesh), args.device,
                         args.store, args.kind)

    if args.device == "cuda":
        import torch
        if torch.cuda.device_count() < world:
            print(f"needs {world} cards, found {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    work = ROOT / "build" / "mesh_check"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--mesh", *map(str, args.mesh),
         "--device", args.device, "--kind", args.kind, "--rank", str(r),
         "--store",
         str(work / "store")], env=env, start_new_session=True)
        for r in range(world)]
    deadline = time.monotonic() + DEADLINE_S
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
    except subprocess.TimeoutExpired:
        print(f"ranks killed at the {DEADLINE_S} s deadline", file=sys.stderr)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    codes = [p.returncode for p in procs]
    print(json.dumps({"mesh": args.mesh, "device": args.device,
                      "kind": args.kind, "rank_exit_codes": codes}))
    return 0 if codes == [0] * world else 1


if __name__ == "__main__":
    sys.exit(main())
