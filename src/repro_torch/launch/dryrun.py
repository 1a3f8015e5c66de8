"""Multi-pod dry run (counterpart of ``repro.launch.dryrun``): run every
(arch x shape) step at full depth on the production meshes without a
card, and record memory, cost and roofline artifacts.

The reference lowers and compiles each step for 256 or 512 forced host
devices. Here each cell starts a fake process group of that many ranks
in this one process (``torch.testing``'s ``"fake"`` backend: every
collective returns at once), builds the (16, 16) or (2, 16, 16)
``DeviceMesh`` over it, places the step's meta-device inputs on the mesh
as DTensors and runs the full-depth step on them: the "proof" that the
sharding is coherent is that step running through, every redistribution
and collective issued (``compile_s`` is that run's seconds). The costs
are counted per rank (``repro_torch.roofline.analysis``) and, by
default, extrapolated from depth-1 and depth-2 runs as the reference
does. On the meta device a kernel route counts its plain version's work.
The collective term uses NVLink's constants, which describe one 8-card
node, not a 256-card fabric.

Usage:
  python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch olmo-1b      # all shapes
  python -m repro_torch.launch.dryrun --all               # all cells
Options:
  --mesh single|multi|both    (default both)
  --out artifacts/dryrun_torch JSON output directory
  --microbatches N            grad-accumulation for train shapes
  --remat none|dots|full      activation checkpoint override
  --attn-impl plain|kernel    attention route
  --rules '{"logical":"mesh_axis",...}' sharding-rule overrides
"""
import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback

import torch.distributed as dist

from repro_torch.configs import SHAPES, cells_for, get_config
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.distributed.sharding import FSDP_RULES
from repro_torch.launch.mesh import describe, make_production_mesh
from repro_torch.launch.steps import build_step
from repro_torch.roofline.analysis import (count_step, dominant_term,
                                           model_flops_for, roofline_terms)
from repro_torch.roofline.hw import H100_SXM
from repro_torch.roofline.measure import _extract, measure_extrapolated

#: what the collective term's constants describe
COLLECTIVE_CONSTANTS = (
    f"NVLink: {H100_SXM.nvlink_links_per_chip} links x "
    f"{H100_SXM.nvlink_link_bandwidth / 1e9:g} GB/s per direction per card "
    f"(H100_SXM), one 8-card node's constants, not a 256-card fabric's")


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks (this process is rank 0),
    destroyed on exit."""
    # imported here: the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise ValueError("the dry run starts its own fake process group; "
                         "one is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             *, microbatches: int = 1, remat: str = None,
             rules_overrides=None, attn_impl: str = None,
             unroll: bool = True, moe_dispatch: str = None,
             moe_pad: int = 0, kv_quant: bool = False,
             tag: str = None) -> dict:
    overrides = {}
    if remat:
        overrides["remat"] = remat
    if attn_impl:
        overrides["attn_impl"] = attn_impl
    if kv_quant:
        overrides["kv_cache_quant"] = True
    cfg = get_config(arch, **overrides)
    if cfg.moe is not None and (moe_dispatch or moe_pad):
        moe_kw = {}
        if moe_dispatch:
            moe_kw["dispatch"] = moe_dispatch
        if moe_pad:
            moe_kw["pad_to"] = moe_pad
        cfg = dataclasses.replace(cfg,
                                  moe=dataclasses.replace(cfg.moe, **moe_kw))
    shape = SHAPES[shape_name]
    rules = FSDP_RULES
    if rules_overrides:
        rules = rules.override(**rules_overrides)
    chips = 512 if multi_pod else 256

    kw = {"rules": rules}
    if shape.kind == "train" and microbatches > 1:
        kw["microbatches"] = microbatches

    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        # -- 1. the full-depth step on meta DTensors: THE dry-run proof
        #       (sharding coherent, every collective issued)
        t0 = time.time()
        bundle = build_step(cfg, shape, mesh, **kw)
        inputs = bundle.place(*bundle.in_specs)
        t_lower = time.time() - t0
        _, counts = count_step(bundle.step, *inputs)
        t_compile = counts.seconds
        del inputs
        mem = {"temp_size_in_bytes": counts.temp_bytes,
               "argument_size_in_bytes": counts.argument_bytes,
               "output_size_in_bytes": counts.output_bytes,
               "alias_size_in_bytes": counts.alias_bytes,
               # no code is generated
               "generated_code_size_in_bytes": None}
        print(f"== {arch} x {shape_name} on {describe(mesh)} "
              f"(build {t_lower:.1f}s, full-depth run {t_compile:.1f}s)")
        print(f"   memory per rank: {mem}")

        # -- 2. cost measurement: two-point depth extrapolation, as the
        #       reference (the full-depth count agrees with it)
        if unroll:
            meas = measure_extrapolated(cfg, shape, mesh, build_step, **kw)
            flops_source = "depth-extrapolated"
        else:
            meas = _extract(counts)
            flops_source = "full-depth count"
    flops, nbytes = meas["flops"], meas["bytes"]
    coll_w, coll_kind = meas["coll_weighted"], meas["coll_by_kind"]
    coll_counts = meas["coll_counts"]
    flops_source += "; matmul-like ops only (FlopCounterMode's registry)"
    if cfg.attn_impl == "kernel" or cfg.use_ssm_kernel:
        flops_source += "; the kernel routes counted as their plain versions"

    compute_s, memory_s, collective_s = roofline_terms(flops, nbytes, coll_w)
    dominant = dominant_term(compute_s, memory_s, collective_s)
    mf = model_flops_for(cfg, shape)
    useful = mf / chips / flops if flops else 0.0
    print(f"   cost: flops/chip={flops:.3e} bytes/chip={nbytes:.3e} "
          f"({flops_source})")
    print(f"   collectives: {coll_kind} ({coll_counts})")
    print(f"   roofline: compute={compute_s:.4f}s memory={memory_s:.4f}s "
          f"collective={collective_s:.4f}s dominant={dominant} "
          f"useful_ratio={useful:.3f} (collective term: "
          f"{COLLECTIVE_CONSTANTS})")

    result = {
        "arch": arch, "shape": shape_name, "mesh": describe(mesh),
        "chips": chips, "ok": True, "kind": shape.kind,
        "flops_per_chip": flops, "bytes_per_chip": nbytes,
        "collective_bytes_weighted": coll_w,
        "collective_by_kind": coll_kind, "collective_counts": coll_counts,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant,
        "model_flops": mf, "useful_ratio": useful,
        "flops_source": flops_source,
        "lower_s": t_lower, "compile_s": t_compile,
        "microbatches": microbatches, "remat": cfg.remat,
        "memory_analysis": mem,
        "collective_constants": COLLECTIVE_CONSTANTS,
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        if tag is None:
            tag = "multi" if multi_pod else "single"
        path = os.path.join(out_dir, f"{arch}__{shape_name}__{tag}.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="both")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", choices=("none", "dots", "full"))
    ap.add_argument("--attn-impl", choices=("plain", "kernel"))
    ap.add_argument("--rules", type=json.loads, default=None,
                    help='sharding-rule overrides as JSON dict')
    ap.add_argument("--moe-dispatch", choices=("global", "grouped"))
    ap.add_argument("--moe-pad", type=int, default=0)
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache for decode cells (dense/moe)")
    ap.add_argument("--tag", default=None,
                    help="artifact filename tag override")
    ap.add_argument("--no-unroll", "--no-measure", dest="no_unroll",
                    action="store_true",
                    help="take the costs from the full-depth run instead "
                         "of the depth-1/2 extrapolation")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch in ARCH_IDS:
            live, _ = cells_for(get_config(arch))
            cells.extend(live)
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.arch:
        live, _ = cells_for(get_config(args.arch))
        cells = live
    else:
        ap.error("need --arch [--shape] or --all")

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    for arch, shape_name in cells:
        for multi in meshes:
            try:
                run_cell(arch, shape_name, multi, args.out,
                         microbatches=args.microbatches, remat=args.remat,
                         rules_overrides=args.rules,
                         attn_impl=args.attn_impl,
                         unroll=not args.no_unroll,
                         moe_dispatch=args.moe_dispatch,
                         moe_pad=args.moe_pad, kv_quant=args.kv_quant,
                         tag=args.tag)
            except Exception as exc:      # recorded; the run exits 1
                failures.append((arch, shape_name, multi, repr(exc)))
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print(f"\nall {len(cells) * len(meshes)} dry-run cells passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
