#!/usr/bin/env python3
"""Runs the PyTorch port on one CUDA card and checks it end to end.

    PYTHONPATH=src python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. every CUDA source of the port built with nvcc (all at once), then
     each kernel held against its plain version on the card at the main
     paths' shapes and timed beside its plain version, one PyTorch
     library call (where one computes the same function) and its bound:
     flash attention (bf16 tensor-core and fp32 scalar routes, at the
     dense, hybrid, MoE, whisper and vision prefill shapes), the fused
     RMSNorm, the two
     SSD-scan passes on both routes (the intra pass, which also takes the
     chunk cumsum, and the inter pass, which also runs the chunk
     recurrence) and the composed SSD scan;
  3. reduced qwen3-0.6b, zamba2-1.2b, qwen2-moe-a2.7b and
     granite-moe-3b-a800m in fp32, the kernel paths against the plain
     ones; the reduced MoE models' logits on the card against the CPU's,
     and the capacity cut between two equal sequences taking the same
     tokens on both; reduced xlstm-350m, whisper-tiny and
     llama-3.2-vision-90b in fp32 on the card against the CPU (logits,
     and greedy tokens equal), the kernel path against the plain one;
  4. the main paths, each with the launch counts set to 0 just before
     and read just after: full-width, full-depth qwen3-0.6b in bf16 on
     random weights serving 8 requests through ServeEngine, then its int8
     KV cache against the bf16 one; the fused RMSNorm's own entry point;
     full-width, full-depth zamba2-1.2b in bf16 serving 8 requests (every
     Mamba2 prefill through the two SSD kernels, the shared attention
     block through flash attention), then one full-width zamba2 forward,
     the reference's own kernel route; full-width, full-depth
     qwen2-moe-a2.7b and then granite-moe-3b-a800m in bf16 serving 8
     requests each, and granite's int8 KV cache; then the last three
     families, 8 requests each: full-size xlstm-350m, full-size
     whisper-tiny (one seeded (1, 1500, 384) frames input) and
     llama-3.2-vision-90b at full width with its depth cut to 20 layers
     (one seeded (1, 1601, 8192) patches input, gates opened). Each of
     these models also gives its parameter count, its peak memory, its
     decode state per slot and a repeated 512-token prefill (448 for
     whisper), equal bit for bit;
  5. host wall time against device-busy time and kernel launches per
     call (torch.profiler) for one decode step and one prefill of each
     served model, and neither torch's cumsum nor the chunk recurrence's
     stack left in the zamba2 prefill;
  6. training, through the plain paths (no kernel has a backward pass;
     none may launch): full-width, full-depth qwen3-0.6b in bf16 with
     remat "dots" at 8 x 512 tokens, whose loss must fall on a fixed
     batch (step time, tokens/s, share of the bf16 peak, peak memory, one
     profiled step); the memory knobs (remat none / dots / full,
     microbatches 2 against 1) from one state, each step's loss and grad
     norm held to the others'; the resilient loop at full width and 2
     layers, once without a fault (no failure, no restore) and once with
     one injected after a checkpoint (one restore, the same losses);
     granite-moe-3b-a800m at full width and 4 layers, whose loss must
     fall and whose gradients must repeat bit for bit from one state; and
     flash attention refusing autograd on the card;
  7. AARC on the card, through the port's own copies of the paper's
     search stack (no kernel of the port may launch): the measured
     oracle's unit (a 128^2 fp32 matmul timed by CUDA events; first call
     and steady median), the Graph-Centric Scheduler over it and over the
     analytic surface on chatbot, ml_pipeline and video_analysis at
     their SLOs (every schedule within its SLO; the analytic ones equal
     to the CPU's bit for bit); the fleet engine's fast-plane sweep at
     64 candidates x 16,384 instances of a 12-node layered DAG in fp64
     (about 0.1 GB of finish state), bit for bit against the numpy
     sweep, timed beside it, its launches counted; the stage-graph
     planner on the H100 oracle (aarc, maff, bo) for qwen3-0.6b and
     llama-3.2-vision-90b at train_4k, SLO 1.5 x the all-resources step;
     and the training launcher with --autotune-slo (full-size
     qwen3-0.6b, 2 steps of 8 x 512, the planner's remat level, finite
     losses);
  8. the fleet engine on the card (no kernel of the port may launch):
     ``FleetEngine.run_many`` over a seeded 12-node layered DAG from the
     port's generator, 64 candidate config maps x 4 Poisson arrival
     sets x 4,096 instances, on the card's plane and on the numpy plane,
     all 256 reports equal field by field, each plane's wall time, the
     sweep's share (CUDA events around ``fast_plane_sweep`` inside the
     run), and one warm run under torch.profiler (launches, idle share);
     ``run_fleet`` of 100 Chatbot instances on a 40 vCPU / 40,960 MB
     cluster with cold starts, over the analytic surface (equal to the
     CPU's numbers) and over the measured oracle (every invocation batch
     timed on the card); the stochastic backend's paired plane (one
     config in two candidate slots scores identically) and the faulty
     fleets of ``examples/fleet_sim.py`` repeating from one seed, with
     the CPU's failure, retry and timeout counts;
  9. distribution on the card, on a one-rank NCCL process group (a
     store in this process, no network; no kernel of the port may
     launch): full-width, full-depth qwen3-0.6b through
     ``build_train_step``'s sharded step on a (data=1, model=1) mesh
     with the FSDP rules, 5 steps from phase 6's state and batch, its
     losses held to phase 6's first 5 and its parameters to 5 plain
     steps at the reference's sharded-step tolerances (bitwise equality
     printed), its step time (CUDA events), launches, idle share and peak
     memory beside the plain step's; the int8 gradient sync over a
     one-rank ``pod`` group on one step's gradients (0.6 B parameters),
     equal bit for bit to quantize-dequantize and its error to what that
     dropped, timed against its byte bound; and a sharded checkpoint of
     the 2-layer state written to build/ and restored onto the mesh, bit
     for bit, then deleted;
 10. distribution on the serving side, on the same one-rank NCCL group
     and (data=1, model=1) mesh: full-width, full-depth qwen3-0.6b (flash
     attention) and zamba2-1.2b (flash attention and both SSD passes) in
     bf16 through ``build_prefill_step``'s sharded prefill of a 4 x 512
     batch (the kernels run inside ``per_shard`` on the local shards),
     the launch counts set to 0 just before and read just after (28
     flash per qwen3 prefill; 6 flash and 38 of each SSD pass per zamba2
     prefill), then 16 greedy steps of ``build_serve_step``'s step; the
     logits, caches and greedy tokens held to the unsharded
     ``Model.prefill`` / ``decode_step`` on the card (bitwise equality
     printed), each call's time (CUDA events), launches and idle share
     (torch.profiler) and peak memory beside the unsharded call's; then
     the dry run (``repro_torch.launch.dryrun.run_cell``) of qwen3-0.6b at
     prefill_32k and decode_32k on a fake (16, 16) mesh of 256 ranks, in a
     subprocess, with its per-rank roofline terms;
 11. campaigns on the card (no kernel of the port may launch): the
     portfolio of ``benchmarks/campaign_scale.py::campaign_case`` (12
     generated workflows of 8 nodes x slacks 1.5 and 2.5 x aarc, bo and
     maff: 72 cells, seed 0) through ``Campaign.run``, replayed on the
     default infinite cluster (24 Poisson instances at 0.2/s), so that
     every replay sweeps once on the card: once on the lockstep grid
     search plane and once on the sequential one, every cell's trace and
     result equal bit for bit between them, the card's replay metrics
     equal to the same replays swept on the CPU; each plane's search and
     replay wall time, the grid's rounds, fused evaluations and
     serialized cells, the sweeps' share of the replays, the summary per
     searcher; the same spec on ``campaign_case``'s finite cluster (120
     vCPU / 122,880 MB; its replays take the constrained plane on the
     host); then ``run_adaptive`` on the same portfolio with 4 grants per
     round in cost-polish mode (``explore_attained``: on an infinite
     cluster every cell attains its SLO when seeded, so without it no
     round runs), its payload equal to the same run swept on the CPU, its
     budget ledger balanced;
 12. the online control plane on the card (no kernel of the port may
     launch), each run through ``run_online`` on the card (``device=None``)
     and again with ``device="cpu"``, the two payloads equal:
     ``benchmarks/online_serving.py``'s INPUT_MIX (an infinite cluster
     without cold starts, so that its deploy replays and challenger
     validations sweep on the card) under the modes drift, never and
     every_epoch, and once more with each validation widened to 4,096
     arrivals, each run's wall time beside its sweeps' (CUDA events and
     perf_counter); then the specs whose replays take the host's planes,
     with no sweep allowed: LOAD_SHIFT under the three modes and NO_DRIFT,
     ``benchmarks/placement.py``'s two scenarios (per-cell baseline,
     packed, round-robin ablation) and ``benchmarks/autoscale.py``'s
     COMPOUND_SHIFT (static, joint, config_only, scale_only); the
     numbers those benchmarks gate with ``--smoke``, computed as they
     compute them and held to their bars;
 13. one JSON line of serving numbers (memory, int8), one of training
     numbers, one of per-kernel numbers, one of AARC numbers, one of
     fleet numbers, one of distribution numbers, one of serving-side
     distribution numbers, one of campaign numbers, one of online
     numbers and, last, the device line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch.autotune import plan
from repro_torch.configs import SHAPES, get_config, reduced_config
from repro_torch.configs.shapes import Shape
from repro_torch.core import (AdaptiveSpec, AutoscaleSpec, Campaign,
                              CampaignSpec, Environment,
                              GraphCentricScheduler, OnlineSpec,
                              PortfolioSpec, ReplaySpec, ResourceConfig,
                              run_adaptive, run_online)
from repro_torch.core import adaptive as adaptive_mod
from repro_torch.core import campaign as campaign_mod
from repro_torch.core import engine as fleet_engine
from repro_torch.core.engine import (ClusterModel, ColdStartModel,
                                     FleetEngine, PoissonArrivals,
                                     fast_plane_sweep, numpy_plane_sweep,
                                     run_fleet)
from repro_torch.core.faults import (FaultModel, ResilienceModel,
                                     ResiliencePolicy)
from repro_torch.core.placement import PlacementSpec
from repro_torch.distributed import InjectedFault, ResilientLoop
from repro_torch.distributed.collectives import (cross_pod_grad_sync,
                                                 dequantize_int8,
                                                 quantize_int8)
from repro_torch.distributed.sharding import (FSDP_RULES, distribute_tree,
                                              tree_shardings)
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.kernel import fused_rmsnorm_cuda
from repro_torch.kernels.rmsnorm.ref import fused_rmsnorm_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.kernel import ssd_inter_cuda, ssd_intra_cuda
from repro_torch.kernels.ssd_scan.ref import (ssd_inter_scan_ref,
                                              ssd_intra_ref, ssd_scan_ref)
from repro_torch.launch import train as launch_train
from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                      build_train_step)
from repro_torch.models.attention import sdpa
from repro_torch.models import moe
from repro_torch.models.mamba2 import chunk_recurrence
from repro_torch.models.model import Model
from repro_torch.models.transformer import layer_slice, tree_leaves, tree_map
from repro_torch.serverless import (WORKLOADS, SimulatedPlatform,
                                    StochasticBackend, TorchMeasuredOracle,
                                    layered_workflow, workload_slo)
from repro_torch.serverless.generator import (DriftEvent, DriftSchedule,
                                              input_mix_schedule,
                                              load_shift_schedule)
from repro_torch.serving import RequestQueue, ServeEngine
from repro_torch.training import (AdamWConfig, SyntheticDataset, adamw_init,
                                  make_train_step, restore_checkpoint,
                                  save_checkpoint, train_state_axes)

#: H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 outside them,
#: and HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
#: tolerances of the reference's own tests: kernel outputs per type and SSM
#: states (tests/test_kernels.py), model forward (test_kernels.py) and
#: prefill / decode (tests/test_serving.py)
TOL = {torch.float32: dict(atol=2e-5, rtol=2e-4),
       torch.bfloat16: dict(atol=6e-2, rtol=6e-2)}
STATE_TOL = dict(atol=1e-3, rtol=1e-2)
MODEL_TOL = dict(atol=2e-4, rtol=2e-3)
SERVE_TOL = dict(atol=2e-3, rtol=2e-2)
#: the chunk cumsum against torch.cumsum (tests/test_torch_cuda.py)
CUM_TOL = dict(atol=1e-5, rtol=0)
#: calls each torch.profiler window of phase 5 covers
PROFILE_CALLS = 5
#: each kernel's earlier device time (ms) at its main-path shape, on an
#: H100 80GB HBM3 at 700 W: flash attention and the SSD passes before
#: their redesigns (the inter pass without the chunk recurrence), RMSNorm
#: as first measured. Constants copied from PERF.md's kernel table,
#: printed for comparison and kept out of the measured kernels line
PREV_MS = {"flash_attention": 0.13056, "fused_rmsnorm": 0.00514,
           "ssd_intra": 0.07731, "ssd_inter": 0.01626}
#: the training phase: global batch x sequence, steps on one batch (3 warm,
#: TRAIN_TIMED timed), the least fall of its loss (nats), the optimizer
TRAIN_BATCH, TRAIN_SEQ = 8, 512
TRAIN_STEPS, TRAIN_TIMED, TRAIN_LOSS_DROP = 20, 10, 1.0
TRAIN_OPT = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100)
#: timed steps per knob, and how far a knob's first-step loss and grad
#: norm may sit from remat "dots" (relative): remat recomputes the same
#: arithmetic; two microbatches run other GEMM shapes and sum bf16
#: gradients in fp32
KNOB_TIMED = 3
REMAT_TOL = dict(loss=1e-5, grad_norm=1e-4)
MICROBATCH_TOL = dict(loss=1e-3, grad_norm=1e-2)
#: the resilient loop: steps, checkpoint cadence, the step that faults
RESILIENT_STEPS, RESILIENT_CKPT_EVERY, RESILIENT_FAULT_AT = 6, 3, 4
#: MoE training: granite-moe-3b-a800m at full width, depth cut to these
#: layers (so that its AdamW state stays small), batch x sequence, steps
MOE_ARCHS = ("qwen2-moe-a2.7b", "granite-moe-3b-a800m")
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = \
    4, 8, 256, 10
#: the int8 KV cache: prompt, teacher-forced decode steps, and the bound
#: on the largest logit error over the largest logit
#: (tests/test_perf_features.py::test_int8_kv_cache_decode_accuracy)
INT8_PROMPT, INT8_STEPS, INT8_BOUND = 300, 16, 0.05
#: the last three families: parameters counted from the reference's
#: configs (the reference's n_params), the vision model's depth cut (100
#: layers, 87,666,794,536 parameters, about 175 GB in bf16, do not fit one
#: 80 GB card), its cross-layer gates (0 at init, where a cross layer adds
#: nothing), and flash launches per prefill (whisper: its 4 decoder
#: layers; the vision model: its 16 self layers; xLSTM has no kernel)
FAMILY_ARCHS = ("xlstm-350m", "whisper-tiny", "llama-3.2-vision-90b")
FAMILY_PARAMS = {"xlstm-350m": 524_361_896, "whisper-tiny": 49_099_776,
                 "llama-3.2-vision-90b": 19_214_442_504}
VLM_LAYERS = 20
GATES = {"gate_attn": 0.5, "gate_mlp": -0.75}
#: the stub frontend's input of each family, and the repeated and
#: profiled prompt where it is not 512 tokens (whisper's real decoder
#: stops at 448 positions)
STUB = {"audio": "frames", "vlm": "patches"}
PROFILE_PROMPT = {"whisper-tiny": 448}
#: AARC on the card. The analytic scheduler's (cost, e2e, samples) on the
#: paper's three workflows at their SLOs, as the CPU computes them (and as
#: tests/test_torch_aarc.py holds them to the reference's): the card's
#: host must give the same bits
ANALYTIC_SCHEDULES = {
    "chatbot": (127.59039999999999, 69.63333333333333, 83),
    "ml_pipeline": (352.8281631449631, 119.89318181818182, 77),
    "video_analysis": (4798.680828070175, 364.4813596491228, 54)}
#: the measured oracle's steady unit: the median of this many calls
UNIT_CALLS = 50
#: the fast-plane sweep at fleet size: candidates x instances over the
#: generator's seeded layered DAG (nodes, layers, edge probability), fp64,
#: timed over repeats
SWEEP_C, SWEEP_I, SWEEP_V, SWEEP_LAYERS, SWEEP_P_EDGE = 64, 16_384, 12, 4, 0.3
SWEEP_REPEATS = 5
#: the planner's models at train_4k, the SLO over the all-resources step
#: (examples/torch_autotune_stage_graph.py), and the launcher's run
PLAN_ARCHS = ("qwen3-0.6b", "llama-3.2-vision-90b")
PLAN_SLACK = 1.5
LAUNCH_ARGS = ["--arch", "qwen3-0.6b", "--steps", "2", "--batch", "8",
               "--seq", "512", "--log-every", "1"]
#: the fleet engine at fleet size: candidates x arrival sets x instances
#: per set over the sweep's layered DAG, Poisson arrivals at this rate
#: (instances/s); the paired stochastic plane's sets
FLEET_C, FLEET_S, FLEET_I, FLEET_RATE = 64, 4, 4096, 0.25
NOISY_S, NOISY_I, NOISE_SIGMA = 2, 1024, 0.025
#: run_fleet over Chatbot, as examples/fleet_sim.py runs it, with AARC's
#: analytic configuration; the analytic fleet's (p50, p99, SLO attainment,
#: queue delay, cost) as the CPU computes them
CHATBOT_FLEET = dict(rate=0.2, n=100, seed=7)
CHATBOT_CLUSTER = ClusterModel(total_cpu=40.0, total_mem_mb=40960.0)
CHATBOT_COLD = ColdStartModel(delay_s=0.5, keep_alive_s=300.0)
CHATBOT_ANALYTIC = (69.63333333333333, 76.05208458404086, 1.0,
                    98.88956164083862, 12759.039999999999)
#: examples/fleet_sim.py's fault schedule and its (failed instances,
#: retries, timeouts) per recovery policy, as the CPU computes them
FLEET_FAULTS = FaultModel(default_transient=0.1, straggler_prob=0.1,
                          straggler_factor=6.0, seed=5)
FAULTY_COUNTS = {"no-recovery": (56, 0, 0), "retries": (1, 86, 0),
                 "+timeouts": (6, 166, 88)}
#: distribution on the card: sharded steps from phase 6's state, the
#: reference's sharded-step tolerances (tests/test_distributed.py), and
#: the CUDA-event repeats of the int8 gradient sync
DIST_STEPS = 5
DIST_LOSS_RTOL = 1e-4
DIST_PARAM_TOL = dict(atol=1e-4, rtol=1e-3)
SYNC_REPS = 10
#: distribution, serving side: the prompt batch, its length, the greedy
#: serve steps after it; each model's kernel launches per prefill (flash,
#: SSD intra, SSD inter): qwen3's 28 layers; zamba2's 6 shared-block
#: applications and 38 Mamba2 layers
SERVE_DIST_BATCH, SERVE_DIST_SEQ, SERVE_DIST_STEPS = 4, 512, 16
SERVE_DIST_LAUNCHES = {"qwen3-0.6b": (28, 0, 0), "zamba2-1.2b": (6, 38, 38)}
#: the dry run's cells (qwen3-0.6b on the fake single-pod mesh), and its
#: subprocess's time limit (s)
DRYRUN_SHAPES = ("prefill_32k", "decode_32k")
DRYRUN_TIMEOUT_S = 240
#: campaigns on the card: benchmarks/campaign_scale.py::campaign_case's
#: portfolio, searchers and budgets, replayed on the default infinite
#: cluster, and its finite cluster; the adaptive run's grants per round
CAMPAIGN_PORTFOLIO = PortfolioSpec(n_workflows=12, size=8,
                                   slo_slacks=(1.5, 2.5))
CAMPAIGN_SEARCHERS = ("aarc", "bo", "maff")
CAMPAIGN_KWARGS = {"aarc": {"batch_size": 4},
                   "bo": {"n_rounds": 40, "batch_size": 8}}
CAMPAIGN_REPLAY = dict(n_instances=24, rate=0.2)
CAMPAIGN_CLUSTER = ClusterModel(total_cpu=120.0, total_mem_mb=122880.0)
CAMPAIGN_CELLS = 72
ADAPTIVE_GRANTS = 4
#: the online control plane on the card: benchmarks/online_serving.py's
#: LOAD_SHIFT, INPUT_MIX and NO_DRIFT, benchmarks/placement.py's two
#: scenarios and placement, benchmarks/autoscale.py's COMPOUND_SHIFT and
#: actuator sets, each with the benchmark's numbers; INPUT_MIX's
#: challenger validations widened to this many arrivals
ONLINE_LOAD_SHIFT = OnlineSpec(
    portfolio=PortfolioSpec(n_workflows=4, size=6, kinds=("chain",),
                            slo_slacks=(1.6,)),
    replay=ReplaySpec(n_instances=24, rate=0.1,
                      cluster=ClusterModel(total_cpu=460.0,
                                           total_mem_mb=460.0 * 1024.0)),
    n_epochs=12, drift=load_shift_schedule(2, 3.0), seed=0,
    total_budget=512)
ONLINE_INPUT_MIX = OnlineSpec(
    portfolio=PortfolioSpec(n_workflows=3, size=6, slo_slacks=(2.0,)),
    replay=ReplaySpec(n_instances=24, rate=0.5),
    n_epochs=10, drift=input_mix_schedule(2, 1.5), seed=0,
    total_budget=512)
ONLINE_NO_DRIFT = dataclasses.replace(ONLINE_LOAD_SHIFT,
                                      drift=DriftSchedule(), n_epochs=6)
ONLINE_MODES = ("drift", "never", "every_epoch")
ONLINE_WIDE_INSTANCES = 4096
PLACEMENT_SCENARIOS = {
    "load_shift": OnlineSpec(
        portfolio=PortfolioSpec(n_workflows=4, size=6, kinds=("chain",),
                                slo_slacks=(1.6,)),
        replay=ReplaySpec(n_instances=16, rate=0.1,
                          cluster=ClusterModel(total_cpu=110.0,
                                               total_mem_mb=110.0 * 1024.0)),
        n_epochs=8, drift=load_shift_schedule(2, 3.0), seed=0,
        mode="never"),
    "input_mix": OnlineSpec(
        portfolio=PortfolioSpec(n_workflows=4, size=6,
                                kinds=("chain", "fan"), slo_slacks=(2.0,)),
        replay=ReplaySpec(n_instances=16, rate=0.25,
                          cluster=ClusterModel(total_cpu=110.0,
                                               total_mem_mb=110.0 * 1024.0)),
        n_epochs=8, drift=input_mix_schedule(2, 1.5), seed=0,
        mode="never")}
PLACEMENT = PlacementSpec(n_bins=4)
COMPOUND_SHIFT = OnlineSpec(
    portfolio=PortfolioSpec(n_workflows=2, size=5, kinds=("chain",),
                            slo_slacks=(1.6,)),
    replay=ReplaySpec(n_instances=16, rate=0.015,
                      cluster=ClusterModel(total_cpu=60.0,
                                           total_mem_mb=61440.0)),
    n_epochs=14,
    drift=DriftSchedule((DriftEvent(4, "load", 3.0),
                         DriftEvent(4, "input", 1.3))),
    seed=0, total_budget=768, cooldown_epochs=0,
    autoscale=AutoscaleSpec(provision_floor=0.02, max_replicas=12,
                            max_cluster_scale=6.0))
AUTOSCALE_VARIANTS = (("joint", ("config", "scale")),
                      ("config_only", ("config",)),
                      ("scale_only", ("scale",)))
#: the benchmarks' windows and bars: the post-drift window (the last 4
#: epochs, in both), the autoscale benchmark's settle-in epochs, the
#: online benchmark's recovery and probe bars, the autoscale benchmark's
#: recovery bar (joint at or above it, config_only below it)
POST_EPOCHS = 4
SETTLE_EPOCHS = 2
RECOVERY_BAR, BUDGET_BAR = 0.80, 0.50
AUTOSCALE_RECOVERY_BAR = 0.95


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def max_err(got, want, atol, rtol, what):
    """Max |got - want|, failing unless every element is within
    atol + rtol * |want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(bool((err <= atol + rtol * want.abs()).all()),
          f"{what}: max abs err {float(err.max())} beyond atol {atol} "
          f"rtol {rtol}")
    return float(err.max())


def time_ms(fn, reps: int = 50) -> float:
    """Device time of one call: CUDA events around ``reps`` back-to-back
    calls, queued behind a device-side sleep so that the host's launch
    cost does not open gaps between them. Inputs stay warm in L2, as
    they are on the main path, where the producer has just written them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)        # ~50 ms of device-side spinning
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float, dtype) -> tuple:
    """(least time in ms, what bounds it) on the H100's published peaks."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def check_flash(gen, b, s, h, hkv, d, dtype):
    q = randn(gen, (b, s, h, d), dtype)
    k = randn(gen, (b, s, hkv, d), dtype)
    v = randn(gen, (b, s, hkv, d), dtype)
    out = flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    err = max_err(out, attention_ref(q, k, v), **TOL[dtype],
                  what=f"flash attention b={b} s={s} h={h}/{hkv} d={d}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    size = q.element_size()
    ms_bound, bound_by = bound(4 * d * b * h * s * (s + 1) / 2,
                               size * b * s * d * (2 * h + 2 * hkv), dtype)
    return dict(
        shape=f"b={b} s={s} h={h} hkv={hkv} d={d} {str(dtype)[6:]}",
        route=("mma.sync bf16" if dtype == torch.bfloat16
               else "scalar fp32"),
        max_abs_err=err,
        ms=time_ms(lambda: flash_attention_cuda(q, k, v)),
        plain_ms=time_ms(lambda: attention_ref(q, k, v)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        bound_ms=ms_bound, bound_by=bound_by)


def check_rmsnorm(gen, shape, dtype):
    x = randn(gen, shape, dtype)
    r = randn(gen, shape, dtype)
    w = randn(gen, shape[-1:], dtype)
    x2, r2 = x.reshape(-1, shape[-1]), r.reshape(-1, shape[-1])
    y, s = fused_rmsnorm_cuda(x2, r2, w)
    torch.cuda.synchronize()
    yr, sr = fused_rmsnorm_ref(x2, r2, w)
    err = max(max_err(y, yr, **TOL[dtype], what=f"rmsnorm y {shape}"),
              max_err(s, sr, **TOL[dtype], what=f"rmsnorm x+r {shape}"))
    n = x.numel()
    ms_bound, bound_by = bound(5 * n, x.element_size() * (4 * n + shape[-1]),
                               dtype)
    d = shape[-1]
    return dict(
        shape=f"{tuple(shape)} {str(dtype)[6:]}", max_abs_err=err,
        ms=time_ms(lambda: fused_rmsnorm_cuda(x2, r2, w)),
        plain_ms=time_ms(lambda: fused_rmsnorm_ref(x2, r2, w)),
        library_ms=time_ms(lambda: F.rms_norm(x2 + r2, (d,), w, 1e-6)),
        bound_ms=ms_bound, bound_by=bound_by)


def check_ssd(gen, b, s, h, p, n, chunk, dtype):
    """Both SSD passes against their plain versions, and the composed scan
    against the chunked model path, on test_ssd_scan_sweep's input
    distributions. The intra pass takes ``log_a`` on the 2^-10 grid, where
    every cumsum is exact, so its outputs are compared on its own
    arithmetic; the composed scan takes the unquantised ``log_a``. The
    inter pass runs the chunk recurrence from zeros and from a random h0:
    its last state must equal ``chunk_recurrence``'s bit for bit. Returns
    one timed row per pass."""
    xh = randn(gen, (b, s, h, p), dtype)
    bm, cm = (randn(gen, (b, s, n), dtype) for _ in range(2))
    dt = F.softplus(randn(gen, (b, s, h), torch.float32))
    log_a = -dt * torch.exp(randn(gen, (b, s, h), torch.float32) * 0.3)
    shape = f"b={b} s={s} h={h} p={p} n={n} chunk={chunk} {str(dtype)[6:]}"
    q = min(chunk, s)
    c = s // q
    xc = xh.reshape(b, c, q, h, p)
    bc, cc = (t.reshape(b, c, q, n) for t in (bm, cm))
    dc = dt.reshape(b, c, q, h)
    la = torch.round(log_a.reshape(b, c, q, h) * 1024) / 1024

    got = ssd_intra_cuda(xc, bc, cc, la, dc)
    torch.cuda.synchronize()
    cum = torch.cumsum(la, dim=2)
    want = ssd_intra_ref(xc, bc, cc, cum, dc)
    err_intra = max(max_err(g, w, **tol, what=f"ssd_intra {name} {shape}")
                    for g, w, tol, name in zip(
                        got, (*want, cum),
                        (TOL[torch.float32], STATE_TOL, TOL[torch.float32],
                         CUM_TOL),
                        ("y_intra", "S", "decay", "cum")))
    y_intra, s_chunk, dec, cum_out = got
    err_inter = 0.0
    for h0 in (None, randn(gen, (b, h, n, p), torch.float32)):
        y, h_last = ssd_inter_cuda(cc, cum_out, s_chunk, dec, y_intra, dtype,
                                   h0)
        torch.cuda.synchronize()
        case = f"{shape} h0={'random' if h0 is not None else 'zeros'}"
        want_y, want_h = ssd_inter_scan_ref(cc, cum_out, s_chunk, dec,
                                            y_intra, dtype, h0)
        err_inter = max(err_inter, max_err(y, want_y, **TOL[dtype],
                                           what=f"ssd_inter y {case}"))
        check(torch.equal(h_last, chunk_recurrence(s_chunk, dec, h0)[1]),
              f"ssd_inter last state equals chunk_recurrence's bit for bit "
              f"{case}")
    ys, hs = ssd_ops.ssd_scan(xh, bm, cm, log_a, dt, chunk=chunk)
    torch.cuda.synchronize()
    # the chunked path on the inputs cast to fp32, the arithmetic of the
    # Pallas bodies: at bf16 the chunked path itself rounds C B^T to bf16
    yr, hr = ssd_scan_ref(xh.float(), bm.float(), cm.float(), log_a, dt,
                          chunk=chunk)
    max_err(ys, yr, **TOL[dtype], what=f"ssd_scan y {shape}")
    max_err(hs, hr, **STATE_TOL, what=f"ssd_scan final state {shape}")

    # bounds: the work these inputs need (the cumsum; the lower triangle
    # of M, once per head; C B^T once per chunk; C h and the recurrence
    # per chunk and head) and each input read, output written once (the
    # inter pass from zeros: no h0 read). Each pass is bound on the unit
    # its route runs on: the bf16 tensor cores or the fp32 units outside
    # them.
    tri = q * (q + 1) / 2
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    intra_flops = b * c * (2 * n * tri + h * (q + 3 * tri + 2 * p * tri
                                              + 2 * q * n * p + q * p))
    inter_flops = b * c * h * (2 * q * n * p + 2 * q * p + 2 * n * p)
    intra_bytes = nbytes(xc, bc, cc, la, dc, *got)
    intra_bound = bound(intra_flops, intra_bytes, dtype)
    y, h_last = ssd_inter_cuda(cc, cum_out, s_chunk, dec, y_intra, dtype)
    inter_bound = bound(inter_flops, nbytes(cc, cum_out, s_chunk, dec,
                                            y_intra, y, h_last), dtype)
    route = "mma.sync bf16" if dtype == torch.bfloat16 else "scalar fp32"
    rows = []
    for err, (ms_bound, bound_by), kernel, plain in (
            (err_intra, intra_bound,
             lambda: ssd_intra_cuda(xc, bc, cc, la, dc),
             lambda: ssd_intra_ref(xc, bc, cc, torch.cumsum(la, dim=2), dc)),
            (err_inter, inter_bound,
             lambda: ssd_inter_cuda(cc, cum_out, s_chunk, dec, y_intra,
                                    dtype),
             lambda: ssd_inter_scan_ref(cc, cum_out, s_chunk, dec, y_intra,
                                        dtype))):
        rows.append(dict(shape=shape, route=route, max_abs_err=err,
                         ms=time_ms(kernel), plain_ms=time_ms(plain),
                         library_ms=None, bound_ms=ms_bound,
                         bound_by=bound_by))
    rows[0]["cumsum_ms"] = time_ms(lambda: torch.cumsum(la, dim=2))
    rows[1]["recurrence_ms"] = time_ms(
        lambda: chunk_recurrence(s_chunk, dec, None))
    return rows


def print_rows(name, rows):
    for row in rows:
        lib = row["library_ms"]
        lib = "none" if lib is None else f"{lib:.5f} ms"
        extra = ""
        if "cumsum_ms" in row:
            extra = f" [torch.cumsum alone {row['cumsum_ms']:.5f} ms]"
        if "recurrence_ms" in row:
            extra = (f" [the torch chunk recurrence alone "
                     f"{row['recurrence_ms']:.5f} ms]")
        route = f" ({row['route']})" if "route" in row else ""
        print(f"  {name}{route} {row['shape']}: kernel {row['ms']:.5f} ms, "
              f"plain {row['plain_ms']:.5f} ms, library {lib}, bound "
              f"{row['bound_ms']:.5f} ms ({row['bound_by']}), max abs err "
              f"{row['max_abs_err']:.3g}{extra}")


# --------------------------------------------------------------------------
# phases 3 and 4: the model
# --------------------------------------------------------------------------

def model_parity():
    """Reduced qwen3-0.6b in fp32: the kernel path against the plain one."""
    plain = Model(reduced_config("qwen3-0.6b"))
    kernel = Model(reduced_config("qwen3-0.6b", attn_impl="kernel"))
    params = plain.init(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, plain.cfg.vocab, (2, 200), generator=gen,
                           device="cuda")
    want, _ = plain.forward(params, {"tokens": tokens})
    got, _ = kernel.forward(params, {"tokens": tokens})
    return max_err(got, want, **MODEL_TOL, what="reduced qwen3 logits")


def hybrid_parity():
    """Reduced zamba2-1.2b in fp32: the SSD kernels and flash attention
    against the plain path; forward over 8 chunks of 32, and prefill
    logits and decode caches. Returns the largest error of each."""
    plain = Model(reduced_config("zamba2-1.2b"))
    kernel = Model(reduced_config("zamba2-1.2b", use_ssm_kernel=True,
                                  attn_impl="kernel"))
    params = plain.init(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, plain.cfg.vocab, (2, 256), generator=gen,
                           device="cuda")
    ssd_ops.intra_launches = ssd_ops.inter_launches = 0
    want, _ = plain.forward(params, {"tokens": tokens})
    check(ssd_ops.intra_launches == ssd_ops.inter_launches == 0,
          "the plain path launches no kernel")
    got, _ = kernel.forward(params, {"tokens": tokens})
    n = kernel.cfg.n_layers
    check(ssd_ops.intra_launches == ssd_ops.inter_launches == n,
          f"{n} launches of each SSD pass in the reduced forward")
    err_fwd = max_err(got, want, **MODEL_TOL, what="reduced zamba2 logits")
    want, want_c = plain.prefill(params, {"tokens": tokens}, max_len=300)
    got, got_c = kernel.prefill(params, {"tokens": tokens}, max_len=300)
    err_pre = max_err(got, want, **SERVE_TOL,
                      what="reduced zamba2 prefill logits")
    for part in ("mamba", "attn"):
        for name in got_c[part]:
            err_pre = max(err_pre, max_err(
                got_c[part][name], want_c[part][name], **SERVE_TOL,
                what=f"reduced zamba2 prefill cache {part}/{name}"))
    return err_fwd, err_pre


def split_tie(routing, tok_ec) -> bool:
    """Whether some expert's capacity cut falls among equal nonzero routing
    values: it keeps a token and leaves out another of the same value."""
    for e in range(tok_ec.shape[0]):
        last = routing[tok_ec[e, -1], e]
        if last > 0 and int((routing[:, e] == last).sum()) > \
                int((routing[tok_ec[e], e] == last).sum()):
            return True
    return False


def moe_parity(arch):
    """Reduced ``arch`` in fp32, weights drawn on the CPU: on the card the
    kernel path against the plain one (one flash launch per layer), the
    card's plain logits against the CPU's, and global dispatch over a
    batch of two equal sequences of 24 tokens (capacity 15, odd, so the
    cut falls between the two of a pair) taking the same tokens on the
    card as on the CPU. Returns the largest errors (kernel, CPU)."""
    cfg = reduced_config(arch)
    cpu = Model(cfg, device="cpu")
    params_cpu = cpu.init(seed=0)
    params = tree_map(lambda t: t.to("cuda"), params_cpu)
    plain = Model(cfg)
    kernel = Model(reduced_config(arch, attn_impl="kernel"))
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (2, 200), generator=gen)
    want, want_aux = plain.forward(params, {"tokens": tokens.cuda()})
    flash_ops.launches = 0
    got, aux = kernel.forward(params, {"tokens": tokens.cuda()})
    torch.cuda.synchronize()
    check(flash_ops.launches == cfg.n_layers,
          f"{arch}: {cfg.n_layers} flash launches in the reduced forward, "
          f"got {flash_ops.launches}")
    err_kernel = max(max_err(got, want, **MODEL_TOL,
                             what=f"reduced {arch} kernel logits"),
                     max_err(aux, want_aux, **MODEL_TOL,
                             what=f"reduced {arch} kernel aux"))
    on_cpu, cpu_aux = cpu.forward(params_cpu, {"tokens": tokens})
    err_cpu = max(max_err(want.cpu(), on_cpu, **MODEL_TOL,
                          what=f"reduced {arch} logits, card against CPU"),
                  max_err(want_aux.cpu(), cpu_aux, **MODEL_TOL,
                          what=f"reduced {arch} aux, card against CPU"))
    mp = layer_slice(params_cpu["layers"], 0)["moe"]
    x = torch.randn((1, 24, cfg.d_model), generator=gen).repeat(2, 1, 1)
    xf = x.reshape(-1, cfg.d_model)
    tok = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), mp)
        tok[dev] = moe._dispatch_global(p, xf.to(dev), cfg.moe)[3].cpu()
    routing = moe._routing(mp, xf, cfg.moe)[0]
    check(split_tie(routing, tok["cpu"]), f"{arch}: the capacity cut falls "
                                          f"among equal routing values")
    check(torch.equal(tok["cuda"], tok["cpu"]),
          f"{arch}: the card takes the same tokens at the capacity cut as "
          f"the CPU")
    return err_kernel, err_cpu


def serve_hybrid():
    """Full zamba2-1.2b serving 8 requests through the SSD kernels and
    flash attention, then one full-width forward; returns (model, params,
    engine, results, {kernel: launches while serving}, prompt lengths,
    wall seconds)."""
    cfg = get_config("zamba2-1.2b", attn_impl="kernel", use_ssm_kernel=True)
    model = Model(cfg)
    params = model.init(seed=0)
    engine = ServeEngine(model, params, n_slots=4, max_len=1024)
    rng = np.random.default_rng(0)
    # the chunked scan takes a prompt of at most one chunk or of whole
    # chunks (the reference's rule), so: 4 short prompts and 4 long ones
    lengths = [int(n) for n in rng.integers(16, 129, size=4)]
    lengths += [int(n) for n in rng.choice([256, 384, 512, 640], size=4)]
    queue = RequestQueue()
    for n in lengths:
        queue.submit(rng.integers(0, cfg.vocab, size=n), max_new_tokens=32)
    torch.cuda.synchronize()
    ssd_ops.intra_launches = ssd_ops.inter_launches = flash_ops.launches = 0
    t0 = time.perf_counter()
    results = engine.run(queue)
    wall = time.perf_counter() - t0
    launches = {"ssd_intra": ssd_ops.intra_launches,
                "ssd_inter": ssd_ops.inter_launches,
                "flash_attention": flash_ops.launches}
    check(len(results) == 8, f"8 requests finish, got {len(results)}")
    for r in results:
        check(len(r.tokens) == 32, f"request {r.uid}: 32 tokens")
        check(all(0 <= t < cfg.vocab for t in r.tokens),
              f"request {r.uid}: tokens in [0, vocab)")
    for part in ("mamba", "attn"):
        for name, t in engine.cache[part].items():
            check(bool(torch.isfinite(t).all()),
                  f"finite cache {part}/{name}")
    n_apps = int(model._shared_flags().sum())
    for name, per in (("ssd_intra", cfg.n_layers), ("ssd_inter", cfg.n_layers),
                      ("flash_attention", n_apps)):
        check(launches[name] == per * engine.n_prefills,
              f"{name} launches {launches[name]} == {per} x "
              f"{engine.n_prefills} prefills")

    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, size=512),
                             device="cuda")[None]
    ssd_ops.intra_launches = ssd_ops.inter_launches = flash_ops.launches = 0
    logits, _ = model.forward(params, {"tokens": tokens})
    torch.cuda.synchronize()
    check(logits.shape == (1, 512, cfg.padded_vocab), "forward logits shape")
    check(bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
          "finite forward logits")
    got = (ssd_ops.intra_launches, ssd_ops.inter_launches, flash_ops.launches)
    check(got == (cfg.n_layers, cfg.n_layers, n_apps),
          f"forward launches {got} == ({cfg.n_layers}, {cfg.n_layers}, "
          f"{n_apps})")
    return model, params, engine, results, launches, lengths, wall


def state_bytes(cache) -> int:
    """Bytes of a decode cache's tensors, its lengths left out."""
    return sum(t.numel() * t.element_size() for k, v in cache.items()
               if k != "length" for t in tree_leaves(v))


def int8_against_bf16(model, params):
    """``model``'s config with kv_cache_quant=True against the bf16 cache
    on one INT8_PROMPT-token prompt, then INT8_STEPS teacher-forced decode
    steps: the largest logit error over the largest logit (real vocab
    columns) must stay under INT8_BOUND. Returns its numbers."""
    cfg = model.cfg
    quant = Model(dataclasses.replace(cfg, kv_cache_quant=True))
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          size=INT8_PROMPT + INT8_STEPS),
                             device="cuda")[None]
    max_len = INT8_PROMPT + INT8_STEPS
    errs, peak = [], []

    def compare(want, got):
        w, g = want[..., :cfg.vocab].float(), got[..., :cfg.vocab].float()
        check(bool(torch.isfinite(g).all()), f"{cfg.name}: finite int8 logits")
        errs.append(float((g - w).abs().max()))
        peak.append(float(w.abs().max()))

    batch = {"tokens": tokens[:, :INT8_PROMPT]}
    want, cache = model.prefill(params, batch, max_len=max_len)
    got, qcache = quant.prefill(params, batch, max_len=max_len)
    check(qcache["layers"]["k"].dtype == torch.int8, "an int8 cache")
    ratio = state_bytes(qcache) / state_bytes(cache)
    compare(want, got)
    for i in range(INT8_PROMPT, max_len):
        want, cache = model.decode_step(params, cache, tokens[:, i:i + 1])
        got, qcache = quant.decode_step(params, qcache, tokens[:, i:i + 1])
        compare(want, got)
    rel = max(errs) / max(peak)
    check(rel < INT8_BOUND, f"{cfg.name}: int8 logits within {INT8_BOUND} of "
                            f"the largest bf16 logit, got {rel:.4f}")
    print(f"{cfg.name} int8 KV cache: largest logit error over largest logit "
          f"{rel:.5f} (bound {INT8_BOUND}) over a {INT8_PROMPT}-token prefill "
          f"and {INT8_STEPS} decode steps; cache {state_bytes(qcache):,} bytes "
          f"against {state_bytes(cache):,} in bf16 ({ratio:.4f})")
    return dict(rel_err=rel, max_abs_err=max(errs), cache_bytes=state_bytes(
        qcache), bf16_cache_bytes=state_bytes(cache), ratio=ratio)


def print_serving(name, engine, results, lengths, wall, launches):
    n_tokens = sum(len(r.tokens) for r in results)
    busy = engine.prefill_s + engine.decode_s
    print(f"{name}: served {len(results)} requests, prompts "
          f"{sorted(lengths)}, {n_tokens} tokens in {wall:.3f} s: prefill "
          f"{engine.prefill_s / engine.n_prefills * 1e3:.3f} ms per request, "
          f"decode {engine.decode_s / engine.decode_steps * 1e3:.3f} ms per "
          f"step ({engine.decode_steps} steps, {engine.n_slots} slots), "
          f"{n_tokens / busy:.1f} tokens/s; launches {launches}")


def profile_call(name, fn, kernels, n: int = PROFILE_CALLS):
    """Host wall time against device-busy time (the sum of the kernels'
    times in a torch.profiler trace) of ``n`` warm calls of ``fn``;
    ``kernels`` names the port's kernels by a substring of their names.
    Prints one line and the top kernels; returns (its kernel rows,
    longest first, kernel launches per call, wall ms, device-busy ms per
    call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    # kernel rows only: a CPU op's row repeats its kernels' time
    rows = sorted((r for r in prof.key_averages()
                   if r.device_type == DeviceType.CUDA),
                  key=lambda r: -r.self_device_time_total)
    launches = sum(r.count for r in rows) // n
    device_ms = sum(r.self_device_time_total for r in rows) / n / 1e3
    if device_ms == 0.0:
        print(f"  {name}: wall {wall_ms:.3f} ms; device time not "
              f"measured (the profiler saw no kernel)")
        return rows, launches, wall_ms, None
    share = lambda key: sum(r.self_device_time_total for r in rows
                            if key in r.key) / n / 1e3
    shares = "".join(f", {kname} {share(key):.3f} ms"
                     for kname, key in kernels.items())
    print(f"  {name}: wall {wall_ms:.3f} ms, device busy "
          f"{device_ms:.3f} ms (idle share "
          f"{1 - device_ms / wall_ms:.3f}), {launches} kernel launches "
          f"per call{shares}; top kernels:")
    for r in rows[:6]:
        print(f"    {r.self_device_time_total / n / 1e3:.3f} ms "
              f"x{r.count // n} {r.key[:90]}")
    return rows, launches, wall_ms, device_ms


def where_time_goes(model, params, engine, kernels, extra=None):
    """``profile_call`` for one decode step of the 4-slot batch and one
    prefill of 512 tokens (PROFILE_PROMPT's length where it names the
    model), warm, as the main path runs them; over 2 calls for xLSTM,
    whose sLSTM prefill launches tens of thousands of kernels. Returns
    {call: (its kernel rows, longest first, kernel launches per call,
    wall ms, device-busy ms)}."""
    cfg = model.cfg
    s = PROFILE_PROMPT.get(cfg.name, 512)
    prompt = torch.randint(0, cfg.vocab, (1, s), device="cuda")
    calls = {
        "decode step, 4 slots": lambda: model.decode_step(
            params, engine.cache, engine.last_tokens),
        f"prefill, {s} tokens": lambda: model.prefill(
            params, {"tokens": prompt, **(extra or {})},
            max_len=engine.max_len)}
    n = 2 if cfg.family == "ssm" else PROFILE_CALLS
    return {name: profile_call(name, fn, kernels, n=n)
            for name, fn in calls.items()}


def rmsnorm_entry_point():
    """The fused RMSNorm's own path: its public entry point on the
    residual stream of a 4 x 512-token batch of qwen3-0.6b (d = 1024)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    x, r = (randn(gen, (4, 512, 1024), torch.bfloat16) for _ in range(2))
    w = randn(gen, (1024,), torch.bfloat16)
    rms_ops.launches = 0
    y, s = rms_ops.fused_rmsnorm(x, r, w)
    torch.cuda.synchronize()
    launches = rms_ops.launches
    check(launches == 1, f"fused RMSNorm launched once, got {launches}")
    check(y.shape == x.shape and bool(torch.isfinite(y).all()),
          "finite normed rows")
    return launches


# --------------------------------------------------------------------------
# phases 3 to 5: the xLSTM, whisper and llama-vision families
# --------------------------------------------------------------------------

def open_gates(params) -> None:
    """Set the vision model's cross-layer gates (0 at init) to GATES."""
    if "segments" in params:
        for name, value in GATES.items():
            params["segments"]["cross"][name].fill_(value)


def stub_input(cfg, b: int, seed: int, device) -> dict:
    """The audio (``frames``) or vision (``patches``) family's stub
    frontend input, (b, n_frontend_tokens, d_model) from a seeded CPU
    generator, or nothing."""
    name = STUB.get(cfg.family)
    if name is None:
        return {}
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, cfg.n_frontend_tokens, cfg.d_model), generator=gen)
    return {name: x.to(device, cfg.tdtype)}


def flash_per_prefill(model) -> int:
    """Flash launches of one prefill or forward: each causal
    self-attention (the encoder and the cross layers run plain)."""
    cfg = model.cfg
    if cfg.family == "ssm":
        return 0
    if cfg.family == "vlm":
        nseg, nself = model._vlm_seg()
        return nseg * nself
    return cfg.n_layers


def family_parity(arch):
    """Reduced ``arch`` in fp32, weights drawn on the CPU (vision gates
    opened): on the card the kernel path against the plain one (flash in
    each causal self-attention), the card's logits against the CPU's, and
    a prefill of 60 tokens and 8 greedy decode steps giving the same
    tokens on the card as on the CPU, each step's logits within the
    serving tolerance. Returns the largest errors (kernel, CPU forward,
    CPU serving)."""
    cfg = reduced_config(arch)
    cpu = Model(cfg, device="cpu")
    params_cpu = cpu.init(seed=0)
    open_gates(params_cpu)
    params = tree_map(lambda t: t.to("cuda"), params_cpu)
    plain = Model(cfg)
    kernel = Model(reduced_config(arch, attn_impl="kernel"))
    gen = torch.Generator().manual_seed(6)
    tokens = torch.randint(0, cfg.vocab, (2, 64), generator=gen)
    extra = stub_input(cfg, 2, 7, "cpu")
    on_card = lambda batch: {k: v.cuda() for k, v in batch.items()}
    batch = {"tokens": tokens, **extra}
    want, _ = plain.forward(params, on_card(batch))
    flash_ops.launches = 0
    got, _ = kernel.forward(params, on_card(batch))
    torch.cuda.synchronize()
    n_flash = flash_per_prefill(kernel)
    check(flash_ops.launches == n_flash,
          f"{arch}: {n_flash} flash launches in the reduced forward, got "
          f"{flash_ops.launches}")
    err_kernel = max_err(got, want, **MODEL_TOL,
                         what=f"reduced {arch} kernel logits")
    on_cpu, _ = cpu.forward(params_cpu, batch)
    err_cpu = max_err(want.cpu(), on_cpu, **MODEL_TOL,
                      what=f"reduced {arch} logits, card against CPU")
    prompt = dict(batch, tokens=tokens[:, :60])
    lg, cache = kernel.prefill(params, on_card(prompt), max_len=72)
    lc, cache_c = cpu.prefill(params_cpu, prompt, max_len=72)
    err_serve = 0.0
    for step in range(9):
        err_serve = max(err_serve, max_err(
            lg.cpu(), lc, **SERVE_TOL,
            what=f"reduced {arch} serving logits step {step}, card "
                 f"against CPU"))
        tok_g, tok_c = lg[:, -1].argmax(-1), lc[:, -1].argmax(-1)
        check(torch.equal(tok_g.cpu(), tok_c),
              f"{arch}: greedy tokens of step {step} equal on the card and "
              f"the CPU: {tok_g.tolist()} against {tok_c.tolist()}")
        if step < 8:
            lg, cache = kernel.decode_step(params, cache, tok_g[:, None])
            lc, cache_c = cpu.decode_step(params_cpu, cache_c,
                                          tok_c[:, None])
    return err_kernel, err_cpu, err_serve


def serve_model(arch):
    """Full-width ``arch`` (dense, MoE, xLSTM, whisper or the vision
    model) in bf16 on random weights from seed 0 (vision gates opened)
    serving 8 requests of 32 new tokens through ServeEngine(n_slots=4,
    max_len=1024), every causal prefill through flash attention, one
    seeded stub input (batch 1) given to every request as
    ``extra_inputs``. Full depth, but the vision model at VLM_LAYERS. Its
    parameter count against cfg.n_params(), peak memory after init and
    after serving, decode state per slot, and one prefill of 512 tokens
    (PROFILE_PROMPT's length where it names the model) run twice, whose
    logits and cache must be equal bit for bit. Returns (model, params,
    engine, results, flash launches while serving, prompt lengths, wall
    seconds, numbers, extra inputs)."""
    overrides = {"n_layers": VLM_LAYERS} if arch.startswith("llama") else {}
    cfg = get_config(arch, attn_impl="kernel", **overrides)
    model = Model(cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = model.init(seed=0)
    open_gates(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base
    resident = torch.cuda.memory_allocated() - base
    n_params = sum(t.numel() for t in tree_leaves(params))
    check(n_params == cfg.n_params() == FAMILY_PARAMS.get(arch, n_params),
          f"{arch}: {n_params} parameters == cfg.n_params() "
          f"{cfg.n_params()} (and the reference's count)")
    engine = ServeEngine(model, params, n_slots=4, max_len=1024)
    rng = np.random.default_rng(0)
    if cfg.family == "ssm":
        # the chunkwise mLSTM prefill takes a prompt of at most one chunk
        # (128) or of whole chunks (the reference's rule)
        lengths = [int(n) for n in rng.integers(16, 129, size=4)]
        lengths += [int(n) for n in rng.choice([128, 256, 384, 512], size=4)]
    else:
        top = 449 if cfg.family == "audio" else 513
        lengths = [int(n) for n in rng.integers(16, top, size=8)]
    check(any(n % 64 for n in lengths), "a ragged prompt length")
    extra = stub_input(cfg, 1, 11, "cuda")
    queue = RequestQueue()
    for n in lengths:
        queue.submit(rng.integers(0, cfg.vocab, size=n), max_new_tokens=32)
    torch.cuda.synchronize()
    flash_ops.launches = 0
    t0 = time.perf_counter()
    results = engine.run(queue, extra_inputs=extra)
    wall = time.perf_counter() - t0
    launches = flash_ops.launches
    check(len(results) == 8, f"{arch}: 8 requests finish, got {len(results)}")
    for r in results:
        check(len(r.tokens) == 32, f"{arch} request {r.uid}: 32 tokens")
        check(all(0 <= t < cfg.vocab for t in r.tokens),
              f"{arch} request {r.uid}: tokens in [0, vocab)")
    for t in tree_leaves({k: v for k, v in engine.cache.items()
                          if k != "length"}):
        check(bool(torch.isfinite(t).all()), f"{arch}: finite decode cache")
    per = flash_per_prefill(model)
    check(launches == per * engine.n_prefills,
          f"{arch}: flash launches {launches} == {per} x "
          f"{engine.n_prefills} prefills")
    serve_peak = torch.cuda.max_memory_allocated() - base
    per_slot = state_bytes(engine.cache) // engine.n_slots
    s = PROFILE_PROMPT.get(arch, 512)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, size=s),
                             device="cuda")[None]
    runs = [model.prefill(params, {"tokens": prompt, **extra},
                          max_len=1024) for _ in range(2)]
    (l1, c1), (l2, c2) = runs
    check(l1.shape == (1, 1, cfg.padded_vocab) and
          bool(torch.isfinite(l1[..., :cfg.vocab]).all()),
          f"{arch}: finite prefill logits")
    check(torch.equal(l1, l2) and all(torch.equal(a, b) for a, b in zip(
        tree_leaves(c1), tree_leaves(c2))),
          f"{arch}: a repeated {s}-token prefill gives equal logits and cache")
    del runs, c1, c2
    numbers = dict(params=n_params, params_active=cfg.n_active_params(),
                   layers=cfg.n_layers, init_s=init_s,
                   init_peak_bytes=init_peak, resident_bytes=resident,
                   serve_peak_bytes=serve_peak, state_bytes_per_slot=per_slot,
                   flash_per_prefill=per, repeated_prefill_equal=True)
    cut = (f" (depth cut from 100: the full model's 87,666,794,536 "
           f"parameters, about 175 GB in bf16, do not fit one 80 GB card)"
           if arch.startswith("llama") else "")
    print(f"{arch}: {cfg.n_layers} layers{cut}, {n_params:,} parameters "
          f"({cfg.n_active_params():,} active per token) == cfg.n_params(); "
          f"init {init_s:.2f} s, peak {init_peak / 2**30:.3f} GiB "
          f"({resident / 2**30:.3f} GiB resident); peak while serving "
          f"{serve_peak / 2**30:.3f} GiB; decode state {per_slot:,} bytes "
          f"per slot; a repeated {s}-token prefill equal bit for bit")
    return (model, params, engine, results, launches, lengths, wall,
            numbers, extra)


# --------------------------------------------------------------------------
# phase 6: training
# --------------------------------------------------------------------------

def train_flops(cfg, params, b: int, s: int) -> float:
    """Model FLOPs of one training step: 6 N per token, N the parameters
    that enter a matmul (the layers' projections and the unembedding),
    plus the attention products, QK^T and PV over the full square the
    plain path computes, forward and twice backward. Recomputation is
    not counted."""
    n_mm = (sum(t.numel() for t in tree_leaves(params["layers"])
                if t.dim() == 3)
            + sum(t.numel() for t in tree_leaves(params["embed"])))
    attn = 3 * 4 * cfg.n_layers * b * cfg.n_heads * s * s * cfg.hd
    return 6 * n_mm * b * s + attn


def train_steps(step, state, batch, n: int):
    """``n`` steps on one batch; returns (state, losses, grad norms, the
    device time of each step from CUDA events)."""
    events = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    metrics = []
    events[0].record()
    for i in range(n):
        state, m = step(state, batch)
        metrics.append(m)
        events[i + 1].record()
    torch.cuda.synchronize()
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"finite losses {losses} and grad norms {norms}")
    return state, losses, norms, ms


def train_main_path():
    """Full-width, full-depth qwen3-0.6b in bf16 (remat "dots"), global
    batch 8 x 512 tokens from SyntheticDataset on the card, through
    make_train_step: 3 warm steps, TRAIN_TIMED timed steps, and the rest
    of TRAIN_STEPS on the same batch, whose loss must fall; then one warm
    step under torch.profiler. Returns (result dict, model, initial
    state, batch)."""
    cfg = get_config("qwen3-0.6b", remat="dots")
    model = Model(cfg)
    state0 = adamw_init(model.init(seed=0))
    ds = SyntheticDataset(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=0)
    batch = ds.batch_at(0)
    check(batch["tokens"].is_cuda and batch["tokens"].shape
          == (TRAIN_BATCH, TRAIN_SEQ), "an 8 x 512 batch on the card")
    step = make_train_step(model, TRAIN_OPT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    state, warm, _, warm_ms = train_steps(step, state0, batch, 3)
    state, timed, norms, ms = train_steps(step, state, batch, TRAIN_TIMED)
    state, rest, _, _ = train_steps(step, state, batch,
                                    TRAIN_STEPS - 3 - TRAIN_TIMED)
    peak = torch.cuda.max_memory_allocated()
    losses = warm + timed + rest
    check(int(state["step"]) == TRAIN_STEPS, "the step counter advanced")
    check(losses[-1] < losses[0] - TRAIN_LOSS_DROP,
          f"the loss falls by more than {TRAIN_LOSS_DROP} on a fixed batch "
          f"over {TRAIN_STEPS} steps: {losses[0]:.4f} -> {losses[-1]:.4f}")
    step_ms = sum(ms) / len(ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = train_flops(cfg, state0["params"], TRAIN_BATCH, TRAIN_SEQ)
    print(f"qwen3-0.6b training, bf16, remat dots, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens: step {step_ms:.3f} ms (CUDA events, mean of "
          f"{TRAIN_TIMED}; min {min(ms):.3f}, max {max(ms):.3f}; first warm "
          f"step {warm_ms[0]:.3f}), {tokens / step_ms * 1e3:.1f} tokens/s, "
          f"{flops / 1e12:.3f} TFLOP per step, "
          f"{flops / (step_ms * 1e-3) / PEAK_FLOPS[torch.bfloat16]:.4f} of "
          f"the bf16 dense peak; peak memory {peak / 2**30:.3f} GiB "
          f"({resident / 2**30:.3f} GiB resident before the first step)")
    print(f"  loss over {TRAIN_STEPS} steps on one batch: "
          f"{[round(x, 4) for x in losses]}")
    print("where the time goes (one warm training step):")
    rows, launches, wall_ms, device_ms = profile_call(
        "train step, remat dots", lambda: step(state, batch), {}, n=1)
    check(device_ms is not None, "the profiler saw the train step's kernels")
    result = dict(
        arch="qwen3-0.6b", dtype="bfloat16", remat="dots",
        batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
        step_ms=step_ms, step_ms_min=min(ms), step_ms_max=max(ms),
        first_step_ms=warm_ms[0], tokens_per_s=tokens / step_ms * 1e3,
        tflop_per_step=flops / 1e12,
        peak_share=flops / (step_ms * 1e-3) / PEAK_FLOPS[torch.bfloat16],
        peak_bytes=peak, resident_bytes=resident,
        loss_first=losses[0], loss_last=losses[-1], grad_norm=norms[-1],
        losses=losses,
        profiled_wall_ms=wall_ms, device_busy_ms=device_ms,
        idle_share=1 - device_ms / wall_ms, launches_per_step=launches,
        top_kernels=[[r.key[:80], r.self_device_time_total / 1e3]
                     for r in rows[:5]])
    return result, model, state0, batch


def train_knobs(model, state0, batch):
    """The autotuner's memory knobs at the main shape: remat none / dots
    / full and microbatches 2 against 1, each from the same state on the
    same batch. Each gives one step (its loss and grad norm compared
    across the knob) and KNOB_TIMED timed steps, with its peak memory."""
    out = {}
    for name, cfg, m in (
            ("remat none", dataclasses.replace(model.cfg, remat="none"), 1),
            ("remat dots", model.cfg, 1),
            ("remat full", dataclasses.replace(model.cfg, remat="full"), 1),
            ("remat dots, 2 microbatches", model.cfg, 2)):
        step = make_train_step(Model(cfg), TRAIN_OPT, microbatches=m)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, losses, norms, _ = train_steps(step, state0, batch, 1)
        _, _, _, ms = train_steps(step, state, batch, KNOB_TIMED)
        del state
        out[name] = dict(loss=losses[0], grad_norm=norms[0],
                         step_ms=sum(ms) / len(ms),
                         peak_bytes=torch.cuda.max_memory_allocated())
        print(f"  {name}: step {out[name]['step_ms']:.3f} ms (mean of "
              f"{KNOB_TIMED}), peak memory "
              f"{out[name]['peak_bytes'] / 2**30:.3f} GiB, first-step loss "
              f"{losses[0]:.6f}, grad norm {norms[0]:.6f}")
    rel = lambda a, b, k: abs(out[a][k] - out[b][k]) / abs(out[b][k])
    for name, tol in (("remat none", REMAT_TOL), ("remat full", REMAT_TOL),
                      ("remat dots, 2 microbatches", MICROBATCH_TOL)):
        for k in ("loss", "grad_norm"):
            err = rel(name, "remat dots", k)
            out[name][f"{k}_rel_diff"] = err
            check(err <= tol[k], f"{name}: {k} within rel {tol[k]} of "
                                 f"remat dots, got {err:.3g}")
    return out


def train_resilient():
    """ResilientLoop at full width and 2 layers: an uninterrupted run,
    which must see no failure and no restore (the loop catches every
    RuntimeError, so a real fault would hide behind a restore), then a
    run with one fault injected after a checkpoint, which must restore
    once and reproduce the uninterrupted losses; checkpoints go to build/
    and are deleted afterwards."""
    cfg = get_config("qwen3-0.6b", n_layers=2, remat="dots")
    model = Model(cfg)
    state0 = adamw_init(model.init(seed=0))
    ds = SyntheticDataset(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=1)
    step = make_train_step(model, TRAIN_OPT)
    ckpt_root = Path(__file__).resolve().parent / "build" / "train_smoke_ckpt"
    n_params = sum(t.numel() for t in tree_leaves(state0["params"]))

    def run(name, fault_at=None):
        log, fired = [], []

        def recording(st, b):
            st2, m = step(st, b)
            log.append((int(st["step"]), float(m["loss"])))
            return st2, m

        def fault_hook(i):
            if i == fault_at and not fired:
                fired.append(i)
                raise InjectedFault(f"injected at step {i}")

        loop = ResilientLoop(recording, state0, ckpt_dir=str(ckpt_root /
                                                             name),
                             ckpt_every=RESILIENT_CKPT_EVERY, keep=1,
                             fault_hook=fault_hook)
        t0 = time.perf_counter()
        report = loop.run(ds, until_step=RESILIENT_STEPS)
        wall = time.perf_counter() - t0
        shutil.rmtree(ckpt_root / name)
        return loop.state, report, log, wall

    shutil.rmtree(ckpt_root, ignore_errors=True)
    try:
        ref_state, ref, ref_log, ref_wall = run("clean")
        state, rep, log, wall = run("faulty", fault_at=RESILIENT_FAULT_AT)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    check(ref.failures == ref.restores == 0 and
          ref.final_step == RESILIENT_STEPS,
          f"the run without a fault: 0 failures, 0 restores, "
          f"{RESILIENT_STEPS} steps; got {ref}")
    check(rep.failures == rep.restores == 1 and
          rep.final_step == RESILIENT_STEPS,
          f"the run with one fault: 1 failure, 1 restore; got {rep}")
    want = dict(ref_log)
    check(len(want) == RESILIENT_STEPS, "one loss per step")
    rel = max(abs(loss - want[i]) / abs(want[i]) for i, loss in log)
    check(rel <= 1e-6, f"losses after the restore equal the uninterrupted "
                       f"run's (rel 1e-6), got {rel:.3g}")
    replayed = sorted(i for i, _ in log)
    check(len(log) > RESILIENT_STEPS, f"steps replayed: {replayed}")
    same_state = all(torch.equal(a, b) for a, b in
                     zip(tree_leaves(state), tree_leaves(ref_state)))
    print(f"qwen3-0.6b full width, 2 layers ({n_params / 1e6:.1f}M params), "
          f"ResilientLoop to step {RESILIENT_STEPS}, checkpoints every "
          f"{RESILIENT_CKPT_EVERY}: clean run {ref_wall:.2f} s, 0 failures "
          f"and 0 restores; fault at step {RESILIENT_FAULT_AT}: 1 restore, "
          f"steps run {replayed}, {wall:.2f} s; max rel loss diff {rel:.3g}; "
          f"final state bit-equal: {same_state}")
    return dict(params=n_params, steps=RESILIENT_STEPS,
                ckpt_every=RESILIENT_CKPT_EVERY, fault_at=RESILIENT_FAULT_AT,
                clean_s=ref_wall, faulty_s=wall, restores=rep.restores,
                steps_run=replayed, max_rel_loss_diff=rel,
                final_state_bit_equal=same_state)


def train_moe():
    """granite-moe-3b-a800m at full width and MOE_TRAIN_LAYERS layers in
    bf16, remat "dots", a global batch of MOE_TRAIN_BATCH x MOE_TRAIN_SEQ:
    two steps from one state must give gradients equal bit for bit (the
    dispatch's gather and sum back to tokens use no atomics), then
    MOE_TRAIN_STEPS steps on one batch, whose loss must fall."""
    cfg = get_config("granite-moe-3b-a800m", n_layers=MOE_TRAIN_LAYERS,
                     remat="dots")
    model = Model(cfg)
    state0 = adamw_init(model.init(seed=0))
    n_params = sum(t.numel() for t in tree_leaves(state0["params"]))
    batch = SyntheticDataset(vocab=cfg.vocab, seq_len=MOE_TRAIN_SEQ,
                             global_batch=MOE_TRAIN_BATCH, seed=0).batch_at(0)
    seen = []

    def capture(grads):
        seen.append(grads)
        return grads

    step = make_train_step(model, TRAIN_OPT, grad_transform=capture)
    _, m1 = step(state0, batch)
    _, m2 = step(state0, batch)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(seen[0]),
                                                 tree_leaves(seen[1])))
    check(same and float(m1["loss"]) == float(m2["loss"]),
          "granite-moe: two steps from one state give equal gradients")
    del seen[:]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, losses, _, ms = train_steps(make_train_step(model, TRAIN_OPT),
                                       state0, batch, MOE_TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    check(losses[-1] < losses[0], f"granite-moe: the loss falls on a fixed "
                                  f"batch: {losses[0]:.4f} -> {losses[-1]:.4f}")
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    step_ms = sum(ms[1:]) / len(ms[1:])
    print(f"granite-moe-3b-a800m training, full width, {MOE_TRAIN_LAYERS} "
          f"layers ({n_params / 1e6:.1f}M params), bf16, remat dots, "
          f"{MOE_TRAIN_BATCH} x {MOE_TRAIN_SEQ} tokens: gradients of two steps "
          f"from one state equal bit for bit; step {step_ms:.3f} ms (CUDA "
          f"events, mean of steps 2-{MOE_TRAIN_STEPS}), "
          f"{tokens / step_ms * 1e3:.1f} tokens/s, peak memory "
          f"{peak / 2**30:.3f} GiB; loss {[round(x, 4) for x in losses]}")
    return dict(arch=cfg.name, layers=MOE_TRAIN_LAYERS, params=n_params,
                batch=MOE_TRAIN_BATCH, seq=MOE_TRAIN_SEQ, step_ms=step_ms,
                first_step_ms=ms[0], tokens_per_s=tokens / step_ms * 1e3,
                peak_bytes=peak, loss_first=losses[0], loss_last=losses[-1],
                grads_bit_equal=same)


def repair_on_card():
    """Under grad, flash attention on CUDA inputs that require grad raises
    (the kernel has no backward pass) and launches nothing."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    q = randn(gen, (1, 128, 16, 128), torch.bfloat16).requires_grad_(True)
    k = randn(gen, (1, 128, 8, 128), torch.bfloat16)
    before = flash_ops.launches
    try:
        sdpa(q, k, k, causal=True, impl="kernel")
    except ValueError as exc:
        check("attn_impl='plain'" in str(exc), f"the message says how to "
                                               f"train: {exc}")
    else:
        check(False, "sdpa(impl='kernel') under grad raises")
    check(flash_ops.launches == before, "the refused call launched nothing")
    return True


# --------------------------------------------------------------------------
# phase 7: AARC on the card
# --------------------------------------------------------------------------

def schedule_paper_workflows(make_env):
    """Algorithm 1 on the paper's three workflows at their SLOs, each in
    a fresh environment from ``make_env``; {name: numbers}."""
    out = {}
    for name in WORKLOADS:
        slo = workload_slo(name)
        env = make_env()
        t0 = time.perf_counter()
        r = GraphCentricScheduler(env).schedule(WORKLOADS[name](), slo)
        wall = time.perf_counter() - t0
        check(r.e2e_runtime <= slo, f"{name}: e2e {r.e2e_runtime} within "
                                    f"the SLO {slo}")
        out[name] = dict(slo_s=slo, n_samples=r.n_samples, cost=r.cost,
                         e2e_s=r.e2e_runtime, search_wall_s=wall,
                         failed_samples=sum(s.error
                                            for s in env.trace.samples))
    return out


def measured_oracle_phase():
    """The measured oracle's unit (CUDA events), first call and steady,
    then the scheduler over it and over the analytic surface."""
    oracle = TorchMeasuredOracle()
    first = oracle.unit()
    units = sorted(oracle.unit() for _ in range(UNIT_CALLS))
    steady = units[UNIT_CALLS // 2]
    check(0.0 < first and 0.0 < units[0], "the measured units are positive")
    print(f"measured oracle ({oracle.unit_dim}^2 fp32 matmul + sum, CUDA "
          f"events): first call in this phase {first * 1e6:.3f} us, steady "
          f"median of {UNIT_CALLS} {steady * 1e6:.3f} us (min "
          f"{units[0] * 1e6:.3f}, max {units[-1] * 1e6:.3f})")
    result = dict(unit_first_us=first * 1e6, unit_steady_us=steady * 1e6,
                  unit_min_us=units[0] * 1e6, unit_max_us=units[-1] * 1e6)
    result["measured"] = schedule_paper_workflows(
        lambda: Environment(TorchMeasuredOracle()))
    result["analytic"] = schedule_paper_workflows(
        lambda: SimulatedPlatform().environment())
    for kind in ("measured", "analytic"):
        for name, r in result[kind].items():
            print(f"  AARC over the {kind} oracle, {name} (SLO "
                  f"{r['slo_s']:.0f} s): {r['n_samples']} samples "
                  f"({r['failed_samples']} failed), cost {r['cost']:.4f}, e2e "
                  f"{r['e2e_s']:.4f} s, search wall {r['search_wall_s']:.3f} s")
    for name, want in ANALYTIC_SCHEDULES.items():
        r = result["analytic"][name]
        got = (r["cost"], r["e2e_s"], r["n_samples"])
        check(got == want, f"{name}: the analytic schedule {got} equals the "
                           f"CPU's {want} bit for bit")
    return result


def sweep_template():
    """The generator's seeded layered DAG that phases 7 and 8 replay."""
    return layered_workflow(SWEEP_V, n_layers=SWEEP_LAYERS,
                            p_edge=SWEEP_P_EDGE, seed=0)


def sweep_phase():
    """The fleet engine's fast-plane sweep at fleet size on the card: bit
    for bit against the numpy sweep, both timed, its launches counted."""
    wf = sweep_template()
    order = wf.topological_order()
    col = {name: i for i, name in enumerate(wf.nodes)}
    rng = np.random.default_rng(1)
    rt = rng.uniform(0.5, 60.0, size=(SWEEP_C, SWEEP_V))
    t_all = np.cumsum(rng.exponential(0.25, size=SWEEP_I))
    fn = lambda: fast_plane_sweep(wf, order, col, t_all, rt)
    got = fn()
    want = numpy_plane_sweep(wf, order, col, t_all, rt)
    check(got.dtype == np.float64 and got.shape == (SWEEP_C, SWEEP_I),
          f"sweep shape {got.shape}")
    check(np.array_equal(got, want), "the card's fp64 sweep equals the "
                                     "numpy sweep bit for bit")
    event_ms, wall_ms, numpy_ms = [], [], []
    for _ in range(SWEEP_REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        end.synchronize()
        wall_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(start.elapsed_time(end))
        t0 = time.perf_counter()
        numpy_plane_sweep(wf, order, col, t_all, rt)
        numpy_ms.append((time.perf_counter() - t0) * 1e3)
    _, launches, _, device_ms = profile_call(
        f"fast-plane sweep, {SWEEP_C} x {SWEEP_I} x {SWEEP_V} fp64", fn, {},
        n=2)
    med = lambda xs: sorted(xs)[len(xs) // 2]
    edges = sum(len(wf.predecessors(v)) for v in wf.nodes)
    result = dict(candidates=SWEEP_C, instances=SWEEP_I, nodes=SWEEP_V,
                  edges=edges,
                  finish_state_bytes=SWEEP_C * SWEEP_I * SWEEP_V * 8,
                  bitwise_equal=True, cuda_event_ms=med(event_ms),
                  wall_ms=med(wall_ms), numpy_ms=med(numpy_ms),
                  launches_per_sweep=launches, device_busy_ms=device_ms)
    print(f"fast-plane sweep {SWEEP_C} x {SWEEP_I} x {SWEEP_V} fp64 ({edges} "
          f"edges, {result['finish_state_bytes'] / 1e9:.3f} GB of finish "
          f"state): bit-equal to numpy; card {result['cuda_event_ms']:.3f} ms "
          f"(CUDA events), {result['wall_ms']:.3f} ms (perf_counter), "
          f"numpy {result['numpy_ms']:.3f} ms; {launches} launches per "
          f"sweep")
    return result


def planner_phase():
    """The planner on the H100 stage oracle at train_4k, SLO = PLAN_SLACK
    x the all-resources step, for aarc, maff and bo."""
    shape = SHAPES["train_4k"]
    result = {}
    for arch in PLAN_ARCHS:
        cfg = get_config(arch)
        base = plan(cfg, shape, 1e9, method="aarc", max_trail=0)
        slo = PLAN_SLACK * base.step_time
        rows = dict(base_step_s=base.step_time, slo_s=slo)
        for method in ("aarc", "maff", "bo"):
            t0 = time.perf_counter()
            r = plan(cfg, shape, slo, method=method, max_trail=64)
            wall = time.perf_counter() - t0
            check(r.step_time <= slo + 1e-9, f"{arch} {method}: step "
                                             f"{r.step_time} within {slo}")
            remats = [p.remat for n, p in r.stages.items()
                      if n.startswith("layers")]
            rows[method] = dict(step_s=r.step_time, cost=r.cost,
                                n_samples=r.n_samples,
                                search_runtime_s=r.search_runtime,
                                planner_wall_s=wall, layer_remats=remats)
            print(f"  plan {arch} x train_4k, {method}: step "
                  f"{r.step_time * 1e3:.3f} ms (SLO {slo * 1e3:.3f} ms), cost "
                  f"{r.cost:.4f}, {r.n_samples} samples, modeled profiling "
                  f"{r.search_runtime:.3f} s, layer remats {remats}")
        check(rows["aarc"]["cost"] < rows["maff"]["cost"],
              f"{arch}: AARC's plan costs less than MAFF's")
        result[arch] = rows
    return result


def launcher_phase(slo: float):
    """``repro_torch.launch.train --autotune-slo`` on the card: full-size
    qwen3-0.6b, 2 steps of 8 x 512 with the remat level the planner
    picks; its checkpoints go to build/ and are deleted after."""
    ckpt = Path("build") / "autotune_launch_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = launch_train.main(LAUNCH_ARGS + [
                "--autotune-slo", str(slo), "--ckpt-dir", str(ckpt)])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    for line in out.splitlines():
        print(f"  | {line}")
    picked = re.search(r"autotune: AARC plan -> remat=(\w+)", out)
    losses = [float(x) for x in re.findall(r"step\s+\d+ loss (\S+)", out)]
    check(rc == 0 and picked is not None, "the launcher planned and ran")
    check(f"remat={picked.group(1)}, device=cuda" in out,
          "the model trains with the picked remat level on the card")
    check(len(losses) == 2 and all(np.isfinite(losses)),
          f"two finite losses, got {losses}")
    return dict(slo_s=slo, remat=picked.group(1), losses=losses,
                wall_s=wall)


def aarc_on_card():
    """Phase 7: the measured oracle, the fast-plane sweep, the planner and
    the launcher, in that order."""
    t0 = time.perf_counter()
    result = dict(oracle=measured_oracle_phase(), sweep=sweep_phase())
    print("the stage-graph planner on the H100 oracle:")
    result["plans"] = planner_phase()
    slo = result["plans"]["qwen3-0.6b"]["slo_s"]
    print(f"the training launcher, --autotune-slo {slo}:")
    result["launcher"] = launcher_phase(slo)
    result["phase_wall_s"] = time.perf_counter() - t0
    print(f"AARC on the card took {result['phase_wall_s']:.1f} s")
    return result


# --------------------------------------------------------------------------
# phase 8: the fleet engine on the card
# --------------------------------------------------------------------------

REPORT_ARRAYS = ("arrivals", "finishes", "latencies", "queue_delays",
                 "cold_delays", "costs", "failed_mask")
REPORT_VALUES = ("makespan", "cpu_utilization", "mem_utilization", "p50",
                 "p99", "total_cost", "total_queue_delay", "tenants",
                 "queue_delay_by_function", "busy_by_function",
                 "spinups_by_function", "provision_by_function",
                 "replicas_by_function", "retries_by_function",
                 "timeouts_by_function", "hedges_by_function",
                 "failures_by_function")


def reports_equal(a, b) -> bool:
    """Two fleet reports field by field: arrays with ``np.array_equal``,
    scalars, lists and dicts with ``==``, and ``saturation()``."""
    return (all(np.array_equal(getattr(a, k), getattr(b, k))
                for k in REPORT_ARRAYS)
            and all(getattr(a, k) == getattr(b, k) for k in REPORT_VALUES)
            and a.saturation() == b.saturation())


@contextlib.contextmanager
def timed_sweeps(out: list):
    """Wrap the engine's ``fast_plane_sweep`` so that each sweep inside a
    run appends (CUDA-event ms, perf_counter ms) to ``out``."""
    real = fleet_engine.fast_plane_sweep

    def sweep(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        got = real(*args, **kw)
        end.record()
        end.synchronize()
        out.append((start.elapsed_time(end),
                    (time.perf_counter() - t0) * 1e3))
        return got

    fleet_engine.fast_plane_sweep = sweep
    try:
        yield
    finally:
        fleet_engine.fast_plane_sweep = real


def busy_ledger_ms(reports) -> float:
    """Host milliseconds of the fast plane's per-cell busy ledger alone:
    the loop ``FleetEngine._run_many_vectorized`` runs, one Python float
    add per (arrival set, candidate, node, instance), on values of the
    reports' size."""
    t0 = time.perf_counter()
    for rep in reports:
        m = len(rep)
        for val in rep.busy_by_function.values():
            val = val / m
            acc = 0.0
            for _ in range(m):
                acc += val
    return (time.perf_counter() - t0) * 1e3


def fleet_replay():
    """``run_many`` at fleet size on the card's plane and the numpy plane:
    every report equal, wall times, the sweep's share, one profiled run."""
    template = sweep_template()
    rng = np.random.default_rng(2)
    cands = [{n.name: ResourceConfig(cpu=float(rng.uniform(1.0, 8.0)),
                                     mem=float(rng.uniform(1024.0, 8192.0)))
              for n in template} for _ in range(FLEET_C)]
    arrivals = [PoissonArrivals(FLEET_RATE, FLEET_I, seed=s)
                for s in range(FLEET_S)]
    plat = SimulatedPlatform()
    card = FleetEngine(plat.backend, pricing=plat.pricing)
    host = FleetEngine(plat.backend, pricing=plat.pricing,
                       plane_backend="numpy")
    check(card.batch_eligibility(template, cands)["plane"] == "fast",
          "the fleet replay routes to the fast plane")
    run = lambda eng: eng.run_many(template, cands, arrivals)
    sweeps, walls = [], {}
    with timed_sweeps(sweeps):
        for plane, eng in (("card first", card), ("card", card),
                           ("numpy", host)):
            t0 = time.perf_counter()
            got = run(eng)
            walls[plane] = (time.perf_counter() - t0) * 1e3
            if plane == "card":
                card_reports = got
    numpy_reports = got
    check(len(sweeps) == 2, f"one sweep per card run, got {len(sweeps)}")
    check(len(card_reports) == FLEET_C * FLEET_S == len(numpy_reports),
          f"{len(card_reports)} reports")
    same = sum(reports_equal(a, b)
               for a, b in zip(card_reports, numpy_reports))
    check(same == FLEET_C * FLEET_S, f"the card's plane equals the numpy "
                                     f"plane in {same} of "
                                     f"{FLEET_C * FLEET_S} reports")
    check(all(np.isfinite(r.latencies).all() and len(r) == FLEET_I
              for r in card_reports), "every instance finished")
    sweep_ms, sweep_wall_ms = sweeps[1]
    ledger_ms = busy_ledger_ms(card_reports)
    _, launches, prof_wall_ms, device_ms = profile_call(
        f"run_many {FLEET_C} x {FLEET_S} x {FLEET_I} on the card's plane",
        lambda: run(card), {}, n=1)
    check(device_ms is not None, "the profiler saw the sweep's kernels")
    result = dict(candidates=FLEET_C, arrival_sets=FLEET_S,
                  instances=FLEET_I, nodes=SWEEP_V,
                  edges=sum(len(template.predecessors(v))
                            for v in template.nodes),
                  reports_equal=same, card_first_ms=walls["card first"],
                  card_ms=walls["card"], numpy_ms=walls["numpy"],
                  sweep_cuda_event_ms=sweep_ms,
                  sweep_wall_ms=sweep_wall_ms,
                  sweep_share=sweep_wall_ms / walls["card"],
                  busy_ledger_ms=ledger_ms,
                  profiled_wall_ms=prof_wall_ms, device_busy_ms=device_ms,
                  idle_share=1 - device_ms / prof_wall_ms,
                  launches=launches)
    print(f"run_many {FLEET_C} x {FLEET_S} x {FLEET_I} over a "
          f"{SWEEP_V}-node layered DAG ({result['edges']} edges): "
          f"{same} reports equal to the numpy plane's; card plane "
          f"{walls['card']:.1f} ms (first {walls['card first']:.1f}), numpy "
          f"plane {walls['numpy']:.1f} ms; sweep {sweep_ms:.3f} ms by CUDA "
          f"events, {sweep_wall_ms:.3f} ms by perf_counter "
          f"({result['sweep_share']:.4f} of the run); the busy ledger's "
          f"loop alone {ledger_ms:.1f} ms; profiled run: "
          f"{launches} launches, idle share {result['idle_share']:.4f}")
    return result


def fleet_numbers(rep, slo):
    return dict(p50_s=rep.p50, p99_s=rep.p99,
                slo_attainment=rep.slo_attainment(slo),
                queue_delay_s=rep.total_queue_delay, cost=rep.total_cost,
                cpu_utilization=rep.cpu_utilization,
                failed=int(rep.failed_mask.sum()))


def chatbot_fleets():
    """``run_fleet`` of 100 Chatbot instances with AARC's configuration,
    over the analytic surface and over the measured oracle."""
    slo = workload_slo("chatbot")
    found = GraphCentricScheduler(
        SimulatedPlatform().environment()).schedule(WORKLOADS["chatbot"](),
                                                    slo)
    arrivals = PoissonArrivals(**CHATBOT_FLEET)
    result = {}
    for name, env in (("analytic", SimulatedPlatform().environment()),
                      ("measured", Environment(TorchMeasuredOracle()))):
        wf = WORKLOADS["chatbot"]()
        wf.apply_configs(found.configs)
        t0 = time.perf_counter()
        rep = run_fleet(env, wf, arrivals, cluster=CHATBOT_CLUSTER,
                        cold_start=CHATBOT_COLD)
        numbers = fleet_numbers(rep, slo)
        numbers["wall_ms"] = (time.perf_counter() - t0) * 1e3
        check(len(rep) == CHATBOT_FLEET["n"]
              and np.isfinite(rep.latencies).all()
              and numbers["failed"] == 0, f"{name}: every instance finished")
        result[name] = numbers
        print(f"  run_fleet chatbot x {len(rep)} over the {name} surface: "
              f"p50 {rep.p50:.4f} s, p99 {rep.p99:.4f} s, SLO attainment "
              f"{numbers['slo_attainment']:.3f}, queue "
              f"{rep.total_queue_delay:.3f} s, cost {rep.total_cost:.4f}, "
              f"wall {numbers['wall_ms']:.1f} ms")
    got = tuple(result["analytic"][k] for k in (
        "p50_s", "p99_s", "slo_attainment", "queue_delay_s", "cost"))
    check(got == CHATBOT_ANALYTIC, f"the analytic fleet {got} equals the "
                                   f"CPU's {CHATBOT_ANALYTIC}")
    return result, found.configs


def stochastic_and_faults(configs):
    """The paired stochastic plane, and the faulty fleets repeating from
    one seed with the CPU's counts."""
    template = sweep_template()
    cfg = {n.name: ResourceConfig(cpu=4.0, mem=4096.0) for n in template}
    arrivals = [PoissonArrivals(FLEET_RATE, NOISY_I, seed=s)
                for s in range(NOISY_S)]
    plat = SimulatedPlatform()
    noisy = FleetEngine(StochasticBackend(noise_sigma=NOISE_SIGMA, seed=0),
                        pricing=plat.pricing)
    reps = noisy.run_many(template, [cfg, cfg], arrivals)
    check(all(reports_equal(reps[i], reps[NOISY_S + i])
              for i in range(NOISY_S)),
          "one config in two candidate slots scores identically")
    exact = FleetEngine(plat.backend, pricing=plat.pricing).run_many(
        template, [cfg], arrivals)
    check(not np.array_equal(reps[0].finishes, exact[0].finishes),
          "the noise is applied")
    result = dict(paired_slots_equal=True,
                  noisy_p99_s=reps[0].p99, exact_p99_s=exact[0].p99)
    slo = workload_slo("chatbot")
    tuned = WORKLOADS["chatbot"]()
    tuned.apply_configs(configs)
    runtimes, _ = plat.backend.invoke_batch(list(tuned.nodes.values()))
    policies = {
        "no-recovery": None,
        "retries": ResilienceModel(default=ResiliencePolicy(
            max_retries=2, backoff_s=0.1)),
        "+timeouts": ResilienceModel(policies={
            name: ResiliencePolicy(max_retries=2, backoff_s=0.1,
                                   timeout_s=3.0 * max(float(rt), 1.0))
            for name, rt in zip(tuned.nodes, runtimes)})}
    for name, policy in policies.items():
        reps = [run_fleet(SimulatedPlatform().environment(), tuned.copy(),
                          PoissonArrivals(**CHATBOT_FLEET),
                          cluster=CHATBOT_CLUSTER, cold_start=CHATBOT_COLD,
                          faults=FLEET_FAULTS, resilience=policy)
                for _ in range(2)]
        counts = (int(reps[0].failed_mask.sum()), reps[0].total_retries,
                  reps[0].total_timeouts)
        check(reports_equal(*reps), f"{name}: the faulty fleet repeats")
        check(counts == FAULTY_COUNTS[name], f"{name}: counts {counts} equal "
                                             f"the CPU's "
                                             f"{FAULTY_COUNTS[name]}")
        result[name] = dict(goodput=reps[0].goodput(slo), failed=counts[0],
                            retries=counts[1], timeouts=counts[2],
                            cost=reps[0].total_cost)
        print(f"  faulty chatbot fleet, {name}: goodput "
              f"{result[name]['goodput']:.3f}, failed {counts[0]}, retries "
              f"{counts[1]}, timeouts {counts[2]}, twice the same")
    return result


def fleet_on_card():
    """Phase 8: the fleet replay, the Chatbot fleets, the stochastic
    plane and the faulty fleets, in that order."""
    t0 = time.perf_counter()
    result = dict(replay=fleet_replay())
    print("run_fleet over the analytic surface and the measured oracle:")
    result["chatbot"], configs = chatbot_fleets()
    print("the stochastic plane and the faulty fleets:")
    result["host_planes"] = stochastic_and_faults(configs)
    result["phase_wall_s"] = time.perf_counter() - t0
    print(f"the fleet engine on the card took {result['phase_wall_s']:.1f} s")
    return result


# --------------------------------------------------------------------------
# phase 9: distribution on the card
# --------------------------------------------------------------------------

def whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def dist_train_step(mesh, model, state0, batch, train):
    """build_train_step's sharded step of full-size qwen3-0.6b on the
    one-rank mesh: DIST_STEPS steps from phase 6's state on phase 6's
    batch against phase 6's losses and DIST_STEPS plain steps, then one
    profiled step; each loop's step time is the mean of its steps after
    the first (CUDA events)."""
    bundle = build_train_step(model.cfg, Shape("train", TRAIN_SEQ,
                                               TRAIN_BATCH, "train"),
                              mesh, rules=FSDP_RULES, opt_cfg=TRAIN_OPT)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, dbatch = bundle.place(state0, batch)
    check(isinstance(state["params"]["embed"]["tok"], DTensor) and
          isinstance(dbatch["tokens"], DTensor), "the state and the batch "
                                                 "are DTensors on the mesh")
    events = [torch.cuda.Event(enable_timing=True)
              for _ in range(DIST_STEPS + 1)]
    metrics = []
    events[0].record()
    for i in range(DIST_STEPS):
        state, m = bundle.step(state, dbatch)
        metrics.append(m)
        events[i + 1].record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    losses = [float(whole(m["loss"])) for m in metrics]
    want = train["losses"][:DIST_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    check(rel <= DIST_LOSS_RTOL, f"the sharded losses {losses} within rel "
                                 f"{DIST_LOSS_RTOL} of phase 6's {want}")
    plain_state, plain_losses, _, plain_ms = train_steps(
        make_train_step(model, TRAIN_OPT), state0, batch, DIST_STEPS)
    param_err = 0.0
    bit_equal = losses == plain_losses
    for a, b in zip(tree_leaves(state["params"]),
                    tree_leaves(plain_state["params"])):
        a = whole(a)
        param_err = max(param_err, max_err(a, b, what="sharded params "
                                           "after 5 steps", **DIST_PARAM_TOL))
        bit_equal = bit_equal and torch.equal(a, b)
    del plain_state
    step_ms = sum(ms[1:]) / len(ms[1:])
    plain_step_ms = sum(plain_ms[1:]) / len(plain_ms[1:])
    print(f"qwen3-0.6b sharded train step, FSDP rules on a (data=1, "
          f"model=1) mesh, bf16, remat dots, {TRAIN_BATCH} x {TRAIN_SEQ}: "
          f"step {step_ms:.3f} ms (CUDA events, mean of steps 2-"
          f"{DIST_STEPS}; first {ms[0]:.3f}) against the plain step's "
          f"{plain_step_ms:.3f} ms in this phase and {train['step_ms']:.3f} "
          f"ms in phase 6; peak memory {peak / 2**30:.3f} GiB (phase 6 "
          f"{train['peak_bytes'] / 2**30:.3f}); losses {losses}, max rel "
          f"diff from phase 6 {rel:.3g}; params max abs err {param_err:.3g}; "
          f"losses and params bit-equal to the plain steps: {bit_equal}")
    rows, launches, wall_ms, device_ms = profile_call(
        "sharded train step", lambda: bundle.step(state, dbatch), {}, n=1)
    check(device_ms is not None, "the profiler saw the sharded step's "
                                 "kernels")
    print(f"  plain step (phase 6): wall {train['profiled_wall_ms']:.3f} ms, "
          f"device busy {train['device_busy_ms']:.3f} ms (idle share "
          f"{train['idle_share']:.3f}), {train['launches_per_step']} "
          f"kernel launches")
    return dict(arch="qwen3-0.6b", mesh="data=1 x model=1", rules="fsdp",
                steps=DIST_STEPS, losses=losses, max_rel_loss_diff=rel,
                param_max_abs_err=param_err, bit_equal_to_plain=bit_equal,
                step_ms=step_ms, first_step_ms=ms[0],
                plain_step_ms=plain_step_ms, phase6_step_ms=train["step_ms"],
                peak_bytes=peak, phase6_peak_bytes=train["peak_bytes"],
                profiled_wall_ms=wall_ms, device_busy_ms=device_ms,
                idle_share=1 - device_ms / wall_ms,
                launches_per_step=launches,
                phase6_launches_per_step=train["launches_per_step"],
                phase6_idle_share=train["idle_share"],
                top_kernels=[[r.key[:80], r.self_device_time_total / 1e3]
                             for r in rows[:5]])


def dist_int8_sync(model, state0, batch):
    """cross_pod_grad_sync over a one-rank ``pod`` group on the gradients
    of one plain qwen3-0.6b step: on one rank the sum over pods is the
    rank's own, so the synced gradients must equal quantize-dequantize
    bit for bit and the error what that dropped. Timed by CUDA events
    against its bound: the gradients read once (bf16), the synced
    gradients (bf16) and the fp32 error written once, and 11 fp32
    operations per element (abs, max, two divisions, round, two clamps,
    two products, the sum over pods, a difference)."""
    seen = []
    make_train_step(model, TRAIN_OPT,
                    grad_transform=lambda g: seen.append(g) or g)(state0,
                                                                  batch)
    grads = seen[0]
    group = init_device_mesh("cuda", (1,),
                             mesh_dim_names=("pod",)).get_group("pod")
    synced, err = cross_pod_grad_sync(grads, None, group)
    for g, s, e in zip(tree_leaves(grads), tree_leaves(synced),
                       tree_leaves(err)):
        dq = dequantize_int8(*quantize_int8(g))
        check(s.dtype == g.dtype and torch.equal(s, dq.to(g.dtype)),
              "synced gradients equal quantize-dequantize bit for bit")
        check(torch.equal(e, g.float() - dq), "the error is what the "
                                              "quantization dropped")
    del synced, err
    n = sum(g.numel() for g in tree_leaves(grads))
    nbytes = sum(g.numel() * (2 * g.element_size() + 4)
                 for g in tree_leaves(grads))
    ms = time_ms(lambda: cross_pod_grad_sync(grads, None, group),
                 reps=SYNC_REPS)
    bound_ms, bound_by = bound(11 * n, nbytes, torch.float32)
    print(f"int8 gradient sync over a one-rank pod group, {n:,} gradients "
          f"({len(tree_leaves(grads))} leaves, bf16): {ms:.3f} ms per call "
          f"(CUDA events, mean of {SYNC_REPS}), bound {bound_ms:.3f} ms "
          f"({bound_by}: {nbytes / 1e9:.3f} GB); synced = "
          f"quantize-dequantize and error = what it dropped, bit for bit")
    return dict(params=n, leaves=len(tree_leaves(grads)), ms=ms,
                bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                bit_equal=True)


def dist_checkpoint(mesh):
    """The 2-layer full-width qwen3-0.6b state (phase 6's resilient-loop
    size) placed on the mesh by the FSDP rules, saved to build/ as a
    sharded checkpoint and restored onto the mesh with ``shardings=``:
    every leaf a DTensor placed as before and equal bit for bit."""
    cfg = get_config("qwen3-0.6b", n_layers=2, remat="dots")
    params, axes = Model(cfg).build(seed=0)
    state = adamw_init(params)
    shardings = tree_shardings(mesh, FSDP_RULES, train_state_axes(axes),
                               state)
    dstate = distribute_tree(state, shardings)
    root = Path(__file__).resolve().parent / "build" / "dist_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        path = save_checkpoint(str(root), 1, dstate)
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
        t0 = time.perf_counter()
        back, step, _ = restore_checkpoint(str(root), like=dstate,
                                           shardings=shardings)
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(step == 1, "the checkpoint's step")
    for a, b in zip(tree_leaves(dstate), tree_leaves(back)):
        check(isinstance(b, DTensor) and b.placements == a.placements,
              "a restored leaf is placed as it was saved")
        check(torch.equal(b.full_tensor(), a.full_tensor()),
              "a restored leaf equals the saved one bit for bit")
    n = sum(t.numel() for t in tree_leaves(params))
    print(f"sharded checkpoint of qwen3-0.6b at full width, 2 layers "
          f"({n / 1e6:.1f}M params, {nbytes / 1e9:.3f} GB of files): saved "
          f"in {save_s:.2f} s, restored onto the mesh in {restore_s:.2f} s, "
          f"every leaf bit-equal")
    return dict(params=n, bytes=nbytes, save_s=save_s, restore_s=restore_s,
                bit_equal=True)


def distribution_on_card(mesh, model, state0, batch, train):
    """Phase 9 on the one-rank mesh."""
    t0 = time.perf_counter()
    result = dict(train_step=dist_train_step(mesh, model, state0, batch,
                                             train))
    result["int8_sync"] = dist_int8_sync(model, state0, batch)
    result["checkpoint"] = dist_checkpoint(mesh)
    result["phase_wall_s"] = time.perf_counter() - t0
    print(f"distribution on the card took {result['phase_wall_s']:.1f} s")
    return result


# --------------------------------------------------------------------------
# phase 10: distribution on the card, serving side
# --------------------------------------------------------------------------

def kernel_counts() -> tuple:
    return (flash_ops.launches, ssd_ops.intra_launches,
            ssd_ops.inter_launches)


def zero_kernel_counts() -> None:
    flash_ops.launches = rms_ops.launches = 0
    ssd_ops.intra_launches = ssd_ops.inter_launches = 0


def timed_call(fn):
    """(fn's result, its time in ms by CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def serve_greedy(prefill, decode):
    """``prefill()`` then SERVE_DIST_STEPS greedy ``decode(tokens)`` calls:
    (every call's logits as whole tensors, the greedy tokens, the final
    cache, the prefill's ms, the decode steps' ms)."""
    (logits, cache), prefill_ms = timed_call(prefill)
    outs, tokens, step_ms = [whole(logits)], [], []
    for _ in range(SERVE_DIST_STEPS):
        tokens.append(outs[-1][:, -1].argmax(-1)[:, None])
        (logits, cache), ms = timed_call(lambda: decode(cache, tokens[-1]))
        outs.append(whole(logits))
        step_ms.append(ms)
    return outs, torch.cat(tokens, 1), cache, prefill_ms, step_ms


def dist_serve_model(mesh, arch):
    """The sharded prefill and serve steps of full-size ``arch`` (bf16,
    kernel routes on) on the one-rank mesh against the unsharded calls
    on the card, on one seeded 4 x 512 prompt batch."""
    cfg = get_config(arch, attn_impl="kernel",
                     use_ssm_kernel=arch == "zamba2-1.2b")
    model = Model(cfg)
    params = model.init(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(10)
    batch = {"tokens": torch.randint(0, cfg.vocab, (SERVE_DIST_BATCH,
                                                    SERVE_DIST_SEQ),
                                     generator=gen, device="cuda")}
    max_len = SERVE_DIST_SEQ + SERVE_DIST_STEPS + 8
    prefill_plain = lambda: model.prefill(params, batch, max_len=max_len)
    prefill_plain()                                          # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want, want_tokens, want_cache, plain_prefill_ms, plain_steps = \
        serve_greedy(prefill_plain,
                     lambda c, t: model.decode_step(params, c, t))
    plain_peak = torch.cuda.max_memory_allocated()

    shape = lambda kind: Shape(kind, max_len, SERVE_DIST_BATCH, kind)
    pre = build_prefill_step(cfg, shape("prefill"), mesh)
    serve = build_serve_step(cfg, shape("decode"), mesh)
    p, b = pre.place(params, batch)
    pre.step(p, b)                                           # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    place_tokens = lambda t: distribute_tree(t, serve.in_shardings[2])

    def sharded_prefill():
        # the serve step takes its cache placed by the cache's rules
        logits, cache = pre.step(p, b)
        return logits, distribute_tree(cache, serve.in_shardings[1])

    zero_kernel_counts()
    got, got_tokens, got_cache, prefill_ms, step_ms = serve_greedy(
        sharded_prefill, lambda c, t: serve.step(p, c, place_tokens(t)))
    launches = kernel_counts()
    peak = torch.cuda.max_memory_allocated()
    check(launches == SERVE_DIST_LAUNCHES[arch],
          f"{arch}: kernel launches (flash, SSD intra, SSD inter) of one "
          f"sharded prefill and {SERVE_DIST_STEPS} serve steps "
          f"{launches}, want {SERVE_DIST_LAUNCHES[arch]}")
    check(torch.equal(got_tokens, want_tokens),
          f"{arch}: the sharded steps' greedy tokens equal the unsharded "
          f"calls'")
    errs = [max_err(a, b, what=f"{arch} sharded logits", **SERVE_TOL)
            for a, b in zip(got, want)]
    cache_pairs = list(zip(tree_leaves(got_cache), tree_leaves(want_cache)))
    errs += [max_err(whole(a), b, what=f"{arch} sharded cache",
                     **SERVE_TOL) for a, b in cache_pairs]
    bit_equal = (all(torch.equal(a, b) for a, b in zip(got, want)) and
                 all(torch.equal(whole(a), b) for a, b in cache_pairs))
    step_mean = sum(step_ms[1:]) / len(step_ms[1:])
    plain_step_mean = sum(plain_steps[1:]) / len(plain_steps[1:])
    print(f"{arch} bf16 kernel routes, {SERVE_DIST_BATCH} x "
          f"{SERVE_DIST_SEQ} prompt, {SERVE_DIST_STEPS} greedy steps: "
          f"sharded prefill {prefill_ms:.3f} ms against the unsharded "
          f"{plain_prefill_ms:.3f} ms; decode step {step_mean:.3f} ms "
          f"against {plain_step_mean:.3f} ms (CUDA events, mean of steps "
          f"2-{SERVE_DIST_STEPS}); peak memory {peak / 2**30:.3f} GiB "
          f"against {plain_peak / 2**30:.3f}; launches (flash, SSD intra, "
          f"SSD inter) {launches}; logits and caches max abs err "
          f"{max(errs):.3g}, bit-equal to the unsharded calls: {bit_equal}; "
          f"greedy tokens equal")
    kernels = {"flash attention": "flash_fwd", "ssd_intra": "ssd_intra",
               "ssd_inter": "ssd_inter"}
    profiles = {}
    dcache, dtokens = got_cache, place_tokens(got_tokens[:, -1:])
    for name, fn in (
            ("sharded prefill", lambda: pre.step(p, b)),
            ("unsharded prefill", prefill_plain),
            ("sharded decode step", lambda: serve.step(p, dcache, dtokens)),
            ("unsharded decode step", lambda: model.decode_step(
                params, want_cache, want_tokens[:, -1:]))):
        _, n, wall_ms, device_ms = profile_call(name, fn, kernels, n=1)
        check(device_ms is not None, f"the profiler saw {arch}'s {name}")
        profiles[name] = dict(wall_ms=wall_ms, device_busy_ms=device_ms,
                              idle_share=1 - device_ms / wall_ms,
                              launches=n)
    return dict(arch=arch, mesh="data=1 x model=1", batch=SERVE_DIST_BATCH,
                prompt=SERVE_DIST_SEQ, steps=SERVE_DIST_STEPS,
                prefill_ms=prefill_ms, plain_prefill_ms=plain_prefill_ms,
                decode_step_ms=step_mean,
                plain_decode_step_ms=plain_step_mean,
                peak_bytes=peak, plain_peak_bytes=plain_peak,
                kernel_launches=dict(zip(("flash_attention", "ssd_intra",
                                          "ssd_inter"), launches)),
                max_abs_err=max(errs), bit_equal_to_unsharded=bit_equal,
                greedy_tokens_equal=True, profile=profiles)


def dryrun_cells():
    """``run_cell`` of qwen3-0.6b at DRYRUN_SHAPES on the fake (16, 16)
    mesh, in a subprocess (the fake process group must not meet this
    process's NCCL group); its per-rank roofline terms."""
    code = ("import json, sys\n"
            "from repro_torch.launch.dryrun import run_cell\n"
            f"for shape in {DRYRUN_SHAPES!r}:\n"
            "    r = run_cell('qwen3-0.6b', shape, False, None)\n"
            "    print('DRYRUN ' + json.dumps(r), flush=True)\n")
    src = str(Path(__file__).resolve().parent / "src")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=DRYRUN_TIMEOUT_S,
                         env=dict(os.environ, PYTHONPATH=src))
    check(res.returncode == 0, f"the dry run exited {res.returncode}: "
                               f"{res.stderr[-2000:]}")
    cells = [json.loads(line[len("DRYRUN "):])
             for line in res.stdout.splitlines()
             if line.startswith("DRYRUN ")]
    check(len(cells) == len(DRYRUN_SHAPES), "one result per dry-run cell")
    keys = ("flops_per_chip", "bytes_per_chip", "collective_by_kind",
            "collective_counts", "compute_s", "memory_s", "collective_s",
            "dominant", "useful_ratio", "compile_s", "memory_analysis",
            "flops_source", "collective_constants")
    out = {}
    for r in cells:
        print(f"dry run qwen3-0.6b x {r['shape']} on {r['mesh']} (fake "
              f"process group, meta tensors, {r['compile_s']:.1f} s): "
              f"flops/rank {r['flops_per_chip']:.4g}, bytes/rank "
              f"{r['bytes_per_chip']:.4g}, collectives "
              f"{r['collective_by_kind']}; terms compute "
              f"{r['compute_s']:.5f} s, memory {r['memory_s']:.5f} s, "
              f"collective {r['collective_s']:.5f} s ({r['dominant']}); "
              f"temp {r['memory_analysis']['temp_size_in_bytes']:,} B")
        out[r["shape"]] = {k: r[k] for k in keys}
    return out


def distribution_serving(mesh):
    """Phase 10: both models, then the dry run."""
    t0 = time.perf_counter()
    result = {}
    for arch in SERVE_DIST_LAUNCHES:
        result[arch] = dist_serve_model(mesh, arch)
        torch.cuda.empty_cache()
    result["dryrun"] = dryrun_cells()
    result["phase_wall_s"] = time.perf_counter() - t0
    print(f"distribution, serving side, took {result['phase_wall_s']:.1f} s")
    return result


# --------------------------------------------------------------------------
# phase 11: campaigns on the card
# --------------------------------------------------------------------------

def campaign_spec(cluster=None) -> CampaignSpec:
    replay = dict(CAMPAIGN_REPLAY)
    if cluster is not None:
        replay["cluster"] = cluster
    return CampaignSpec(portfolio=CAMPAIGN_PORTFOLIO,
                        replay=ReplaySpec(**replay),
                        searchers=CAMPAIGN_SEARCHERS,
                        searcher_kwargs=CAMPAIGN_KWARGS, seed=0)


def search_view(res) -> tuple:
    """A search result as plain values: every field but the wall clock
    and the continuation, and its trace sample by sample."""
    return (res.searcher, res.workflow, res.slo, res.e2e_runtime, res.cost,
            res.feasible, res.n_samples, res.search_time, res.search_cost,
            res.note, {n: (c.cpu, c.mem) for n, c in res.configs.items()},
            None if res.best is None else dataclasses.astuple(res.best),
            [dataclasses.astuple(x) for x in res.trace.samples])


@contextlib.contextmanager
def captured_grids(module, out: list):
    """Wrap ``module``'s ``run_grid_search`` so that each ``GridReport``
    it returns is appended to ``out``."""
    real = module.run_grid_search

    def grid(*args, **kw):
        report = real(*args, **kw)
        out.append(report)
        return report

    module.run_grid_search = grid
    try:
        yield
    finally:
        module.run_grid_search = real


def timed_campaign(spec, plane: str):
    """``Campaign.run`` on the card: (the campaign, its report, its
    numbers). The replays are timed one by one (perf_counter), and each
    sweep inside them (CUDA events and perf_counter)."""
    campaign = Campaign(spec)
    replay_ms = []
    real_replay = campaign.replay

    def replay(*args, **kw):
        t0 = time.perf_counter()
        out = real_replay(*args, **kw)
        replay_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    campaign.replay = replay
    sweeps, grids = [], []
    with timed_sweeps(sweeps), captured_grids(campaign_mod, grids):
        t0 = time.perf_counter()
        report = campaign.run(search_plane=plane)
        wall_ms = (time.perf_counter() - t0) * 1e3
    check(len(report.results) == CAMPAIGN_CELLS,
          f"{plane}: {len(report.results)} cells")
    numbers = dict(wall_ms=wall_ms, search_ms=wall_ms - sum(replay_ms),
                   replays=len(replay_ms), replay_ms=sum(replay_ms),
                   sweeps=len(sweeps),
                   sweep_cuda_event_ms=sum(e for e, _ in sweeps),
                   sweep_wall_ms=sum(w for _, w in sweeps))
    numbers["sweep_share"] = numbers["sweep_wall_ms"] / numbers["replay_ms"]
    if grids:
        (grid,) = grids
        numbers.update(grid_wall_ms=grid.wall_time_s * 1e3,
                       rounds=grid.rounds,
                       fused_evaluations=grid.fused_evaluations,
                       serialized_cells=grid.serialized_cells)
    return campaign, report, numbers


def campaign_summary(report) -> dict:
    keys = ("total_search_time_s", "search_time_reduction_vs_worst",
            "total_search_cost", "total_samples", "feasible_rate",
            "mean_slo_attainment", "mean_replay_cost")
    return {name: {k: agg[k] for k in keys}
            for name, agg in report.summary().items()}


def print_campaign(tag, numbers, summary):
    print(f"  {tag}: wall {numbers['wall_ms']:.1f} ms (search "
          f"{numbers['search_ms']:.1f} ms, {numbers['replays']} replays "
          f"{numbers['replay_ms']:.1f} ms; {numbers['sweeps']} card sweeps "
          f"{numbers['sweep_cuda_event_ms']:.3f} ms by CUDA events, "
          f"{numbers['sweep_wall_ms']:.3f} ms by perf_counter, "
          f"{numbers['sweep_share']:.4f} of the replays)")
    if "rounds" in numbers:
        print(f"    grid: {numbers['grid_wall_ms']:.1f} ms, "
              f"{numbers['rounds']} rounds, {numbers['fused_evaluations']} "
              f"fused evaluations, {numbers['serialized_cells']} serialized "
              f"cells")
    for name, agg in summary.items():
        print(f"    {name}: search time {agg['total_search_time_s']:.1f} s "
              f"({agg['search_time_reduction_vs_worst']:.4f} under the "
              f"slowest), search cost {agg['total_search_cost']:.1f}, "
              f"{agg['total_samples']} samples, feasible "
              f"{agg['feasible_rate']:.3f}, attainment "
              f"{agg['mean_slo_attainment']:.3f}, replay cost "
              f"{agg['mean_replay_cost']:.2f}")


def uniform_campaigns():
    """The 72-cell campaign on both search planes, its replays against
    the CPU's, then the same spec on the finite cluster."""
    spec = campaign_spec()
    result, reports = {}, {}
    for plane in ("grid", "sequential"):
        campaign, reports[plane], numbers = timed_campaign(spec, plane)
        check(numbers["sweeps"] == numbers["replays"] == CAMPAIGN_CELLS,
              f"{plane}: one card sweep per replay, got {numbers['sweeps']} "
              f"sweeps for {numbers['replays']} replays")
        check(campaign._engine.device is None
              and campaign._engine.plane_backend == "torch",
              f"{plane}: the replay engine sweeps on the card")
        result[plane] = numbers
    check(result["grid"]["serialized_cells"] == 0
          and result["grid"]["fused_evaluations"] > 0,
          "every cell joined the lockstep plane, and rounds were fused")
    grid, seq = reports["grid"], reports["sequential"]
    same = sum(search_view(a.search) == search_view(b.search)
               and a.replay == b.replay and a.task.index == b.task.index
               for a, b in zip(grid.results, seq.results))
    check(same == CAMPAIGN_CELLS, f"the grid plane equals the sequential "
                                  f"plane in {same} of {CAMPAIGN_CELLS} "
                                  f"cells")
    # the card's replays against the same replays swept on the CPU
    cpu = Campaign(spec, device="cpu")
    seeds = cpu.arrival_seeds(len(cpu.tasks()))
    cpu_replay_ms, cpu_same = 0.0, 0
    for r in grid.results:
        t0 = time.perf_counter()
        m = cpu.replay(r.task, r.search, seeds[r.task.index])
        cpu_replay_ms += (time.perf_counter() - t0) * 1e3
        cpu_same += m == r.replay
    check(cpu_same == CAMPAIGN_CELLS, f"the card's replays equal the CPU's "
                                      f"in {cpu_same} of {CAMPAIGN_CELLS}")
    for r in grid.results:
        m = r.replay
        check(all(np.isfinite([m.p50_s, m.p99_s, m.total_cost]))
              and 0.0 <= m.slo_attainment <= 1.0 and m.p99_s >= m.p50_s
              and m.total_cost > 0.0, f"cell {r.task.index}: replay {m}")
        # infinite cluster, no cold start: a feasible search's latency is
        # every instance's latency
        check(not r.search.feasible or m.slo_attainment == 1.0,
              f"cell {r.task.index}: a feasible search attains its SLO")
    summary = campaign_summary(grid)
    check(summary["aarc"]["total_search_time_s"]
          < summary["maff"]["total_search_time_s"],
          "AARC's modeled search time beats MAFF's")
    result.update(cells=CAMPAIGN_CELLS, planes_equal=same,
                  card_equals_cpu=cpu_same, cpu_replay_ms=cpu_replay_ms,
                  summary=summary,
                  totals=grid.totals())
    print_campaign("grid plane", result["grid"], summary)
    print_campaign("sequential plane", result["sequential"],
                   campaign_summary(seq))
    print(f"  {same} of {CAMPAIGN_CELLS} cells equal between the planes "
          f"(traces, results, replays); {cpu_same} card replays equal to "
          f"the CPU's; the replays {result['grid']['replay_ms']:.1f} ms "
          f"swept on the card, {cpu_replay_ms:.1f} ms on the CPU")

    finite_spec = campaign_spec(CAMPAIGN_CLUSTER)
    campaign, finite, numbers = timed_campaign(finite_spec, "grid")
    first = finite.results[0]
    plane = campaign._engine.batch_eligibility(
        first.task.template, [first.search.configs])["plane"]
    check(numbers["sweeps"] == 0, f"the finite cluster's replays swept "
                                  f"{numbers['sweeps']} times on the card")
    check(all(search_view(a.search) == search_view(b.search)
              for a, b in zip(finite.results, grid.results)),
          "the finite cluster's searches equal the uniform campaign's")
    result["finite"] = dict(numbers, plane=plane,
                            summary=campaign_summary(finite),
                            totals=finite.totals())
    print_campaign(f"finite cluster ({CAMPAIGN_CLUSTER.total_cpu:.0f} vCPU "
                   f"/ {CAMPAIGN_CLUSTER.total_mem_mb:.0f} MB; replays on "
                   f"the {plane} plane, on the host)", numbers,
                   result["finite"]["summary"])
    return result


def adaptive_campaign():
    """``run_adaptive`` on the same portfolio, ADAPTIVE_GRANTS grants per
    round through the grid runner, its payload against the CPU's."""
    spec = AdaptiveSpec(portfolio=CAMPAIGN_PORTFOLIO,
                        replay=ReplaySpec(**CAMPAIGN_REPLAY),
                        searchers=CAMPAIGN_SEARCHERS, seed=0,
                        grants_per_round=ADAPTIVE_GRANTS,
                        explore_attained=True)
    sweeps, grids = [], []
    with timed_sweeps(sweeps), captured_grids(adaptive_mod, grids):
        t0 = time.perf_counter()
        report = run_adaptive(spec)
        wall_ms = (time.perf_counter() - t0) * 1e3
    payload = report.to_payload()
    t0 = time.perf_counter()
    cpu = run_adaptive(spec, device="cpu").to_payload()
    cpu_wall_ms = (time.perf_counter() - t0) * 1e3
    check(payload == cpu, "the adaptive payload equals the CPU's")
    b = payload["budget"]
    check(b["total"] == b["spent"] + b["remaining"]
          and b["spent"] == sum(c.spent for c in report.cells)
          and b["spent"] <= b["total"], f"the budget ledger balances: {b}")
    # a round of one grant resumes that cell alone, without the grid
    check(0 < len(grids) <= payload["rounds"]
          and all(g.serialized_cells == 0 for g in grids),
          f"{payload['rounds']} rounds, {len(grids)} through the grid")
    check(len(sweeps) >= CAMPAIGN_CELLS, f"{len(sweeps)} card sweeps: every "
                                         f"seeded cell settles on the card")
    grants = sum(c.grants for c in report.cells)
    result = dict(rounds=payload["rounds"], grants=grants,
                  budget=b, attainment=payload["portfolio_attainment"],
                  mean_replay_cost=payload["mean_replay_cost"],
                  wall_ms=wall_ms, cpu_wall_ms=cpu_wall_ms,
                  sweeps=len(sweeps),
                  sweep_cuda_event_ms=sum(e for e, _ in sweeps),
                  sweep_wall_ms=sum(w for _, w in sweeps),
                  grid_wall_ms=sum(g.wall_time_s for g in grids) * 1e3,
                  fused_evaluations=sum(g.fused_evaluations for g in grids),
                  payload_equals_cpu=True)
    print(f"  adaptive ({ADAPTIVE_GRANTS} grants per round, cost-polish): "
          f"{result['rounds']} rounds, {grants} grants, spent {b['spent']} "
          f"of {b['total']}; attainment {result['attainment']:.3f}, mean "
          f"replay cost {result['mean_replay_cost']:.2f}; wall "
          f"{wall_ms:.1f} ms on the card ({cpu_wall_ms:.1f} ms swept on the "
          f"CPU), {len(sweeps)} card sweeps {result['sweep_wall_ms']:.3f} ms "
          f"by perf_counter, grids {result['grid_wall_ms']:.1f} ms with "
          f"{result['fused_evaluations']} fused evaluations; payload equal "
          f"to the CPU's")
    return result


def campaigns_on_card():
    """Phase 11: the uniform campaigns, then the adaptive one."""
    t0 = time.perf_counter()
    result = uniform_campaigns()
    result["adaptive"] = adaptive_campaign()
    result["phase_wall_s"] = time.perf_counter() - t0
    print(f"campaigns on the card took {result['phase_wall_s']:.1f} s")
    return result


# --------------------------------------------------------------------------
# phase 12: the online control plane on the card
# --------------------------------------------------------------------------

def online_on_both(tag: str, spec, *, card: bool):
    """``run_online`` on the card, its sweeps timed, then on the CPU:
    (the card's report, its numbers). The payloads must be equal; a run
    whose replays take the contention-free plane (``card``) must sweep
    on the card more than once, any other run never."""
    sweeps = []
    with timed_sweeps(sweeps):
        t0 = time.perf_counter()
        report = run_online(spec)
        wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cpu = run_online(spec, device="cpu")
    cpu_wall_ms = (time.perf_counter() - t0) * 1e3
    check(report.to_payload() == cpu.to_payload(),
          f"{tag}: the card's payload equals the CPU's")
    if card:
        check(len(sweeps) > 1, f"{tag}: {len(sweeps)} card sweeps")
    else:
        check(not sweeps, f"{tag}: the host's planes swept {len(sweeps)} "
                          f"times on the card")
    numbers = dict(wall_ms=wall_ms, cpu_wall_ms=cpu_wall_ms,
                   sweeps=len(sweeps),
                   sweep_cuda_event_ms=sum(e for e, _ in sweeps),
                   sweep_wall_ms=sum(w for _, w in sweeps),
                   validations=report.n_validations,
                   reconfigs=len(report.reconfigs),
                   mean_attainment=report.mean_attainment())
    numbers["sweep_share"] = numbers["sweep_wall_ms"] / wall_ms
    print(f"  {tag}: wall {wall_ms:.1f} ms on the card, {cpu_wall_ms:.1f} "
          f"ms on the CPU; {len(sweeps)} card sweeps "
          f"{numbers['sweep_wall_ms']:.3f} ms by perf_counter "
          f"({numbers['sweep_cuda_event_ms']:.3f} ms by CUDA events), "
          f"{numbers['sweep_share']:.4f} of the wall; "
          f"{report.n_validations} validations, {len(report.reconfigs)} "
          f"grants; payload equal to the CPU's")
    return report, numbers


def drift_gates(spec, online, static, naive) -> dict:
    """``benchmarks/online_serving.py::drift_case``'s numbers from its
    three runs: the static fleet's attainment before the drift, each
    run's over the last POST_EPOCHS epochs, the share of the static
    fleet's loss that the online run recovers, and its probe samples over
    the naive per-epoch re-search's."""
    drift_epoch = min(e.epoch for e in spec.drift.events)
    post = range(spec.n_epochs - POST_EPOCHS, spec.n_epochs)
    pre_att = static.mean_attainment(range(0, drift_epoch))
    static_post = static.mean_attainment(post)
    online_post = online.mean_attainment(post)
    loss = pre_att - static_post
    online_spent = online.budget["spent"]
    naive_spent = naive.budget["spent"]
    return dict(pre_attainment=pre_att, static_post=static_post,
                online_post=online_post,
                naive_post=naive.mean_attainment(post),
                attainment_loss=loss,
                recovery=((online_post - static_post) / loss)
                if loss > 1e-9 else float("nan"),
                online_spent=online_spent, naive_spent=naive_spent,
                probe_fraction=(online_spent / naive_spent)
                if naive_spent else float("nan"),
                grants=len(online.reconfigs),
                swaps=sum(r.accepted for r in online.reconfigs))


def no_drift_identical(online, static) -> bool:
    """``benchmarks/online_serving.py::no_drift_case``'s verdict: with no
    drift the online run serves bit for bit as the static one."""
    a, b = online.to_payload(), static.to_payload()
    return (a["epochs"] == b["epochs"]
            and a["epoch_attainment"] == b["epoch_attainment"]
            and not a["reconfigs"] and not b["reconfigs"]
            and a["budget"]["spent"] == 0)


def placement_gates(baseline, packed, ablation) -> dict:
    """``benchmarks/placement.py::placement_case``'s numbers: mean
    attainment and total cost of each run, and its two verdicts."""
    def total_cost(report):
        return float(sum(float(r["cost"]) for r in report.epochs))
    out = {}
    for name, report in (("baseline", baseline), ("packed", packed),
                         ("ablation", ablation)):
        out[f"{name}_attainment"] = report.mean_attainment()
        out[f"{name}_cost"] = total_cost(report)
    tol = 1e-9
    out["packed_ge_baseline"] = bool(
        out["packed_attainment"] >= out["baseline_attainment"] - tol)
    out["ablation_worse"] = bool(
        out["ablation_attainment"] < out["packed_attainment"] - tol
        or out["ablation_cost"] > out["packed_cost"] + tol)
    return out


def autoscale_gates(spec, static, runs) -> dict:
    """``benchmarks/autoscale.py::autoscale_case``'s numbers: the static
    fleet's settled pre-drift attainment, and per actuator set its
    post-window attainment, mean cost, recovery, cost per attained unit
    (None where it attains nothing) and replicas."""
    drift_epoch = min(e.epoch for e in spec.drift.events)
    post = range(spec.n_epochs - POST_EPOCHS, spec.n_epochs)

    def post_cost(report):
        costs = [e["cost"] for e in report.epochs if e["epoch"] in post]
        return sum(costs) / len(costs) if costs else float("nan")

    pre_att = static.mean_attainment(range(SETTLE_EPOCHS, drift_epoch))
    static_post = static.mean_attainment(post)
    loss = pre_att - static_post
    out = dict(pre_attainment=pre_att, static_post=static_post,
               static_post_cost=post_cost(static), attainment_loss=loss)
    for name, report in runs.items():
        att = report.mean_attainment(post)
        cost = post_cost(report)
        out[f"{name}_post"] = att
        out[f"{name}_post_cost"] = cost
        out[f"{name}_recovery"] = ((att - static_post) / loss) \
            if loss > 1e-9 else float("nan")
        out[f"{name}_cost_at_attainment"] = (cost / att) if att > 1e-9 \
            else None
        out[f"{name}_total_replicas"] = sum(
            sum(c.replicas.values()) for c in report.cells
            if c.replicas is not None)
    return out


def online_on_card():
    """Phase 12: INPUT_MIX swept on the card, then the specs that run on
    the host's planes, each payload against the CPU's, and the three
    benchmarks' gates held to their bars."""
    t0 = time.perf_counter()
    runs, reports = {}, {}
    print(" the contention-free replays, swept on the card:")
    for mode in ONLINE_MODES:
        reports[f"input_mix {mode}"], runs[f"input_mix {mode}"] = \
            online_on_both(f"input_mix {mode}",
                           dataclasses.replace(ONLINE_INPUT_MIX, mode=mode),
                           card=True)
    wide = dataclasses.replace(ONLINE_INPUT_MIX,
                               validation_instances=ONLINE_WIDE_INSTANCES)
    _, runs["input_mix wide"] = online_on_both(
        f"input_mix, validations of {ONLINE_WIDE_INSTANCES} arrivals", wide,
        card=True)
    print(" the host's planes (finite clusters, replica pools):")
    host = [(f"load_shift {mode}",
             dataclasses.replace(ONLINE_LOAD_SHIFT, mode=mode))
            for mode in ONLINE_MODES]
    host += [(f"no_drift {mode}", dataclasses.replace(ONLINE_NO_DRIFT,
                                                      mode=mode))
             for mode in ("drift", "never")]
    for scenario, spec in PLACEMENT_SCENARIOS.items():
        host += [(f"placement {scenario} baseline", spec),
                 (f"placement {scenario} packed",
                  dataclasses.replace(spec, placement=PLACEMENT)),
                 (f"placement {scenario} ablation", dataclasses.replace(
                     spec, placement=dataclasses.replace(PLACEMENT,
                                                         affinity=False)))]
    host.append(("compound_shift static",
                 dataclasses.replace(COMPOUND_SHIFT, mode="never")))
    host += [(f"compound_shift {name}", dataclasses.replace(
                 COMPOUND_SHIFT, autoscale=dataclasses.replace(
                     COMPOUND_SHIFT.autoscale, actuators=actuators)))
             for name, actuators in AUTOSCALE_VARIANTS]
    for tag, spec in host:
        reports[tag], runs[tag] = online_on_both(tag, spec, card=False)

    gates = {case: drift_gates(spec, *(reports[f"{case} {mode}"]
                                       for mode in ONLINE_MODES))
             for case, spec in (("load_shift", ONLINE_LOAD_SHIFT),
                                ("input_mix", ONLINE_INPUT_MIX))}
    gates["no_drift"] = dict(bit_identical=no_drift_identical(
        reports["no_drift drift"], reports["no_drift never"]))
    for scenario in PLACEMENT_SCENARIOS:
        gates[f"placement {scenario}"] = placement_gates(
            *(reports[f"placement {scenario} {name}"]
              for name in ("baseline", "packed", "ablation")))
    gates["compound_shift"] = autoscale_gates(
        COMPOUND_SHIFT, reports["compound_shift static"],
        {name: reports[f"compound_shift {name}"]
         for name, _ in AUTOSCALE_VARIANTS})

    print(" the benchmarks' gates:")
    for case in ("load_shift", "input_mix"):
        g = gates[case]
        print(f"  {case}: attainment {g['pre_attainment']:.4f} before the "
              f"drift, after it static {g['static_post']:.4f}, online "
              f"{g['online_post']:.4f}, naive {g['naive_post']:.4f}; "
              f"recovery {g['recovery']:.4f} (bar {RECOVERY_BAR}), probes "
              f"{g['online_spent']} of the naive re-search's "
              f"{g['naive_spent']} = {g['probe_fraction']:.4f} (bar "
              f"{BUDGET_BAR})")
        check(g["recovery"] >= RECOVERY_BAR,
              f"{case}: recovery {g['recovery']} under {RECOVERY_BAR}")
        check(g["probe_fraction"] <= BUDGET_BAR,
              f"{case}: probe fraction {g['probe_fraction']} over "
              f"{BUDGET_BAR}")
    print(f"  no_drift: online bit for bit the static fleet: "
          f"{gates['no_drift']['bit_identical']}")
    check(gates["no_drift"]["bit_identical"],
          "no_drift: the online run equals the static one")
    for scenario in PLACEMENT_SCENARIOS:
        g = gates[f"placement {scenario}"]
        print(f"  placement {scenario}: attainment packed "
              f"{g['packed_attainment']:.4f}, baseline "
              f"{g['baseline_attainment']:.4f}, ablation "
              f"{g['ablation_attainment']:.4f}; cost packed "
              f"{g['packed_cost']:.2f}, baseline {g['baseline_cost']:.2f}, "
              f"ablation {g['ablation_cost']:.2f}")
        check(g["packed_ge_baseline"] and g["ablation_worse"],
              f"placement {scenario}: packed at or above the baseline and "
              f"the ablation worse than packed: {g}")
    g = gates["compound_shift"]
    cost_at = {name: (math.inf if g[f"{name}_cost_at_attainment"] is None
                      else g[f"{name}_cost_at_attainment"])
               for name, _ in AUTOSCALE_VARIANTS}
    print(f"  compound_shift: recovery joint {g['joint_recovery']:.4f}, "
          f"config_only {g['config_only_recovery']:.4f}, scale_only "
          f"{g['scale_only_recovery']:.4f} (bar {AUTOSCALE_RECOVERY_BAR}); "
          f"cost at attainment joint {cost_at['joint']:.2f}, config_only "
          f"{cost_at['config_only']:.2f}, scale_only "
          f"{cost_at['scale_only']:.2f}")
    check(g["joint_recovery"] >= AUTOSCALE_RECOVERY_BAR,
          f"compound_shift: joint recovery {g['joint_recovery']}")
    check(g["config_only_recovery"] < AUTOSCALE_RECOVERY_BAR,
          f"compound_shift: config_only recovery "
          f"{g['config_only_recovery']}: the capacity wall did not hold")
    check(cost_at["joint"] < min(cost_at["config_only"],
                                 cost_at["scale_only"]),
          f"compound_shift: joint cost at attainment {cost_at}")
    result = dict(runs=runs, gates=gates,
                  phase_wall_s=time.perf_counter() - t0)
    print(f"the online control plane on the card took "
          f"{result['phase_wall_s']:.1f} s")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for stem, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {stem}: {line.strip()}")
        spills = re.findall(r"[1-9]\d* bytes spill", log)
        check(not spills, f"{stem}: ptxas reports spills {spills}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    # qwen3's heads at b = 1, 4 and ragged lengths, MQA, zamba2's shared
    # block (32/32, d = 64), and d = 32; then the fp32 route at qwen3's
    # and zamba2's prefill shapes
    flash_rows = [check_flash(gen, b, s, 16, 8, 128, torch.bfloat16)
                  for b in (1, 4) for s in (37, 128, 512, 1000)]
    flash_rows += [check_flash(gen, 1, 512, 16, 1, 64, torch.bfloat16),
                   check_flash(gen, 1, 512, 32, 32, 64, torch.bfloat16),
                   check_flash(gen, 1, 512, 16, 8, 32, torch.bfloat16)]
    # the MoE prefills: qwen2-moe (16/16, d = 128) and granite (24/8, d = 64)
    flash_moe = [check_flash(gen, 1, 512, 16, 16, 128, torch.bfloat16),
                 check_flash(gen, 1, 512, 24, 8, 64, torch.bfloat16)]
    flash_rows += flash_moe
    # the last families' causal prefills: whisper's decoder (6/6, d = 64)
    # at its longest prompt, and the vision model's self layers (64/8,
    # d = 128: a GQA group of 8)
    flash_new = [check_flash(gen, 1, 448, 6, 6, 64, torch.bfloat16),
                 check_flash(gen, 1, 512, 64, 8, 128, torch.bfloat16)]
    flash_rows += flash_new
    flash_f32 = [check_flash(gen, 1, 512, 16, 8, 128, torch.float32),
                 check_flash(gen, 1, 512, 32, 32, 64, torch.float32)]
    print_rows("flash_attention", flash_rows)
    print_rows("flash_attention", flash_f32)
    rms_rows = [check_rmsnorm(gen, shape, dtype)
                for shape in ((2048, 1024), (2, 64, 128), (4, 100, 256),
                              (512, 384), (1, 7, 64))
                for dtype in (torch.bfloat16, torch.float32)]
    print_rows("fused_rmsnorm", rms_rows)
    # zamba2-1.2b's prefill shape (4 chunks of 128) in bf16, the main
    # path's type, and in fp32, then a short prompt (q = 77) and the
    # reference's sweep (tests/test_kernels.py) in both types
    ssd_rows = [check_ssd(gen, 1, 512, 64, 64, 64, 128, dtype)
                for dtype in (torch.bfloat16, torch.float32)]
    ssd_rows += [check_ssd(gen, *shape, dtype)
                 for shape in ((1, 77, 64, 64, 64, 128),
                               (2, 128, 4, 32, 16, 32),
                               (1, 256, 8, 64, 64, 128),
                               (2, 64, 2, 16, 8, 16))
                 for dtype in (torch.bfloat16, torch.float32)]
    for dtype in ("bfloat16", "float32"):
        print_rows("ssd_intra", [rows[0] for rows in ssd_rows
                                 if rows[0]["shape"].endswith(dtype)])
    print_rows("ssd_inter", [rows[1] for rows in ssd_rows])

    err = model_parity()
    print(f"reduced qwen3-0.6b fp32, kernel vs plain logits: max abs err "
          f"{err:.3g}")
    err_fwd, err_pre = hybrid_parity()
    print(f"reduced zamba2-1.2b fp32, kernels vs plain: forward logits max "
          f"abs err {err_fwd:.3g}, prefill logits and caches {err_pre:.3g}")
    for arch in MOE_ARCHS:
        err_kernel, err_cpu = moe_parity(arch)
        print(f"reduced {arch} fp32: kernel vs plain logits and aux max abs "
              f"err {err_kernel:.3g}; card vs CPU {err_cpu:.3g}; the capacity "
              f"cut between two equal sequences takes the same tokens on "
              f"the card as on the CPU")
    parity = {}
    for arch in FAMILY_ARCHS:
        err_kernel, err_cpu, err_serve = family_parity(arch)
        parity[arch] = dict(kernel_max_abs_err=err_kernel,
                            cpu_max_abs_err=err_cpu,
                            cpu_serving_max_abs_err=err_serve,
                            greedy_tokens_equal=True)
        print(f"reduced {arch} fp32: kernel vs plain logits max abs err "
              f"{err_kernel:.3g}; card vs CPU forward {err_cpu:.3g}, prefill "
              f"and 8 greedy decode steps {err_serve:.3g}, the same greedy "
              f"tokens")

    serving = {}
    (model, params, engine, results, flash_launches, lengths, wall,
     serving["qwen3-0.6b"], _) = serve_model("qwen3-0.6b")
    print_serving("qwen3-0.6b", engine, results, lengths, wall,
                  {"flash_attention": flash_launches})
    serving["int8 qwen3-0.6b"] = int8_against_bf16(model, params)
    rms_launches = rmsnorm_entry_point()
    print("where the time goes (qwen3-0.6b bf16, warm):")
    where_time_goes(model, params, engine, {"flash attention": "flash_fwd"})
    del model, params, engine
    torch.cuda.empty_cache()

    model, params, engine, results, hybrid_launches, lengths, wall = \
        serve_hybrid()
    print_serving("zamba2-1.2b", engine, results, lengths, wall,
                  hybrid_launches)
    print("where the time goes (zamba2-1.2b bf16, warm):")
    traces = where_time_goes(model, params, engine,
                             {"ssd_intra": "ssd_intra",
                              "ssd_inter": "ssd_inter",
                              "flash attention": "flash_fwd"})
    # the chunk cumsum is folded into the intra pass: torch's scan kernel
    # (tensor_kernel_scan_outer_dim) must not appear in the prefill. The
    # chunk recurrence is folded into the inter pass: the torch loop's
    # stack of the states (a CatArrayBatchedCopy kernel, once per Mamba2
    # layer) must not appear either; the model's own cats (rope in the 6
    # shared-block applications, the cache stacks) launch fewer times
    prefill_rows, prefill_launches = traces["prefill, 512 tokens"][:2]
    check(bool(prefill_rows), "the profiler saw the zamba2 prefill's kernels")
    scans = [r.key for r in prefill_rows
             if "cumsum" in r.key.lower() or "scan_outer_dim" in r.key]
    check(not scans, f"no cumsum kernel in the zamba2 prefill, got {scans}")
    cats = [(r.count // PROFILE_CALLS, r.key) for r in prefill_rows
            if "CatArray" in r.key]
    per_layer = [key for count, key in cats if count >= model.cfg.n_layers]
    check(not per_layer, f"no cat kernel once per Mamba2 layer (the chunk "
                         f"recurrence's stack) in the zamba2 prefill, got "
                         f"{per_layer}")
    print(f"  no cumsum kernel and no recurrence stack among the zamba2 "
          f"prefill's {len(prefill_rows)} kernel rows ({prefill_launches} "
          f"launches per call); cat kernel launches per call: "
          f"{sorted(count for count, _ in cats)}")
    del model, params, engine, traces, prefill_rows
    torch.cuda.empty_cache()

    moe_launches = {}
    for arch in MOE_ARCHS:
        (model, params, engine, results, moe_launches[arch], lengths, wall,
         serving[arch], _) = serve_model(arch)
        print_serving(arch, engine, results, lengths, wall,
                      {"flash_attention": moe_launches[arch]})
        if arch == "qwen2-moe-a2.7b":
            print(f"where the time goes ({arch} bf16, warm):")
            where_time_goes(model, params, engine,
                            {"flash attention": "flash_fwd"})
        else:
            serving[f"int8 {arch}"] = int8_against_bf16(model, params)
        del model, params, engine
        torch.cuda.empty_cache()

    family_launches = {}
    for arch in FAMILY_ARCHS:
        (model, params, engine, results, family_launches[arch], lengths,
         wall, numbers, extra) = serve_model(arch)
        print_serving(arch, engine, results, lengths, wall,
                      {"flash_attention": family_launches[arch]})
        n_tokens = sum(len(r.tokens) for r in results)
        numbers.update(
            tokens_per_s=n_tokens / (engine.prefill_s + engine.decode_s),
            prefill_ms=engine.prefill_s / engine.n_prefills * 1e3,
            decode_step_ms=engine.decode_s / engine.decode_steps * 1e3,
            wall_s=wall, prompts=sorted(lengths), parity=parity[arch],
            profile={})
        print(f"where the time goes ({arch} bf16, warm):")
        traces = where_time_goes(model, params, engine,
                                 {"flash attention": "flash_fwd"}, extra)
        for name, (_, launches, wall_ms, device_ms) in traces.items():
            check(device_ms is not None, f"the profiler saw {arch}'s {name}")
            numbers["profile"][name] = dict(
                wall_ms=wall_ms, device_busy_ms=device_ms,
                idle_share=1 - device_ms / wall_ms, launches=launches)
        serving[arch] = numbers
        del model, params, engine, extra, traces
        torch.cuda.empty_cache()

    # training runs the plain paths, as the reference's does: no kernel of
    # the port has a backward pass, so none may launch in these phases
    flash_ops.launches = rms_ops.launches = 0
    ssd_ops.intra_launches = ssd_ops.inter_launches = 0
    train, model, state0, batch = train_main_path()
    print("the memory knobs (qwen3-0.6b bf16, 8 x 512, from one state):")
    train["knobs"] = train_knobs(model, state0, batch)
    # phase 9 starts from this model, state and batch again
    train_model, train_state0, train_batch = model, state0, batch
    del model, state0, batch
    torch.cuda.empty_cache()
    train["resilient"] = train_resilient()
    train["moe"] = train_moe()
    got = (flash_ops.launches, rms_ops.launches, ssd_ops.intra_launches,
           ssd_ops.inter_launches)
    check(got == (0, 0, 0, 0), f"no kernel launched while training, got "
                               f"{got}")
    train["kernel_launches"] = 0
    train["kernel_refuses_autograd"] = repair_on_card()
    print("flash attention under grad on the card: refused, no launch")

    # AARC runs no kernel of the port: none may launch in this phase
    flash_ops.launches = rms_ops.launches = 0
    ssd_ops.intra_launches = ssd_ops.inter_launches = 0
    aarc = aarc_on_card()
    got = (flash_ops.launches, rms_ops.launches, ssd_ops.intra_launches,
           ssd_ops.inter_launches)
    check(got == (0, 0, 0, 0), f"no kernel launched by AARC, got {got}")

    # nor does the fleet engine
    fleet = fleet_on_card()
    got = (flash_ops.launches, rms_ops.launches, ssd_ops.intra_launches,
           ssd_ops.inter_launches)
    check(got == (0, 0, 0, 0), f"no kernel launched by the fleet engine, "
                               f"got {got}")

    # phases 9 and 10 on a one-rank NCCL group, met through a store in this
    # process, and a (data=1, model=1) mesh; the group is destroyed after
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        # distribution trains through the plain paths too: no kernel
        # launches
        print("distribution on the card:")
        distribution = distribution_on_card(mesh, train_model, train_state0,
                                            train_batch, train)
        del train_model, train_state0, train_batch
        got = (flash_ops.launches, rms_ops.launches, ssd_ops.intra_launches,
               ssd_ops.inter_launches)
        check(got == (0, 0, 0, 0), f"no kernel launched by the distribution "
                                   f"phase, got {got}")
        torch.cuda.empty_cache()
        # serving through the sharded steps runs the kernels on local
        # shards: each model's counts are set to 0 and read in its run
        print("distribution on the card, serving side:")
        dist_serving = distribution_serving(mesh)
    finally:
        dist.destroy_process_group()

    # campaigns replay through the engine's sweep and launch no kernel
    zero_kernel_counts()
    print("campaigns on the card:")
    campaign = campaigns_on_card()
    got = (flash_ops.launches, rms_ops.launches, ssd_ops.intra_launches,
           ssd_ops.inter_launches)
    check(got == (0, 0, 0, 0), f"no kernel launched by the campaigns, got "
                               f"{got}")

    # nor does the online control plane: the counts stay at 0 through it
    print("the online control plane on the card:")
    online = online_on_card()
    got = (flash_ops.launches, rms_ops.launches, ssd_ops.intra_launches,
           ssd_ops.inter_launches)
    check(got == (0, 0, 0, 0), f"no kernel launched by the online control "
                               f"plane, got {got}")

    # phase 10's launches, per model: one sharded prefill and its serve
    # steps
    sharded_launches = lambda name: {
        f"{arch} sharded prefill + serve steps":
            dist_serving[arch]["kernel_launches"][name]
        for arch in SERVE_DIST_LAUNCHES}
    kernels = [
        dict(name="flash_attention", route="cuda",
             design="mma.sync bf16 + scalar fp32",
             source="src/repro_torch/kernels/flash_attention/csrc/"
                    "flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/kernel.py:101",
             launches=(flash_launches + hybrid_launches["flash_attention"]
                       + sum(moe_launches.values())
                       + sum(family_launches.values())
                       + sum(sharded_launches("flash_attention").values())),
             launches_by_path={
                 "qwen3-0.6b serving": flash_launches,
                 "zamba2-1.2b serving": hybrid_launches["flash_attention"],
                 **{f"{arch} serving": n
                    for arch, n in moe_launches.items()},
                 **{f"{arch} serving": n
                    for arch, n in family_launches.items()},
                 **sharded_launches("flash_attention")}),
        dict(name="fused_rmsnorm", route="triton",
             design="a block of rows per program",
             source="src/repro_torch/kernels/rmsnorm/kernel.py",
             replaces="src/repro/kernels/rmsnorm/kernel.py:40",
             launches=rms_launches),
        dict(name="ssd_intra", route="cuda",
             design="mma.sync bf16 + scalar fp32, chunk cumsum folded in",
             source="src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan/kernel.py:91",
             launches=(hybrid_launches["ssd_intra"]
                       + sum(sharded_launches("ssd_intra").values())),
             launches_by_path={
                 "zamba2-1.2b serving": hybrid_launches["ssd_intra"],
                 **sharded_launches("ssd_intra")}),
        dict(name="ssd_inter", route="cuda",
             design="mma.sync bf16 + scalar fp32, chunk recurrence "
                    "folded in",
             source="src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
             replaces="src/repro/kernels/ssd_scan/kernel.py:117",
             launches=(hybrid_launches["ssd_inter"]
                       + sum(sharded_launches("ssd_inter").values())),
             launches_by_path={
                 "zamba2-1.2b serving": hybrid_launches["ssd_inter"],
                 **sharded_launches("ssd_inter")}),
    ]
    # the rows at each kernel's main-path shape: flash at a full-length
    # qwen3 prompt (b=1 s=512), RMSNorm on 4 x 512 tokens of d=1024 bf16,
    # the SSD passes at a 512-token zamba2 prefill; the fp32 routes of
    # flash and the intra pass at the same shapes beside them
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")
    main_rows = (flash_rows[2], rms_rows[0], ssd_rows[0][0], ssd_rows[0][1])
    for entry, row in zip(kernels, main_rows):
        entry.update({k: row[k] for k in keys})
        print(f"  {entry['name']}: {row['ms']:.5f} ms at its main shape, "
              f"{PREV_MS[entry['name']]:.5f} ms earlier (constant from "
              f"PERF.md, not measured here)")
    kernels[0]["fp32"] = {k: flash_f32[0][k] for k in keys}
    kernels[0]["moe_shapes"] = [{k: row[k] for k in keys}
                                for row in flash_moe]
    kernels[0]["whisper_vision_shapes"] = [{k: row[k] for k in keys}
                                           for row in flash_new]
    kernels[2]["fp32"] = {k: ssd_rows[1][0][k] for k in keys}
    kernels[2]["cumsum_ms"] = ssd_rows[0][0]["cumsum_ms"]
    kernels[3]["fp32"] = {k: ssd_rows[1][1][k] for k in keys}
    kernels[3]["recurrence_ms"] = ssd_rows[0][1]["recurrence_ms"]
    print(json.dumps({"serving": serving}))
    print(json.dumps({"training": train}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"aarc": aarc}))
    print(json.dumps({"fleet": fleet}))
    print(json.dumps({"distribution": distribution}))
    print(json.dumps({"distribution_serving": dist_serving}))
    print(json.dumps({"campaign": campaign}))
    print(json.dumps({"online": online}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
