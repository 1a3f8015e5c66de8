"""AARC on the H100: the paper's decoupled-resource configurator applied
to LM training/serving stages.

The mapping:

  serverless function   ->  pipeline stage (layer group / embed / head)
  workflow DAG          ->  stage graph of the train/serve step
  vCPU knob             ->  per-stage GPU allocation (0.1..10 "cpu"
                            units = 2.56..256 GPUs of an NVLink pod)
  memory knob           ->  per-stage activation budget (MB knob ->
                            fraction of full activation residency;
                            lower budget = deeper remat = recompute)
  execute-the-workflow  ->  analytic roofline oracle on H100 constants
  cost t(mu0 cpu+mu1 mem) -> GPU-seconds + HBM-GB-seconds
  end-to-end SLO        ->  step-latency target

Algorithms 1 & 2 (and the BO/MAFF baselines) run *unchanged* — only
the Environment's oracle differs. Copied from ``repro.autotune`` with
the H100 oracle in place of the reference's.
"""
from repro_torch.autotune.oracle import (GPU_PRICING, GPUStageOracle,
                                         OracleConfig, make_gpu_env)
from repro_torch.autotune.planner import PlanResult, StagePlan, plan
from repro_torch.autotune.stages import StageSpec, build_stage_graph

__all__ = ["StageSpec", "build_stage_graph", "GPUStageOracle",
           "OracleConfig", "GPU_PRICING", "make_gpu_env", "PlanResult",
           "StagePlan", "plan"]
