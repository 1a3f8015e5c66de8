"""Simulated serverless (FaaS) substrate of the port: the paper's
function model and three workflows, the seeded workflow generator, the
analytic and stochastic response surfaces, and the measured oracle
timed on the card (copied from ``repro.serverless``; see each module
for what was left out)."""
from repro_torch.serverless.function import FunctionSpec
from repro_torch.serverless.generator import (AFFINITY_PROFILES, DriftEvent,
                                              DriftSchedule, EpochConditions,
                                              GENERATORS, chain_workflow,
                                              coldstart_schedule,
                                              degree_bucket,
                                              diamond_workflow, fan_workflow,
                                              generate, input_mix_schedule,
                                              layered_workflow,
                                              load_shift_schedule,
                                              random_drift_schedule,
                                              random_spec, suggest_slo,
                                              topology_signature,
                                              transfer_configs)
from repro_torch.serverless.platform import (AnalyticBackend,
                                             SimulatedPlatform,
                                             StochasticBackend,
                                             TorchMeasuredOracle, make_env,
                                             make_scaled_env)
from repro_torch.serverless.workloads import (WORKLOADS, chatbot,
                                              ml_pipeline, video_analysis,
                                              workload_slo)

__all__ = [
    "FunctionSpec",
    "AFFINITY_PROFILES", "GENERATORS", "chain_workflow", "diamond_workflow",
    "fan_workflow", "generate", "layered_workflow", "random_spec",
    "suggest_slo",
    "DriftEvent", "DriftSchedule", "EpochConditions", "coldstart_schedule",
    "degree_bucket", "input_mix_schedule", "load_shift_schedule",
    "random_drift_schedule", "topology_signature", "transfer_configs",
    "AnalyticBackend", "SimulatedPlatform", "StochasticBackend",
    "TorchMeasuredOracle", "make_env", "make_scaled_env",
    "WORKLOADS", "chatbot", "ml_pipeline", "video_analysis", "workload_slo",
]
