"""Simulated serverless (FaaS) substrate of the port: the paper's
function model and three workflows, the analytic response surface, and
the measured oracle timed on the card (copied from ``repro.serverless``;
see each module for what was left out)."""
from repro_torch.serverless.function import FunctionSpec
from repro_torch.serverless.platform import (AnalyticBackend,
                                             SimulatedPlatform,
                                             TorchMeasuredOracle, make_env)
from repro_torch.serverless.workloads import (WORKLOADS, chatbot,
                                              ml_pipeline, video_analysis,
                                              workload_slo)

__all__ = ["FunctionSpec", "AnalyticBackend", "SimulatedPlatform",
           "TorchMeasuredOracle", "make_env", "WORKLOADS", "chatbot",
           "ml_pipeline", "video_analysis", "workload_slo"]
