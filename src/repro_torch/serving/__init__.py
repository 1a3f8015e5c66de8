"""Serving of the port: slot-based continuous batching over the model's
prefill/decode entry points."""
from repro_torch.serving.engine import GenerationResult, ServeEngine
from repro_torch.serving.scheduler import Request, RequestQueue

__all__ = ["ServeEngine", "GenerationResult", "Request", "RequestQueue"]
