"""LM substrate of the port: the dense decoder family in plain torch.

Params are nested dicts of tensors in the reference layout; the layer
stack carries a leading ``layers`` axis that the model loops over.
"""
from repro_torch.models.model import Model, ModelConfig

__all__ = ["Model", "ModelConfig"]
