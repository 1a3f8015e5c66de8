"""LM substrate of the port: the seven model families (one class each,
``families.py``) in plain torch around the kernels.

Params are nested dicts of tensors in the reference layout; the layer
stack carries a leading ``layers`` axis that the model loops over.
"""
from repro_torch.models.model import Model, ModelConfig

__all__ = ["Model", "ModelConfig"]
