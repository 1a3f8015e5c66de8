"""PyTorch/CUDA port of the LM substrate, beside the JAX package ``repro``.

The port imports ``torch`` and numpy and nothing of JAX or of ``repro``:
what it needs of the reference it keeps as its own copy. Module names
follow the reference (``configs``, ``models``, ``kernels``, ``serving``)
so each counterpart is easy to find. Entry points run on the CUDA card
unless the caller passes ``device="cpu"`` (see :mod:`repro_torch.device`).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
