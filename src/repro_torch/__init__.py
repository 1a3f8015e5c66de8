"""PyTorch/CUDA port of the LM substrate, beside the JAX package ``repro``.

The port imports ``torch`` and numpy and nothing of JAX or of ``repro``:
what it needs of the reference it keeps as its own copy. Module names
follow the reference (``configs``, ``models``, ``kernels``, ``serving``)
so each counterpart is easy to find. Entry points run on the CUDA card
unless the caller passes ``device="cpu"`` (see :mod:`repro_torch.device`).
"""
import torch

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]

# torch's MKL elementwise kernels (exp, cos, sin, ...) set up their CPU
# dispatch on first use. When that first use is split across threads, it
# can come out at about 12 bits of accuracy (relative errors of 1.5e-4 in
# one process of ten: scripts/cpu_first_call_check.py), which is enough to
# move a rotary embedding or a routing choice. One call on a single
# element runs on this thread alone and sets the dispatch up first.
torch.exp(torch.zeros(1))
