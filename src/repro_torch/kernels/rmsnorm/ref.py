"""Plain torch version of the fused residual-add + RMSNorm kernel.

It follows the kernel (and the TPU kernel it replaces): the norm is taken
of the fp32 sum ``s = x + r``. The JAX package's own oracle rounds ``s``
to x's type first; in bf16 the kernels' tolerance covers that gap.
"""
from __future__ import annotations

import torch


def fused_rmsnorm_ref(x: torch.Tensor, residual: torch.Tensor,
                      w: torch.Tensor, *, eps: float = 1e-6):
    """Returns (normed, x + residual), both of x's type."""
    s = x.float() + residual.float()
    var = (s * s).mean(dim=-1, keepdim=True)
    y = s * torch.rsqrt(var + eps) * w.float()
    return y.to(x.dtype), s.to(x.dtype)
