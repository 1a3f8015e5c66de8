"""Public fused residual-add + RMSNorm: any (..., d) shape."""
from __future__ import annotations

import torch

from repro_torch.kernels import (PLAIN_DEVICES, refuse_autograd,
                                 refuse_dtensor)
from repro_torch.kernels.rmsnorm.kernel import fused_rmsnorm_cuda
from repro_torch.kernels.rmsnorm.ref import fused_rmsnorm_ref

#: launches of the Triton kernel since the count was last set to 0
launches = 0


def fused_rmsnorm(x: torch.Tensor, residual: torch.Tensor, w: torch.Tensor,
                  *, eps: float = 1e-6):
    """Fused (x + residual) -> RMSNorm. Returns (normed, new_residual).

    A CUDA tensor goes through the Triton kernel (or the call raises); a
    CPU tensor through the plain version, and so does a meta tensor, which
    has no data, so nothing is hidden. Refuses autograd (no backward) and
    DTensors (call it on local shards).
    """
    global launches
    refuse_autograd("fused_rmsnorm", x, residual, w)
    refuse_dtensor("fused_rmsnorm", x, residual, w)
    if x.device.type in PLAIN_DEVICES:
        return fused_rmsnorm_ref(x, residual, w, eps=eps)
    shape = x.shape
    y, s = fused_rmsnorm_cuda(x.reshape(-1, shape[-1]).contiguous(),
                              residual.reshape(-1, shape[-1]).contiguous(),
                              w.contiguous(), eps=eps)
    launches += 1
    return y.reshape(shape), s.reshape(shape)
