"""Public flash attention: (b, s, h, d) layout, kernel or plain version."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import (PLAIN_DEVICES, refuse_autograd,
                                 refuse_dtensor)
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref

#: launches of the CUDA kernel since the count was last set to 0
launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Causal GQA flash attention.

    q: (b, sq, h, d); k: (b, skv, hkv, d); v: (b, skv, hkv, dv), dv = d
    but in latent attention's prefill; returns (b, sq, h, dv). The
    scores are scaled by ``scale`` (None: d^-1/2, as before the argument
    existed).
    A CUDA tensor goes through the CUDA kernel (or the call raises); a
    CPU tensor through the plain version, and so does a meta tensor (the
    dry run's), which has no data, so nothing is hidden. Refuses autograd
    (no backward) and DTensors (call it on local shards).
    """
    global launches
    refuse_autograd("flash_attention", q, k, v)
    refuse_dtensor("flash_attention", q, k, v)
    if q.device.type in PLAIN_DEVICES:
        return attention_ref(q, k, v, causal=causal, scale=scale)
    out = flash_attention_cuda(q, k, v, causal=causal, scale=scale)
    launches += 1
    return out
