"""Public decode attention: one query position per slot against the cache,
kernel or plain version."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import (PLAIN_DEVICES, refuse_autograd,
                                 refuse_dtensor)
from repro_torch.kernels.decode_attention.kernel import decode_attention_cuda
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

#: calls that launched the CUDA kernels (a partial and a merge kernel each)
#: since the count was last set to 0; under a CUDA graph, the captured calls
launches = 0


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor, *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Grouped decode attention over a KV cache read in place.

    q: (b, 1, h, d); k/v: (b, S, hkv, d); length: (b,) int32, slot r
    attending rows 0 .. min(length[r], S - 1); returns (b, 1, h, d). The
    scores are scaled by ``scale`` (None: d^-1/2).
    A CUDA tensor goes through the CUDA kernels (or the call raises); a
    CPU or meta tensor through the plain version. Refuses autograd (no
    backward) and DTensors (call it on local shards).
    """
    global launches
    refuse_autograd("decode_attention", q, k, v)
    refuse_dtensor("decode_attention", q, k, v, length)
    if q.device.type in PLAIN_DEVICES:
        return decode_attention_ref(q, k, v, length, scale=scale)
    out = decode_attention_cuda(q, k, v, length, scale=scale)
    launches += 1
    return out
