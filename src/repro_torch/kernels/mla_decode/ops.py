"""Public MLA decode attention: every query head of a slot against its
latent rows, kernel or plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels import (PLAIN_DEVICES, refuse_autograd,
                                 refuse_dtensor)
from repro_torch.kernels.mla_decode.kernel import mla_decode_cuda
from repro_torch.kernels.mla_decode.ref import mla_decode_ref

#: calls that launched the CUDA kernels (a partial and a merge kernel each)
#: since the count was last set to 0; under a CUDA graph, the captured calls
launches = 0


def mla_decode(q: torch.Tensor, cache: torch.Tensor, length: torch.Tensor,
               *, v_dim: int, scale: float) -> torch.Tensor:
    """Multi-query decode attention over a latent cache read in place.

    q: (b, h, R), the absorbed queries [q~, q_pe]; cache: (b, S, R), one
    row [c, k_pe] a position; length: (b,) int32, slot r attending rows
    0 .. min(length[r], S - 1); the values are the rows' first ``v_dim``
    columns. Returns (b, h, v_dim), the scores scaled by ``scale``.
    A CUDA tensor goes through the CUDA kernels (or the call raises); a
    CPU or meta tensor through the plain version. Refuses autograd (no
    backward) and DTensors.
    """
    global launches
    refuse_autograd("mla_decode", q, cache)
    refuse_dtensor("mla_decode", q, cache, length)
    if q.device.type in PLAIN_DEVICES:
        return mla_decode_ref(q, cache, length, v_dim=v_dim, scale=scale)
    out = mla_decode_cuda(q, cache, length, v_dim=v_dim, scale=scale)
    launches += 1
    return out
