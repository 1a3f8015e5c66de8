"""Plain torch version of the flash-attention kernel (dense softmax)."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, sq, h, d); k: (b, skv, hkv, d); v: (b, skv, hkv, dv). fp32
    softmax, GQA grouping; returns (b, sq, h, dv).

    The causal mask keeps key ``j`` for query ``i`` when ``j <= i``.
    """
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, sq, hkv, group, d).float() * scale
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if causal:
        skv = k.shape[1]
        mask = (torch.arange(skv, device=q.device)[None, :]
                <= torch.arange(sq, device=q.device)[:, None])
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)
