"""Plain torch version of the decode-attention kernel: the grouped
attention of the model's plain path over a mask of the whole cache."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length: torch.Tensor, *,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, 1, h, d); k/v: (b, S, hkv, d); length: (b,). Slot r attends
    the rows ``arange(S) <= length[r]``.

    The arithmetic of ``models.attention._sdpa_plain``'s grouped form with
    that mask, bit for bit: scores in q's type, scaled in fp32 (by
    d^-1/2, or times ``scale``), an fp32 softmax whose probabilities are
    cast to q's type before the P V product. V's rows past the mask are
    read as zeros, so what they hold (a stale request's values, or
    anything else) cannot reach the output through 0 * inf or NaN.
    """
    b, sq, h, d = q.shape
    S, hkv = k.shape[1], k.shape[2]
    live = torch.arange(S, device=q.device)[None, :] <= length[:, None]
    scores = torch.einsum("bqhgd,bkhd->bhgqk",
                          q.reshape(b, sq, hkv, h // hkv, d), k).float()
    scores = scores / d ** 0.5 if scale is None else scores * scale
    scores = torch.where(live[:, None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    v = torch.where(live[:, :, None, None], v, 0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, h, d)
