"""Plain torch version of the MLA decode kernel: every query head of a
slot against the slot's latent rows, over a mask of the whole cache."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def mla_decode_ref(q: torch.Tensor, cache: torch.Tensor,
                   length: torch.Tensor, *, v_dim: int,
                   scale: float) -> torch.Tensor:
    """q: (b, h, R); cache: (b, S, R); length: (b,). Slot r's heads attend
    the rows ``arange(S) <= length[r]``, the values the rows' first
    ``v_dim`` columns; returns (b, h, v_dim).

    Scores in q's type, scaled in fp32, an fp32 softmax whose
    probabilities are cast to q's type before the P V product, as
    ``decode_attention_ref`` computes. Rows past the mask are read as
    zeros, so what they hold cannot reach the output through 0 * inf or
    NaN.
    """
    S = cache.shape[1]
    live = torch.arange(S, device=q.device)[None, :] <= length[:, None]
    scores = torch.einsum("bhr,bsr->bhs", q, cache).float() * scale
    scores = torch.where(live[:, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    values = torch.where(live[:, :, None], cache[..., :v_dim], 0)
    return torch.einsum("bhs,bsv->bhv", probs, values)
