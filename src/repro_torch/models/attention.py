"""Multi-head attention: GQA, RoPE, qk-norm, QKV bias (counterpart of
``repro.models.attention``).

Two execution paths selected by ``impl``:
  * ``"plain"``  — torch einsum (the reference's ``"xla"``),
  * ``"kernel"`` — the hand-written CUDA flash kernel for causal
    attention (the reference's ``"pallas"``); on CPU tensors the
    kernel's plain version.

Softmax accumulates in fp32.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.layers import apply_rope, dense_init, rms_norm

NEG_INF = -1e30
IMPLS = ("plain", "kernel")


def make_attention_params(gen, d_model: int, n_heads: int, kv_heads: int,
                          head_dim: int, dtype, device, *,
                          qkv_bias: bool = False,
                          qk_norm: bool = False) -> Dict[str, torch.Tensor]:
    params = {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype, device),
        "wk": dense_init(gen, d_model, kv_heads * head_dim, dtype, device),
        "wv": dense_init(gen, d_model, kv_heads * head_dim, dtype, device),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype, device,
                         scale=(n_heads * head_dim) ** -0.5),
    }
    if qkv_bias:
        zeros = lambda n: torch.zeros(n, dtype=dtype, device=device)
        params.update(bq=zeros(n_heads * head_dim),
                      bk=zeros(kv_heads * head_dim),
                      bv=zeros(kv_heads * head_dim))
    if qk_norm:
        params.update(q_norm=torch.ones(head_dim, dtype=dtype, device=device),
                      k_norm=torch.ones(head_dim, dtype=dtype, device=device))
    return params


def _project_qkv(params, x: torch.Tensor, kv_x: torch.Tensor, n_heads: int,
                 kv_heads: int, head_dim: int,
                 positions: Optional[torch.Tensor],
                 kv_positions: Optional[torch.Tensor],
                 rope_theta: Optional[float]):
    b = x.shape[0]
    q = x @ params["wq"]
    k = kv_x @ params["wk"]
    v = kv_x @ params["wv"]
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, -1, n_heads, head_dim)
    k = k.reshape(b, -1, kv_heads, head_dim)
    v = v.reshape(b, -1, kv_heads, head_dim)
    if "q_norm" in params:                       # qwen3-style per-head qk-norm
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, kv_positions, rope_theta)
    return q, k, v


#: at and above this query length the GQA groups are expanded (k/v repeated
#: to the full head count), below it the grouped form is kept, as in the
#: reference (decode, sq = 1, stays grouped)
GQA_EXPAND_MIN_SQ = 128


def _sdpa_plain(q, k, v, *, causal: bool, q_offset: int = 0,
                kv_len_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (b, sq, h, d); k/v: (b, skv, hkv, d) with GQA head grouping.

    Probabilities are cast to q's type before the PV product, as in the
    reference.
    """
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    skv = k.shape[1]
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(skv, device=q.device)
    if group > 1 and sq >= GQA_EXPAND_MIN_SQ:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
        hkv, group = h, 1
    if group == 1:
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / (d ** 0.5)
        if causal:
            scores = torch.where(kpos[None, :] <= qpos[:, None], scores,
                                 NEG_INF)
        if kv_len_mask is not None:
            scores = torch.where(kv_len_mask[:, None, None, :], scores,
                                 NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(q.dtype)
        return torch.einsum("bhqk,bkhd->bqhd", probs, v)
    qg = q.reshape(b, sq, hkv, group, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float() / (d ** 0.5)
    if causal:
        scores = torch.where(kpos[None, :] <= qpos[:, None], scores, NEG_INF)
    if kv_len_mask is not None:                 # (b, skv) valid-key mask
        scores = torch.where(kv_len_mask[:, None, None, None, :], scores,
                             NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, h, d)


#: sequences longer than this run query block by query block, so the score
#: matrix never materialises at (S, S)
CHUNKED_SEQ_THRESHOLD = 2048
Q_BLOCK = 1024


def _sdpa_plain_chunked(q, k, v, *, causal: bool,
                        q_block: int = Q_BLOCK) -> torch.Tensor:
    """Blockwise attention: full keys for each query block; the same math
    as :func:`_sdpa_plain` with O(q_block * S) peak memory."""
    sq = q.shape[1]
    if sq % q_block:
        raise ValueError(f"seq {sq} not divisible by q_block {q_block}")
    return torch.cat([_sdpa_plain(q[:, i:i + q_block], k, v, causal=causal,
                                  q_offset=i)
                      for i in range(0, sq, q_block)], dim=1)


def sdpa(q, k, v, *, causal: bool, impl: str = "plain") -> torch.Tensor:
    """Dispatch: flash kernel (causal), chunked plain, or dense plain."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; one of {IMPLS}")
    if impl == "kernel" and causal:
        from repro_torch.kernels.flash_attention import ops as flash_ops
        return flash_ops.flash_attention(q, k, v)
    if q.shape[1] > CHUNKED_SEQ_THRESHOLD and q.shape[1] == k.shape[1]:
        return _sdpa_plain_chunked(q, k, v, causal=causal)
    return _sdpa_plain(q, k, v, causal=causal)
