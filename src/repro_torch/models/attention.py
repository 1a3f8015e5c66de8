"""Multi-head attention: GQA, RoPE, qk-norm, QKV bias, KV cache
(counterpart of ``repro.models.attention``).

Two execution paths selected by ``impl``:
  * ``"plain"``  — torch einsum (the reference's ``"xla"``),
  * ``"kernel"`` — the hand-written CUDA flash kernel for causal
    attention (the reference's ``"pallas"``); on CPU tensors the
    kernel's plain version.

On a mesh both paths run on each rank's local (batch, head) shards
(``sharding.per_shard``). Softmax accumulates in fp32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain, per_shard
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


def attention_axes(*, qkv_bias: bool = False, qk_norm: bool = False
                   ) -> Dict[str, tuple]:
    """The logical axes of :func:`make_attention_params`' tree."""
    axes = {"wq": ("embed", "qkv"), "wk": ("embed", "kv_qkv"),
            "wv": ("embed", "kv_qkv"), "wo": ("qkv", "embed")}
    if qkv_bias:
        axes.update(bq=("qkv",), bk=("kv_qkv",), bv=("kv_qkv",))
    if qk_norm:
        axes.update(q_norm=("head_dim",), k_norm=("head_dim",))
    return axes


def _split_heads(t: torch.Tensor, n: int, head_dim: int) -> torch.Tensor:
    """(b, s, n * head_dim) viewed as (b, s, n, head_dim). On a mesh the
    heads shard over the model axis only where ``n`` divides it; else the
    projection is replicated over it first."""
    b, s = t.shape[:2]
    t = constrain(t, ("batch", "act_seq", "heads_act", None),
                  shape=(b, s, n, head_dim))
    return t.reshape(b, -1, n, head_dim)


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
    q = _split_heads(q, n_heads, head_dim)
    k = _split_heads(k, kv_heads, head_dim)
    v = _split_heads(v, kv_heads, head_dim)
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


#: per_shard roles of attention's operands: its products are independent
#: per (batch, head)
_BSHD = ("b", None, "h", None)
_BHQK = ("b", "h", None, None)
_BHGQK = ("b", "h", None, None, None)


def _scale_scores(scores: torch.Tensor, d: int,
                  scale: Optional[float]) -> torch.Tensor:
    """fp32 scores over d^1/2, or times ``scale`` where one is given."""
    return scores / (d ** 0.5) if scale is None else scores * scale


def _sdpa_plain(q, k, v, *, causal: bool, q_offset: int = 0,
                kv_len_mask: Optional[torch.Tensor] = None,
                scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, sq, h, d); k/v: (b, skv, hkv, d) with GQA head grouping.

    Probabilities are cast to q's type before the PV product, as in the
    reference. The fp32 scores are scaled by ``scale`` (None: d^-1/2).
    Without GQA groups the scores and probabilities are pinned by logical
    axes: over heads where they divide the model axis, else over the
    query sequence.
    """
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    skv = k.shape[1]
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(skv, device=q.device)
    # on a mesh every product runs on the local (batch, head) shards
    if group > 1 and sq >= GQA_EXPAND_MIN_SQ:
        k, v = per_shard(lambda k, v: (k.repeat_interleave(group, dim=2),
                                       v.repeat_interleave(group, dim=2)),
                         (k, v), (_BSHD, _BSHD), (_BSHD, _BSHD))
        hkv, group = h, 1
    if group == 1:
        score_axes = ("batch", "heads_act", "act_seq", None)
        scores = per_shard(lambda q, k: _scale_scores(torch.einsum(
            "bqhd,bkhd->bhqk", q, k).float(), d, scale), (q, k),
            (_BSHD, _BSHD), _BHQK)
        scores = constrain(scores, score_axes)
        if causal:
            scores = torch.where(kpos[None, :] <= qpos[:, None], scores,
                                 NEG_INF)
        if kv_len_mask is not None:
            scores = torch.where(kv_len_mask[:, None, None, :], scores,
                                 NEG_INF)
        probs = constrain(torch.softmax(scores, dim=-1).to(q.dtype),
                          score_axes)
        return per_shard(lambda p, v: torch.einsum("bhqk,bkhd->bqhd", p, v),
                         (probs, v), (_BHQK, _BSHD), _BSHD)
    # the query heads grouped by their kv head: (b, sq, hkv, group, d)
    scores = per_shard(lambda q, k: _scale_scores(torch.einsum(
        "bqhgd,bkhd->bhgqk", q.reshape(*q.shape[:2], k.shape[2], group, d),
        k).float(), d, scale), (q, k), (_BSHD, _BSHD), _BHGQK)
    if causal:
        scores = torch.where(kpos[None, :] <= qpos[:, None], scores, NEG_INF)
    if kv_len_mask is not None:                 # (b, skv) valid-key mask
        scores = torch.where(kv_len_mask[:, None, None, None, :], scores,
                             NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = per_shard(lambda p, v: torch.einsum("bhgqk,bkhd->bqhgd", p, v),
                    (probs, v), (_BHGQK, _BSHD), ("b", None, "h", None, None))
    return out.reshape(b, sq, h, d)


#: sequences longer than this run query block by query block, so the score
#: matrix never materialises at (S, S)
CHUNKED_SEQ_THRESHOLD = 2048
Q_BLOCK = 1024


def _sdpa_plain_chunked(q, k, v, *, causal: bool,
                        q_block: int = Q_BLOCK,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Blockwise attention: full keys for each query block; the same math
    as :func:`_sdpa_plain` with O(q_block * S) peak memory."""
    sq = q.shape[1]
    if sq % q_block:
        raise ValueError(f"seq {sq} not divisible by q_block {q_block}")
    return torch.cat([_sdpa_plain(q[:, i:i + q_block], k, v, causal=causal,
                                  q_offset=i, scale=scale)
                      for i in range(0, sq, q_block)], dim=1)


def sdpa(q, k, v, *, causal: bool, impl: str = "plain",
         scale: Optional[float] = None) -> torch.Tensor:
    """Dispatch: flash kernel (causal), chunked plain, or dense plain; the
    scores scaled by ``scale`` (None: head_dim^-1/2) on every route."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; one of {IMPLS}")
    if impl == "kernel" and causal:
        from repro_torch.kernels.flash_attention import ops as flash_ops
        # on a mesh each rank runs the kernel on its local (batch, head)
        # shards; contiguous head shards keep GQA's groups whole when both
        # head counts divide the model axis, and per_shard replicates the
        # heads where either does not
        return per_shard(lambda q, k, v: flash_ops.flash_attention(
            q, k, v, scale=scale), (q, k, v), (_BSHD, _BSHD, _BSHD), _BSHD)
    if q.shape[1] > CHUNKED_SEQ_THRESHOLD and q.shape[1] == k.shape[1]:
        return _sdpa_plain_chunked(q, k, v, causal=causal, scale=scale)
    return _sdpa_plain(q, k, v, causal=causal, scale=scale)


def attention(params, x: torch.Tensor, *, n_heads: int, kv_heads: int,
              head_dim: int, causal: bool = True,
              rope_theta: Optional[float] = None,
              positions: Optional[torch.Tensor] = None,
              kv_x: Optional[torch.Tensor] = None,
              impl: str = "plain") -> torch.Tensor:
    """Full-sequence attention (training / prefill / encoder / cross); a
    cross attention (``kv_x`` given) takes no rope and plain attention."""
    b, s, _ = x.shape
    kv_src = kv_x if kv_x is not None else x
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    kv_positions = (torch.arange(kv_src.shape[1], device=x.device).expand(
        b, kv_src.shape[1]) if kv_x is not None else positions)
    q, k, v = _project_qkv(params, x, kv_src, n_heads, kv_heads, head_dim,
                           positions, kv_positions,
                           rope_theta if kv_x is None else None)
    out = sdpa(q, k, v, causal=causal and kv_x is None,
               impl=impl if kv_x is None else "plain")
    return out.reshape(b, s, n_heads * head_dim) @ params["wo"]


# --------------------------------------------------------------------------
# KV-cache decode
# --------------------------------------------------------------------------

def init_kv_cache(batch: int, kv_heads: int, max_len: int, head_dim: int,
                  dtype, device=None) -> Dict[str, torch.Tensor]:
    zeros = lambda: torch.zeros((batch, max_len, kv_heads, head_dim),
                                dtype=dtype, device=device)
    return {"k": zeros(), "v": zeros(),
            "length": torch.zeros((batch,), dtype=torch.int32,
                                  device=device)}


def decode_attention(params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                     *, n_heads: int, kv_heads: int, head_dim: int,
                     rope_theta: Optional[float] = None
                     ) -> Tuple[torch.Tensor, Dict]:
    """One-token decode: x (b, 1, d) against cache (b, S, hkv, hd).

    The new K/V is added at position ``length`` as a one-hot row, as in
    the reference: a new cache is returned and the one passed in is not
    written (a row at ``length >= S`` adds nothing). Keys beyond
    ``length`` are masked.
    """
    b = x.shape[0]
    length = cache["length"]
    positions = length[:, None]                                  # (b, 1)
    q, k_new, v_new = _project_qkv(params, x, x, n_heads, kv_heads, head_dim,
                                   positions, positions, rope_theta)
    max_len = cache["k"].shape[1]
    slots = torch.arange(max_len, device=x.device)[None, :]
    onehot = (slots == length[:, None]).to(x.dtype)               # (b, S)
    k = cache["k"] + onehot[:, :, None, None] * k_new
    v = cache["v"] + onehot[:, :, None, None] * v_new
    valid = slots <= length[:, None]                             # (b, S)
    out = _sdpa_plain(q, k, v, causal=False, kv_len_mask=valid)
    out = out.reshape(b, 1, n_heads * head_dim) @ params["wo"]
    return out, {"k": k, "v": v, "length": length + 1}


def prefill_into_cache(params, x: torch.Tensor, *, n_heads: int,
                       kv_heads: int, head_dim: int, max_len: int,
                       rope_theta: Optional[float] = None,
                       impl: str = "plain") -> Tuple[torch.Tensor, Dict]:
    """Causal prefill that also returns the populated KV cache."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(params, x, x, n_heads, kv_heads, head_dim,
                           positions, positions, rope_theta)
    out = sdpa(q, k, v, causal=True, impl=impl)
    out = out.reshape(b, s, n_heads * head_dim) @ params["wo"]
    pad = (0, 0, 0, 0, 0, max_len - s)
    cache = {"k": F.pad(k, pad), "v": F.pad(v, pad),
             "length": torch.full((b,), s, dtype=torch.int32,
                                  device=x.device)}
    return out, cache
