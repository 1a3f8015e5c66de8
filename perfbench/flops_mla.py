"""Operations and bytes of a latent-attention model's calls (DeepSeek-V2:
a leading dense layer, then experts), from shapes alone, counted as
``flops.py`` counts a decoder's: the work of the call, whatever
implements it. A multiply-add is 2 operations; the experts count each
token's top-k and the shared experts, not capacity padding; causal
attention counts its s (s + 1) / 2 pairs. Bytes count each input read
once and each output written once.

A prefill's attention is the expanded form (q.k over nope + rope dims, v
over v_dim, per head); a decode step's is the absorbed form, the one
that reads the latent cache as it lies: W_uk folded into each head's
query (nope_dim x kv_rank), the scores over the kv_rank + rope wide
rows, the output over their first kv_rank columns, then W_uv (kv_rank x
v_dim).

``m`` is the ``model`` dict of a configuration file: its ``mla`` group,
``dense_layers`` and ``moe``.
"""
from __future__ import annotations

from typing import Dict, Iterable

BF16 = 2


def _mla(m: Dict):
    a = m["mla"]
    return (a["kv_rank"], a["nope_dim"], a["rope_dim"], a["v_dim"],
            m["n_heads"])


def row_width(m: Dict) -> int:
    """One latent cache row: kv_rank + rope_dim."""
    r, _, rope, _, _ = _mla(m)
    return r + rope


def attn_token_macs(m: Dict) -> int:
    """One token through an attention layer's projections: W_q, W_kv_a,
    W_kv_b (kv_rank -> the heads' k_nope and v) and W_o."""
    r, nope, rope, v, h = _mla(m)
    d = m["d_model"]
    return d * h * (nope + rope) + d * (r + rope) + r * h * (nope + v) \
        + h * v * d


def absorbed_token_macs(m: Dict) -> int:
    """One decode row through an attention layer's projections, absorbed:
    W_q, W_kv_a, W_uk into the query, W_uv out of the latent, W_o."""
    r, nope, rope, v, h = _mla(m)
    d = m["d_model"]
    return d * h * (nope + rope) + d * (r + rope) + h * nope * r \
        + h * r * v + h * v * d


def ffn_token_macs(m: Dict, dense: bool) -> int:
    d = m["d_model"]
    if dense:
        return 3 * d * m["d_ff"]
    e = m["moe"]
    return d * e["n_experts"] + 3 * d * (e["top_k"] * e["expert_ff"]
                                         + e["shared_ff"])


def _ffn_macs(m: Dict) -> int:
    k = m["dense_layers"]
    return k * ffn_token_macs(m, True) \
        + (m["n_layers"] - k) * ffn_token_macs(m, False)


def flash_call(m: Dict, s: int) -> Dict[str, float]:
    """One layer's causal attention of a prompt of s tokens, expanded: per
    head the s (s + 1) / 2 pairs of a q.k product over nope + rope dims
    and a P V product over v_dim; q, k (nope + rope) and v read, o (v_dim)
    written once, in bf16."""
    _, nope, rope, v, h = _mla(m)
    pairs = s * (s + 1) / 2
    return {"flops": 2.0 * h * pairs * (nope + rope + v),
            "bytes": float(BF16 * s * h * (2 * (nope + rope) + 2 * v))}


def mla_decode_call(m: Dict, ctx: int) -> Dict[str, float]:
    """One row's absorbed attention in one layer, over ``ctx`` latent rows:
    per head the scores over the rows' full width and the output over
    their first kv_rank columns; each live row read once (in bf16), the
    query (kv_rank + rope per head) read and the output (kv_rank per
    head) written once."""
    r, _, rope, _, h = _mla(m)
    return {"flops": 2.0 * h * ctx * (r + rope + r),
            "bytes": float(BF16 * (ctx * (r + rope) + h * (r + rope) + h * r))}


def prefill_flops(m: Dict, s: int) -> float:
    """One prompt of s tokens: every projection and FFN on every token,
    each layer's causal attention, and the logits of the last
    position."""
    per_token = m["n_layers"] * attn_token_macs(m) + _ffn_macs(m)
    return 2.0 * s * per_token + m["n_layers"] * flash_call(m, s)["flops"] \
        + 2.0 * m["d_model"] * m["vocab"]


def decode_flops(m: Dict, contexts: Iterable[int]) -> float:
    """One decode step of the rows whose new token attends ``contexts``
    latent rows each: the absorbed projections, the attention over those
    rows in every layer, the FFNs and the logits."""
    per_row = 2.0 * (m["n_layers"] * absorbed_token_macs(m) + _ffn_macs(m)
                     + m["d_model"] * m["vocab"])
    return sum(per_row + m["n_layers"] * mla_decode_call(m, c)["flops"]
               for c in contexts)
