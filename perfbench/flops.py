"""Operations and bytes of the work a call does, from shapes alone.

What is counted is the work of the call, whatever implements it, so a
later kernel that computes the same thing in other launches reads the
same bound. A multiply-add is 2 operations. Causal attention counts the
s (s + 1) / 2 query-key pairs it needs, not the square; a mixture of
experts counts the top-k experts of each token, not capacity padding.
Bytes count each input read once and each output written once.

``m`` is the ``model`` dict of a configuration file (``configs/*.json``).
"""
from __future__ import annotations

from typing import Dict, Iterable

BF16 = 2


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

def flash_call(b: int, s: int, h: int, hkv: int, d: int,
               itemsize: int = BF16) -> Dict[str, float]:
    """Causal self-attention over s positions: QK^T and PV on the
    s (s + 1) / 2 causal pairs of each head; q, k, v read and o written
    once."""
    pairs = s * (s + 1) / 2
    return {"flops": 4.0 * b * h * d * pairs,
            "bytes": float(itemsize * b * s * d * (2 * h + 2 * hkv))}


# --------------------------------------------------------------------------
# the model's calls
# --------------------------------------------------------------------------

def _attn_macs(m: Dict, heads: int, kv_heads: int) -> int:
    hd = m["head_dim"]
    return m["d_model"] * hd * (2 * heads + 2 * kv_heads)


def _ffn_macs(m: Dict, d_ff: int) -> int:
    if m.get("moe"):
        moe = m["moe"]
        return (m["d_model"] * moe["n_experts"]
                + moe["top_k"] * 3 * m["d_model"] * moe["expert_ff"])
    return 3 * m["d_model"] * d_ff


def _layer_token_macs(m: Dict) -> int:
    """Multiply-adds of one token through every layer's projections."""
    return m["n_layers"] * (_attn_macs(m, m["n_heads"], m["kv_heads"])
                            + _ffn_macs(m, m["d_ff"]))


def flash_calls_of_prefill(m: Dict, s: int):
    """The (b, s, h, hkv, d) of each causal attention a prefill runs."""
    return [(1, s, m["n_heads"], m["kv_heads"], m["head_dim"])] \
        * m["n_layers"]


def prefill_flops(m: Dict, s: int) -> float:
    """One prompt of s tokens: every projection on every token, causal
    attention, and the logits of the last position."""
    total = 2.0 * s * _layer_token_macs(m) + 2.0 * m["d_model"] * m["vocab"]
    total += sum(flash_call(*c)["flops"] for c in flash_calls_of_prefill(m, s))
    return total


def decode_flops(m: Dict, contexts: Iterable[int]) -> float:
    """One decode step of the rows whose new token attends ``contexts``
    positions each (its cache and itself): projections, attention over
    those positions, the logits."""
    per_row = 2.0 * _layer_token_macs(m) + 2.0 * m["d_model"] * m["vocab"]
    attn = 4.0 * m["n_heads"] * m["head_dim"] * m["n_layers"]
    return sum(per_row + attn * ctx for ctx in contexts)
