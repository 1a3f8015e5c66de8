"""Operations and bytes of a hybrid_moe model's calls (granite-4.0-h:
Mamba2 or attention mixers, each followed by experts), from shapes
alone, counted as ``flops.py`` counts a decoder's: the work of the call,
whatever implements it. A multiply-add is 2 operations; the experts
count each token's top-k and the shared expert, not capacity padding;
causal attention counts its s (s + 1) / 2 pairs on the attention layers
alone. Bytes count each input read once and each output written once.

``m`` is the ``model`` dict of a configuration file; its
``layer_types`` (the first ``n_layers``) say which layer has which
mixer.
"""
from __future__ import annotations

from typing import Dict, Iterable

BF16, F32 = 2, 4


def kinds(m: Dict):
    """"mamba" or "attention" for each layer."""
    return list(m["layer_types"][:m["n_layers"]])


def _ssm(m: Dict):
    """(d_inner, heads, state N, head dim P) of the Mamba2 mixer."""
    s = m["ssm"]
    di = s["expand"] * m["d_model"]
    return di, di // s["head_dim"], s["state"], s["head_dim"]


def mamba_token_macs(m: Dict) -> int:
    """One token through a Mamba2 mixer's projections (z, x, B, C, dt in;
    out) and its conv over x, B and C."""
    d = m["d_model"]
    di, h, n, _ = _ssm(m)
    return d * (2 * di + 2 * n + h) + di * d \
        + m["ssm"]["conv_kernel"] * (di + 2 * n)


def attn_token_macs(m: Dict) -> int:
    """One token through an attention mixer's q, k, v and o projections."""
    return m["d_model"] * m["head_dim"] * (2 * m["n_heads"]
                                           + 2 * m["kv_heads"])


def moe_token_macs(m: Dict) -> int:
    """One token through the router, its top-k experts and the shared
    expert."""
    d, e = m["d_model"], m["moe"]
    return d * e["n_experts"] + 3 * d * (e["top_k"] * e["expert_ff"]
                                         + e["shared_ff"])


def _layers_token_macs(m: Dict) -> int:
    mixer = {"mamba": mamba_token_macs(m), "attention": attn_token_macs(m)}
    return sum(mixer[k] + moe_token_macs(m) for k in kinds(m))


def ssd_call(m: Dict, s: int) -> Dict[str, float]:
    """The SSD scan of one prompt of s tokens (unpadded) at the model's
    chunk Q, per head: in each chunk of q rows (the last holds what is
    left) the q (q + 1) / 2 causal pairs of C_i . B_j and of the mixing
    with x, the chunk's state B^T (w x) and its read C . h, q N P each,
    and the state's update, N P. Bytes: x, B and C in the model's type
    and log a, dt in fp32 read once; y in the model's type and the last
    state in fp32 written once."""
    _, h, n, p = _ssm(m)
    q_max = m["ssm"]["chunk"]
    macs = 0.0
    for c0 in range(0, s, q_max):
        q = min(q_max, s - c0)
        macs += q * (q + 1) / 2 * (n + p) + 2 * q * n * p + n * p
    return {"flops": 2.0 * h * macs,
            "bytes": float(BF16 * (2 * s * h * p + 2 * s * n)
                           + F32 * (2 * s * h + h * n * p))}


def prefill_flops(m: Dict, s: int) -> float:
    """One prompt of s tokens: every projection and expert on every token,
    the SSD scans, causal attention on the attention layers, and the
    logits of the last position."""
    ks = kinds(m)
    total = 2.0 * s * _layers_token_macs(m) + 2.0 * m["d_model"] * m["vocab"]
    total += ks.count("mamba") * ssd_call(m, s)["flops"]
    total += ks.count("attention") * 4.0 * m["n_heads"] * m["head_dim"] \
        * s * (s + 1) / 2
    return total


def decode_flops(m: Dict, contexts: Iterable[int]) -> float:
    """One decode step of the rows whose new token attends ``contexts``
    positions each: projections and experts, each Mamba2 layer's state
    update and read (2 N P multiply-adds a head), attention over those
    positions on the attention layers, the logits."""
    ks = kinds(m)
    _, h, n, p = _ssm(m)
    per_row = 2.0 * _layers_token_macs(m) + 2.0 * m["d_model"] * m["vocab"] \
        + ks.count("mamba") * 2.0 * h * 2 * n * p
    attn = 4.0 * m["n_heads"] * m["head_dim"] * ks.count("attention")
    return sum(per_row + attn * ctx for ctx in contexts)
