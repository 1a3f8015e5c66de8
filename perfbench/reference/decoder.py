"""Decoder-only transformer with a mixture of experts (Granite MoE), as a
served batch: a prompt is prefilled alone into a slot, and every decode
step runs all slots at once.

The experts' capacity is shared by all the tokens of one call (a
prompt's tokens, or one token of every slot, idle slots included), so
the rows of a batch interact: the reference follows the served batch
step by step (``Replay``), the same requests in the same slots at the
same steps, fed the served tokens. Its semantics, as the configuration
states them (``model.moe``): softmax over the experts, each token's
top-k renormalised; each expert takes at most ``capacity`` tokens of the
call, its top ones by routing weight (the lower row first among equal
weights), with capacity = min(max(floor(T k factor / E), floor), T) for
T tokens; a token an expert does not take loses that expert's share.

An idle slot keeps decoding: it is fed token 0 (or the last token of
the request that just ended there), its length keeps growing, and a
position past the cache's end writes into the last one.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from perfbench.reference.common import (Precision, causal_attention, layer,
                                        logits, rms, rope, swiglu)

#: the compared requests are replayed together with the whole batch
COUPLED_ROWS = True


def moe(p, x, m, prec: Precision) -> torch.Tensor:
    """x (T, d): the experts' share of each token."""
    cfg = m["moe"]
    t, e, k = x.shape[0], cfg["n_experts"], cfg["top_k"]
    probs = torch.softmax(prec.mm(x, p["router"]), dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    if cfg["norm_topk"]:
        top = top / (top.sum(-1, keepdim=True) + 1e-9)
    route = torch.zeros_like(probs).scatter(1, idx, top)         # (T, E)
    cap = min(max(int(t * k * cfg["capacity_factor"] / e),
                  cfg["capacity_floor"]), t)
    _, order = torch.sort(route.T, dim=-1, descending=True, stable=True)
    taken = order[:, :cap]                                       # (E, cap)
    gate = torch.gather(route.T, 1, taken)                       # (E, cap)
    xs = prec.x(x)[taken]                                        # (E, cap, d)
    h = F.silu(xs @ prec.w(p["gate"])) * (xs @ prec.w(p["up"]))
    y = (prec.x(h) @ prec.w(p["down"])) * gate[..., None]
    out = torch.zeros_like(x)
    out.index_add_(0, taken.reshape(-1), y.reshape(-1, x.shape[1]))
    return out


def _qkv(a, hn, pos, m, prec):
    hd = m["head_dim"]
    b, s = hn.shape[:2]
    q = prec.mm(hn, a["wq"]).view(b, s, -1, hd)
    k = prec.mm(hn, a["wk"]).view(b, s, -1, hd)
    v = prec.mm(hn, a["wv"]).view(b, s, -1, hd)
    return (rope(q, pos, m["rope_theta"]), rope(k, pos, m["rope_theta"]), v)


def _ffn(p, x, m, prec):
    hn = rms(x, p["norm2"]["w"], m["norm_eps"])
    if m.get("moe"):
        return moe(p["moe"], hn.reshape(-1, hn.shape[-1]), m,
                   prec).view_as(x)
    return swiglu(hn, p["mlp"], prec)


class Replay:
    """The served batch, in fp32 (or the fp8 control): ``n_slots`` rows of
    keys and values ``max_len`` deep for every layer."""

    def __init__(self, params, m, n_slots: int, max_len: int,
                 prec: Precision, device):
        self.p, self.m, self.prec = params, m, prec
        shape = (m["n_layers"], n_slots, max_len, m["kv_heads"],
                 m["head_dim"])
        self.k = torch.zeros(shape, dtype=torch.float32, device=device)
        self.v = torch.zeros(shape, dtype=torch.float32, device=device)
        self.length = torch.zeros(n_slots, dtype=torch.long, device=device)
        self.max_len = max_len

    def prefill(self, slot: int, prompt: torch.Tensor) -> torch.Tensor:
        """Prefill one prompt (s,) into ``slot``; the last position's
        logits (vocab,)."""
        m, prec = self.m, self.prec
        s = prompt.shape[0]
        x = self.p["embed"]["tok"][prompt].float()[None]
        pos = torch.arange(s, device=x.device)[None]
        for i in range(m["n_layers"]):
            lp = layer(self.p["layers"], i)
            hn = rms(x, lp["norm1"]["w"], m["norm_eps"])
            q, k, v = _qkv(lp["attn"], hn, pos, m, prec)
            self.k[i, slot].zero_()
            self.v[i, slot].zero_()
            self.k[i, slot, :s] = k[0]
            self.v[i, slot, :s] = v[0]
            o = causal_attention(q[0], k[0], v[0]).reshape(1, s, -1)
            x = x + prec.mm(o, lp["attn"]["wo"])
            x = x + _ffn(lp, x, m, prec)
        self.length[slot] = s
        x = rms(x[0, -1:], self.p["final_norm"]["w"], m["norm_eps"])
        return logits(x, self.p["embed"], m["vocab"], prec)[0]

    def decode(self, tokens: torch.Tensor) -> torch.Tensor:
        """One step of every slot, fed ``tokens`` (n_slots,); logits
        (n_slots, vocab)."""
        m, prec = self.m, self.prec
        n = tokens.shape[0]
        rows = torch.arange(n, device=tokens.device)
        length = self.length
        at = length.clamp(max=self.max_len - 1)
        span = int(min(int(length.max()) + 1, self.max_len))
        valid = torch.arange(span, device=tokens.device)[None] <= length[:, None]
        x = self.p["embed"]["tok"][tokens].float()[:, None]      # (n, 1, d)
        hd, hkv = m["head_dim"], m["kv_heads"]
        for i in range(m["n_layers"]):
            lp = layer(self.p["layers"], i)
            hn = rms(x, lp["norm1"]["w"], m["norm_eps"])
            q, k, v = _qkv(lp["attn"], hn, length[:, None], m, prec)
            self.k[i, rows, at] = k[:, 0]
            self.v[i, rows, at] = v[:, 0]
            # query head j reads kv head j // (heads / kv_heads)
            qg = q[:, 0].reshape(n, hkv, -1, hd)
            sc = torch.einsum("nkgd,nskd->nkgs", qg,
                              self.k[i, :, :span]) / math.sqrt(hd)
            sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
            o = torch.einsum("nkgs,nskd->nkgd", torch.softmax(sc, -1),
                             self.v[i, :, :span])
            x = x + prec.mm(o.reshape(n, 1, -1), lp["attn"]["wo"])
            x = x + _ffn(lp, x, m, prec)
        self.length = length + 1
        x = rms(x[:, 0], self.p["final_norm"]["w"], m["norm_eps"])
        return logits(x, self.p["embed"], m["vocab"], prec)
