"""DeepSeek-V2 (-Lite): multi-head latent attention, a leading dense
layer, then experts with shared ones, as a served batch: a prompt is
prefilled alone into a slot, and every decode step runs all slots at
once.

The published layer (``DeepseekV2DecoderLayer``), for ``h`` the
residual stream:

    h += attn(rmsnorm(h))
    h += ffn(rmsnorm(h))

with untied embeddings, a final RMSNorm and every norm at ``norm_eps``.
The attention (``DeepseekV2Attention`` without ``q_lora_rank``), per
token, for H heads:

    q = x W_q                  H x (nope + rope): [q_nope, q_pe]
    [c, k_pe] = x W_kv_a       kv_rank + rope, k_pe shared by the heads
    [k_nope, v] = rmsnorm(c) W_kv_b      H x (nope + v)
    q_pe, k_pe rotated: de-interleaved, then rotate-half with YaRN's
    frequencies and cos/sin (``DeepseekV2YarnRotaryEmbedding``)
    o = softmax([q_nope, q_pe] . [k_nope, k_pe] * scale) v, causal
    out = o W_o

with scale = (nope + rope)^-1/2 * mscale(factor, mscale_all_dim)^2. The
first ``dense_layers`` FFNs are a SwiGLU of width ``d_ff``; the others
the experts (``model.moe``): softmax over the experts, each token's
top-k weights as they are (not renormalised, scaled by 1), SwiGLU
experts, plus the shared experts as one ungated SwiGLU of width
``shared_ff``.

Departures, as the configuration states them: the port's capacity
dispatch (``moe``, as ``decoder.moe``: each expert takes at most
``capacity`` tokens of a call), so the rows of a batch interact and the
reference follows the served batch step by step (``Replay``); the
replay keeps its latent cache in the model's type (``model.dtype``:
bf16), as the program does (fp32 rows of 16,384 positions for 32 slots
and 27 layers would not fit beside the served weights); the card's
products run through ``fmm``, below; and ``Replay.decode`` takes the
absorbed product (q_nope W_uk^T against c, then W_uv after the
attention), which equals the expanded one by associativity. Idle slots
follow ``decoder.py``'s rule.

Products (``fmm``): on the card an fp32 activation times a bf16 weight
or latent row is three bf16 products on the tensor cores, one for each
of three bf16 parts that sum to the activation, accumulated and summed
in fp32. Each product of two bf16 numbers is exact in fp32, so only the
additions round, as in an fp32 product (the tensor cores may truncate
each: within fp32's worst-case bound, (K + 2) 2^-23 of the products'
magnitudes, against the program's bf16 2^-8); it reads the weights and
the cached rows as they are, with no fp32 copy of them. Elsewhere, and
for fp32 weights, the operand is converted and the product is plain
fp32. The prefill's attention, whose operands are both fp32, stays
plain fp32. For the fp8 control each weight is rounded to e4m3 when it
is used and dropped after (``hybrid_moe._Uncached``).
"""
from __future__ import annotations

import math

import contextlib

import torch
import torch.nn.functional as F

from perfbench.reference.common import layer, rms
from perfbench.reference.hybrid_moe import _Uncached

#: the compared requests are replayed together with the whole batch
COUPLED_ROWS = True
#: the query rows of one block of the prefill's causal attention
BLOCK = 1024


def _parts(x: torch.Tensor):
    """x (fp32) as three bf16 tensors that sum to it, each the rounding of
    what the ones before leave (24 significant bits in all)."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


@contextlib.contextmanager
def _full_reductions():
    """cuBLAS's bf16 products reduced in fp32 only, for the duration."""
    flags = torch.backends.cuda.matmul
    old = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = old


def fmm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x @ y in fp32, for x fp32 (2-D, or 3-D batched against 3-D y). On
    the card with y bf16: the three parts of x stacked along the rows,
    one bf16 product with fp32 accumulation and output, the parts'
    results summed; otherwise y converted to fp32."""
    if not (x.is_cuda and y.dtype == torch.bfloat16):
        return x @ y.float()
    t = x.shape[-2]
    parts = torch.cat(_parts(x), dim=-2)
    with _full_reductions():
        out = (torch.mm if x.dim() == 2 else torch.bmm)(
            parts, y, out_dtype=torch.float32)
    return out.unflatten(-2, (3, t)).sum(-3)


class _Prec(_Uncached):
    """``_Uncached`` with its fp32 products through ``fmm``: the weights
    are read in their own type, not converted per use."""

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return fmm(x, w) if self.kind == "fp32" else super().mm(x, w)


def moe(p, x, m, prec) -> torch.Tensor:
    """``decoder.moe`` (the capacity dispatch) with the experts' products
    through ``prec.mm``; x (T, d): the experts' share of each token."""
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
    xs = x[taken]                                                # (E, cap, d)
    h = F.silu(prec.mm(xs, p["gate"])) * prec.mm(xs, p["up"])
    y = prec.mm(h, p["down"]) * gate[..., None]
    out = torch.zeros_like(x)
    out.index_add_(0, taken.reshape(-1), y.reshape(-1, x.shape[1]))
    return out


def _stacks(m):
    """(the weight stack, the row in it) of each layer: the dense layers
    lead, then the expert layers."""
    k = m["dense_layers"]
    return [("dense_layers", i) if i < k else ("layers", i - k)
            for i in range(m["n_layers"])]


def _yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def softmax_scale(m) -> float:
    a, y = m["mla"], m["yarn"]
    scale = (a["nope_dim"] + a["rope_dim"]) ** -0.5
    if y["mscale_all_dim"]:
        ms = _yarn_mscale(y["factor"], y["mscale_all_dim"])
        scale = scale * ms * ms
    return scale


def yarn_inv_freq(m, device) -> torch.Tensor:
    """``DeepseekV2YarnRotaryEmbedding``'s inverse frequencies (rope
    dims / 2,)."""
    dim, base, y = m["mla"]["rope_dim"], m["rope_theta"], m["yarn"]
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / base ** exps
    inter = 1.0 / (y["factor"] * base ** exps)

    def corr_dim(rot):
        return (dim * math.log(y["original_max_pos"] / (rot * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(corr_dim(y["beta_fast"])), 0)
    high = min(math.ceil(corr_dim(y["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def rope(x: torch.Tensor, pos: torch.Tensor, m) -> torch.Tensor:
    """DeepSeek's rope on x (t, heads, rope_dim), stored interleaved:
    de-interleaved, then rotate-half, at positions pos (t,). The
    published mscale equals mscale_all_dim, so cos and sin are unscaled."""
    t, nh, d = x.shape
    ang = pos.float()[:, None] * yarn_inv_freq(m, x.device)[None]
    emb = torch.cat([ang, ang], dim=-1)
    cos, sin = emb.cos()[:, None], emb.sin()[:, None]
    x = x.reshape(t, nh, d // 2, 2).transpose(-1, -2).reshape(t, nh, d)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos + rot * sin


def _projections(a, hn, pos, m, prec):
    """(q_nope (t, H, nope), q_pe (t, H, rope) rotated, c (t, kv_rank)
    normalised, k_pe (t, rope) rotated) of hn (t, d)."""
    mla, nh = m["mla"], m["n_heads"]
    t = hn.shape[0]
    q = prec.mm(hn, a["wq"]).view(t, nh, mla["nope_dim"] + mla["rope_dim"])
    q_nope, q_pe = q.split([mla["nope_dim"], mla["rope_dim"]], dim=-1)
    kv = prec.mm(hn, a["wkv_a"])
    c = rms(kv[:, :mla["kv_rank"]], a["kv_norm"]["w"], m["norm_eps"])
    k_pe = rope(kv[:, None, mla["kv_rank"]:], pos, m)[:, 0]
    return q_nope, rope(q_pe, pos, m), c, k_pe


def _expanded(a, q_nope, q_pe, c, k_pe, m, prec):
    """Causal attention of one sequence from its latent, expanded: (s, H
    v), query blocks of ``BLOCK`` rows keeping the scores small."""
    mla, nh = m["mla"], m["n_heads"]
    s = c.shape[0]
    kv = prec.mm(c, a["wkv_b"]).view(s, nh, mla["nope_dim"] + mla["v_dim"])
    k_nope, v = kv.split([mla["nope_dim"], mla["v_dim"]], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1).transpose(0, 1)        # (H, s, qk)
    k = torch.cat([k_nope, k_pe[:, None].expand(s, nh, mla["rope_dim"])],
                  dim=-1).transpose(0, 1)
    v = v.transpose(0, 1)
    scale = softmax_scale(m)
    out = torch.empty((nh, s, mla["v_dim"]), dtype=q.dtype, device=q.device)
    kpos = torch.arange(s, device=q.device)
    for i in range(0, s, BLOCK):
        j = min(s, i + BLOCK)
        sc = q[:, i:j] @ k[:, :j].transpose(1, 2) * scale
        qpos = torch.arange(i, j, device=q.device)
        sc = sc.masked_fill(kpos[None, :j] > qpos[:, None], float("-inf"))
        out[:, i:j] = torch.softmax(sc, dim=-1) @ v[:, :j]
    return out.transpose(0, 1).reshape(s, nh * mla["v_dim"])


def _ffn(p, x, m, prec):
    """The dense SwiGLU, or the experts and the ungated shared experts, on
    rmsnorm(x); x (t, d)."""
    hn = rms(x, p["norm2"]["w"], m["norm_eps"])
    if "mlp" in p:
        w = p["mlp"]
        return prec.mm(F.silu(prec.mm(hn, w["gate"])) * prec.mm(hn, w["up"]),
                       w["down"])
    e = p["moe"]
    sh = prec.mm(F.silu(prec.mm(hn, e["shared_gate"]))
                 * prec.mm(hn, e["shared_up"]), e["shared_down"])
    return moe(e, hn, m, prec) + sh


def _logits(x, params, m, prec):
    x = rms(x, params["final_norm"]["w"], m["norm_eps"])
    return prec.mm(x, params["embed"]["out"][:, :m["vocab"]])


def forward(params, m, seq: torch.Tensor, pos: torch.Tensor, prec):
    """One sequence (s,) through every layer in one call (the experts'
    capacity over all its tokens), the published expanded attention; the
    logits at positions ``pos``."""
    prec = _Prec(prec)
    x = params["embed"]["tok"][seq].float()
    at = torch.arange(seq.shape[0], device=seq.device)
    for stack, i in _stacks(m):
        lp = layer(params[stack], i)
        hn = rms(x, lp["norm1"]["w"], m["norm_eps"])
        q_nope, q_pe, c, k_pe = _projections(lp["attn"], hn, at, m, prec)
        o = _expanded(lp["attn"], q_nope, q_pe, c, k_pe, m, prec)
        x = x + prec.mm(o, lp["attn"]["wo"])
        x = x + _ffn(lp, x, m, prec)
    return _logits(x[pos], params, m, prec)


class Replay:
    """The served batch, in fp32 (or the fp8 control): for every layer and
    slot the latent rows [c, k_pe] ``max_len`` deep, kept in the model's
    type."""

    def __init__(self, params, m, n_slots: int, max_len: int, prec, device):
        self.p, self.m, self.prec = params, m, _Prec(prec)
        mla = m["mla"]
        self.rows = torch.zeros(
            (m["n_layers"], n_slots, max_len, mla["kv_rank"] + mla["rope_dim"]),
            dtype=getattr(torch, m["dtype"]), device=device)
        self.length = torch.zeros(n_slots, dtype=torch.long, device=device)
        self.max_len = max_len

    def _layers(self):
        for n, (stack, i) in enumerate(_stacks(self.m)):
            yield n, layer(self.p[stack], i)

    def prefill(self, slot: int, prompt: torch.Tensor) -> torch.Tensor:
        """Prefill one prompt (s,) into ``slot``; the last position's
        logits (vocab,)."""
        m, prec = self.m, self.prec
        s = prompt.shape[0]
        x = self.p["embed"]["tok"][prompt].float()
        at = torch.arange(s, device=x.device)
        for n, lp in self._layers():
            hn = rms(x, lp["norm1"]["w"], m["norm_eps"])
            q_nope, q_pe, c, k_pe = _projections(lp["attn"], hn, at, m, prec)
            self.rows[n, slot].zero_()
            self.rows[n, slot, :s] = torch.cat([c, k_pe], dim=-1)
            o = _expanded(lp["attn"], q_nope, q_pe, c, k_pe, m, prec)
            x = x + prec.mm(o, lp["attn"]["wo"])
            x = x + _ffn(lp, x, m, prec)
        self.length[slot] = s
        return _logits(x[-1:], self.p, m, prec)[0]

    def decode(self, tokens: torch.Tensor) -> torch.Tensor:
        """One step of every slot, fed ``tokens`` (n_slots,); logits
        (n_slots, vocab)."""
        m, prec = self.m, self.prec
        mla, nh = m["mla"], m["n_heads"]
        r = mla["kv_rank"]
        n = tokens.shape[0]
        slots = torch.arange(n, device=tokens.device)
        length = self.length
        at = length.clamp(max=self.max_len - 1)
        span = int(min(int(length.max()) + 1, self.max_len))
        valid = torch.arange(span, device=tokens.device)[None] \
            <= length[:, None]
        scale = softmax_scale(m)
        x = self.p["embed"]["tok"][tokens].float()
        for i, lp in self._layers():
            a = lp["attn"]
            hn = rms(x, lp["norm1"]["w"], m["norm_eps"])
            q_nope, q_pe, c, k_pe = _projections(a, hn, length, m, prec)
            self.rows[i, slots, at] = torch.cat([c, k_pe], dim=-1).to(
                self.rows.dtype)
            rows = self.rows[i, :, :span]                       # (n, S, R)
            c, pe = rows[..., :r], rows[..., r:]
            w = prec.w(a["wkv_b"]).view(r, nh, mla["nope_dim"] + mla["v_dim"])
            w_uk, w_uv = w.split([mla["nope_dim"], mla["v_dim"]], dim=-1)
            q_abs = torch.einsum("nhd,chd->nhc", prec.x(q_nope), w_uk)
            # batched products over the rows in place (no copy of them)
            sc = (fmm(q_abs, c.transpose(1, 2))
                  + fmm(q_pe, pe.transpose(1, 2))) * scale
            sc = sc.masked_fill(~valid[:, None, :], float("-inf"))
            o_lat = fmm(torch.softmax(sc, -1), c)
            o = torch.einsum("nhc,chv->nhv", prec.x(o_lat), w_uv)
            x = x + prec.mm(o.reshape(n, nh * mla["v_dim"]), a["wo"])
            x = x + _ffn(lp, x, m, prec)
        self.length = length + 1
        return _logits(x, self.p, m, prec)
