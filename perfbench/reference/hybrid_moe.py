"""Granite 4.0-H (``GraniteMoeHybrid``): Mamba2 mixers and a few NoPE
attention mixers, each followed by a mixture of experts with a shared
expert, as a served batch: a prompt is prefilled alone into a slot, and
every decode step runs all slots at once.

The published layer, for ``h`` the residual stream and ``r`` the
residual multiplier:

    h += r * mixer(rmsnorm(h))
    h += r * (experts(rmsnorm(h)) + shared(rmsnorm(h)))

with the embeddings multiplied by ``embedding_multiplier``, a final
RMSNorm and the tied unembedding, the logits divided by
``logits_scaling``. The mixer of layer i is the i-th entry of the
published ``layer_types`` (the first ``n_layers`` of them):

  * ``mamba``: in-projections to z, xBC and dt; a depthwise causal conv
    of xBC (``conv_kernel`` taps and a bias), then SiLU, split into x, B
    and C (one group); dt = softplus(dt + dt_bias), A = -exp(A_log); the
    SSD recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,
    y_t = C_t h_t + D x_t, per head; RMSNorm of y * silu(z); out_proj.
    The scan runs in chunks of the published ``REF_CHUNK`` (256), an
    exact rewriting of the recurrence;
  * ``attention``: grouped-query attention without position embedding,
    the scores scaled by ``attention_multiplier``.

The experts (``model.moe``) are granite-moe's: softmax over the
experts, each token's top-k renormalised (the softmax over the top-k
logits), SwiGLU experts. Departure, as the configuration states it
(``assumed``): the port's capacity dispatch, each expert taking at most
``capacity`` tokens of a call (``decoder.moe``), so the rows of a batch
interact and the reference follows the served batch step by step
(``Replay``). The shared expert is a SwiGLU of its own width, added
ungated. Idle slots follow ``decoder.py``'s rule: an idle slot keeps
decoding, fed token 0 (or the last token of the request that just ended
there), its SSM state, conv window and length move on with it, and a
position past the cache's end writes into the last one.

Memory: the served weights are 16 B parameters in bf16 here, so an fp32
copy of them (as ``common.Precision`` keeps) would not fit beside them.
Each weight is converted when it is used and dropped after
(``_Uncached``), in fp32 or, for the fp8 control, rounded to e4m3 as
``Precision`` rounds it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.common import layer, rms, to_e4m3
from perfbench.reference.decoder import moe

#: the compared requests are replayed together with the whole batch
COUPLED_ROWS = True
#: the published SSD chunk (``mamba_chunk_size``)
REF_CHUNK = 256
#: the weight stack of each kind of layer
STACKS = {"mamba": "mamba_layers", "attention": "attn_layers"}


class _Uncached:
    """``common.Precision``'s arithmetic with no weight kept: fp32 exactly,
    or fp8 with activations rounded per row and weights per tensor (per
    expert for a stack of experts) to e4m3."""

    def __init__(self, prec):
        self.kind = prec.kind

    def w(self, w: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return w.float()
        if w.dim() == 3:
            return to_e4m3(w.float().flatten(1), dim=1).view(w.shape)
        return to_e4m3(w.float())

    def x(self, x: torch.Tensor) -> torch.Tensor:
        return to_e4m3(x, dim=-1) if self.kind == "fp8" else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.x(x) @ self.w(w)


def layer_kinds(m):
    """"mamba" or "attention" for each of the model's layers."""
    return list(m["layer_types"][:m["n_layers"]])


def _sizes(m):
    s = m["ssm"]
    di = s["expand"] * m["d_model"]
    return di, di // s["head_dim"], s["state"], s["head_dim"]


def _ffn(p, x, m, prec):
    """The experts and the ungated shared expert on rmsnorm(x); x (T, d)."""
    hn = rms(x, p["norm2"]["w"], m["norm_eps"])
    sh = prec.mm(F.silu(prec.mm(hn, p["moe"]["shared_gate"]))
                 * prec.mm(hn, p["moe"]["shared_up"]), p["moe"]["shared_down"])
    return moe(p["moe"], hn, m, prec) + sh


def _conv_in(p, x, prec):
    """The in-projections of x (T, d) to z, xBC and dt."""
    xbc = torch.cat([prec.mm(x, p["x_proj"]), prec.mm(x, p["b_proj"]),
                     prec.mm(x, p["c_proj"])], dim=-1)
    return prec.mm(x, p["z_proj"]), xbc, prec.mm(x, p["dt_proj"])


def _mixer_out(p, y, z, xs, m, prec):
    """y (T, H, P) + D x, the gated RMSNorm and out_proj."""
    y = y + p["D"].float()[:, None] * xs
    y = y.reshape(y.shape[0], -1) * F.silu(z)
    return prec.mm(rms(y, p["norm_w"], m["norm_eps"]), p["out_proj"])


def ssd(xs, dt, a, bm, cm, chunk: int = REF_CHUNK):
    """The SSD recurrence from a zero state over s steps, in chunks: xs
    (s, H, P), dt (s, H), a (H,), bm/cm (s, N). Returns (y (s, H, P), the
    last state (H, N, P))."""
    s, nh, hp = xs.shape
    state = xs.new_zeros((nh, bm.shape[1], hp))
    ys = []
    for c0 in range(0, s, chunk):
        xc, dtc = xs[c0:c0 + chunk], dt[c0:c0 + chunk]
        bc, cc = bm[c0:c0 + chunk], cm[c0:c0 + chunk]
        q = xc.shape[0]
        cum = torch.cumsum(dtc * a, dim=0)                         # (q, H)
        tril = torch.ones(q, q, dtype=torch.bool, device=xs.device).tril()
        diff = cum[:, None, :] - cum[None, :, :]                   # (q, q, H)
        decay = torch.where(tril[..., None],
                            torch.exp(torch.where(tril[..., None], diff, 0.0)),
                            0.0)
        mix = (cc @ bc.T)[..., None] * decay * dtc[None]           # (q, q, H)
        y = torch.einsum("ijh,jhp->ihp", mix, xc)
        y = y + torch.einsum("in,hnp->ihp", cc, state) * torch.exp(cum)[..., None]
        w = torch.exp(cum[-1:] - cum) * dtc                         # (q, H)
        state = state * torch.exp(cum[-1])[:, None, None] + torch.einsum(
            "jh,jn,jhp->hnp", w, bc, xc)
        ys.append(y)
    return torch.cat(ys), state


def _mamba_seq(p, x, m, prec):
    """The Mamba2 mixer over one sequence x (s, d) from a zero state.
    Returns (out (s, d), the last state (H, N, P), the conv window: the
    pre-conv xBC of the last k - 1 positions, zeros before the first)."""
    di, nh, n, hp = _sizes(m)
    k = m["ssm"]["conv_kernel"]
    z, xbc, dt = _conv_in(p, x, prec)
    s = x.shape[0]
    padded = F.pad(xbc, (0, 0, k - 1, 0))
    taps = p["conv"]["taps"].float()
    conv = sum(padded[i:i + s] * taps[i] for i in range(k)) \
        + p["conv"]["b"].float()
    xs, bm, cm = F.silu(conv).split([di, n, n], dim=-1)
    dt = F.softplus(dt + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    y, state = ssd(xs.reshape(s, nh, hp), dt, a, bm, cm)
    out = _mixer_out(p, y, z, xs.reshape(s, nh, hp), m, prec)
    return out, state, padded[s:]


def _attn_qkv(p, hn, m, prec):
    hd = m["head_dim"]
    t = hn.shape[0]
    return (prec.mm(hn, p["wq"]).view(t, -1, hd),
            prec.mm(hn, p["wk"]).view(t, -1, hd),
            prec.mm(hn, p["wv"]).view(t, -1, hd))


def _causal(q, k, v, scale: float, block: int = 1024) -> torch.Tensor:
    """Causal attention of one sequence: q (s, H, hd), k/v (s, Hkv, hd),
    query head j on kv head j // (H / Hkv); query blocks of ``block``
    rows keep the scores small. Returns (s, H * hd)."""
    s, nh, hd = q.shape
    rep = nh // k.shape[1]
    kk = k.repeat_interleave(rep, dim=1).transpose(0, 1)         # (H, s, hd)
    vv = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    qq = q.transpose(0, 1)
    out = torch.empty_like(qq)
    kpos = torch.arange(s, device=q.device)
    for i in range(0, s, block):
        j = min(s, i + block)
        sc = qq[:, i:j] @ kk[:, :j].transpose(1, 2) * scale
        qpos = torch.arange(i, j, device=q.device)
        sc = sc.masked_fill(kpos[None, :j] > qpos[:, None], float("-inf"))
        out[:, i:j] = torch.softmax(sc, dim=-1) @ vv[:, :j]
    return out.transpose(0, 1).reshape(s, nh * hd)


def _attend(q, k, v, scale: float, valid):
    """One query per row: q (T, H, hd) against k/v (T, S, Hkv, hd) under
    ``valid`` (T, S); query head j reads kv head j // (H / Hkv)."""
    t, nh, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(t, hkv, nh // hkv, hd)
    sc = torch.einsum("tkgd,tskd->tkgs", qg, k) * scale
    sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
    o = torch.einsum("tkgs,tskd->tkgd", torch.softmax(sc, -1), v)
    return o.reshape(t, nh * hd)


def _logits(x, params, m, prec):
    w = params["embed"]["tok"].T[:, :m["vocab"]]
    return prec.mm(x, w) / m["logits_scaling"]


def forward(params, m, seq: torch.Tensor, pos: torch.Tensor, prec):
    """One sequence (s,) through every layer in one call (the experts'
    capacity over all its tokens); the logits at positions ``pos``."""
    prec = _Uncached(prec)
    r = m["residual_multiplier"]
    x = params["embed"]["tok"][seq].float() * m["embedding_multiplier"]
    at = {"mamba": 0, "attention": 0}
    for kind in layer_kinds(m):
        lp = layer(params[STACKS[kind]], at[kind])
        at[kind] += 1
        hn = rms(x, lp["norm1"]["w"], m["norm_eps"])
        if kind == "mamba":
            x = x + r * _mamba_seq(lp["mamba"], hn, m, prec)[0]
        else:
            q, k, v = _attn_qkv(lp["attn"], hn, m, prec)
            o = _causal(q, k, v, m["attention_multiplier"])
            x = x + r * prec.mm(o, lp["attn"]["wo"])
        x = x + r * _ffn(lp, x, m, prec)
    x = rms(x[pos], params["final_norm"]["w"], m["norm_eps"])
    return _logits(x, params, m, prec)


class Replay:
    """The served batch, in fp32 (or the fp8 control): for every slot the
    keys and values of each attention layer ``max_len`` deep, and the SSM
    state and conv window of each Mamba2 layer."""

    def __init__(self, params, m, n_slots: int, max_len: int, prec, device):
        self.p, self.m, self.prec = params, m, _Uncached(prec)
        kinds = layer_kinds(m)
        di, nh, n, hp = _sizes(m)
        f32 = dict(dtype=torch.float32, device=device)
        kv = (kinds.count("attention"), n_slots, max_len, m["kv_heads"],
              m["head_dim"])
        self.k, self.v = torch.zeros(kv, **f32), torch.zeros(kv, **f32)
        nm = kinds.count("mamba")
        self.h = torch.zeros((nm, n_slots, nh, n, hp), **f32)
        self.conv = torch.zeros((nm, n_slots, m["ssm"]["conv_kernel"] - 1,
                                 di + 2 * n), **f32)
        self.length = torch.zeros(n_slots, dtype=torch.long, device=device)
        self.max_len = max_len

    def _layers(self):
        """(kind, index in its stack, the layer's params) in layer order."""
        at = {"mamba": 0, "attention": 0}
        for kind in layer_kinds(self.m):
            i = at[kind]
            at[kind] += 1
            yield kind, i, layer(self.p[STACKS[kind]], i)

    def prefill(self, slot: int, prompt: torch.Tensor) -> torch.Tensor:
        """Prefill one prompt (s,) into ``slot``; the last position's
        logits (vocab,)."""
        m, prec = self.m, self.prec
        r = m["residual_multiplier"]
        s = prompt.shape[0]
        x = self.p["embed"]["tok"][prompt].float() * m["embedding_multiplier"]
        for kind, i, lp in self._layers():
            hn = rms(x, lp["norm1"]["w"], m["norm_eps"])
            if kind == "mamba":
                out, state, window = _mamba_seq(lp["mamba"], hn, m, prec)
                self.h[i, slot] = state
                self.conv[i, slot] = window
            else:
                q, k, v = _attn_qkv(lp["attn"], hn, m, prec)
                self.k[i, slot].zero_()
                self.v[i, slot].zero_()
                self.k[i, slot, :s] = k
                self.v[i, slot, :s] = v
                out = prec.mm(_causal(q, k, v, m["attention_multiplier"]),
                              lp["attn"]["wo"])
            x = x + r * out
            x = x + r * _ffn(lp, x, m, prec)
        self.length[slot] = s
        x = rms(x[-1:], self.p["final_norm"]["w"], m["norm_eps"])
        return _logits(x, self.p, m, prec)[0]

    def decode(self, tokens: torch.Tensor) -> torch.Tensor:
        """One step of every slot, fed ``tokens`` (n_slots,); logits
        (n_slots, vocab)."""
        m, prec = self.m, self.prec
        r = m["residual_multiplier"]
        di, nh, n, hp = _sizes(m)
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        length = self.length
        at = length.clamp(max=self.max_len - 1)
        span = int(min(int(length.max()) + 1, self.max_len))
        valid = torch.arange(span, device=tokens.device)[None] \
            <= length[:, None]
        x = self.p["embed"]["tok"][tokens].float() * m["embedding_multiplier"]
        for kind, i, lp in self._layers():
            hn = rms(x, lp["norm1"]["w"], m["norm_eps"])
            if kind == "mamba":
                out = self._mamba_step(lp["mamba"], hn, i)
            else:
                q, k, v = _attn_qkv(lp["attn"], hn, m, prec)
                self.k[i, rows, at] = k
                self.v[i, rows, at] = v
                o = _attend(q, self.k[i, :, :span], self.v[i, :, :span],
                            m["attention_multiplier"], valid)
                out = prec.mm(o, lp["attn"]["wo"])
            x = x + r * out
            x = x + r * _ffn(lp, x, m, prec)
        self.length = length + 1
        x = rms(x, self.p["final_norm"]["w"], m["norm_eps"])
        return _logits(x, self.p, m, prec)

    def _mamba_step(self, p, x, i: int) -> torch.Tensor:
        """One recurrent step of Mamba2 layer i for every slot; x (n, d)."""
        m, prec = self.m, self.prec
        di, nh, n, hp = _sizes(m)
        z, xbc, dt = _conv_in(p, x, prec)
        window = torch.cat([self.conv[i], xbc[:, None]], dim=1)    # (n, k, C)
        self.conv[i] = window[:, 1:]
        conv = torch.einsum("tkc,kc->tc", window, p["conv"]["taps"].float()) \
            + p["conv"]["b"].float()
        xs, bm, cm = F.silu(conv).split([di, n, n], dim=-1)
        dt = F.softplus(dt + p["dt_bias"].float())                  # (n, H)
        decay = torch.exp(dt * -torch.exp(p["A_log"].float()))
        xs = xs.reshape(-1, nh, hp)
        self.h[i] = self.h[i] * decay[..., None, None] + torch.einsum(
            "th,tn,thp->thnp", dt, bm, xs)
        y = torch.einsum("tn,thnp->thp", cm, self.h[i])
        return _mixer_out(p, y, z, xs, m, prec)
