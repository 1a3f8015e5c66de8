"""xLSTM blocks: mLSTM (matrix memory, parallelizable) and sLSTM (scalar
memory, recurrent), Beck et al., arXiv:2405.04517 (counterpart of
``repro.models.xlstm``).

The mLSTM runs in one of two forms that compute the same function: the
parallel form (stabilised gated linear attention, dense S x S per head)
up to ``MLSTM_CHUNK_THRESHOLD`` tokens, and the chunkwise form above it
and in every prefill, which also returns the matrix memory for decode.
Decode is the O(1) matrix-memory recurrence. The sLSTM is a token by
token exponential-gating recurrence: a Python loop where the reference
runs ``lax.scan`` (the reference has no kernel for either).

Cast points are the reference's: the gate pre-activations and the sLSTM
input projection are fp32 products of fp32 weights; the parallel form
casts its weights to the activation type before the PV product and
divides by the normaliser in that type; the chunkwise form and decode
work in fp32 with ``d**-0.25`` on q and k each, and cast out once.

Decode updates its state in place (the reference returns new arrays):
the mLSTM's C is (b, heads, d, d) fp32, 4 MiB per slot and layer at
xlstm-350m's width.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import per_shard, replicated
from repro_torch.models.layers import dense_init, normal, rms_norm
from repro_torch.models.mamba2 import _causal_conv, chunk_len

Tree = Dict[str, torch.Tensor]

#: the stabilisers' start, as in the reference
M_INIT = -1e30


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    n_heads: int = 4
    expand: int = 2          # mLSTM up-projection factor
    conv_kernel: int = 4
    slstm_every: int = 8     # every k-th block is an sLSTM block
    ffn_factor: float = 4.0 / 3.0


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def make_mlstm_params(gen, d_model: int, cfg: XLSTMConfig, dtype,
                      device) -> Tree:
    """The reference's keys and (in, out) layout; the gate weights and
    biases are fp32 whatever the model dtype."""
    di = cfg.expand * d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "up": dense_init(gen, d_model, 2 * di, dtype, device),
        "conv": normal(gen, (cfg.conv_kernel, di), dtype,
                       cfg.conv_kernel ** -0.5, device),
        "wq": dense_init(gen, di, di, dtype, device),
        "wk": dense_init(gen, di, di, dtype, device),
        "wv": dense_init(gen, di, di, dtype, device),
        "w_if": dense_init(gen, di, 2 * cfg.n_heads, torch.float32, device),
        "b_if": torch.cat([torch.zeros(cfg.n_heads, **f32),
                           torch.full((cfg.n_heads,), 3.0, **f32)]),
        "norm_w": torch.ones(di, dtype=dtype, device=device),
        "down": dense_init(gen, di, d_model, dtype, device,
                           scale=di ** -0.5),
    }


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``; a DTensor gate runs it replicated, as DTensor has
    no sharding strategy for its backward (``aten.log_sigmoid_backward``)."""
    return replicated(F.logsigmoid, x)


def mlstm_axes() -> Tree:
    """The logical axes of :func:`make_mlstm_params`' tree."""
    return {"up": ("embed", "inner"), "conv": ("conv", "inner"),
            "wq": ("inner", "inner"), "wk": ("inner", "inner"),
            "wv": ("inner", "inner"), "w_if": ("inner", "gates"),
            "b_if": ("gates",), "norm_w": ("inner",),
            "down": ("inner", "embed")}


def _mlstm_parallel(q, k, v, i_pre, f_pre) -> torch.Tensor:
    """Stabilised parallel mLSTM.

    q/k/v: (b, s, h, d); i_pre/f_pre: (b, s, h) fp32 pre-activations.
    D[i,j] = sum_{t=j+1..i} log sigmoid(f_t) + i_j (j <= i); m_i = max_j D;
    h = (q k^T / sqrt(d) * exp(D - m)) v / max(|row sum|, exp(-m)).
    """
    s, d = q.shape[1], q.shape[3]
    cum_f = torch.cumsum(_log_sigmoid(f_pre), dim=1)               # (b,s,h)
    dmat = (cum_f[:, :, None, :] - cum_f[:, None, :, :]
            + i_pre[:, None, :, :])                                # (b,i,j,h)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    dmat = dmat.masked_fill(~mask[None, :, :, None], float("-inf"))
    m = dmat.amax(dim=2, keepdim=True)                             # (b,i,1,h)
    dexp = torch.exp(dmat - m)
    scores = torch.einsum("bihd,bjhd->bijh", q, k) * (d ** -0.5)
    w = scores.float() * dexp
    norm = torch.maximum(w.sum(dim=2).abs(), torch.exp(-m[:, :, 0, :]))
    out = torch.einsum("bijh,bjhd->bihd", w.to(q.dtype), v)
    return out / norm[..., None].to(q.dtype)


def init_mlstm_state(batch: int, heads: int, d: int, device) -> Tree:
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, heads, d, d), **f32),
            "n": torch.zeros((batch, heads, d), **f32),
            "m": torch.full((batch, heads), M_INIT, **f32)}


def _mlstm_chunked(q, k, v, i_pre, f_pre, chunk: int = 128,
                   state0: Optional[Tree] = None
                   ) -> Tuple[torch.Tensor, Tree]:
    """Chunkwise-parallel stabilised mLSTM, the same function as
    :func:`_mlstm_parallel` in O(S * chunk) memory.

    Phase A (all chunks at once): each chunk's intra-chunk numerator and
    denominator under a local stabiliser, and its state summary. Then a
    loop over the chunks carries the matrix memory (C, n, m). Phase B
    merges the incoming state with the intra part under a joint
    stabiliser. All in fp32; the output is cast to q's type once.

    q/k/v: (b, s, h, d); i_pre/f_pre: (b, s, h) fp32. Returns (out
    (b, s, h, d), state {C, n, m} after the last token).
    """
    b, s, h, d = q.shape
    chunk = chunk_len(s, chunk)
    nc = s // chunk
    scale = d ** -0.25                       # applied to q and k each
    resh = lambda x: x.reshape(b, nc, chunk, *x.shape[2:])
    qc, kc = resh(q.float() * scale), resh(k.float() * scale)
    vc = resh(v.float())
    ic, fc = resh(i_pre), resh(f_pre)
    if state0 is None:
        state0 = init_mlstm_state(b, h, d, q.device)

    # ---- phase A: every chunk at once -------------------------------------
    cum = torch.cumsum(_log_sigmoid(fc), dim=2)   # (b,c,q,h), inclusive
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()
    dmat = (cum[:, :, :, None, :] - cum[:, :, None, :, :]
            + ic[:, :, None, :, :])               # (b,c,q,k,h)
    dmat = dmat.masked_fill(~tri[None, None, :, :, None], float("-inf"))
    m_intra = dmat.amax(dim=3)                    # (b,c,q,h)
    dexp = torch.exp(dmat - m_intra[:, :, :, None, :])
    scores = torch.einsum("bcqhd,bckhd->bcqkh", qc, kc) * dexp
    num_intra = torch.einsum("bcqkh,bckhe->bcqhe", scores, vc)
    den_intra = scores.sum(dim=3)                 # (b,c,q,h)

    # per-chunk state summaries (to the chunk's end), local stabiliser m_g
    cum_q = cum[:, :, -1, :]                      # (b,c,h)
    g = cum_q[:, :, None, :] - cum + ic           # (b,c,q,h)
    m_g = g.amax(dim=2)                           # (b,c,h)
    wj = torch.exp(g - m_g[:, :, None, :])
    big_g = torch.einsum("bcqh,bcqhd,bcqhe->bchde", wj, kc, vc)
    ng = torch.einsum("bcqh,bcqhd->bchd", wj, kc)

    # ---- the loop over chunks: carry (C, n, m), keep each incoming one ----
    st = state0
    prevs = []
    for c in range(nc):
        prevs.append(st)
        m_new = torch.maximum(st["m"] + cum_q[:, c], m_g[:, c])
        w0 = torch.exp(st["m"] + cum_q[:, c] - m_new)
        w1 = torch.exp(m_g[:, c] - m_new)
        st = {"C": st["C"] * w0[..., None, None]
              + big_g[:, c] * w1[..., None, None],
              "n": st["n"] * w0[..., None] + ng[:, c] * w1[..., None],
              "m": m_new}
    c_prev = torch.stack([p["C"] for p in prevs], dim=1)   # (b,c,h,d,d)
    n_prev = torch.stack([p["n"] for p in prevs], dim=1)   # (b,c,h,d)
    m_prev = torch.stack([p["m"] for p in prevs], dim=1)   # (b,c,h)

    # ---- phase B: merge the state and intra tracks -------------------------
    m_state = m_prev[:, :, None, :] + cum         # (b,c,q,h)
    m_i = torch.maximum(m_state, m_intra)
    w_state = torch.exp(m_state - m_i)
    w_intra = torch.exp(m_intra - m_i)
    num = (num_intra * w_intra[..., None]
           + torch.einsum("bcqhd,bchde->bcqhe", qc, c_prev)
           * w_state[..., None])
    den = (den_intra * w_intra
           + torch.einsum("bcqhd,bchd->bcqh", qc, n_prev) * w_state)
    den = torch.maximum(den.abs(), torch.exp(-m_i))
    out = (num / den[..., None]).reshape(b, s, h, d)
    return out.to(q.dtype), st


#: sequences above this take the chunkwise mLSTM form
MLSTM_CHUNK_THRESHOLD = 512


def apply_mlstm(params: Tree, x: torch.Tensor, cfg: XLSTMConfig,
                return_state: bool = False):
    """Full-sequence mLSTM block (the caller adds the residual). With
    ``return_state`` it returns (out, state, xm), xm the conv's input."""
    b, s, _ = x.shape
    di = params["wq"].shape[0]
    h = cfg.n_heads
    d = di // h
    xm, z = (x @ params["up"]).chunk(2, dim=-1)
    xc = F.silu(_causal_conv(xm, params["conv"]))
    q = (xc @ params["wq"]).reshape(b, s, h, d)
    k = (xc @ params["wk"]).reshape(b, s, h, d)
    v = (xm @ params["wv"]).reshape(b, s, h, d)
    gates = xc.float() @ params["w_if"] + params["b_if"]
    i_pre, f_pre = gates.chunk(2, dim=-1)                          # (b,s,h)
    # on a mesh the cell runs on the local (batch, head) shards
    qkv, gate = ("b", None, "h", None), ("b", None, "h")
    roles = (qkv, qkv, qkv, gate, gate)
    if s > MLSTM_CHUNK_THRESHOLD or return_state:
        y, state = per_shard(_mlstm_chunked, (q, k, v, i_pre, f_pre), roles,
                             (qkv, {"C": ("b", "h", None, None),
                                    "n": ("b", "h", None),
                                    "m": ("b", "h")}))
    else:
        y, state = per_shard(_mlstm_parallel, (q, k, v, i_pre, f_pre),
                             roles, qkv), None
    y = rms_norm(y.reshape(b, s, di), params["norm_w"]) * F.silu(z)
    out = y @ params["down"]
    return (out, state, xm) if return_state else out


def apply_mlstm_with_state(params: Tree, x: torch.Tensor, cfg: XLSTMConfig
                           ) -> Tuple[torch.Tensor, Tree]:
    """Prefill entry point: full-sequence output + decode-ready cache
    (the last ``conv_kernel - 1`` conv inputs, zero-padded on the left)."""
    out, state, xm = apply_mlstm(params, x, cfg, return_state=True)
    k = cfg.conv_kernel
    conv = xm[:, -(k - 1):, :]
    # on local (batch, channel) shards: torch 2.11's DTensor fails on the
    # pad (an IndexError), even a pad of 0
    conv = per_shard(lambda c: F.pad(c, (0, 0, (k - 1) - c.shape[1], 0)),
                     (conv,), (("b", None, "c"),), ("b", None, "c"))
    return out, {"C": state["C"], "n": state["n"], "m": state["m"],
                 "conv": conv}


def init_mlstm_cache(batch: int, d_model: int, cfg: XLSTMConfig, dtype,
                     device) -> Tree:
    di = cfg.expand * d_model
    cache = init_mlstm_state(batch, cfg.n_heads, di // cfg.n_heads, device)
    cache["conv"] = torch.zeros((batch, cfg.conv_kernel - 1, di),
                                dtype=dtype, device=device)
    return cache


def decode_mlstm(params: Tree, x: torch.Tensor, cache: Tree,
                 cfg: XLSTMConfig) -> Tuple[torch.Tensor, Tree]:
    """One-token mLSTM recurrence. x: (b, 1, d). ``cache`` is updated in
    place and returned."""
    b = x.shape[0]
    di = params["wq"].shape[0]
    h, d = cfg.n_heads, di // cfg.n_heads
    xm, z = (x[:, 0] @ params["up"]).chunk(2, dim=-1)
    window = torch.cat([cache["conv"], xm[:, None, :]], dim=1)
    xc = F.silu(torch.einsum("bkc,kc->bc", window, params["conv"]))
    q = (xc @ params["wq"]).reshape(b, h, d)
    k = (xc @ params["wk"]).reshape(b, h, d)
    v = (xm @ params["wv"]).reshape(b, h, d)
    gates = xc.float() @ params["w_if"] + params["b_if"]
    i_pre, f_pre = gates.chunk(2, dim=-1)                          # (b,h)
    log_f = _log_sigmoid(f_pre)
    m_new = torch.maximum(log_f + cache["m"], i_pre)
    f_sc = torch.exp(log_f + cache["m"] - m_new)[..., None]
    i_sc = torch.exp(i_pre - m_new)[..., None]
    kf = k.float() * (d ** -0.25)
    qf = q.float() * (d ** -0.25)
    c_new = cache["C"].mul_(f_sc[..., None]).add_(
        i_sc[..., None] * torch.einsum("bhd,bhe->bhde", kf, v.float()))
    n_new = cache["n"].mul_(f_sc).add_(i_sc * kf)
    num = torch.einsum("bhd,bhde->bhe", qf, c_new)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", qf, n_new).abs(),
                        torch.exp(-m_new))[..., None]
    y = (num / den).reshape(b, di).to(x.dtype)
    y = rms_norm(y, params["norm_w"]) * F.silu(z)
    cache["m"].copy_(m_new)
    cache["conv"].copy_(window[:, 1:, :])
    return (y @ params["down"])[:, None, :], cache


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

def make_slstm_params(gen, d_model: int, cfg: XLSTMConfig, dtype,
                      device) -> Tree:
    """The reference's keys; the gate weights are fp32."""
    h = cfg.n_heads
    dh = d_model // h
    d_ff = int(d_model * cfg.ffn_factor)
    return {
        "w_gates": dense_init(gen, d_model, 4 * d_model, torch.float32,
                              device),
        "r_gates": normal(gen, (h, dh, 4 * dh), torch.float32, dh ** -0.5,
                          device),
        "b_gates": torch.zeros(4 * d_model, dtype=torch.float32,
                               device=device),
        "norm_w": torch.ones(d_model, dtype=dtype, device=device),
        "ffn_up": dense_init(gen, d_model, d_ff, dtype, device),
        "ffn_down": dense_init(gen, d_ff, d_model, dtype, device,
                               scale=d_ff ** -0.5),
    }


def slstm_axes() -> Tree:
    """The logical axes of :func:`make_slstm_params`' tree."""
    return {"w_gates": ("embed", "gates"),
            "r_gates": ("heads", "head_dim", "gates"),
            "b_gates": ("gates",), "norm_w": ("embed",),
            "ffn_up": ("embed", "mlp"), "ffn_down": ("mlp", "embed")}


def init_slstm_state(batch: int, d_model: int, cfg: XLSTMConfig,
                     device) -> Tree:
    shape = (batch, cfg.n_heads, d_model // cfg.n_heads)
    zeros = lambda: torch.zeros(shape, dtype=torch.float32, device=device)
    return {"c": zeros(), "n": zeros() + 1e-6, "h": zeros(),
            "m": torch.full(shape, M_INIT, dtype=torch.float32,
                            device=device)}


def _slstm_heads(wx: torch.Tensor, heads: int) -> torch.Tensor:
    """(..., 4 * d_model) gate pre-activations, gate-major, as
    (..., heads, 4 * dh), head-major: the layout of the recurrent term."""
    lead, dh = wx.shape[:-1], wx.shape[-1] // (4 * heads)
    return (wx.reshape(*lead, 4, heads, dh).transpose(-3, -2)
            .reshape(*lead, heads, 4 * dh))


def _slstm_step(params: Tree, cfg: XLSTMConfig, state: Tree,
                wx_t: torch.Tensor) -> Tree:
    """One sLSTM step. wx_t: (b, 4 * d_model) input pre-activation."""
    return _slstm_cell(params, state, _slstm_heads(wx_t, cfg.n_heads))


def _slstm_cell(params: Tree, state: Tree, wx: torch.Tensor) -> Tree:
    """One step on pre-activations already laid out per head (b, H, 4dh)."""
    rec = torch.einsum("bhd,hdg->bhg", state["h"], params["r_gates"])
    z_pre, i_pre, f_pre, o_pre = (wx + rec).chunk(4, dim=-1)       # (b,H,dh)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    log_f = _log_sigmoid(f_pre)
    m_new = torch.maximum(log_f + state["m"], i_pre)
    i_sc = torch.exp(i_pre - m_new)
    f_sc = torch.exp(log_f + state["m"] - m_new)
    c_new = f_sc * state["c"] + i_sc * z
    n_new = f_sc * state["n"] + i_sc
    h_new = o * c_new / torch.clamp(n_new, min=1e-6)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def _slstm_out(params: Tree, y: torch.Tensor) -> torch.Tensor:
    """RMSNorm and the GeLU FFN after the recurrence."""
    y = rms_norm(y, params["norm_w"])
    ff = F.gelu(y @ params["ffn_up"], approximate="tanh")
    return ff @ params["ffn_down"]


def apply_slstm(params: Tree, x: torch.Tensor, cfg: XLSTMConfig,
                state: Optional[Tree] = None) -> Tuple[torch.Tensor, Tree]:
    """Full-sequence sLSTM recurrence + FFN. x: (b, s, d). One step per
    token, each about 15 small ops: the host's launch cost, not the
    device, bounds it on the card."""
    b, s, d = x.shape
    # on a mesh the gates are regrouped on the local batch shard: the
    # regrouping's backward would flatten a sharded dim
    wx = per_shard(lambda t: _slstm_heads(t, cfg.n_heads),
                   (x.float() @ params["w_gates"] + params["b_gates"],),
                   (("b", None, None),), ("b", None, None, None))  # (b,s,H,4dh)
    if state is None:
        state = init_slstm_state(b, d, cfg, x.device)
    hs = []
    for t in range(s):
        state = _slstm_cell(params, state, wx[:, t])
        hs.append(state["h"])
    y = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    return _slstm_out(params, y), state


def decode_slstm(params: Tree, x: torch.Tensor, state: Tree,
                 cfg: XLSTMConfig) -> Tuple[torch.Tensor, Tree]:
    """One-token sLSTM step. x: (b, 1, d). ``state`` is updated in place
    and returned."""
    b, _, d = x.shape
    wx = x[:, 0].float() @ params["w_gates"] + params["b_gates"]
    new = _slstm_step(params, cfg, state, wx)
    for key, t in new.items():
        state[key].copy_(t)
    y = new["h"].reshape(b, d).to(x.dtype)
    return _slstm_out(params, y)[:, None, :], state
