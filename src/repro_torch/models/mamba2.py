"""Mamba2 (SSD, state-space duality) block, chunkwise-parallel
(counterpart of ``repro.models.mamba2``).

The sequence is cut into chunks of ``chunk`` tokens. Within a chunk the
interactions are dense (q x q) products; across chunks a short loop over
``seq / chunk`` steps carries the state. ``use_kernel=True`` routes the
scan through ``repro_torch.kernels.ssd_scan`` (the two CUDA passes on a
CUDA tensor), otherwise :func:`_ssd_chunked` runs it in plain torch.

State per head: h in R^{N x P} with N = ssm state, P = head_dim. Decode
is the O(1) recurrent update in plain torch; the reference has no kernel
for it either.

Two options of :class:`SSMConfig` give the published Mamba2 mixer (Granite
4.0-H); both default to the reference's mixer (zamba2). ``conv_xbc``: the
causal conv, with a bias, runs over x, B and C together, and all three
pass through the SiLU (the conv cache holds ``d_inner + 2 N`` channels).
``pad_to_chunk``: a prompt that is longer than a chunk and not a whole
number of chunks is padded, for the scan alone, to the next multiple with
``dt = 0``, where the reference asserts: a step of ``dt = 0`` neither
decays the state nor adds to it, so the state after the padding is the
state at the last true position, and the padded rows of y are dropped.
``ssd_real_tokens`` and ``ssd_pad_tokens`` count, over every scan since
import (always on, host integers), the positions scanned and those added
by the padding.

Where JAX promotes mixed dtypes inside ``einsum``, torch raises, so the
bf16 operands are cast to fp32 at the points where JAX promotes them; the
reference's rounding points are kept (``C . B^T`` in the model dtype on
the chunked path, the decode outer product in the model dtype).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain, per_shard
from repro_torch.models.layers import dense_init, normal, rms_norm

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state: int = 64          # N
    head_dim: int = 64       # P
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 128
    #: the published mixer's conv: over x, B and C, with a bias
    conv_xbc: bool = False
    #: pad a prompt to a whole number of chunks (dt = 0) instead of raising
    pad_to_chunk: bool = False


#: positions every scan ran on, and the ones ``pad_to_chunk`` added
ssd_real_tokens = 0
ssd_pad_tokens = 0


def d_inner(d_model: int, cfg: SSMConfig) -> int:
    return cfg.expand * d_model


def n_heads(d_model: int, cfg: SSMConfig) -> int:
    return d_inner(d_model, cfg) // cfg.head_dim


def conv_channels(d_model: int, cfg: SSMConfig) -> int:
    """Channels of the causal conv: x, or x, B and C (``conv_xbc``)."""
    return d_inner(d_model, cfg) + (2 * cfg.state if cfg.conv_xbc else 0)


def _make_conv(gen, d_model: int, cfg: SSMConfig, dtype, device) -> Tree:
    """The conv's taps (k, channels): ``conv_x`` over x alone, or ``conv``
    with ``taps`` and a bias ``b`` (zeros) over x, B and C."""
    k, ch = cfg.conv_kernel, conv_channels(d_model, cfg)
    taps = normal(gen, (k, ch), dtype, k ** -0.5, device)
    if not cfg.conv_xbc:
        return {"conv_x": taps}
    return {"conv": {"taps": taps,
                     "b": torch.zeros(ch, dtype=dtype, device=device)}}


def make_mamba2_params(gen, d_model: int, cfg: SSMConfig, dtype,
                       device) -> Tree:
    """The reference's keys and (in, out) layout; ``A_log``, ``dt_bias``
    and ``D`` are fp32 whatever the model dtype."""
    di = d_inner(d_model, cfg)
    h = n_heads(d_model, cfg)
    n = cfg.state
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "z_proj": dense_init(gen, d_model, di, dtype, device),
        "x_proj": dense_init(gen, d_model, di, dtype, device),
        "b_proj": dense_init(gen, d_model, n, dtype, device),
        "c_proj": dense_init(gen, d_model, n, dtype, device),
        "dt_proj": dense_init(gen, d_model, h, dtype, device),
        **_make_conv(gen, d_model, cfg, dtype, device),
        "A_log": torch.zeros(h, **f32),             # A = -exp(A_log)
        "dt_bias": torch.zeros(h, **f32),
        "D": torch.ones(h, **f32),
        "norm_w": torch.ones(di, dtype=dtype, device=device),
        "out_proj": dense_init(gen, di, d_model, dtype, device,
                               scale=di ** -0.5),
    }


def mamba2_axes(cfg: Optional[SSMConfig] = None) -> Tree:
    """The logical axes of :func:`make_mamba2_params`' tree; the conv over
    x, B and C mixes the inner and state channels, so its channel axis
    has no name."""
    conv = ({"conv": {"taps": ("conv", None), "b": (None,)}}
            if cfg is not None and cfg.conv_xbc
            else {"conv_x": ("conv", "inner")})
    return {"z_proj": ("embed", "inner"), "x_proj": ("embed", "inner"),
            "b_proj": ("embed", "state"), "c_proj": ("embed", "state"),
            "dt_proj": ("embed", "ssm_heads"), **conv,
            "A_log": ("ssm_heads",), "dt_bias": ("ssm_heads",),
            "D": ("ssm_heads",), "norm_w": ("inner",),
            "out_proj": ("inner", "embed")}


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) everywhere, as ``jax.nn.softplus``; ``F.softplus``
    returns x itself above its threshold of 20."""
    return torch.logaddexp(x, x.new_zeros(()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq. x: (b, s, ch), w: (k, ch). On a
    mesh it runs on the local (batch, channel) shards."""
    return per_shard(_causal_conv_local, (x, w),
                     (("b", None, "c"), (None, "c")), ("b", None, "c"))


def _causal_conv_local(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):                      # k is tiny (4): unrolled taps
        out = out + xp[:, i:i + x.shape[1], :] * w[i]
    return out


def chunk_len(s: int, chunk: int) -> int:
    """The chunk length ``min(chunk, s)``; raises where the reference
    asserts that it divides the sequence."""
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    return q


def chunk_recurrence(s_chunk: torch.Tensor, chunk_decay: torch.Tensor,
                     h0: Optional[torch.Tensor]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_c = h_{c-1} dec_c + S_c over the chunks, in fp32 from ``h0``
    (zeros if None). s_chunk: (b, c, h, n, p); chunk_decay: (b, c, h).
    Returns (the state entering each chunk (b, c, h, n, p), the last)."""
    if h0 is None:
        h0 = s_chunk.new_zeros((s_chunk.shape[0], *s_chunk.shape[2:]))
    state = h0.float()
    h_prevs = []
    for ci in range(s_chunk.shape[1]):
        h_prevs.append(state)                                     # h_{c-1}
        state = state * chunk_decay[:, ci, :, None, None] + s_chunk[:, ci]
    return torch.stack(h_prevs, dim=1), state


def _ssd_chunked(xh, b_mat, c_mat, log_a, dt, cfg: SSMConfig,
                 h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan in plain torch.

    xh:    (b, s, h, p)  inputs per head
    b_mat: (b, s, n)     input->state projection (shared across heads)
    c_mat: (b, s, n)     state->output projection
    log_a: (b, s, h)     per-step log decay (dt * A, negative)
    dt:    (b, s, h)     step sizes
    returns y (b, s, h, p) fp32, final state (b, h, n, p) fp32
    """
    bsz, s, h, p = xh.shape
    n = b_mat.shape[-1]
    q = chunk_len(s, cfg.chunk)
    c = s // q
    xh = xh.reshape(bsz, c, q, h, p)
    bm = b_mat.reshape(bsz, c, q, n)
    cm = c_mat.reshape(bsz, c, q, n)
    la = log_a.reshape(bsz, c, q, h)
    dt = dt.reshape(bsz, c, q, h)

    cum = torch.cumsum(la, dim=2)                                 # (b,c,q,h)
    # intra-chunk: decay matrix L[i,j] = exp(cum_i - cum_j), i >= j
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]            # (b,c,q,k,h)
    mask = torch.ones((q, q), dtype=torch.bool, device=xh.device).tril()
    l_mat = torch.where(mask[None, None, :, :, None], torch.exp(li), 0.0)
    g_mat = torch.einsum("bcqn,bckn->bcqk", cm, bm)               # model dtype
    m_mat = g_mat[..., None] * l_mat * dt[:, :, None, :, :]       # (b,c,q,k,h)
    xf = xh.to(m_mat.dtype)                   # JAX promotes xh here
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", m_mat, xf)

    # chunk summaries: S_c = sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)                # (b,c,q,h)
    w = decay_end * dt                                            # (b,c,q,h)
    s_chunk = torch.einsum("bcqh,bcqn,bcqhp->bchnp", w, bm.to(w.dtype),
                           xh.to(w.dtype))                        # (b,c,h,n,p)
    chunk_decay = torch.exp(cum[:, :, -1, :])                     # (b,c,h)

    h_prevs, h_last = chunk_recurrence(s_chunk, chunk_decay, h0)

    # inter-chunk: y_i += C_i . h_{c-1} . exp(cum_i)
    c_decay = cm[:, :, :, None, :] * torch.exp(cum)[..., None]    # (b,c,q,h,n)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", c_decay, h_prevs)

    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y, h_last


def _scan_length(s: int, cfg: SSMConfig) -> int:
    """The length the scan runs at: s, or with ``pad_to_chunk`` a prompt
    longer than a chunk rounded up to a whole number of chunks."""
    if cfg.pad_to_chunk and s > cfg.chunk and s % cfg.chunk:
        return -(-s // cfg.chunk) * cfg.chunk
    return s


def _conv_input(params: Tree, x: torch.Tensor, cfg: SSMConfig
                ) -> torch.Tensor:
    """What the causal conv runs over, before it: x's projection, or the
    projections to x, B and C side by side (``conv_xbc``)."""
    if not cfg.conv_xbc:
        return x @ params["x_proj"]
    return torch.cat([x @ params["x_proj"], x @ params["b_proj"],
                      x @ params["c_proj"]], dim=-1)


def _split_xbc(xbc: torch.Tensor, di: int, n: int):
    """x, B and C of the conv's SiLU output, each contiguous (the scan's
    kernels take contiguous rows)."""
    return tuple(t.contiguous() for t in xbc.split([di, n, n], dim=-1))


def apply_mamba2(params: Tree, x: torch.Tensor, cfg: SSMConfig,
                 use_kernel: bool = False, return_state: bool = False,
                 eps: Optional[float] = None):
    """Full-sequence (train / prefill) Mamba2 block. x: (b, s, d).

    The chunked path returns y in fp32, the kernel route in x's type, so
    the skip term, the gated norm and the cast before ``out_proj`` see
    different types on the two paths, as in the reference. ``eps`` is the
    gated norm's.
    """
    global ssd_real_tokens, ssd_pad_tokens
    bsz, s, _ = x.shape
    di = params["x_proj"].shape[1]
    h = params["A_log"].shape[0]
    p = di // h

    z = x @ params["z_proj"]
    xr_pre = _conv_input(params, x, cfg)                    # pre-conv (cache)
    if cfg.conv_xbc:
        conv = params["conv"]
        xbc = F.silu(_causal_conv(xr_pre, conv["taps"]) + conv["b"])
        xr, bm, cm = _split_xbc(xbc, di, cfg.state)
    else:
        xr = F.silu(_causal_conv(xr_pre, params["conv_x"]))
        bm = x @ params["b_proj"]
        cm = x @ params["c_proj"]

    dt = softplus((x @ params["dt_proj"]).float() + params["dt_bias"])
    a = -torch.exp(params["A_log"])                               # (h,)
    log_a = dt * a                                                # (b,s,h)

    # on a mesh the scan (either route) runs on the local (batch, head)
    # shards, the batch pinned over the data axes (the projections' GEMMs
    # may leave it whole) and the heads over the model axis; B and C carry
    # no head dim, so they replicate over heads
    xh = constrain(xr.reshape(bsz, s, h, p), ("batch", "act_seq", "inner",
                                             None))
    pad = _scan_length(s, cfg) - s
    ssd_real_tokens += bsz * s
    ssd_pad_tokens += bsz * pad
    scan_in = (xh, bm, cm, log_a, dt)
    if pad:             # zeros: dt = 0 keeps the state, adds nothing to it
        scan_in = tuple(F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                        for t in scan_in)
    if use_kernel:
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        scan = lambda *a: ssd_ops.ssd_scan(*a, chunk=cfg.chunk)
    else:
        scan = lambda *a: _ssd_chunked(*a, cfg)
    y, h_last = per_shard(
        scan, scan_in,
        (("b", None, "h", None), ("b", None, None), ("b", None, None),
         ("b", None, "h"), ("b", None, "h")),
        (("b", None, "h", None), ("b", "h", None, None)))
    if pad:
        y = y[:, :s]
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(bsz, s, di)
    y = rms_norm(y * F.silu(z).to(y.dtype), params["norm_w"], eps)
    out = y.to(x.dtype) @ params["out_proj"]
    return (out, h_last, xr_pre) if return_state else out


def apply_mamba2_with_state(params: Tree, x: torch.Tensor, cfg: SSMConfig,
                            use_kernel: bool = False, eps: Optional[float] = None
                            ) -> Tuple[torch.Tensor, Tree]:
    """Prefill entry point: full-seq output + decode-ready cache, whose
    conv window is the pre-conv inputs of the last true positions."""
    out, h_last, xr_pre = apply_mamba2(params, x, cfg, use_kernel=use_kernel,
                                       return_state=True, eps=eps)
    k = cfg.conv_kernel
    conv = xr_pre[:, -(k - 1):, :]
    pad = (k - 1) - conv.shape[1]
    if pad > 0:                                   # prompt shorter than window
        # on local (batch, channel) shards, as the causal conv's pad:
        # torch 2.11's DTensor cannot pad a DTensor along this dim
        conv = per_shard(lambda c: F.pad(c, (0, 0, pad, 0)), (conv,),
                         (("b", None, "c"),), ("b", None, "c"))
    return out, {"h": h_last.to(x.dtype), "conv": conv}


# --------------------------------------------------------------------------
# decode (recurrent, O(1) per token)
# --------------------------------------------------------------------------

def init_mamba2_cache(batch: int, d_model: int, cfg: SSMConfig, dtype,
                      device) -> Tree:
    h = n_heads(d_model, cfg)
    return {"h": torch.zeros((batch, h, cfg.state, cfg.head_dim),
                             dtype=dtype, device=device),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1,
                                 conv_channels(d_model, cfg)),
                                dtype=dtype, device=device)}


def decode_mamba2(params: Tree, x: torch.Tensor, cache: Tree,
                  cfg: SSMConfig, eps: Optional[float] = None
                  ) -> Tuple[torch.Tensor, Tree]:
    """One-token recurrent step. x: (b, 1, d). Returns new tensors; the
    cache passed in is not written. ``eps`` is the gated norm's."""
    bsz = x.shape[0]
    di = params["x_proj"].shape[1]
    h = params["A_log"].shape[0]
    p = di // h

    x1 = x[:, 0]
    z = x1 @ params["z_proj"]
    xr = _conv_input(params, x1, cfg)                             # (b, ch)
    window = torch.cat([cache["conv"], xr[:, None, :]], dim=1)    # (b,k,ch)
    new_conv = window[:, 1:, :]
    if cfg.conv_xbc:
        conv_out = torch.einsum("bkc,kc->bc", window, params["conv"]["taps"])
        xr, bm, cm = F.silu(conv_out + params["conv"]["b"]).split(
            [di, cfg.state, cfg.state], dim=-1)
    else:
        conv_out = torch.einsum("bkc,kc->bc", window, params["conv_x"])
        xr = F.silu(conv_out)
        bm = x1 @ params["b_proj"]
        cm = x1 @ params["c_proj"]
    dt = softplus((x1 @ params["dt_proj"]).float() + params["dt_bias"])
    a = torch.exp(dt * -torch.exp(params["A_log"]))               # (b,h)

    xh = xr.reshape(bsz, h, p)
    h_new = (cache["h"] * a[..., None, None].to(cache["h"].dtype)
             + torch.einsum("bh,bn,bhp->bhnp", dt.to(x.dtype), bm, xh))
    y = torch.einsum("bn,bhnp->bhp", cm, h_new)
    y = y + params["D"].to(y.dtype)[None, :, None] * xh
    y = y.reshape(bsz, di)
    y = rms_norm(y * F.silu(z), params["norm_w"], eps)
    out = (y @ params["out_proj"])[:, None, :]
    return out, {"h": h_new, "conv": new_conv}
