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

from repro_torch.models.layers import dense_init, normal, rms_norm

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state: int = 64          # N
    head_dim: int = 64       # P
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 128


def d_inner(d_model: int, cfg: SSMConfig) -> int:
    return cfg.expand * d_model


def n_heads(d_model: int, cfg: SSMConfig) -> int:
    return d_inner(d_model, cfg) // cfg.head_dim


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
        "conv_x": normal(gen, (cfg.conv_kernel, di), dtype,
                         cfg.conv_kernel ** -0.5, device),
        "A_log": torch.zeros(h, **f32),             # A = -exp(A_log)
        "dt_bias": torch.zeros(h, **f32),
        "D": torch.ones(h, **f32),
        "norm_w": torch.ones(di, dtype=dtype, device=device),
        "out_proj": dense_init(gen, di, d_model, dtype, device,
                               scale=di ** -0.5),
    }


def mamba2_axes() -> Tree:
    """The logical axes of :func:`make_mamba2_params`' tree."""
    return {"z_proj": ("embed", "inner"), "x_proj": ("embed", "inner"),
            "b_proj": ("embed", "state"), "c_proj": ("embed", "state"),
            "dt_proj": ("embed", "ssm_heads"), "conv_x": ("conv", "inner"),
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
    # imported here: repro_torch.distributed imports the training code,
    # which imports the models
    from repro_torch.distributed.sharding import per_shard
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


def apply_mamba2(params: Tree, x: torch.Tensor, cfg: SSMConfig,
                 use_kernel: bool = False, return_state: bool = False):
    """Full-sequence (train / prefill) Mamba2 block. x: (b, s, d).

    The chunked path returns y in fp32, the kernel route in x's type, so
    the skip term, the gated norm and the cast before ``out_proj`` see
    different types on the two paths, as in the reference.
    """
    bsz, s, _ = x.shape
    di = params["x_proj"].shape[1]
    h = params["A_log"].shape[0]
    p = di // h

    z = x @ params["z_proj"]
    xr_pre = x @ params["x_proj"]                           # pre-conv (cache)
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
    from repro_torch.distributed.sharding import constrain, per_shard
    xh = constrain(xr.reshape(bsz, s, h, p), ("batch", "act_seq", "inner",
                                             None))
    if use_kernel:
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        scan = lambda *a: ssd_ops.ssd_scan(*a, chunk=cfg.chunk)
    else:
        scan = lambda *a: _ssd_chunked(*a, cfg)
    y, h_last = per_shard(
        scan, (xh, bm, cm, log_a, dt),
        (("b", None, "h", None), ("b", None, None), ("b", None, None),
         ("b", None, "h"), ("b", None, "h")),
        (("b", None, "h", None), ("b", "h", None, None)))
    y = y + params["D"].to(y.dtype)[None, None, :, None] * xh
    y = y.reshape(bsz, s, di)
    y = rms_norm(y * F.silu(z).to(y.dtype), params["norm_w"])
    out = y.to(x.dtype) @ params["out_proj"]
    return (out, h_last, xr_pre) if return_state else out


def apply_mamba2_with_state(params: Tree, x: torch.Tensor, cfg: SSMConfig,
                            use_kernel: bool = False
                            ) -> Tuple[torch.Tensor, Tree]:
    """Prefill entry point: full-seq output + decode-ready cache."""
    out, h_last, xr_pre = apply_mamba2(params, x, cfg, use_kernel=use_kernel,
                                       return_state=True)
    # imported here: repro_torch.distributed imports the training code,
    # which imports this module
    from repro_torch.distributed.sharding import per_shard
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
    di = d_inner(d_model, cfg)
    h = n_heads(d_model, cfg)
    return {"h": torch.zeros((batch, h, cfg.state, cfg.head_dim),
                             dtype=dtype, device=device),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, di),
                                dtype=dtype, device=device)}


def decode_mamba2(params: Tree, x: torch.Tensor, cache: Tree,
                  cfg: SSMConfig) -> Tuple[torch.Tensor, Tree]:
    """One-token recurrent step. x: (b, 1, d). Returns new tensors; the
    cache passed in is not written."""
    bsz = x.shape[0]
    di = params["x_proj"].shape[1]
    h = params["A_log"].shape[0]
    p = di // h

    x1 = x[:, 0]
    z = x1 @ params["z_proj"]
    xr = x1 @ params["x_proj"]                                    # (b, di)
    window = torch.cat([cache["conv"], xr[:, None, :]], dim=1)    # (b,k,di)
    conv_out = torch.einsum("bkc,kc->bc", window, params["conv_x"])
    xr = F.silu(conv_out)
    new_conv = window[:, 1:, :]

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
    y = rms_norm(y * F.silu(z), params["norm_w"])
    out = (y @ params["out_proj"])[:, None, :]
    return out, {"h": h_new, "conv": new_conv}
