"""Shared neural-net layers (plain torch), counterpart of ``repro.models.layers``.

Conventions kept from the reference:
  * params are dicts of tensors; weights are stored as (in, out);
  * every maker has a sibling ``*_axes`` that returns the reference
    maker's logical axes: a tree of the same structure whose leaves are
    tuples of logical axis names (see repro_torch.distributed.sharding);
  * compute dtype is the activation dtype; norms accumulate in fp32.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
Axes = Dict[str, object]


# --------------------------------------------------------------------------
# initializers
# --------------------------------------------------------------------------

def normal(gen: Optional[torch.Generator], shape, dtype, scale: float,
           device) -> torch.Tensor:
    """N(0, scale²) drawn in fp32 then cast, as the reference does.

    ``gen`` is None on the meta device, where nothing is drawn.
    """
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def dense_init(gen, in_dim: int, out_dim: int, dtype, device, *,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else in_dim ** -0.5
    return normal(gen, (in_dim, out_dim), dtype, scale, device)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
             eps: Optional[float] = None) -> torch.Tensor:
    """RMSNorm at ``eps`` (None: 1e-6)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + (1e-6 if eps is None else eps))
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
               bias: Optional[torch.Tensor],
               eps: Optional[float] = None) -> torch.Tensor:
    """Parametric LN at ``eps`` (None: 1e-5); pass weight=bias=None for
    OLMo's non-parametric LN."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + (1e-5 if eps is None else eps))
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def make_norm_params(d: int, norm_type: str, dtype, device) -> Params:
    if norm_type == "rmsnorm":
        return {"w": torch.ones(d, dtype=dtype, device=device)}
    if norm_type == "layernorm":
        return {"w": torch.ones(d, dtype=dtype, device=device),
                "b": torch.zeros(d, dtype=dtype, device=device)}
    if norm_type == "nonparametric":       # OLMo
        return {}
    raise ValueError(norm_type)


def norm_axes(norm_type: str) -> Axes:
    if norm_type == "rmsnorm":
        return {"w": ("embed",)}
    if norm_type == "layernorm":
        return {"w": ("embed",), "b": ("embed",)}
    if norm_type == "nonparametric":
        return {}
    raise ValueError(norm_type)


def apply_norm(params: Params, x: torch.Tensor, norm_type: str,
               eps: Optional[float] = None) -> torch.Tensor:
    """The norm of ``norm_type``, at ``eps`` (None: the norm's own)."""
    if norm_type == "rmsnorm":
        return rms_norm(x, params["w"], eps)
    if norm_type == "layernorm":
        return layer_norm(x, params["w"], params["b"], eps)
    if norm_type == "nonparametric":
        return layer_norm(x, None, None, eps)
    raise ValueError(norm_type)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).

    Split-half rotation (the two halves of head_dim pair up), not the
    interleaved form.
    """
    freqs = rope_frequencies(x.shape[-1], theta, x.device)     # (hd/2,)
    angles = positions[..., :, None].float() * freqs           # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                   # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def make_mlp_params(gen, d_model: int, d_ff: int, mlp_type: str, dtype,
                    device) -> Params:
    if mlp_type == "swiglu":
        return {"gate": dense_init(gen, d_model, d_ff, dtype, device),
                "up": dense_init(gen, d_model, d_ff, dtype, device),
                "down": dense_init(gen, d_ff, d_model, dtype, device,
                                   scale=d_ff ** -0.5)}
    if mlp_type == "gelu":
        return {"up": dense_init(gen, d_model, d_ff, dtype, device),
                "up_b": torch.zeros(d_ff, dtype=dtype, device=device),
                "down": dense_init(gen, d_ff, d_model, dtype, device,
                                   scale=d_ff ** -0.5),
                "down_b": torch.zeros(d_model, dtype=dtype, device=device)}
    raise ValueError(mlp_type)


def mlp_axes(mlp_type: str) -> Axes:
    if mlp_type == "swiglu":
        return {"gate": ("embed", "mlp"), "up": ("embed", "mlp"),
                "down": ("mlp", "embed")}
    if mlp_type == "gelu":
        return {"up": ("embed", "mlp"), "up_b": ("mlp",),
                "down": ("mlp", "embed"), "down_b": ("embed",)}
    raise ValueError(mlp_type)


def apply_mlp(params: Params, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    if mlp_type == "swiglu":
        h = F.silu(x @ params["gate"]) * (x @ params["up"])
        return h @ params["down"]
    if mlp_type == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["up"] + params["up_b"], approximate="tanh")
        return h @ params["down"] + params["down_b"]
    raise ValueError(mlp_type)


# --------------------------------------------------------------------------
# embeddings / unembedding
# --------------------------------------------------------------------------

def make_embed_params(gen, vocab: int, d_model: int, dtype, tie: bool,
                      device) -> Params:
    params = {"tok": normal(gen, (vocab, d_model), dtype, d_model ** -0.5,
                            device)}
    if not tie:
        params["out"] = normal(gen, (d_model, vocab), dtype, d_model ** -0.5,
                               device)
    return params


def embed_axes(tie: bool) -> Axes:
    axes = {"tok": ("vocab", "embed")}
    if not tie:
        axes["out"] = ("embed", "vocab")
    return axes


def embed_tokens(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens]


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    if "out" in params:
        return x @ params["out"]
    return x @ params["tok"].T
