"""Shared neural-net layers (plain torch), counterpart of ``repro.models.layers``.

Conventions kept from the reference:
  * params are dicts of tensors; weights are stored as (in, out);
  * every maker has a sibling ``*_axes`` that returns the reference
    maker's logical axes: a tree of the same structure whose leaves are
    tuples of logical axis names (see repro_torch.distributed.sharding);
  * compute dtype is the activation dtype; norms accumulate in fp32.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

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


@dataclasses.dataclass(frozen=True)
class YarnConfig:
    """YaRN's rope scaling (DeepSeek-V2's ``rope_scaling`` of type
    ``yarn``): the frequencies of the dims that turn fewer than
    ``beta_slow`` times over ``original_max_pos`` positions are divided by
    ``factor``, those that turn more than ``beta_fast`` times are kept,
    and a linear ramp blends the dims between; the attention scores gain
    ``yarn_mscale(factor, mscale_all_dim)`` squared. The published
    ``mscale`` is taken equal to ``mscale_all_dim``, as in DeepSeek-V2,
    so cos and sin keep their unit gain."""

    factor: float
    original_max_pos: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale_all_dim: float = 0.0


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's magnitude correction: 0.1 mscale ln(factor) + 1 (1 at
    factor <= 1)."""
    return 1.0 if factor <= 1.0 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_correction_range(dim: int, theta: float, yarn: YarnConfig
                          ) -> Tuple[int, int]:
    """The dims (of the ``dim // 2`` frequencies) where the ramp starts and
    ends: a frequency index whose dim turns ``beta`` times over the
    original context, floored for ``beta_fast`` and ceiled for
    ``beta_slow``, clamped to [0, dim - 1]."""
    def at(turns: float) -> float:
        return (dim * math.log(yarn.original_max_pos / (turns * 2 * math.pi))
                / (2 * math.log(theta)))
    low = math.floor(at(yarn.beta_fast))
    high = math.ceil(at(yarn.beta_slow))
    return max(low, 0), min(high, dim - 1)


def yarn_frequencies(dim: int, theta: float, yarn: YarnConfig,
                     device) -> torch.Tensor:
    """The ``dim // 2`` inverse frequencies under YaRN: the plain ones
    (extrapolated) below the ramp, divided by ``factor`` (interpolated)
    above it, linearly between."""
    exponent = torch.arange(0, dim, 2, dtype=torch.float32,
                            device=device) / dim
    extra = 1.0 / (theta ** exponent)
    inter = 1.0 / (yarn.factor * theta ** exponent)
    low, high = yarn_correction_range(dim, theta, yarn)
    span = max(high - low, 0.001)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / span).clamp(0.0, 1.0)
    keep = 1.0 - ramp
    return inter * (1.0 - keep) + extra * keep


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float, yarn: Optional[YarnConfig] = None
               ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).

    Split-half rotation (the two halves of head_dim pair up), not the
    interleaved form. With ``yarn`` the frequencies are YaRN's.
    """
    d = x.shape[-1]
    freqs = (rope_frequencies(d, theta, x.device) if yarn is None
             else yarn_frequencies(d, theta, yarn, x.device))   # (hd/2,)
    angles = positions[..., :, None].float() * freqs           # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                   # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """(..., d) with its pairs (2i, 2i + 1) moved to (i, i + d/2): the even
    dims, then the odd ones. DeepSeek-V2 stores its rope dims interleaved
    and rotates them split-half after this permutation."""
    d = x.shape[-1]
    return x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)


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
