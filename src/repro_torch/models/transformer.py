"""Decoder, cross-attention and encoder blocks (counterpart of
``repro.models.transformer``).

A block is a pre-norm attention sublayer plus a pre-norm FFN sublayer
(an MLP, or a mixture of experts), with residuals. Entry points:

  * ``apply_*``   — full sequence (forward, encoder),
  * ``prefill_*`` — full sequence that also emits the cache,
  * ``decode_*``  — one-token step against the cache.

A cross block (whisper's decoder layer, llama-vision's gated layer)
attends to encoder or image states with plain attention, as in the
reference; only causal self-attention takes the flash kernel.

Parameters of a stack of blocks carry a leading ``layers`` axis; the
model loops over it where the reference scans. The KV cache is kept in
the block's dtype, or as int8 with one fp16 scale per (position, head).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro_torch.distributed.sharding import per_shard, replicated
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.models.attention import (_BSHD, _project_qkv, _sdpa_plain,
                                          attention_axes,
                                          make_attention_params, sdpa)
from repro_torch.models.layers import (YarnConfig, apply_mlp, apply_norm,
                                       make_mlp_params, make_norm_params,
                                       mlp_axes, norm_axes)
from repro_torch.models.moe import (MoEConfig, RealTokens, apply_moe,
                                    make_moe_params, moe_axes)
from repro_torch.tracing import span
from repro_torch.tree import tree_leaves, tree_map  # noqa: F401 re-exported

if TYPE_CHECKING:
    from repro_torch.models.mla import MLAConfig

Tree = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """Static geometry shared by block creators/applicators."""

    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    norm: str = "rmsnorm"            # rmsnorm | layernorm | nonparametric
    mlp: str = "swiglu"              # swiglu | gelu
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: Optional[float] = 10000.0
    moe: Optional[MoEConfig] = None
    attn_impl: str = "plain"         # plain | kernel
    #: the attention scores' scale (None: head_dim^-1/2)
    attn_scale: Optional[float] = None
    #: each sublayer's output is scaled by this before its residual add
    residual_multiplier: float = 1.0
    #: the norms' epsilon (None: each norm's default)
    norm_eps: Optional[float] = None
    #: latent attention (its blocks are models/mla.py's); None: per-head
    #: keys and values
    mla: Optional["MLAConfig"] = None
    #: YaRN's rope scaling (latent attention's rope dims)
    yarn: Optional[YarnConfig] = None


def residual(out: torch.Tensor, cfg: BlockConfig) -> torch.Tensor:
    """A sublayer's output as it is added to the residual stream: scaled
    by ``cfg.residual_multiplier`` (Granite), untouched at 1."""
    m = cfg.residual_multiplier
    return out if m == 1.0 else out * m


# --------------------------------------------------------------------------
# parameter trees (nested dicts of tensors)
# --------------------------------------------------------------------------

def stack_params(n, maker: Callable[[], Tree]) -> Tree:
    """``n`` independently initialised copies of ``maker()`` stacked on a
    leading ``layers`` axis; ``n`` may be a tuple of sizes, for stacks
    nested in stacks (``(nseg, nself)``). Each layer is drawn in turn and
    copied into its row of a preallocated stack, so that init holds one
    layer beyond the stack, not all of them twice over."""
    shape = (n,) if isinstance(n, int) else tuple(n)
    stack = None
    for idx in np.ndindex(*shape):
        layer = maker()
        if stack is None:
            stack = tree_map(lambda t: torch.empty(
                (*shape, *t.shape), dtype=t.dtype, device=t.device), layer)
        tree_map(lambda row, t: row[idx].copy_(t), stack, layer)
    return stack


def is_axes_leaf(x) -> bool:
    """Axes trees use tuples of strings (and Nones) as leaves."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def prepend_axis(axes, name: str = "layers"):
    """The axes of a stack of trees with ``axes``: ``name`` leads every
    leaf, as on the stack's leading dim."""
    return tree_map(lambda t: (name,) + t, axes)


def unstack_params(tree: Tree, n: int) -> List[Tree]:
    """The ``n`` per-layer trees of a stacked tree, as views. Under
    autograd each leaf's gradient comes back through one ``unbind``,
    whose backward stacks the layers' gradients once; indexing each layer
    would give every layer a zero-filled gradient of the whole stack to
    add up, n times the stack's size in traffic."""
    parts = tree_map(torch.unbind, tree)
    return [tree_map(lambda ts: ts[i], parts) for i in range(n)]


# --------------------------------------------------------------------------
# standard decoder block (attention + MLP or MoE)
# --------------------------------------------------------------------------

def block_rest(gen, cfg: BlockConfig, dtype, device) -> Tree:
    """A decoder block's parameters after its attention: the two norms and
    the MLP or the experts."""
    params = {"norm1": make_norm_params(cfg.d_model, cfg.norm, dtype, device),
              "norm2": make_norm_params(cfg.d_model, cfg.norm, dtype, device)}
    if cfg.moe is not None:
        params["moe"] = make_moe_params(gen, cfg.d_model, cfg.moe, dtype,
                                        device)
    else:
        params["mlp"] = make_mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.mlp,
                                        dtype, device)
    return params


def block_rest_axes(cfg: BlockConfig) -> Tree:
    """The logical axes of :func:`block_rest`'s tree."""
    axes = {"norm1": norm_axes(cfg.norm), "norm2": norm_axes(cfg.norm)}
    if cfg.moe is not None:
        axes["moe"] = moe_axes(cfg.moe)
    else:
        axes["mlp"] = mlp_axes(cfg.mlp)
    return axes


def make_decoder_block(gen, cfg: BlockConfig, dtype, device) -> Tree:
    attn = make_attention_params(
        gen, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim, dtype,
        device, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm)
    return {"attn": attn, **block_rest(gen, cfg, dtype, device)}


def decoder_block_axes(cfg: BlockConfig) -> Tree:
    """The logical axes of :func:`make_decoder_block`'s tree."""
    return {"attn": attention_axes(qkv_bias=cfg.qkv_bias,
                                   qk_norm=cfg.qk_norm),
            **block_rest_axes(cfg)}


def _ffn(params: Tree, x: torch.Tensor, cfg: BlockConfig,
         real: Optional[RealTokens] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Second sublayer, its norm then an MLP or MoE (span ``rt.mlp`` /
    ``rt.moe``). Returns (out, aux_loss), out without the residual. On a
    mesh the MoE runs replicated: its dispatch (the capacity top-k over
    tokens, the row map written in place, the gathers and sums of
    ``_Gather`` / ``_Combine``) has no DTensor sharding strategy. ``real``
    passes a padded sequence's real tokens to the MoE."""
    if cfg.moe is not None:
        with span("rt.moe"):
            h = apply_norm(params["norm2"], x, cfg.norm)
            moe = apply_moe if real is None else \
                functools.partial(apply_moe, real=real)
            return replicated(moe, params["moe"], h, cfg.moe)
    with span("rt.mlp"):
        h = apply_norm(params["norm2"], x, cfg.norm)
        return (apply_mlp(params["mlp"], h, cfg.mlp),
                torch.zeros((), dtype=torch.float32, device=h.device))


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def _attend_and_ffn(params: Tree, x: torch.Tensor, cfg: BlockConfig,
                    causal: bool, positions: torch.Tensor,
                    real: Optional[RealTokens] = None):
    """Shared body of the full-sequence block; returns (x, aux, k, v)."""
    b, s, _ = x.shape
    with span("rt.attn"):
        h = apply_norm(params["norm1"], x, cfg.norm, cfg.norm_eps)
        q, k, v = _project_qkv(params["attn"], h, h, cfg.n_heads,
                               cfg.kv_heads, cfg.head_dim, positions,
                               positions, cfg.rope_theta)
        o = sdpa(q, k, v, causal=causal, impl=cfg.attn_impl,
                 scale=cfg.attn_scale)
        x = x + residual(o.reshape(b, s, cfg.n_heads * cfg.head_dim)
                         @ params["attn"]["wo"], cfg)
    f, aux = _ffn(params, x, cfg, real)
    return x + residual(f, cfg), aux, k, v


def apply_decoder_block(params: Tree, x: torch.Tensor, cfg: BlockConfig, *,
                        causal: bool = True,
                        positions: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block. Returns (x, aux_loss); the aux loss of a
    block without experts is 0."""
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(b, s, x.device)
    x, aux, _, _ = _attend_and_ffn(params, x, cfg, causal, positions)
    return x, aux


# -- KV-cache paths ---------------------------------------------------------

def init_block_cache(batch: int, max_len: int, cfg: BlockConfig, dtype,
                     device, quantized: bool = False
                     ) -> Dict[str, torch.Tensor]:
    return _zero_cache((batch, max_len, cfg.kv_heads, cfg.head_dim), dtype,
                       device, quantized)


def _zero_cache(shape, dtype, device, quantized: bool
                ) -> Dict[str, torch.Tensor]:
    if quantized:
        # int8 payload + per-(position, head) fp16 scales: about half the
        # bytes decode reads from the cache
        zeros = lambda shp, dt: torch.zeros(shp, dtype=dt, device=device)
        return {"k": zeros(shape, torch.int8), "v": zeros(shape, torch.int8),
                "k_scale": zeros(shape[:3], torch.float16),
                "v_scale": zeros(shape[:3], torch.float16)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


#: logical axes of a block KV cache; the engine finds the batch axis here
BLOCK_CACHE_AXES = {"k": ("batch", "cache_seq", None, None),
                    "v": ("batch", "cache_seq", None, None)}
BLOCK_CACHE_AXES_Q = dict(BLOCK_CACHE_AXES,
                          k_scale=("batch", "cache_seq", None),
                          v_scale=("batch", "cache_seq", None))


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, h, d) -> (int8, fp16 scale (b, s, h)). The division is by
    the fp32 scale; an all-zero row's scale (1e-8) is 0 in fp16."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.half()


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype
                   ) -> torch.Tensor:
    return (q.float() * scale.float()[..., None]).to(dtype)


def prefill_decoder_block(params: Tree, x: torch.Tensor, cfg: BlockConfig,
                          max_len: int, quantized: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Causal full-sequence pass that also returns the populated cache."""
    b, s, _ = x.shape
    x, aux, k, v = _attend_and_ffn(params, x, cfg, True,
                                   _positions(b, s, x.device))
    return x, aux, _prefill_cache(k, v, max_len, quantized)


def prefill_decoder_block_into(params: Tree, x: torch.Tensor,
                               cfg: BlockConfig, cache: Dict,
                               slot: torch.Tensor, real: RealTokens
                               ) -> torch.Tensor:
    """The causal pass of one prompt padded at its end (x: (1, B, d)),
    its keys and values written in place into rows [0, B) of row
    ``slot`` ((1,) int64 on the device) of the batch cache ``cache``.
    Causal attention keeps every real position from seeing a pad, and
    the MoE takes only the real tokens (``real``), so each real
    position's output and K/V are those of the prompt alone. The pads'
    rows of the cache lie past the slot's length, where no decode step
    reads. Returns x; the aux loss is dropped."""
    b, s, _ = x.shape
    x, _, k, v = _attend_and_ffn(params, x, cfg, True,
                                 _positions(b, s, x.device), real)
    for name, t in (("k", k), ("v", v)):
        cache[name].narrow(1, 0, s).index_copy_(0, slot, t)
    return x


#: per_shard roles of a cache's K/V and scales: written independently per
#: (batch, head)
_SCALE = ("b", None, "h")


def _prefill_cache(k: torch.Tensor, v: torch.Tensor, max_len: int,
                   quantized: bool = False) -> Dict[str, torch.Tensor]:
    """A prefill's cache: k/v (b, s, hkv, d) written at positions [0, s)
    of zeros ``max_len`` deep (int8 and fp16 scales if ``quantized``). On
    a mesh each rank writes its local (batch, head) shards, and the cache
    comes back placed as k and v are, its sequence whole."""

    def fill(k, v):
        b, s = k.shape[:2]
        cache = _zero_cache((b, max_len, *k.shape[2:]), k.dtype, k.device,
                            quantized)
        for name, t in (("k", k), ("v", v)):
            if quantized:
                q, scale = _quantize_kv(t)
                cache[name][:, :s] = q
                cache[f"{name}_scale"][:, :s] = scale
            else:
                cache[name][:, :s] = t
        return cache

    roles = {"k": _BSHD, "v": _BSHD}
    if quantized:
        roles.update(k_scale=_SCALE, v_scale=_SCALE)
    return per_shard(fill, (k, v), (_BSHD, _BSHD), roles)


def _write_at(buf: torch.Tensor, at: torch.Tensor, new: torch.Tensor
              ) -> None:
    """``buf[r, at[r]] = new[r]`` for every row r, in place. buf: (b, S,
    ...); at: (b,); new: (b, ...).

    On a mesh ``buf`` is a DTensor whose sequence dim may be sharded (the
    cache's ``cache_seq``): each rank writes its own shard, and only the
    rows whose ``at`` falls inside its slice of the sequence, so no
    collective runs beyond placing ``at`` and ``new`` by ``buf``'s rows
    (an in-place op on a DTensor cannot change its placement). The other
    rows rewrite the value they hold, so the result is the unsharded
    write's bit for bit.
    """
    if not isinstance(buf, DTensor):
        buf[torch.arange(buf.shape[0], device=buf.device), at] = new
        return
    mesh = buf.device_mesh
    # new lacks buf's sequence dim; at has only buf's batch dim
    new_place = [Shard(p.dim - (p.dim > 1))
                 if isinstance(p, Shard) and p.dim != 1 else Replicate()
                 for p in buf.placements]
    at_place = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
                for p in buf.placements]
    local = buf.to_local()
    _, offset = compute_local_shape_and_global_offset(buf.shape, mesh,
                                                      buf.placements)
    pos = _local_as(at, mesh, at_place) - offset[1]
    new_l = _local_as(new, mesh, new_place).to(local.dtype)
    mine = (pos >= 0) & (pos < local.shape[1])
    pos = pos.clamp(0, local.shape[1] - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    keep = local[rows, pos]
    mine = mine.reshape(-1, *(1,) * (new_l.dim() - 1))
    local[rows, pos] = torch.where(mine, new_l, keep)


def _local_as(t: torch.Tensor, mesh, place) -> torch.Tensor:
    """This rank's shard of ``t`` (a DTensor, or a plain tensor the same on
    every rank) placed by ``place``."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, place).to_local()


def decode_decoder_block(params: Tree, x: torch.Tensor, cache: Dict,
                         length: torch.Tensor, cfg: BlockConfig
                         ) -> Tuple[torch.Tensor, Dict]:
    """One-token step. x: (b, 1, d); length: (b,) current cache fill.

    The new key and value (int8 and their scales, in a quantized cache)
    are written into ``cache`` in place at ``length`` (on a mesh, each
    rank into its own shard: :func:`_write_at`), where the reference adds
    a one-hot row: the slot at ``length`` is zero, so both give the same
    cache. A row already past the end (only an idle slot
    gets there) rewrites its last position, where the reference drops the
    write; no live request reads it. With ``attn_impl="kernel"`` an
    unquantized cache that is not a DTensor is attended by the decode
    attention kernel (its plain version on the CPU); every other cache
    through plain attention over the mask ``arange(S) <= length``. A
    quantized cache is dequantized whole to ``x``'s dtype for the
    attention, as in the reference. The block's aux loss is dropped.
    """
    b = x.shape[0]
    with span("rt.attn"):
        h = apply_norm(params["norm1"], x, cfg.norm, cfg.norm_eps)
        positions = length[:, None]
        q, k_new, v_new = _project_qkv(params["attn"], h, h, cfg.n_heads,
                                       cfg.kv_heads, cfg.head_dim, positions,
                                       positions, cfg.rope_theta)
        max_len = cache["k"].shape[1]
        at = length.clamp(max=max_len - 1)
        if "k_scale" in cache:
            for name, new in (("k", k_new), ("v", v_new)):
                q_new, s_new = _quantize_kv(new)
                _write_at(cache[name], at, q_new[:, 0])
                _write_at(cache[f"{name}_scale"], at, s_new[:, 0])
            k = _dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
            v = _dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
        else:
            _write_at(cache["k"], at, k_new[:, 0])
            _write_at(cache["v"], at, v_new[:, 0])
            k, v = cache["k"], cache["v"]
        if (cfg.attn_impl == "kernel" and "k_scale" not in cache
                and not any(isinstance(t, DTensor) for t in (q, k))):
            # each slot's live rows, read in place once per query group
            o = decode_ops.decode_attention(q, k, v, length,
                                            scale=cfg.attn_scale)
        else:
            valid = (torch.arange(max_len, device=x.device)[None, :]
                     <= length[:, None])
            o = _sdpa_plain(q, k, v, causal=False, kv_len_mask=valid,
                            scale=cfg.attn_scale)
        x = x + residual(o.reshape(b, 1, cfg.n_heads * cfg.head_dim)
                         @ params["attn"]["wo"], cfg)
    f, _ = _ffn(params, x, cfg)
    return x + residual(f, cfg), cache


# --------------------------------------------------------------------------
# cross-attention block (whisper decoder / llama-vision gated layers)
# --------------------------------------------------------------------------

def make_cross_block(gen, cfg: BlockConfig, dtype, device, *,
                     gated: bool = False, self_attn: bool = True) -> Tree:
    """Cross-attention block. ``self_attn=True``: a whisper decoder layer
    (self + cross + MLP); ``gated=True``: a llama-vision gated layer
    (cross + MLP with tanh-gated residuals, no self-attention). The gates
    start at 0, so a fresh gated layer adds nothing."""
    params: Tree = {}
    if self_attn:
        params["self_attn"] = make_attention_params(
            gen, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim, dtype,
            device, qkv_bias=cfg.qkv_bias)
        params["norm_self"] = make_norm_params(cfg.d_model, cfg.norm, dtype,
                                               device)
    params["cross_attn"] = make_attention_params(
        gen, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim, dtype,
        device, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm and gated)
    params["norm_cross"] = make_norm_params(cfg.d_model, cfg.norm, dtype,
                                            device)
    params["mlp"] = make_mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.mlp,
                                    dtype, device)
    params["norm_mlp"] = make_norm_params(cfg.d_model, cfg.norm, dtype,
                                          device)
    if gated:
        params["gate_attn"] = torch.zeros((), dtype=torch.float32,
                                          device=device)
        params["gate_mlp"] = torch.zeros((), dtype=torch.float32,
                                         device=device)
    return params


def cross_block_axes(cfg: BlockConfig, *, gated: bool = False,
                     self_attn: bool = True) -> Tree:
    """The logical axes of :func:`make_cross_block`'s tree; the gates are
    scalars, with no axis."""
    axes: Tree = {}
    if self_attn:
        axes["self_attn"] = attention_axes(qkv_bias=cfg.qkv_bias)
        axes["norm_self"] = norm_axes(cfg.norm)
    axes["cross_attn"] = attention_axes(qkv_bias=cfg.qkv_bias,
                                        qk_norm=cfg.qk_norm and gated)
    axes["norm_cross"] = norm_axes(cfg.norm)
    axes["mlp"] = mlp_axes(cfg.mlp)
    axes["norm_mlp"] = norm_axes(cfg.norm)
    if gated:
        axes.update(gate_attn=(), gate_mlp=())
    return axes


def _cross_attend(params: Tree, h: torch.Tensor, kv: torch.Tensor,
                  cfg: BlockConfig) -> torch.Tensor:
    """h: (b, s, d) queries; kv: (b, skv, d) encoder or image states. No
    rope, no mask, and plain attention whatever ``cfg.attn_impl``, as in
    the reference."""
    b, s, _ = h.shape
    q, k, v = _project_qkv(params, h, kv, cfg.n_heads, cfg.kv_heads,
                           cfg.head_dim, None, None, None)
    o = sdpa(q, k, v, causal=False, impl="plain")
    return o.reshape(b, s, -1) @ params["wo"]


def _cross_attend_cached(params: Tree, h: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, cfg: BlockConfig) -> torch.Tensor:
    """Decode path: the source's K/V were projected once, at prefill."""
    b, s, _ = h.shape
    q, _, _ = _project_qkv(params, h, h[:, :1], cfg.n_heads, cfg.kv_heads,
                           cfg.head_dim, None, None, None)
    o = _sdpa_plain(q, k, v, causal=False)
    return o.reshape(b, s, -1) @ params["wo"]


def cross_source_kv(params: Tree, kv_x: torch.Tensor, cfg: BlockConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention K/V of the encoder or image states."""
    _, k, v = _project_qkv(params, kv_x[:, :1], kv_x, cfg.n_heads,
                           cfg.kv_heads, cfg.head_dim, None, None, None)
    return k, v


def _gate(params: Tree, name: str, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(params[name]).to(x.dtype) * x


def _self_attend(params: Tree, x: torch.Tensor, cfg: BlockConfig):
    """The causal self-attention sublayer of a whisper decoder layer;
    returns (x, k, v)."""
    b, s, _ = x.shape
    h = apply_norm(params["norm_self"], x, cfg.norm)
    positions = _positions(b, s, x.device)
    q, k, v = _project_qkv(params["self_attn"], h, h, cfg.n_heads,
                           cfg.kv_heads, cfg.head_dim, positions, positions,
                           cfg.rope_theta)
    o = sdpa(q, k, v, causal=True, impl=cfg.attn_impl)
    return x + o.reshape(b, s, -1) @ params["self_attn"]["wo"], k, v


def _cross_and_mlp(params: Tree, x: torch.Tensor, c: torch.Tensor,
                   cfg: BlockConfig, gated: bool) -> torch.Tensor:
    """The residual of the cross-attention output ``c``, then the MLP
    sublayer, each tanh-gated in a gated block."""
    x = x + (_gate(params, "gate_attn", c) if gated else c)
    f = apply_mlp(params["mlp"], apply_norm(params["norm_mlp"], x, cfg.norm),
                  cfg.mlp)
    return x + (_gate(params, "gate_mlp", f) if gated else f)


def apply_cross_block(params: Tree, x: torch.Tensor, kv_x: torch.Tensor,
                      cfg: BlockConfig, *, gated: bool = False
                      ) -> torch.Tensor:
    """Full-sequence cross block (forward / prefill)."""
    if "self_attn" in params:
        x, _, _ = _self_attend(params, x, cfg)
    c = _cross_attend(params["cross_attn"],
                      apply_norm(params["norm_cross"], x, cfg.norm), kv_x, cfg)
    return _cross_and_mlp(params, x, c, cfg, gated)


def prefill_cross_block(params: Tree, x: torch.Tensor, kv_x: torch.Tensor,
                        cfg: BlockConfig, max_len: int
                        ) -> Tuple[torch.Tensor, Dict]:
    """A whisper decoder layer's prefill (``Model._prefill_cross`` in the
    reference): the full-sequence block that also returns its cache, the
    causal self K/V padded to ``max_len`` and the source's K/V."""
    x, k, v = _self_attend(params, x, cfg)
    cache = _prefill_cache(k, v, max_len)
    cache["xk"], cache["xv"] = cross_source_kv(params["cross_attn"], kv_x,
                                               cfg)
    c = _cross_attend(params["cross_attn"],
                      apply_norm(params["norm_cross"], x, cfg.norm), kv_x, cfg)
    return _cross_and_mlp(params, x, c, cfg, False), cache


def decode_cross_block(params: Tree, x: torch.Tensor, cache: Dict,
                       length: torch.Tensor, cfg: BlockConfig, *,
                       gated: bool = False) -> Tuple[torch.Tensor, Dict]:
    """One-token step; ``cache`` holds the self K/V (a whisper layer),
    written in place at ``length`` as in :func:`decode_decoder_block`,
    and the source's K/V projected at prefill."""
    if "self_attn" in params:
        b = x.shape[0]
        h = apply_norm(params["norm_self"], x, cfg.norm)
        positions = length[:, None]
        q, k_new, v_new = _project_qkv(params["self_attn"], h, h,
                                       cfg.n_heads, cfg.kv_heads,
                                       cfg.head_dim, positions, positions,
                                       cfg.rope_theta)
        max_len = cache["k"].shape[1]
        at = length.clamp(max=max_len - 1)
        _write_at(cache["k"], at, k_new[:, 0])
        _write_at(cache["v"], at, v_new[:, 0])
        valid = (torch.arange(max_len, device=x.device)[None, :]
                 <= length[:, None])
        o = _sdpa_plain(q, cache["k"], cache["v"], causal=False,
                        kv_len_mask=valid)
        x = x + o.reshape(b, 1, -1) @ params["self_attn"]["wo"]
    c = _cross_attend_cached(params["cross_attn"],
                             apply_norm(params["norm_cross"], x, cfg.norm),
                             cache["xk"], cache["xv"], cfg)
    return _cross_and_mlp(params, x, c, cfg, gated), cache


# --------------------------------------------------------------------------
# encoder block (whisper encoder: bidirectional self-attention + MLP)
# --------------------------------------------------------------------------

def apply_encoder_block(params: Tree, x: torch.Tensor, cfg: BlockConfig
                        ) -> torch.Tensor:
    out, _ = apply_decoder_block(params, x, cfg, causal=False)
    return out
