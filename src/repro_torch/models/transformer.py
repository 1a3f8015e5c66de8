"""Dense decoder block (counterpart of ``repro.models.transformer``).

A block is a pre-norm attention sublayer plus a pre-norm MLP sublayer,
with residuals. Entry points:

  * ``apply_decoder_block``   — full sequence (forward),
  * ``prefill_decoder_block`` — full sequence that also emits the cache,
  * ``decode_decoder_block``  — one-token step against the cache.

Parameters of a stack of blocks carry a leading ``layers`` axis; the
model loops over it where the reference scans.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models.attention import (_project_qkv, _sdpa_plain,
                                          make_attention_params, sdpa)
from repro_torch.models.layers import (apply_mlp, apply_norm, make_mlp_params,
                                       make_norm_params)

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
    attn_impl: str = "plain"         # plain | kernel


# --------------------------------------------------------------------------
# parameter trees (nested dicts of tensors)
# --------------------------------------------------------------------------

def tree_map(fn: Callable, *trees):
    """Apply ``fn`` leaf-wise over nested dicts of the same structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def stack_params(n: int, maker: Callable[[], Tree]) -> Tree:
    """``n`` independently initialised copies of ``maker()`` stacked on a
    leading ``layers`` axis."""
    return tree_map(lambda *xs: torch.stack(xs), *[maker() for _ in range(n)])


def layer_slice(tree: Tree, i: int) -> Tree:
    return tree_map(lambda x: x[i], tree)


def unstack_params(tree: Tree, n: int) -> List[Tree]:
    """The ``n`` per-layer trees of a stacked tree, as views. Under
    autograd each leaf's gradient comes back through one ``unbind``,
    whose backward stacks the layers' gradients once; indexing each layer
    (:func:`layer_slice`) would give every layer a zero-filled gradient
    of the whole stack to add up, n times the stack's size in traffic."""
    parts = tree_map(torch.unbind, tree)
    return [tree_map(lambda ts: ts[i], parts) for i in range(n)]


# --------------------------------------------------------------------------
# standard decoder block (attention + MLP)
# --------------------------------------------------------------------------

def make_decoder_block(gen, cfg: BlockConfig, dtype, device) -> Tree:
    return {"attn": make_attention_params(
                gen, cfg.d_model, cfg.n_heads, cfg.kv_heads, cfg.head_dim,
                dtype, device, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm),
            "norm1": make_norm_params(cfg.d_model, cfg.norm, dtype, device),
            "norm2": make_norm_params(cfg.d_model, cfg.norm, dtype, device),
            "mlp": make_mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.mlp, dtype,
                                   device)}


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def _attend_and_mlp(params: Tree, x: torch.Tensor, cfg: BlockConfig,
                    causal: bool, positions: torch.Tensor):
    """Shared body of the full-sequence block; returns (x, k, v)."""
    b, s, _ = x.shape
    h = apply_norm(params["norm1"], x, cfg.norm)
    q, k, v = _project_qkv(params["attn"], h, h, cfg.n_heads, cfg.kv_heads,
                           cfg.head_dim, positions, positions, cfg.rope_theta)
    o = sdpa(q, k, v, causal=causal, impl=cfg.attn_impl)
    x = x + o.reshape(b, s, cfg.n_heads * cfg.head_dim) @ params["attn"]["wo"]
    hh = apply_norm(params["norm2"], x, cfg.norm)
    return x + apply_mlp(params["mlp"], hh, cfg.mlp), k, v


def apply_decoder_block(params: Tree, x: torch.Tensor, cfg: BlockConfig, *,
                        causal: bool = True,
                        positions: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence block. Returns (x, aux_loss); a dense block has no
    auxiliary loss."""
    b, s, _ = x.shape
    if positions is None:
        positions = _positions(b, s, x.device)
    x, _, _ = _attend_and_mlp(params, x, cfg, causal, positions)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# -- KV-cache paths ---------------------------------------------------------

def init_block_cache(batch: int, max_len: int, cfg: BlockConfig, dtype,
                     device, quantized: bool = False
                     ) -> Dict[str, torch.Tensor]:
    if quantized:
        raise NotImplementedError("the int8 KV cache is not ported yet")
    shape = (batch, max_len, cfg.kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


#: logical axes of a block KV cache; the engine finds the batch axis here
BLOCK_CACHE_AXES = {"k": ("batch", "cache_seq", None, None),
                    "v": ("batch", "cache_seq", None, None)}


def prefill_decoder_block(params: Tree, x: torch.Tensor, cfg: BlockConfig,
                          max_len: int, quantized: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """Causal full-sequence pass that also returns the populated cache."""
    b, s, _ = x.shape
    x, k, v = _attend_and_mlp(params, x, cfg, True, _positions(b, s, x.device))
    cache = init_block_cache(b, max_len, cfg, k.dtype, x.device, quantized)
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    return x, torch.zeros((), dtype=torch.float32, device=x.device), cache


def decode_decoder_block(params: Tree, x: torch.Tensor, cache: Dict,
                         length: torch.Tensor, cfg: BlockConfig
                         ) -> Tuple[torch.Tensor, Dict]:
    """One-token step. x: (b, 1, d); length: (b,) current cache fill.

    The new key and value are written into ``cache`` in place at
    ``length``, where the reference adds a one-hot row: the slot at
    ``length`` is zero, so both give the same cache. A row already past
    the end (only an idle slot gets there) rewrites its last position,
    where the reference drops the write; no live request reads it.
    """
    b = x.shape[0]
    h = apply_norm(params["norm1"], x, cfg.norm)
    positions = length[:, None]
    q, k_new, v_new = _project_qkv(params["attn"], h, h, cfg.n_heads,
                                   cfg.kv_heads, cfg.head_dim, positions,
                                   positions, cfg.rope_theta)
    max_len = cache["k"].shape[1]
    rows = torch.arange(b, device=x.device)
    at = length.clamp(max=max_len - 1)
    cache["k"][rows, at] = k_new[:, 0]
    cache["v"][rows, at] = v_new[:, 0]
    valid = torch.arange(max_len, device=x.device)[None, :] <= length[:, None]
    o = _sdpa_plain(q, cache["k"], cache["v"], causal=False,
                    kv_len_mask=valid)
    x = x + o.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ params["attn"]["wo"]
    hh = apply_norm(params["norm2"], x, cfg.norm)
    return x + apply_mlp(params["mlp"], hh, cfg.mlp), cache
