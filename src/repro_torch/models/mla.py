"""Multi-head latent attention (DeepSeek-V2) and its decoder block.

The block is :mod:`transformer`'s decoder block (pre-norm attention, then
an MLP or the experts, with residuals) whose attention is latent:

  * q = x W_q: per head ``nope_dim`` dims without position and
    ``rope_dim`` rotated ones;
  * [c, k_pe] = x W_kv_a: the ``kv_rank``-wide latent c, RMSNormed
    (``kv_norm``), and one ``rope_dim``-wide rotated key that every head
    shares;
  * [k_nope, v] = c W_kv_b, per head; the scores are q_nope . k_nope +
    q_pe . k_pe over nope_dim + rope_dim dims, the values ``v_dim`` wide,
    and ``wo`` maps the heads back to d_model.

The rope is DeepSeek's: the rope dims are de-interleaved
(:func:`layers.deinterleave`) and rotated split-half with YaRN's
frequencies, and the scores are scaled by ``BlockConfig.attn_scale``
(``ModelConfig.block_cfg``: (nope + rope)^-1/2 times YaRN's mscale
squared).

The decode cache of a layer is one row per position: [c, k_pe], kv_rank
+ rope_dim wide (576 at DeepSeek-V2's widths), in place of per-head K
and V. Two paths read it:

  * prefill, expanded (span ``rt.mla.expand``): k_nope and v are computed
    from c for every position and causal attention runs at q.k
    nope + rope, v v_dim (the flash kernel on the card);
  * decode, absorbed (span ``rt.mla.absorb``): W_kv_b's key half is
    folded into the query, q~ = q_nope W_uk^T (nope_dim -> kv_rank per
    head), so the scores are [q~, q_pe] . [c, k_pe] against the cache rows
    as they are: one multi-query attention of every head over one
    kv_rank + rope_dim wide "head" whose values are the rows' first
    kv_rank columns (the MLA decode kernel on the card), and the output
    (sum p c) W_uv. It equals the expanded product by associativity.

The latent, its norm, k_pe's rotation and the cache write are under
``rt.mla.latent``; everything of the sublayer under ``rt.attn``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.mla_decode import ops as mla_ops
from repro_torch.kernels.mla_decode.ref import mla_decode_ref
from repro_torch.models.attention import sdpa
from repro_torch.models.layers import (apply_norm, apply_rope, deinterleave,
                                       dense_init, make_norm_params, rms_norm)
from repro_torch.models.moe import RealTokens
from repro_torch.models.transformer import (BlockConfig, _ffn, _positions,
                                            _write_at, block_rest,
                                            block_rest_axes, residual)
from repro_torch.tracing import span

Tree = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """The widths of multi-head latent attention (DeepSeek-V2's
    ``kv_lora_rank``, ``qk_nope_head_dim``, ``qk_rope_head_dim``,
    ``v_head_dim``); the queries are projected at full rank (no
    ``q_lora_rank``)."""

    kv_rank: int
    nope_dim: int
    rope_dim: int
    v_dim: int

    @property
    def qk_dim(self) -> int:
        return self.nope_dim + self.rope_dim

    @property
    def row(self) -> int:
        """The width of one cache row: the latent and the shared k_pe."""
        return self.kv_rank + self.rope_dim


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

def make_mla_params(gen, d_model: int, n_heads: int, mla: MLAConfig, dtype,
                    device) -> Tree:
    """W_q (d, H (nope + rope)), W_kv_a (d, kv_rank + rope), the latent's
    norm, W_kv_b (kv_rank, H (nope + v)) with each head's k_nope then v
    columns, and W_o (H v, d)."""
    return {
        "wq": dense_init(gen, d_model, n_heads * mla.qk_dim, dtype, device),
        "wkv_a": dense_init(gen, d_model, mla.row, dtype, device),
        "kv_norm": make_norm_params(mla.kv_rank, "rmsnorm", dtype, device),
        "wkv_b": dense_init(gen, mla.kv_rank,
                            n_heads * (mla.nope_dim + mla.v_dim), dtype,
                            device),
        "wo": dense_init(gen, n_heads * mla.v_dim, d_model, dtype, device,
                         scale=(n_heads * mla.v_dim) ** -0.5),
    }


def mla_axes() -> Tree:
    """The logical axes of :func:`make_mla_params`' tree: the latent's
    width has no axis of its own (it is replicated)."""
    return {"wq": ("embed", "qkv"), "wkv_a": ("embed", None),
            "kv_norm": {"w": (None,)}, "wkv_b": (None, "qkv"),
            "wo": ("qkv", "embed")}


def make_decoder_block(gen, cfg: BlockConfig, dtype, device) -> Tree:
    """A decoder block with latent attention (the tree of
    :func:`transformer.make_decoder_block`, its ``attn`` latent)."""
    attn = make_mla_params(gen, cfg.d_model, cfg.n_heads, cfg.mla, dtype,
                           device)
    return {"attn": attn, **block_rest(gen, cfg, dtype, device)}


def decoder_block_axes(cfg: BlockConfig) -> Tree:
    return {"attn": mla_axes(), **block_rest_axes(cfg)}


def init_block_cache(batch: int, max_len: int, cfg: BlockConfig, dtype,
                     device, quantized: bool = False
                     ) -> Dict[str, torch.Tensor]:
    """One zero latent row per position: (batch, max_len, kv_rank +
    rope_dim). There is no int8 form (``quantized`` is refused by the
    decoder family)."""
    return {"latent": torch.zeros((batch, max_len, cfg.mla.row),
                                  dtype=dtype, device=device)}


#: logical axes of a latent cache; the engine finds the batch axis here
BLOCK_CACHE_AXES = {"latent": ("batch", "cache_seq", None)}


# --------------------------------------------------------------------------
# the attention sublayer
# --------------------------------------------------------------------------

def _rope(x: torch.Tensor, positions: torch.Tensor, cfg: BlockConfig
          ) -> torch.Tensor:
    """DeepSeek's rope on (b, s, heads, rope_dim): de-interleaved, then
    rotated split-half (YaRN's frequencies where the config scales)."""
    return apply_rope(deinterleave(x), positions, cfg.rope_theta, cfg.yarn)


def _queries(p: Tree, h: torch.Tensor, positions: torch.Tensor,
             cfg: BlockConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q_nope (b, s, H, nope), q_pe (b, s, H, rope) rotated)."""
    b, s, _ = h.shape
    mla = cfg.mla
    q = (h @ p["wq"]).view(b, s, cfg.n_heads, mla.qk_dim)
    q_nope, q_pe = q.split([mla.nope_dim, mla.rope_dim], dim=-1)
    return q_nope, _rope(q_pe, positions, cfg)


def _latent(p: Tree, h: torch.Tensor, positions: torch.Tensor,
            cfg: BlockConfig) -> torch.Tensor:
    """The cache rows of h (b, s, d): [rmsnorm(c), rotated k_pe], (b, s,
    kv_rank + rope)."""
    mla = cfg.mla
    kv = h @ p["wkv_a"]
    c = rms_norm(kv[..., :mla.kv_rank], p["kv_norm"]["w"], cfg.norm_eps)
    k_pe = _rope(kv[..., None, mla.kv_rank:], positions, cfg)
    return torch.cat([c, k_pe[:, :, 0]], dim=-1)


def _expanded(p: Tree, h: torch.Tensor, positions: torch.Tensor,
              cfg: BlockConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention of a whole sequence h (b, s, d), its keys and
    values expanded from the latent. Returns (the heads' output (b, s,
    H v), the cache rows (b, s, kv_rank + rope))."""
    b, s, _ = h.shape
    mla, nh = cfg.mla, cfg.n_heads
    q_nope, q_pe = _queries(p, h, positions, cfg)
    with span("rt.mla.latent"):
        rows = _latent(p, h, positions, cfg)
    with span("rt.mla.expand"):
        kv = (rows[..., :mla.kv_rank] @ p["wkv_b"]).view(
            b, s, nh, mla.nope_dim + mla.v_dim)
        k_nope, v = kv.split([mla.nope_dim, mla.v_dim], dim=-1)
        k_pe = rows[:, :, None, mla.kv_rank:].expand(b, s, nh, mla.rope_dim)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe], dim=-1)
        o = sdpa(q, k, v, causal=True, impl=cfg.attn_impl,
                 scale=cfg.attn_scale)
    return o.reshape(b, s, nh * mla.v_dim), rows


def _absorbed(p: Tree, h: torch.Tensor, cache: Dict, length: torch.Tensor,
              cfg: BlockConfig) -> torch.Tensor:
    """One position per row, h (b, 1, d), against the latent cache: its
    row written at ``length`` (as :func:`transformer._write_at` writes),
    then W_uk folded into the query and W_uv applied to the latent
    output. Returns the heads' output (b, 1, H v)."""
    b = h.shape[0]
    mla, nh = cfg.mla, cfg.n_heads
    positions = length[:, None]
    q_nope, q_pe = _queries(p, h, positions, cfg)
    with span("rt.mla.latent"):
        rows = _latent(p, h, positions, cfg)
        latent = cache["latent"]
        _write_at(latent, length.clamp(max=latent.shape[1] - 1), rows[:, 0])
    with span("rt.mla.absorb"):
        # W_kv_b as (kv_rank, H, nope + v): the heads' k_nope and v halves
        w = p["wkv_b"].view(mla.kv_rank, nh, mla.nope_dim + mla.v_dim)
        # q~ (H, b, kv_rank) = q_nope (H, b, nope) W_uk^T (H, nope, kv_rank)
        q_abs = torch.matmul(q_nope[:, 0].transpose(0, 1),
                             w[..., :mla.nope_dim].permute(1, 2, 0))
        q_lat = torch.cat([q_abs.transpose(0, 1), q_pe[:, 0]], dim=-1)
        if cfg.attn_impl == "kernel":
            o_lat = mla_ops.mla_decode(q_lat, latent, length,
                                       v_dim=mla.kv_rank,
                                       scale=cfg.attn_scale)
        else:
            o_lat = mla_decode_ref(q_lat, latent, length, v_dim=mla.kv_rank,
                                   scale=cfg.attn_scale)
        # (H, b, kv_rank) W_uv (H, kv_rank, v)
        o = torch.matmul(o_lat.transpose(0, 1),
                         w[..., mla.nope_dim:].permute(1, 0, 2))
    return o.transpose(0, 1).reshape(b, 1, nh * mla.v_dim)


# --------------------------------------------------------------------------
# the block's entry points (those of transformer's decoder block)
# --------------------------------------------------------------------------

def _attend_and_ffn(params: Tree, x: torch.Tensor, cfg: BlockConfig,
                    real: Optional[RealTokens] = None):
    """The full-sequence block; returns (x, aux, the cache rows)."""
    b, s, _ = x.shape
    with span("rt.attn"):
        h = apply_norm(params["norm1"], x, cfg.norm, cfg.norm_eps)
        o, rows = _expanded(params["attn"], h, _positions(b, s, x.device),
                            cfg)
        x = x + residual(o @ params["attn"]["wo"], cfg)
    f, aux = _ffn(params, x, cfg, real)
    return x + residual(f, cfg), aux, rows


def apply_decoder_block(params: Tree, x: torch.Tensor, cfg: BlockConfig
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence causal block. Returns (x, aux)."""
    x, aux, _ = _attend_and_ffn(params, x, cfg)
    return x, aux


def prefill_decoder_block(params: Tree, x: torch.Tensor, cfg: BlockConfig,
                          max_len: int, quantized: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """The causal pass that also returns the layer's latent cache, its
    rows at [0, s) of zeros ``max_len`` deep."""
    b, s, _ = x.shape
    x, aux, rows = _attend_and_ffn(params, x, cfg)
    cache = init_block_cache(b, max_len, cfg, rows.dtype, rows.device,
                             quantized)
    cache["latent"][:, :s] = rows
    return x, aux, cache


def prefill_decoder_block_into(params: Tree, x: torch.Tensor,
                               cfg: BlockConfig, cache: Dict,
                               slot: torch.Tensor, real: RealTokens
                               ) -> torch.Tensor:
    """One prompt padded at its end (x (1, B, d)), its latent rows written
    in place into rows [0, B) of row ``slot`` of the batch cache, as
    :func:`transformer.prefill_decoder_block_into` writes K and V."""
    b, s, _ = x.shape
    x, _, rows = _attend_and_ffn(params, x, cfg, real)
    cache["latent"].narrow(1, 0, s).index_copy_(0, slot, rows)
    return x


def decode_decoder_block(params: Tree, x: torch.Tensor, cache: Dict,
                         length: torch.Tensor, cfg: BlockConfig
                         ) -> Tuple[torch.Tensor, Dict]:
    """One-token step against the latent cache, written in place at
    ``length`` (a row past the end rewrites the last position, as in
    :func:`transformer.decode_decoder_block`). With
    ``attn_impl="kernel"`` the MLA decode kernel reads the cache (its
    plain version on the CPU); else the plain version. The aux loss is
    dropped."""
    with span("rt.attn"):
        h = apply_norm(params["norm1"], x, cfg.norm, cfg.norm_eps)
        o = _absorbed(params["attn"], h, cache, length, cfg)
        x = x + residual(o @ params["attn"]["wo"], cfg)
    f, _ = _ffn(params, x, cfg)
    return x + residual(f, cfg), cache
