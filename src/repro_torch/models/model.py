"""Model factory of the port (counterpart of ``repro.models.model``).

One config schema; the dense decoder family is ported so far. Entry
points, as in the reference:

  ``forward``      full-sequence logits
  ``loss``         next-token CE with fp32 softmax
  ``prefill``      full-sequence pass that also emits the decode cache
  ``decode_step``  one-token step against the cache

Params and caches are nested dicts of tensors in the reference layout:
weights stored as (in, out) and a leading ``layers`` axis on the block
stack, so the bridge from the reference is a plain tree map.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import (apply_norm, embed_tokens,
                                       make_embed_params, make_norm_params,
                                       unembed)
from repro_torch.models.transformer import (BLOCK_CACHE_AXES, BlockConfig,
                                            apply_decoder_block,
                                            decode_decoder_block,
                                            init_block_cache, layer_slice,
                                            make_decoder_block,
                                            prefill_decoder_block,
                                            stack_params, tree_leaves,
                                            tree_map)

Tree = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense (the only family ported)
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    norm: str = "rmsnorm"
    mlp: str = "swiglu"
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: Optional[float] = 10000.0
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    attn_impl: str = "plain"         # plain | kernel
    vocab_pad: int = 256
    kv_cache_quant: bool = False     # int8 KV cache: not ported yet

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad
        return ((self.vocab + p - 1) // p) * p

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def block_cfg(self) -> BlockConfig:
        return BlockConfig(
            d_model=self.d_model, n_heads=self.n_heads, kv_heads=self.kv_heads,
            head_dim=self.hd, d_ff=self.d_ff,
            norm=self.norm, mlp=self.mlp, qkv_bias=self.qkv_bias,
            qk_norm=self.qk_norm, rope_theta=self.rope_theta,
            attn_impl=self.attn_impl)

    def n_params(self) -> int:
        """Total parameter count, from shapes on the meta device."""
        params = Model(self, device="meta").init()
        return sum(math.prod(p.shape) for p in tree_leaves(params))


class Model:
    """Functional model wrapper: holds the config and the device."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported to PyTorch yet; only "
                "'dense' is")
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- parameters -----------------------------------------------------------

    def init(self, seed: int = 0) -> Tree:
        """Random weights drawn from a ``torch.Generator`` on the model's
        device (none is drawn on the meta device)."""
        gen = None
        if self.device.type != "meta":
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
        return self._build_decoder(gen)

    def _build_decoder(self, gen) -> Tree:
        cfg, dev, dt = self.cfg, self.device, self.cfg.tdtype
        bcfg = cfg.block_cfg()
        return {"embed": make_embed_params(gen, cfg.padded_vocab, cfg.d_model,
                                           dt, cfg.tie_embeddings, dev),
                "layers": stack_params(
                    cfg.n_layers,
                    lambda: make_decoder_block(gen, bcfg, dt, dev)),
                "final_norm": make_norm_params(cfg.d_model, cfg.norm, dt,
                                               dev)}

    # -- shared pieces ----------------------------------------------------------

    def _logits(self, params: Tree, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        logits = unembed(params["embed"], x).float()
        if cfg.padded_vocab != cfg.vocab:          # mask pad columns
            pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
            logits = logits.masked_fill(pad, -1e30)
        return logits

    def _decoder_forward(self, params: Tree, x: torch.Tensor):
        cfg = self.cfg
        bcfg = cfg.block_cfg()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.n_layers):
            x, a = apply_decoder_block(layer_slice(params["layers"], i), x,
                                       bcfg)
            aux = aux + a
        return apply_norm(params["final_norm"], x, cfg.norm), aux

    # -- forward / loss ----------------------------------------------------------

    def forward(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward. Returns (logits fp32, aux loss)."""
        x = embed_tokens(params["embed"], batch["tokens"])
        x, aux = self._decoder_forward(params, x)
        return self._logits(params, x), aux

    def loss(self, params: Tree, batch: Dict[str, torch.Tensor]):
        """Next-token CE over valid (label >= 0) positions + aux."""
        logits, aux = self.forward(params, batch)
        labels = batch["labels"]
        valid = (labels >= 0).float()
        lse = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1,
                              labels.clamp(min=0)[..., None])[..., 0]
        ce = (lse - picked) * valid
        n = valid.sum().clamp(min=1.0)
        ce_mean = ce.sum() / n
        total = ce_mean + aux
        return total, {"loss": total, "ce": ce_mean, "aux": aux, "tokens": n}

    # -- serving (prefill / decode) ----------------------------------------------

    def make_cache(self, batch: int, max_len: int) -> Tuple[Tree, Tree]:
        """Zero-initialised decode cache + its logical axes."""
        cfg = self.cfg
        one = init_block_cache(batch, max_len, cfg.block_cfg(), cfg.tdtype,
                               self.device, quantized=cfg.kv_cache_quant)
        layers = {k: torch.zeros((cfg.n_layers, *t.shape), dtype=t.dtype,
                                 device=t.device) for k, t in one.items()}
        axes = {"layers": {k: ("layers", *a)
                           for k, a in BLOCK_CACHE_AXES.items()},
                "length": ("batch",)}
        length = torch.zeros(batch, dtype=torch.int32, device=self.device)
        return {"layers": layers, "length": length}, axes

    def prefill(self, params: Tree, batch: Dict[str, torch.Tensor],
                max_len: int) -> Tuple[torch.Tensor, Tree]:
        """Process the full prompt; emit last-position logits + cache."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        bcfg = cfg.block_cfg()
        x = embed_tokens(params["embed"], tokens)
        caches = []
        for i in range(cfg.n_layers):
            x, _, c = prefill_decoder_block(layer_slice(params["layers"], i),
                                            x, bcfg, max_len,
                                            quantized=cfg.kv_cache_quant)
            caches.append(c)
        x = apply_norm(params["final_norm"], x, cfg.norm)
        length = torch.full((b,), s, dtype=torch.int32, device=x.device)
        layers = tree_map(lambda *cs: torch.stack(cs), *caches)
        return self._logits(params, x[:, -1:]), {"layers": layers,
                                                 "length": length}

    def decode_step(self, params: Tree, cache: Tree, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Tree]:
        """One token for every sequence. tokens: (b, 1).

        The cache's tensors are updated in place; the returned cache holds
        them and the advanced length.
        """
        cfg = self.cfg
        bcfg = cfg.block_cfg()
        length = cache["length"]
        x = embed_tokens(params["embed"], tokens)
        for i in range(cfg.n_layers):
            x, _ = decode_decoder_block(layer_slice(params["layers"], i), x,
                                        layer_slice(cache["layers"], i),
                                        length, bcfg)
        x = apply_norm(params["final_norm"], x, cfg.norm)
        return self._logits(params, x), {"layers": cache["layers"],
                                         "length": length + 1}
