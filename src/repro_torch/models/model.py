"""Model factory of the port (counterpart of ``repro.models.model``).

One config schema; three families are ported so far:

  dense   decoder-only transformer (starcoder2, qwen3, qwen1.5, olmo)
  moe     decoder-only with an MoE FFN (qwen2-moe, granite-moe)
  hybrid  Mamba2 backbone + one *shared* attention block applied every
          k layers (zamba2)

Entry points, as in the reference:

  ``forward``      full-sequence logits
  ``loss``         next-token CE (+ MoE aux) with fp32 softmax; while grad
                   is on, each layer is rematerialised as ``cfg.remat``
                   says
  ``prefill``      full-sequence pass that also emits the decode cache
  ``decode_step``  one-token step against the cache

Params and caches are nested dicts of tensors in the reference layout:
weights stored as (in, out) and a leading ``layers`` axis on the block
stack, so the bridge from the reference is a plain tree map.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import mamba2 as m2
from repro_torch.models.layers import (apply_norm, embed_tokens,
                                       make_embed_params, make_norm_params,
                                       unembed)
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import (BLOCK_CACHE_AXES,
                                            BLOCK_CACHE_AXES_Q, BlockConfig,
                                            apply_decoder_block,
                                            decode_decoder_block,
                                            init_block_cache, layer_slice,
                                            make_decoder_block,
                                            prefill_decoder_block,
                                            stack_params, tree_leaves,
                                            tree_map, unstack_params)

Tree = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid (the ported ones)
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
    moe: Optional[MoEConfig] = None
    ssm: Optional[m2.SSMConfig] = None
    shared_attn_every: int = 0       # hybrid: shared block cadence
    shared_attn_d_ff: int = 0        # hybrid: shared block MLP width
    dtype: str = "bfloat16"
    attn_impl: str = "plain"         # plain | kernel
    use_ssm_kernel: bool = False     # hybrid: SSD scan through its kernels
    vocab_pad: int = 256
    remat: str = "dots"              # none | dots | full
    sub_quadratic: bool = False      # can serve long_500k
    kv_cache_quant: bool = False     # int8 KV cache (dense/moe decode)

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

    def block_cfg(self, *, moe: bool = True, d_ff: Optional[int] = None
                  ) -> BlockConfig:
        return BlockConfig(
            d_model=self.d_model, n_heads=self.n_heads, kv_heads=self.kv_heads,
            head_dim=self.hd, d_ff=d_ff if d_ff is not None else self.d_ff,
            norm=self.norm, mlp=self.mlp, qkv_bias=self.qkv_bias,
            qk_norm=self.qk_norm, rope_theta=self.rope_theta,
            moe=self.moe if moe else None, attn_impl=self.attn_impl)

    def n_params(self) -> int:
        """Total parameter count, from shapes on the meta device."""
        params = Model(self, device="meta").init()
        return sum(math.prod(p.shape) for p in tree_leaves(params))

    def n_active_params(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        total = self.n_params()
        if self.moe is None:
            return total
        per_expert = 3 * self.d_model * self.moe.expert_ff
        inactive = (self.moe.n_experts - self.moe.top_k) * per_expert \
            * self.n_layers
        return total - inactive


REMAT = ("none", "dots", "full")


def _save_dots(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``"dots"``: keep the outputs of 2-D
    matmuls (the projections, ``aten.mm``) and recompute the rest,
    attention's batched products (``aten.bmm``) included, as the
    reference's ``checkpoint_dots_with_no_batch_dims`` does."""
    return (CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn: Callable, remat: str) -> Callable:
    """``fn`` wrapped for rematerialisation while grad is on: ``"full"``
    saves nothing, ``"dots"`` saves the projections (``_save_dots``).
    With grad off (serving) ``fn`` runs as it is."""
    if remat not in REMAT:
        raise ValueError(f"unknown remat policy {remat!r}")
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return functools.partial(
        checkpoint, fn, use_reentrant=False,
        context_fn=functools.partial(create_selective_checkpoint_contexts,
                                     _save_dots))


class Model:
    """Functional model wrapper: holds the config and the device."""

    FAMILIES = ("dense", "moe", "hybrid")

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        if cfg.family not in self.FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported to PyTorch yet; "
                f"ported: {self.FAMILIES}")
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
        if self.cfg.family == "hybrid":
            return self._build_hybrid(gen)
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

    def _build_hybrid(self, gen) -> Tree:
        cfg, dev, dt = self.cfg, self.device, self.cfg.tdtype

        def mamba_layer():
            return {"mamba": m2.make_mamba2_params(gen, cfg.d_model, cfg.ssm,
                                                   dt, dev),
                    "norm": make_norm_params(cfg.d_model, cfg.norm, dt, dev)}

        return {"embed": make_embed_params(gen, cfg.padded_vocab, cfg.d_model,
                                           dt, cfg.tie_embeddings, dev),
                "layers": stack_params(cfg.n_layers, mamba_layer),
                "shared": make_decoder_block(gen, self._shared_cfg(), dt,
                                             dev),
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
        block = _maybe_remat(
            lambda lp, h: apply_decoder_block(lp, h, bcfg), cfg.remat)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in unstack_params(params["layers"], cfg.n_layers):
            x, a = block(lp, x)
            aux = aux + a
        return apply_norm(params["final_norm"], x, cfg.norm), aux

    # -- hybrid (zamba2) ---------------------------------------------------------

    def _shared_cfg(self) -> BlockConfig:
        return self.cfg.block_cfg(moe=False, d_ff=self.cfg.shared_attn_d_ff)

    def _shared_flags(self) -> np.ndarray:
        """Static per-layer flags: apply the shared block after layer i."""
        cfg = self.cfg
        k = cfg.shared_attn_every
        return (np.arange(cfg.n_layers) % k) == (k - 1)

    def _hybrid_forward(self, params: Tree, x: torch.Tensor):
        cfg = self.cfg
        sb_cfg = self._shared_cfg()

        def body(lp, h, flag):
            hn = apply_norm(lp["norm"], h, cfg.norm)
            h = h + m2.apply_mamba2(lp["mamba"], hn, cfg.ssm,
                                    use_kernel=cfg.use_ssm_kernel)
            if flag:
                h, _ = apply_decoder_block(params["shared"], h, sb_cfg)
            return h

        body = _maybe_remat(body, cfg.remat)
        for lp, flag in zip(unstack_params(params["layers"], cfg.n_layers),
                            self._shared_flags()):
            x = body(lp, x, bool(flag))
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return apply_norm(params["final_norm"], x, cfg.norm), aux

    # -- forward / loss ----------------------------------------------------------

    def forward(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward. Returns (logits fp32, aux loss)."""
        x = embed_tokens(params["embed"], batch["tokens"])
        if self.cfg.family == "hybrid":
            x, aux = self._hybrid_forward(params, x)
        else:
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
        length = torch.zeros(batch, dtype=torch.int32, device=self.device)
        prepend = lambda axes: {k: ("layers", *a) for k, a in axes.items()}
        if cfg.family == "hybrid":
            n_apps = int(self._shared_flags().sum())
            one = init_block_cache(batch, max_len, self._shared_cfg(),
                                   cfg.tdtype, self.device)
            mamba = m2.init_mamba2_cache(batch, cfg.d_model, cfg.ssm,
                                         cfg.tdtype, self.device)
            axes = {"mamba": {"h": ("layers", "batch", "inner", None, None),
                              "conv": ("layers", "batch", None, "inner")},
                    "attn": prepend(BLOCK_CACHE_AXES), "length": ("batch",)}
            return {"mamba": _stacked(mamba, cfg.n_layers),
                    "attn": _stacked(one, n_apps), "length": length}, axes
        one = init_block_cache(batch, max_len, cfg.block_cfg(), cfg.tdtype,
                               self.device, quantized=cfg.kv_cache_quant)
        axes = {"layers": prepend(BLOCK_CACHE_AXES_Q if cfg.kv_cache_quant
                                  else BLOCK_CACHE_AXES),
                "length": ("batch",)}
        return {"layers": _stacked(one, cfg.n_layers), "length": length}, axes

    def prefill(self, params: Tree, batch: Dict[str, torch.Tensor],
                max_len: int) -> Tuple[torch.Tensor, Tree]:
        """Process the full prompt; emit last-position logits + cache."""
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = embed_tokens(params["embed"], tokens)
        length = torch.full((b,), s, dtype=torch.int32, device=x.device)
        stack = lambda cs: tree_map(lambda *xs: torch.stack(xs), *cs)
        if cfg.family == "hybrid":
            # mamba prefill runs the chunked scan and keeps final states;
            # shared-attn applications emit their own KV caches
            sb_cfg = self._shared_cfg()
            mamba_states, attn_caches = [], []
            for i, flag in enumerate(self._shared_flags()):
                lp = layer_slice(params["layers"], i)
                hn = apply_norm(lp["norm"], x, cfg.norm)
                y, st = self._mamba_prefill(lp["mamba"], hn)
                x = x + y
                mamba_states.append(st)
                if flag:
                    x, _, c = prefill_decoder_block(params["shared"], x,
                                                    sb_cfg, max_len)
                    attn_caches.append(c)
            x = apply_norm(params["final_norm"], x, cfg.norm)
            return self._logits(params, x[:, -1:]), {
                "mamba": stack(mamba_states), "attn": stack(attn_caches),
                "length": length}
        bcfg = cfg.block_cfg()
        caches = []
        for i in range(cfg.n_layers):
            x, _, c = prefill_decoder_block(layer_slice(params["layers"], i),
                                            x, bcfg, max_len,
                                            quantized=cfg.kv_cache_quant)
            caches.append(c)
        x = apply_norm(params["final_norm"], x, cfg.norm)
        return self._logits(params, x[:, -1:]), {"layers": stack(caches),
                                                 "length": length}

    def _mamba_prefill(self, mp: Tree, hn: torch.Tensor):
        """Mamba2 full-seq pass that also returns the final SSM state.

        It passes ``use_ssm_kernel`` on, where the reference's prefill
        drops it and always runs the chunked path: both compute the same
        (tests/test_torch_mamba2.py), and serving is where the kernels run.
        """
        cfg = self.cfg
        return m2.apply_mamba2_with_state(mp, hn, cfg.ssm,
                                          use_kernel=cfg.use_ssm_kernel)

    def decode_step(self, params: Tree, cache: Tree, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Tree]:
        """One token for every sequence. tokens: (b, 1).

        The cache's tensors are updated in place (the reference returns new
        ones); the returned cache holds them and the advanced length.
        """
        cfg = self.cfg
        length = cache["length"]
        x = embed_tokens(params["embed"], tokens)
        if cfg.family == "hybrid":
            sb_cfg = self._shared_cfg()
            app = 0
            for i, flag in enumerate(self._shared_flags()):
                lp = layer_slice(params["layers"], i)
                mc = layer_slice(cache["mamba"], i)
                hn = apply_norm(lp["norm"], x, cfg.norm)
                y, new = m2.decode_mamba2(lp["mamba"], hn, mc, cfg.ssm)
                x = x + y
                for k, t in new.items():
                    mc[k].copy_(t)
                if flag:
                    x, _ = decode_decoder_block(
                        params["shared"], x, layer_slice(cache["attn"], app),
                        length, sb_cfg)
                    app += 1
            x = apply_norm(params["final_norm"], x, cfg.norm)
            return self._logits(params, x), dict(cache, length=length + 1)
        bcfg = cfg.block_cfg()
        for i in range(cfg.n_layers):
            x, _ = decode_decoder_block(layer_slice(params["layers"], i), x,
                                        layer_slice(cache["layers"], i),
                                        length, bcfg)
        x = apply_norm(params["final_norm"], x, cfg.norm)
        return self._logits(params, x), {"layers": cache["layers"],
                                         "length": length + 1}


def _stacked(one: Tree, n: int) -> Tree:
    """Zeros of ``n`` copies of the cache ``one`` on a leading axis."""
    return tree_map(lambda t: torch.zeros((n, *t.shape), dtype=t.dtype,
                                          device=t.device), one)
