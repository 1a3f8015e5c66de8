"""Model factory of the port (counterpart of ``repro.models.model``).

One config schema, the reference's six families:

  dense   decoder-only transformer (starcoder2, qwen3, qwen1.5, olmo)
  moe     decoder-only with an MoE FFN (qwen2-moe, granite-moe)
  hybrid  Mamba2 backbone + one *shared* attention block applied every
          k layers (zamba2)
  ssm     xLSTM: mLSTM blocks with a recurrent sLSTM block every k
          (xlstm-350m)
  audio   encoder-decoder over precomputed frame embeddings (whisper; the
          conv frontend is a stub, as in the reference)
  vlm     decoder with gated cross-attention to precomputed patch
          embeddings every k layers (llama-3.2-vision)

and one of the port alone, with no counterpart in the reference:

  hybrid_moe  Mamba2 mixers with attention on the layers ``attn_layers``
          names, a mixture of experts after every mixer (granite-4.0-h)

Entry points, as in the reference:

  ``forward``      full-sequence logits
  ``loss``         next-token CE (+ MoE aux) with fp32 softmax; while grad
                   is on, each layer is rematerialised as ``cfg.remat``
                   says
  ``prefill``      full-sequence pass that also emits the decode cache
  ``decode_step``  one-token step against the cache

Params and caches are nested dicts of tensors in the reference layout:
weights stored as (in, out) and a leading ``layers`` axis on the block
stack (two, ``(segments, layers)``, on the vision model's self layers),
and a Python list where the reference keeps one (the xLSTM layers), so
the bridge from the reference is a plain tree map. Every leaf has a
parallel *logical axes* annotation (a tuple of names; ``param_axes``,
``make_cache``) that repro_torch.distributed.sharding maps onto a mesh,
and the model pins its large intermediates by those names
(``constrain``), a no-op outside ``activation_sharding``.
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
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import (apply_norm, dense_init, embed_axes,
                                       embed_tokens, make_embed_params,
                                       make_norm_params, norm_axes, unembed)
from repro_torch.models.moe import MoEConfig, make_moe_params, moe_axes
from repro_torch.models.transformer import (BLOCK_CACHE_AXES,
                                            BLOCK_CACHE_AXES_Q, BlockConfig,
                                            apply_cross_block,
                                            apply_decoder_block,
                                            cross_block_axes,
                                            cross_source_kv,
                                            decode_cross_block,
                                            decode_decoder_block,
                                            decoder_block_axes,
                                            init_block_cache, layer_slice,
                                            make_cross_block,
                                            make_decoder_block,
                                            prefill_cross_block,
                                            prefill_decoder_block,
                                            prepend_axis, residual,
                                            stack_params, tree_leaves,
                                            tree_map, unstack_params)
from repro_torch.models.transformer import _ffn as ffn_sublayer
from repro_torch.distributed.sharding import constrain, per_shard
from repro_torch.tracing import span

Tree = Dict[str, object]

#: the logical axes the residual stream is pinned to between layers
ACT_AXES = ("batch", "act_seq", None)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|hybrid|ssm|audio|vlm
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
    xlstm: Optional[xl.XLSTMConfig] = None
    shared_attn_every: int = 0       # hybrid: shared block cadence
    shared_attn_d_ff: int = 0        # hybrid: shared block MLP width
    cross_attn_every: int = 0        # vlm: gated cross-attn cadence
    n_frontend_tokens: int = 0       # vlm/audio: stub frontend seq len
    n_encoder_layers: int = 0        # audio: encoder depth
    max_pos: int = 0                 # audio: learned decoder positions
    dtype: str = "bfloat16"
    attn_impl: str = "plain"         # plain | kernel
    use_ssm_kernel: bool = False     # hybrid: SSD scan through its kernels
    vocab_pad: int = 256
    remat: str = "dots"              # none | dots | full
    sub_quadratic: bool = False      # can serve long_500k
    kv_cache_quant: bool = False     # int8 KV cache (dense/moe decode)
    #: hybrid_moe: the layers whose mixer is attention (the others are
    #: Mamba2); an index past n_layers lies beyond a depth cut
    attn_layers: Tuple[int, ...] = ()
    #: Granite's scalars (moe, hybrid_moe); the defaults change
    #: nothing. The embeddings are multiplied by ``embedding_multiplier``,
    #: the attention scores scaled by ``attention_multiplier`` (None:
    #: head_dim^-1/2), each sublayer's output by ``residual_multiplier``
    #: before its residual add, and the logits divided by
    #: ``logits_scaling``
    embedding_multiplier: float = 1.0
    attention_multiplier: Optional[float] = None
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    #: every norm's epsilon (moe, hybrid_moe; None: each norm's own)
    norm_eps: Optional[float] = None

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
            moe=self.moe if moe else None, attn_impl=self.attn_impl,
            attn_scale=self.attention_multiplier,
            residual_multiplier=self.residual_multiplier,
            norm_eps=self.norm_eps)

    def n_params(self) -> int:
        """Total parameter count, from shapes on the meta device."""
        params = Model(self, device="meta").init()
        return sum(math.prod(p.shape) for p in tree_leaves(params))

    def n_active_params(self) -> int:
        """Active params per token (MoE: routed top-k + shared only; every
        layer of the moe and hybrid_moe families has experts)."""
        total = self.n_params()
        if self.moe is None:
            return total
        per_expert = 3 * self.d_model * self.moe.expert_ff
        inactive = (self.moe.n_experts - self.moe.top_k) * per_expert \
            * self.n_layers
        return total - inactive


REMAT = ("none", "dots", "full")
#: the families that honour Granite's scalars and ``norm_eps``
SCALED_FAMILIES = ("moe", "hybrid_moe")


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

    FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm", "hybrid_moe")

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        if cfg.family not in self.FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}; one of "
                             f"{self.FAMILIES}")
        scaled = (cfg.embedding_multiplier, cfg.attention_multiplier,
                  cfg.residual_multiplier, cfg.logits_scaling, cfg.norm_eps)
        if cfg.family not in SCALED_FAMILIES and \
                scaled != (1.0, None, 1.0, 1.0, None):
            raise ValueError(f"family {cfg.family!r} takes no multipliers "
                             f"nor norm_eps; only {SCALED_FAMILIES} do")
        if cfg.family == "hybrid_moe" and (cfg.ssm is None or cfg.moe is None):
            raise ValueError("hybrid_moe needs an ssm and a moe config")
        if cfg.attn_layers and cfg.family != "hybrid_moe":
            raise ValueError("attn_layers is hybrid_moe's")
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
        build = {"dense": self._build_decoder, "moe": self._build_decoder,
                 "hybrid": self._build_hybrid, "ssm": self._build_xlstm,
                 "audio": self._build_audio, "vlm": self._build_vlm,
                 "hybrid_moe": self._build_hybrid_moe}
        return build[self.cfg.family](gen)

    def build(self, seed: int = 0) -> Tuple[Tree, Tree]:
        """Concrete (params, logical axes)."""
        return self.init(seed), self.param_axes()

    def abstract_params(self) -> Tuple[Tree, Tree]:
        """(params on the meta device, logical axes): shapes and dtypes
        with no storage and nothing drawn, as the reference's
        ``eval_shape``."""
        return Model(self.cfg, device="meta").init(), self.param_axes()

    def param_axes(self) -> Tree:
        """The logical axes of :meth:`init`'s tree, as the reference's
        ``build`` returns them: the block stack's leading ``layers`` axis
        (two of them on the vision model's self layers), the xLSTM's
        per-layer list."""
        cfg = self.cfg
        family = cfg.family
        axes = {"embed": embed_axes(cfg.tie_embeddings),
                "final_norm": norm_axes(cfg.norm)}
        if family in ("dense", "moe"):
            axes["layers"] = prepend_axis(decoder_block_axes(cfg.block_cfg()))
        elif family == "hybrid":
            axes["layers"] = prepend_axis({"mamba": m2.mamba2_axes(),
                                           "norm": norm_axes(cfg.norm)})
            axes["shared"] = decoder_block_axes(self._shared_cfg())
        elif family == "hybrid_moe":
            bcfg = cfg.block_cfg()
            axes["mamba_layers"] = prepend_axis(
                {"mamba": m2.mamba2_axes(cfg.ssm), "norm1": norm_axes(cfg.norm),
                 "norm2": norm_axes(cfg.norm), "moe": moe_axes(cfg.moe)})
            if "attn" in self._mixer_kinds():
                axes["attn_layers"] = prepend_axis(decoder_block_axes(bcfg))
        elif family == "ssm":
            block = {"mlstm": xl.mlstm_axes, "slstm": xl.slstm_axes}
            axes["layers"] = [{"block": block[kind](),
                               "norm": norm_axes(cfg.norm)}
                              for kind in self._xlstm_kinds()]
        elif family == "audio":
            bcfg = cfg.block_cfg(moe=False)
            axes["embed"]["pos"] = (None, "embed")
            axes["enc_layers"] = prepend_axis(decoder_block_axes(bcfg))
            axes["enc_norm"] = norm_axes(cfg.norm)
            axes["layers"] = prepend_axis(cross_block_axes(bcfg,
                                                           self_attn=True))
        else:
            bcfg = cfg.block_cfg(moe=False)
            axes["segments"] = prepend_axis(
                {"self": prepend_axis(decoder_block_axes(bcfg)),
                 "cross": cross_block_axes(bcfg, gated=True,
                                           self_attn=False)})
        return axes

    def _embed_params(self, gen) -> Tree:
        cfg = self.cfg
        return make_embed_params(gen, cfg.padded_vocab, cfg.d_model,
                                 cfg.tdtype, cfg.tie_embeddings, self.device)

    def _norm_params(self) -> Tree:
        cfg = self.cfg
        return make_norm_params(cfg.d_model, cfg.norm, cfg.tdtype, self.device)

    def _build_decoder(self, gen) -> Tree:
        cfg, dev, dt = self.cfg, self.device, self.cfg.tdtype
        bcfg = cfg.block_cfg()
        return {"embed": self._embed_params(gen),
                "layers": stack_params(
                    cfg.n_layers,
                    lambda: make_decoder_block(gen, bcfg, dt, dev)),
                "final_norm": self._norm_params()}

    def _build_hybrid(self, gen) -> Tree:
        cfg, dev, dt = self.cfg, self.device, self.cfg.tdtype

        def mamba_layer():
            return {"mamba": m2.make_mamba2_params(gen, cfg.d_model, cfg.ssm,
                                                   dt, dev),
                    "norm": self._norm_params()}

        return {"embed": self._embed_params(gen),
                "layers": stack_params(cfg.n_layers, mamba_layer),
                "shared": make_decoder_block(gen, self._shared_cfg(), dt,
                                             dev),
                "final_norm": self._norm_params()}

    # -- shared pieces ----------------------------------------------------------

    def _head(self, params: Tree, x: torch.Tensor, last: bool = False
              ) -> torch.Tensor:
        """The final norm and the logits (span ``rt.logits``), of the last
        position only if ``last``."""
        with span("rt.logits"):
            x = apply_norm(params["final_norm"], x, self.cfg.norm,
                           self.cfg.norm_eps)
            return self._logits(params, x[:, -1:] if last else x)

    def _logits(self, params: Tree, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        logits = unembed(params["embed"], x).float()
        if cfg.logits_scaling != 1.0:
            logits = logits / cfg.logits_scaling
        if cfg.padded_vocab != cfg.vocab:          # mask pad columns
            pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
            logits = logits.masked_fill(pad, -1e30)
        return constrain(logits, ("batch", "act_seq", "vocab"))

    def _embed_tokens(self, params: Tree, tokens: torch.Tensor
                      ) -> torch.Tensor:
        """The token embeddings; on a mesh the table is gathered whole and
        each rank looks up its own tokens (the lookup's backward has no
        DTensor strategy in torch 2.11)."""
        x = per_shard(lambda ids, tok: embed_tokens({"tok": tok}, ids),
                      (tokens, params["embed"]["tok"]),
                      (("b", None), (None, None)), ("b", None, None))
        if self.cfg.embedding_multiplier != 1.0:
            x = x * self.cfg.embedding_multiplier
        return constrain(x, ACT_AXES)

    def _zero_aux(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=x.device)

    def _decoder_forward(self, params: Tree, x: torch.Tensor):
        cfg = self.cfg
        bcfg = cfg.block_cfg()
        block = _maybe_remat(
            lambda lp, h: apply_decoder_block(lp, h, bcfg), cfg.remat)
        aux = self._zero_aux(x)
        for lp in unstack_params(params["layers"], cfg.n_layers):
            x, a = block(lp, constrain(x, ACT_AXES))
            aux = aux + a
        return apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps), \
            aux

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
            x = body(lp, constrain(x, ACT_AXES), bool(flag))
        return apply_norm(params["final_norm"], x, cfg.norm), self._zero_aux(x)

    # -- hybrid_moe (granite-4.0-h: Mamba2 or attention, then experts) --------

    def _mixer_kinds(self):
        """Per-layer mixer: "attn" on the layers ``attn_layers`` names,
        "mamba" on the others."""
        attn = set(self.cfg.attn_layers)
        return ["attn" if i in attn else "mamba"
                for i in range(self.cfg.n_layers)]

    def _build_hybrid_moe(self, gen) -> Tree:
        """Two stacks: ``mamba_layers`` (norm1, the Mamba2 mixer, norm2,
        the experts) and ``attn_layers`` (a decoder block with experts),
        each in layer order; ``_mixer_kinds`` interleaves them."""
        cfg, dev, dt = self.cfg, self.device, self.cfg.tdtype
        bcfg = cfg.block_cfg()
        kinds = self._mixer_kinds()

        def mamba_layer():
            return {"mamba": m2.make_mamba2_params(gen, cfg.d_model, cfg.ssm,
                                                   dt, dev),
                    "norm1": self._norm_params(),
                    "norm2": self._norm_params(),
                    "moe": make_moe_params(gen, cfg.d_model, cfg.moe, dt,
                                           dev)}

        params = {"embed": self._embed_params(gen),
                  "mamba_layers": stack_params(kinds.count("mamba"),
                                               mamba_layer),
                  "final_norm": self._norm_params()}
        if "attn" in kinds:
            params["attn_layers"] = stack_params(
                kinds.count("attn"),
                lambda: make_decoder_block(gen, bcfg, dt, dev))
        return params

    def _hybrid_moe_layers(self, params: Tree):
        """(kind, the layer's params) of every layer in order."""
        kinds = self._mixer_kinds()
        stacks = {k: iter(unstack_params(params[f"{k}_layers"],
                                         kinds.count(k)))
                  for k in set(kinds)}
        return [(k, next(stacks[k])) for k in kinds]

    def _mamba_moe(self, lp: Tree, x: torch.Tensor, bcfg: BlockConfig,
                   mixer: Callable):
        """A Mamba2 layer: x + r mixer(norm1(x)), then + r experts(norm2(.)).
        ``mixer(params, h)`` gives (y, the layer's decode state or None).
        Returns (x, aux, that state)."""
        cfg = self.cfg
        with span("rt.mamba"):
            y, st = mixer(lp["mamba"],
                          apply_norm(lp["norm1"], x, cfg.norm, cfg.norm_eps))
            x = x + residual(y, bcfg)
        f, aux = ffn_sublayer(lp, x, bcfg)
        return x + residual(f, bcfg), aux, st

    def _scan(self, with_state: bool) -> Callable:
        """The full-sequence Mamba2 mixer for ``_mamba_moe``, with or
        without the decode state."""
        cfg = self.cfg
        kw = dict(use_kernel=cfg.use_ssm_kernel, eps=cfg.norm_eps)
        if with_state:
            return lambda p, h: m2.apply_mamba2_with_state(p, h, cfg.ssm, **kw)
        return lambda p, h: (m2.apply_mamba2(p, h, cfg.ssm, **kw), None)

    def _hybrid_moe_forward(self, params: Tree, x: torch.Tensor):
        cfg = self.cfg
        bcfg = cfg.block_cfg()
        attn = _maybe_remat(lambda lp, h: apply_decoder_block(lp, h, bcfg),
                            cfg.remat)
        scan = self._scan(with_state=False)
        mamba = _maybe_remat(
            lambda lp, h: self._mamba_moe(lp, h, bcfg, scan)[:2], cfg.remat)
        aux = self._zero_aux(x)
        for kind, lp in self._hybrid_moe_layers(params):
            x, a = (attn if kind == "attn" else mamba)(lp, constrain(x,
                                                                     ACT_AXES))
            aux = aux + a
        return apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps), \
            aux

    # -- ssm (xlstm) -------------------------------------------------------------

    def _xlstm_kinds(self):
        """Per-layer block kind: every k-th is an sLSTM block."""
        k = self.cfg.xlstm.slstm_every
        return ["slstm" if (i % k) == (k - 1) else "mlstm"
                for i in range(self.cfg.n_layers)]

    def _build_xlstm(self, gen) -> Tree:
        """The layers as a Python list of dicts, as in the reference: the
        two kinds of block have different leaves, so they do not stack."""
        cfg, dev, dt = self.cfg, self.device, self.cfg.tdtype
        make = {"mlstm": xl.make_mlstm_params, "slstm": xl.make_slstm_params}
        layers = [{"block": make[kind](gen, cfg.d_model, cfg.xlstm, dt, dev),
                   "norm": self._norm_params()}
                  for kind in self._xlstm_kinds()]
        return {"embed": self._embed_params(gen), "layers": layers,
                "final_norm": self._norm_params()}

    def _xlstm_forward(self, params: Tree, x: torch.Tensor):
        cfg = self.cfg

        def layer(lp, h, kind):
            hn = apply_norm(lp["norm"], h, cfg.norm)
            if kind == "mlstm":
                return h + xl.apply_mlstm(lp["block"], hn, cfg.xlstm)
            return h + xl.apply_slstm(lp["block"], hn, cfg.xlstm)[0]

        layer = _maybe_remat(layer, cfg.remat)
        for lp, kind in zip(params["layers"], self._xlstm_kinds()):
            x = layer(lp, constrain(x, ACT_AXES), kind)
        return apply_norm(params["final_norm"], x, cfg.norm), self._zero_aux(x)

    # -- audio (whisper encoder-decoder over stub frame embeddings) -------------

    def _build_audio(self, gen) -> Tree:
        cfg, dev, dt = self.cfg, self.device, self.cfg.tdtype
        bcfg = cfg.block_cfg(moe=False)
        embed = self._embed_params(gen)
        embed["pos"] = dense_init(gen, cfg.max_pos, cfg.d_model, dt, dev,
                                  scale=0.02)
        return {"embed": embed,
                "enc_layers": stack_params(
                    cfg.n_encoder_layers,
                    lambda: make_decoder_block(gen, bcfg, dt, dev)),
                "enc_norm": self._norm_params(),
                "layers": stack_params(
                    cfg.n_layers,
                    lambda: make_cross_block(gen, bcfg, dt, dev,
                                             self_attn=True)),
                "final_norm": self._norm_params()}

    @staticmethod
    def _sinusoid(seq: int, d: int, device) -> torch.Tensor:
        pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
        dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None]
        angle = pos / torch.pow(10000.0, dim / d)
        return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)

    def _encode(self, params: Tree, frames: torch.Tensor) -> torch.Tensor:
        """frames: (b, s_enc, d_model) precomputed frame embeddings. The
        encoder is bidirectional: plain attention, never the causal
        kernel."""
        cfg = self.cfg
        enc_cfg = cfg.block_cfg(moe=False)
        x = frames + self._sinusoid(frames.shape[1], cfg.d_model,
                                    frames.device).to(frames.dtype)
        block = _maybe_remat(lambda lp, h: apply_decoder_block(
            lp, h, enc_cfg, causal=False)[0], cfg.remat)
        for lp in unstack_params(params["enc_layers"], cfg.n_encoder_layers):
            x = block(lp, constrain(x, ACT_AXES))
        return apply_norm(params["enc_norm"], x, cfg.norm)

    def _embed_positions(self, params: Tree, tokens: torch.Tensor
                         ) -> torch.Tensor:
        """Token embeddings plus the learned positions 0..s-1."""
        s = tokens.shape[1]
        return self._embed_tokens(params, tokens) + \
            params["embed"]["pos"][:s]

    def _audio_forward(self, params: Tree, tokens: torch.Tensor,
                       frames: torch.Tensor):
        cfg = self.cfg
        dec_cfg = cfg.block_cfg(moe=False)
        enc_out = self._encode(params, frames)
        x = self._embed_positions(params, tokens)
        block = _maybe_remat(
            lambda lp, h, kv: apply_cross_block(lp, h, kv, dec_cfg), cfg.remat)
        for lp in unstack_params(params["layers"], cfg.n_layers):
            x = block(lp, constrain(x, ACT_AXES), enc_out)
        return apply_norm(params["final_norm"], x, cfg.norm), self._zero_aux(x)

    # -- vlm (llama-3.2-vision: gated cross-attention every k layers) -----------

    def _vlm_seg(self) -> Tuple[int, int]:
        """(n_segments, self layers per segment): k-1 self layers + 1
        cross layer per segment."""
        cfg = self.cfg
        k = cfg.cross_attn_every
        if cfg.n_layers % k:
            raise ValueError("n_layers must divide cross cadence")
        return cfg.n_layers // k, k - 1

    def _build_vlm(self, gen) -> Tree:
        """``segments.self`` is stacked over (segments, self layers) and
        ``segments.cross`` over segments, each into one preallocated stack
        that the layers are drawn into in turn."""
        cfg, dev, dt = self.cfg, self.device, self.cfg.tdtype
        nseg, nself = self._vlm_seg()
        bcfg = cfg.block_cfg(moe=False)
        return {"embed": self._embed_params(gen),
                "segments": {
                    "self": stack_params(
                        (nseg, nself),
                        lambda: make_decoder_block(gen, bcfg, dt, dev)),
                    "cross": stack_params(
                        nseg, lambda: make_cross_block(
                            gen, bcfg, dt, dev, gated=True,
                            self_attn=False))},
                "final_norm": self._norm_params()}

    def _vlm_forward(self, params: Tree, x: torch.Tensor,
                     patches: torch.Tensor):
        cfg = self.cfg
        bcfg = cfg.block_cfg(moe=False)
        nseg, nself = self._vlm_seg()
        inner = _maybe_remat(
            lambda lp, h: apply_decoder_block(lp, h, bcfg)[0], cfg.remat)
        for seg in unstack_params(params["segments"], nseg):
            for lp in unstack_params(seg["self"], nself):
                x = inner(lp, constrain(x, ACT_AXES))
            x = apply_cross_block(seg["cross"], x, patches, bcfg, gated=True)
        return apply_norm(params["final_norm"], x, cfg.norm), self._zero_aux(x)

    # -- forward / loss ----------------------------------------------------------

    def forward(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward. Returns (logits fp32, aux loss). The
        audio family also takes ``batch["frames"]``, the vision family
        ``batch["patches"]``."""
        family = self.cfg.family
        tokens = batch["tokens"]
        if family == "audio":
            x, aux = self._audio_forward(params, tokens, batch["frames"])
            return self._logits(params, x), aux
        x = self._embed_tokens(params, tokens)
        if family == "hybrid":
            x, aux = self._hybrid_forward(params, x)
        elif family == "hybrid_moe":
            x, aux = self._hybrid_moe_forward(params, x)
        elif family == "ssm":
            x, aux = self._xlstm_forward(params, x)
        elif family == "vlm":
            x, aux = self._vlm_forward(params, x, batch["patches"])
        else:
            x, aux = self._decoder_forward(params, x)
        return self._logits(params, x), aux

    def loss(self, params: Tree, batch: Dict[str, torch.Tensor]):
        """Next-token CE over valid (label >= 0) positions + aux."""
        logits, aux = self.forward(params, batch)
        labels = batch["labels"]
        valid = (labels >= 0).float()
        lse = torch.logsumexp(logits, dim=-1)
        # the gather from vocab-sharded logits leaves each rank a masked
        # partial sum, reduced here, at its own (b, s, 1) shape
        picked = constrain(torch.gather(logits, -1,
                                        labels.clamp(min=0)[..., None]),
                           ACT_AXES)[..., 0]
        ce = (lse - picked) * valid
        n = valid.sum().clamp(min=1.0)
        ce_mean = ce.sum() / n
        total = ce_mean + aux
        return total, {"loss": total, "ce": ce_mean, "aux": aux, "tokens": n}

    # -- serving (prefill / decode) ----------------------------------------------

    def make_cache(self, batch: int, max_len: int) -> Tuple[Tree, Tree]:
        """Zero-initialised decode cache + its logical axes."""
        cfg, dev, dt = self.cfg, self.device, self.cfg.tdtype
        length = torch.zeros(batch, dtype=torch.int32, device=dev)
        la = ("batch",)
        if cfg.family == "hybrid":
            n_apps = int(self._shared_flags().sum())
            one = init_block_cache(batch, max_len, self._shared_cfg(), dt, dev)
            mamba = m2.init_mamba2_cache(batch, cfg.d_model, cfg.ssm, dt, dev)
            axes = {"mamba": {"h": ("layers", "batch", "inner", None, None),
                              "conv": ("layers", "batch", None, "inner")},
                    "attn": prepend_axis(BLOCK_CACHE_AXES), "length": la}
            return {"mamba": _stacked(mamba, cfg.n_layers),
                    "attn": _stacked(one, n_apps), "length": length}, axes
        if cfg.family == "hybrid_moe":
            kinds = self._mixer_kinds()
            mamba = m2.init_mamba2_cache(batch, cfg.d_model, cfg.ssm, dt, dev)
            cache = {"mamba": _stacked(mamba, kinds.count("mamba")),
                     "length": length}
            axes = {"mamba": {"h": ("layers", "batch", "inner", None, None),
                              "conv": ("layers", "batch", None, None)},
                    "length": la}
            if "attn" in kinds:
                one = init_block_cache(batch, max_len, cfg.block_cfg(), dt,
                                       dev)
                cache["attn"] = _stacked(one, kinds.count("attn"))
                axes["attn"] = prepend_axis(BLOCK_CACHE_AXES)
            return cache, axes
        if cfg.family == "ssm":
            caches, axes = [], []
            for kind in self._xlstm_kinds():
                if kind == "mlstm":
                    caches.append(xl.init_mlstm_cache(batch, cfg.d_model,
                                                      cfg.xlstm, dt, dev))
                    axes.append({"C": ("batch", "heads", None, None),
                                 "n": ("batch", "heads", None),
                                 "m": ("batch", "heads"),
                                 "conv": ("batch", None, "inner")})
                else:
                    caches.append(xl.init_slstm_state(batch, cfg.d_model,
                                                      cfg.xlstm, dev))
                    axes.append({k: ("batch", "heads", None)
                                 for k in ("c", "n", "h", "m")})
            return ({"layers": caches, "length": length},
                    {"layers": axes, "length": la})
        bcfg = cfg.block_cfg(moe=False)
        src = (batch, cfg.n_frontend_tokens, cfg.kv_heads, cfg.hd)
        src_zeros = lambda *lead: torch.zeros((*lead, *src), dtype=dt,
                                              device=dev)
        if cfg.family == "audio":
            one = dict(init_block_cache(batch, max_len, bcfg, dt, dev),
                       xk=src_zeros(), xv=src_zeros())
            ca = dict(BLOCK_CACHE_AXES, xk=("batch", None, None, None),
                      xv=("batch", None, None, None))
            return ({"layers": _stacked(one, cfg.n_layers), "length": length},
                    {"layers": prepend_axis(ca), "length": la})
        if cfg.family == "vlm":
            nseg, nself = self._vlm_seg()
            one = init_block_cache(batch, max_len, bcfg, dt, dev)
            axes = {"self": prepend_axis(prepend_axis(BLOCK_CACHE_AXES, "seg")),
                    "cross": {"xk": ("seg", "batch", None, None, None),
                              "xv": ("seg", "batch", None, None, None)},
                    "length": la}
            return {"self": _stacked(one, (nseg, nself)),
                    "cross": {"xk": src_zeros(nseg), "xv": src_zeros(nseg)},
                    "length": length}, axes
        one = init_block_cache(batch, max_len, cfg.block_cfg(), dt, dev,
                               quantized=cfg.kv_cache_quant)
        axes = {"layers": prepend_axis(BLOCK_CACHE_AXES_Q
                                       if cfg.kv_cache_quant
                                       else BLOCK_CACHE_AXES),
                "length": la}
        return {"layers": _stacked(one, cfg.n_layers), "length": length}, axes

    def abstract_cache(self, batch: int, max_len: int) -> Tuple[Tree, Tree]:
        """(the cache on the meta device, its logical axes): what
        :meth:`make_cache` makes, with no storage, as the reference's
        ``eval_shape`` of it."""
        return Model(self.cfg, device="meta").make_cache(batch, max_len)

    def prefill(self, params: Tree, batch: Dict[str, torch.Tensor],
                max_len: int) -> Tuple[torch.Tensor, Tree]:
        """Process the full prompt; emit last-position logits + cache."""
        with span("rt.prefill"):
            return self._prefill(params, batch, max_len)

    def _prefill(self, params: Tree, batch: Dict[str, torch.Tensor],
                 max_len: int) -> Tuple[torch.Tensor, Tree]:
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        length = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
        stack = lambda cs: tree_map(lambda *xs: torch.stack(xs), *cs)
        if cfg.family == "audio":
            bcfg = cfg.block_cfg(moe=False)
            enc_out = self._encode(params, batch["frames"])
            x = self._embed_positions(params, tokens)
            caches = []
            for i in range(cfg.n_layers):
                with span("rt.cross"):
                    x, c = prefill_cross_block(
                        layer_slice(params["layers"], i),
                        constrain(x, ACT_AXES), enc_out, bcfg, max_len)
                caches.append(c)
            return self._head(params, x, last=True), {
                "layers": stack(caches), "length": length}
        x = self._embed_tokens(params, tokens)
        if cfg.family == "hybrid":
            # mamba prefill runs the chunked scan and keeps final states;
            # shared-attn applications emit their own KV caches
            sb_cfg = self._shared_cfg()
            mamba_states, attn_caches = [], []
            for i, flag in enumerate(self._shared_flags()):
                lp = layer_slice(params["layers"], i)
                with span("rt.mamba"):
                    hn = apply_norm(lp["norm"], x, cfg.norm)
                    y, st = self._mamba_prefill(lp["mamba"], hn)
                    x = x + y
                mamba_states.append(st)
                if flag:
                    x, _, c = prefill_decoder_block(params["shared"], x,
                                                    sb_cfg, max_len)
                    attn_caches.append(c)
            return self._head(params, x, last=True), {
                "mamba": stack(mamba_states), "attn": stack(attn_caches),
                "length": length}
        if cfg.family == "hybrid_moe":
            # each Mamba2 layer keeps its final SSM state and conv window,
            # each attention layer its keys and values
            bcfg, scan = cfg.block_cfg(), self._scan(with_state=True)
            states, caches = [], []
            for kind, lp in self._hybrid_moe_layers(params):
                if kind == "attn":
                    x, _, c = prefill_decoder_block(lp, x, bcfg, max_len)
                    caches.append(c)
                else:
                    x, _, st = self._mamba_moe(lp, x, bcfg, scan)
                    states.append(st)
            cache = {"mamba": stack(states), "length": length}
            if caches:
                cache["attn"] = stack(caches)
            return self._head(params, x, last=True), cache
        if cfg.family == "ssm":
            # every mLSTM prefill takes the chunkwise form, which returns
            # the matrix memory; the sLSTM runs its recurrence
            states = []
            for lp, kind in zip(params["layers"], self._xlstm_kinds()):
                with span(f"rt.{kind}"):
                    hn = apply_norm(lp["norm"], x, cfg.norm)
                    if kind == "mlstm":
                        y, st = xl.apply_mlstm_with_state(lp["block"], hn,
                                                          cfg.xlstm)
                    else:
                        y, st = xl.apply_slstm(lp["block"], hn, cfg.xlstm)
                    x = x + y
                states.append(st)
            return self._head(params, x, last=True), {"layers": states,
                                                      "length": length}
        if cfg.family == "vlm":
            bcfg = cfg.block_cfg(moe=False)
            patches = batch["patches"]
            nseg, nself = self._vlm_seg()
            self_kv, xks, xvs = [], [], []
            for i in range(nseg):
                sp = layer_slice(params["segments"], i)
                seg_kv = []
                for j in range(nself):
                    x, _, c = prefill_decoder_block(
                        layer_slice(sp["self"], j), constrain(x, ACT_AXES),
                        bcfg, max_len)
                    seg_kv.append(c)
                self_kv.append(stack(seg_kv))
                with span("rt.cross"):
                    xk, xv = cross_source_kv(sp["cross"]["cross_attn"],
                                             patches, bcfg)
                    x = apply_cross_block(sp["cross"], x, patches, bcfg,
                                          gated=True)
                xks.append(xk)
                xvs.append(xv)
            return self._head(params, x, last=True), {
                "self": stack(self_kv),
                "cross": {"xk": torch.stack(xks), "xv": torch.stack(xvs)},
                "length": length}
        bcfg = cfg.block_cfg()
        caches = []
        for i in range(cfg.n_layers):
            x, _, c = prefill_decoder_block(layer_slice(params["layers"], i),
                                            constrain(x, ACT_AXES), bcfg,
                                            max_len,
                                            quantized=cfg.kv_cache_quant)
            caches.append(c)
        return self._head(params, x, last=True), {"layers": stack(caches),
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
        with span("rt.decode"):
            return self._decode_step(params, cache, tokens)

    def _decode_step(self, params: Tree, cache: Tree, tokens: torch.Tensor
                     ) -> Tuple[torch.Tensor, Tree]:
        cfg = self.cfg
        length = cache["length"]
        x = self._embed_tokens(params, tokens)
        out = dict(cache, length=length + 1)
        if cfg.family == "hybrid":
            sb_cfg = self._shared_cfg()
            app = 0
            for i, flag in enumerate(self._shared_flags()):
                lp = layer_slice(params["layers"], i)
                mc = layer_slice(cache["mamba"], i)
                with span("rt.mamba"):
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
        elif cfg.family == "hybrid_moe":
            bcfg = cfg.block_cfg()
            at = {"mamba": 0, "attn": 0}
            for kind in self._mixer_kinds():
                i = at[kind]
                at[kind] += 1
                lp = layer_slice(params[f"{kind}_layers"], i)
                if kind == "attn":
                    x, _ = decode_decoder_block(
                        lp, x, layer_slice(cache["attn"], i), length, bcfg)
                    continue

                def step(p, h, mc=layer_slice(cache["mamba"], i)):
                    y, new = m2.decode_mamba2(p, h, mc, cfg.ssm,
                                              eps=cfg.norm_eps)
                    for k, t in new.items():
                        mc[k].copy_(t)
                    return y, None

                x, _, _ = self._mamba_moe(lp, x, bcfg, step)
        elif cfg.family == "ssm":
            decode = {"mlstm": xl.decode_mlstm, "slstm": xl.decode_slstm}
            for lp, kind, st in zip(params["layers"], self._xlstm_kinds(),
                                    cache["layers"]):
                with span(f"rt.{kind}"):
                    hn = apply_norm(lp["norm"], x, cfg.norm)
                    y, _ = decode[kind](lp["block"], hn, st, cfg.xlstm)
                    x = x + y
        elif cfg.family == "audio":
            bcfg = cfg.block_cfg(moe=False)
            pos = length.clamp(0, cfg.max_pos - 1).long()
            x = x + params["embed"]["pos"][pos][:, None, :]
            for i in range(cfg.n_layers):
                with span("rt.cross"):
                    x, _ = decode_cross_block(
                        layer_slice(params["layers"], i),
                        constrain(x, ACT_AXES),
                        layer_slice(cache["layers"], i), length, bcfg)
        elif cfg.family == "vlm":
            bcfg = cfg.block_cfg(moe=False)
            nseg, nself = self._vlm_seg()
            for i in range(nseg):
                sp = layer_slice(params["segments"], i)
                sc = layer_slice(cache["self"], i)
                for j in range(nself):
                    x, _ = decode_decoder_block(layer_slice(sp["self"], j),
                                                constrain(x, ACT_AXES),
                                                layer_slice(sc, j), length,
                                                bcfg)
                with span("rt.cross"):
                    x, _ = decode_cross_block(
                        sp["cross"], x, layer_slice(cache["cross"], i),
                        length, bcfg, gated=True)
        else:
            bcfg = cfg.block_cfg()
            for i in range(cfg.n_layers):
                x, _ = decode_decoder_block(layer_slice(params["layers"], i),
                                            constrain(x, ACT_AXES),
                                            layer_slice(cache["layers"], i),
                                            length, bcfg)
        return self._head(params, x), out


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    return Model(cfg, device=device)


def _stacked(one: Tree, n) -> Tree:
    """Zeros of ``n`` copies of the cache ``one`` on a leading axis (on
    leading axes, for a tuple ``n``)."""
    lead = (n,) if isinstance(n, int) else tuple(n)
    return tree_map(lambda t: torch.zeros((*lead, *t.shape), dtype=t.dtype,
                                          device=t.device), one)
