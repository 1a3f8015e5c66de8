"""Model factory of the port (counterpart of ``repro.models.model``).

One config schema over seven families: the reference's six (dense, moe,
hybrid, ssm, audio, vlm) and ``hybrid_moe``, the port's alone. Each is
one class of :mod:`repro_torch.models.families`, chosen once from
``cfg.family``; its layer plan (:meth:`Model.layer_plan`) says which
block runs at each position and where its parameters and cache sit.
Entry points, as in the reference:

  ``forward``      full-sequence logits
  ``loss``         next-token CE (+ MoE aux) with fp32 softmax; while grad
                   is on, each layer is rematerialised as ``cfg.remat``
                   says
  ``prefill``      full-sequence pass that also emits the decode cache
  ``prefill_into`` (where ``pads_prefill``) one prompt padded to a fixed
                   length, written straight into a row of a batch cache
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
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import constrain, per_shard
from repro_torch.models import mamba2 as m2
from repro_torch.models import xlstm as xl
from repro_torch.models.families import (  # noqa: F401 re-exported
    ACT_AXES, FAMILIES, REMAT, SCALED_FAMILIES, Layer, Tree, _maybe_remat)
from repro_torch.models.layers import (YarnConfig, apply_norm, embed_tokens,
                                       unembed, yarn_mscale)
from repro_torch.models.mla import MLAConfig
from repro_torch.models.moe import MoEConfig, RealTokens, capacity
from repro_torch.models.transformer import BlockConfig
from repro_torch.tracing import span
from repro_torch.tree import tree_leaves


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # one of Model.FAMILIES
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
    #: multi-head latent attention (DeepSeek-V2; dense and moe): keys and
    #: values through a normalised latent, one latent row a position in
    #: the decode cache; ``head_dim`` is then its q.k width, nope + rope
    mla: Optional[MLAConfig] = None
    #: YaRN's scaling of the rope (with ``mla``)
    yarn: Optional[YarnConfig] = None
    #: moe: the leading layers whose FFN is a dense MLP of width ``d_ff``
    #: (DeepSeek-V2's ``first_k_dense_replace``)
    dense_layers: int = 0

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

    @property
    def attn_scale(self) -> Optional[float]:
        """The attention scores' scale: ``attention_multiplier``, or with
        ``mla`` (nope + rope)^-1/2 times YaRN's ``mscale_all_dim`` mscale
        squared, as DeepSeek-V2 scales; None: head_dim^-1/2."""
        if self.attention_multiplier is not None or self.mla is None:
            return self.attention_multiplier
        gain = 1.0 if self.yarn is None or not self.yarn.mscale_all_dim \
            else yarn_mscale(self.yarn.factor, self.yarn.mscale_all_dim)
        return self.mla.qk_dim ** -0.5 * gain * gain

    def block_cfg(self, *, moe: bool = True, d_ff: Optional[int] = None
                  ) -> BlockConfig:
        return BlockConfig(
            d_model=self.d_model, n_heads=self.n_heads, kv_heads=self.kv_heads,
            head_dim=self.hd, d_ff=d_ff if d_ff is not None else self.d_ff,
            norm=self.norm, mlp=self.mlp, qkv_bias=self.qkv_bias,
            qk_norm=self.qk_norm, rope_theta=self.rope_theta,
            moe=self.moe if moe else None, attn_impl=self.attn_impl,
            attn_scale=self.attn_scale,
            residual_multiplier=self.residual_multiplier,
            norm_eps=self.norm_eps, mla=self.mla, yarn=self.yarn)

    def n_params(self) -> int:
        """Total parameter count, from shapes on the meta device."""
        params = Model(self, device="meta").init()
        return sum(math.prod(p.shape) for p in tree_leaves(params))

    def n_active_params(self) -> int:
        """Active params per token (MoE: routed top-k + shared only; every
        layer of the moe and hybrid_moe families has experts but the
        ``dense_layers`` leading ones, whose MLP is all active)."""
        total = self.n_params()
        if self.moe is None:
            return total
        per_expert = 3 * self.d_model * self.moe.expert_ff
        inactive = (self.moe.n_experts - self.moe.top_k) * per_expert \
            * (self.n_layers - self.dense_layers)
        return total - inactive


class Model:
    """Functional model wrapper: holds the config, the device and the
    config's family."""

    FAMILIES = tuple(FAMILIES)

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        family = FAMILIES.get(cfg.family)
        if family is None:
            raise ValueError(f"unknown family {cfg.family!r}; one of "
                             f"{self.FAMILIES}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._family = family(cfg, self.device)

    def layer_plan(self) -> Tuple[Layer, ...]:
        """The blocks in the order they run, each with its kind and where
        its parameters and cache sit (:class:`families.Layer`)."""
        return self._family.plan

    # -- parameters -----------------------------------------------------------

    def init(self, seed: int = 0) -> Tree:
        """Random weights drawn from a ``torch.Generator`` on the model's
        device (none is drawn on the meta device)."""
        gen = None
        if self.device.type != "meta":
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
        return self._family.build(gen)

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
        return self._family.axes()

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

    # -- forward / loss ----------------------------------------------------------

    def forward(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward. Returns (logits fp32, aux loss). The
        audio family also takes ``batch["frames"]``, the vision family
        ``batch["patches"]``."""
        cfg = self.cfg
        x, aux = self._family.forward(
            params, self._embed_tokens(params, batch["tokens"]), batch)
        x = apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps)
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
        length = torch.zeros(batch, dtype=torch.int32, device=self.device)
        cache, axes = self._family.cache(batch, max_len)
        return dict(cache, length=length), dict(axes, length=("batch",))

    def abstract_cache(self, batch: int, max_len: int) -> Tuple[Tree, Tree]:
        """(the cache on the meta device, its logical axes): what
        :meth:`make_cache` makes, with no storage, as the reference's
        ``eval_shape`` of it."""
        return Model(self.cfg, device="meta").make_cache(batch, max_len)

    def prefill(self, params: Tree, batch: Dict[str, torch.Tensor],
                max_len: int) -> Tuple[torch.Tensor, Tree]:
        """Process the full prompt; emit last-position logits + cache."""
        with span("rt.prefill"):
            tokens = batch["tokens"]
            b, s = tokens.shape
            length = torch.full((b,), s, dtype=torch.int32,
                                device=tokens.device)
            # the embedding is passed, not named, so that it is freed
            # once the first layer has run
            x, cache = self._family.prefill(
                params, self._embed_tokens(params, tokens), batch, max_len)
            return self._head(params, x, last=True), dict(cache,
                                                          length=length)

    @property
    def pads_prefill(self) -> bool:
        """Whether :meth:`prefill_into` serves this model: its family
        declares it and the cache keeps keys and values in the model's
        type (not int8)."""
        return self._family.pads_prefill and not self.cfg.kv_cache_quant

    def real_counts(self, n: int) -> Tuple[int, int]:
        """What :meth:`prefill_into`'s ``real`` holds for a prompt of
        ``n`` tokens: (n, the MoE capacity at n; 0 without experts)."""
        moe = self.cfg.moe
        return n, 0 if moe is None else capacity(n, moe)

    def prefill_into(self, params: Tree, tokens: torch.Tensor,
                     real: RealTokens, slot: torch.Tensor, cache: Tree
                     ) -> torch.Tensor:
        """One prompt padded at its end, tokens (1, B), prefilled into row
        ``slot`` ((1,) int64 on the device) of the batch cache ``cache``
        in place: its keys and values at positions [0, B), its length set
        to ``real.n``. Returns the logits at position ``real.n - 1``, (1,
        1, vocab). Every shape is fixed by B and every count is on the
        device, so one CUDA graph per B serves every prompt that pads to
        it. Only where :attr:`pads_prefill`."""
        if not self.pads_prefill:
            raise ValueError(f"{self.cfg.name} has no padded prefill")
        with span("rt.prefill"):
            x = self._family.prefill_into(
                params, self._embed_tokens(params, tokens), cache, slot, real)
            cache["length"].index_copy_(0, slot, real.n.to(torch.int32))
            return self._head(params, x.index_select(1, real.n - 1))

    def decode_step(self, params: Tree, cache: Tree, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Tree]:
        """One token for every sequence. tokens: (b, 1).

        The cache's tensors are updated in place (the reference returns new
        ones); the returned cache holds them and the advanced length.
        """
        with span("rt.decode"):
            length = cache["length"]
            x = self._embed_tokens(params, tokens)
            out = dict(cache, length=length + 1)
            x = self._family.decode(params, cache, x, length)
            return self._head(params, x), out


def build_model(cfg: ModelConfig, device: DeviceLike = None) -> Model:
    return Model(cfg, device=device)
