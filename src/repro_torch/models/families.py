"""The model families, one class each, behind ``Model``.

A family's *layer plan* (:class:`Layer`) lists its blocks in the order
they run and where each one's parameters and decode cache sit. Its
build, logical axes, cache, full-sequence body, prefill and decode all
walk that one plan. ``Model`` picks the family once from ``cfg.family``
and keeps what every family shares (the token embedding, the final norm,
the logits, the loss), so a family's ``forward``, ``prefill`` and
``decode`` take the embedded tokens and return the residual stream.
"""
from __future__ import annotations

import functools
import operator
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed.sharding import constrain
from repro_torch.models import mamba2 as m2
from repro_torch.models import mla
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import (apply_norm, dense_init, embed_axes,
                                       make_embed_params, make_norm_params,
                                       norm_axes)
from repro_torch.models.moe import make_moe_params, moe_axes
from repro_torch.models.transformer import (BLOCK_CACHE_AXES, prepend_axis,
                                            stack_params)
from repro_torch.tracing import span
from repro_torch.tree import tree_leaves, tree_map

Tree = Dict[str, object]
#: the logical axes the residual stream is pinned to between layers
ACT_AXES = ("batch", "act_seq", None)
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


class Layer(NamedTuple):
    """One block of a family's walk. ``kind`` is ``attn`` (a decoder
    block: causal self-attention over a KV cache, then an MLP or experts),
    ``encoder`` (whisper's bidirectional decoder block), ``cross`` (a
    whisper decoder layer: self-attention, attention to the encoder, an
    MLP), ``gated_cross`` (a llama-vision layer: tanh-gated attention to
    the patches and MLP), ``mamba`` (a Mamba2 mixer, and its experts in
    hybrid_moe), ``mlstm`` or ``slstm`` (the xLSTM blocks).

    ``params`` and ``cache`` are paths into the params and cache trees:
    keys, then the block's row in each stacked dim. A path without rows
    names one block applied at every such position (zamba2's shared
    block); a block without a cache path keeps no decode state."""

    kind: str
    params: Tuple
    cache: Optional[Tuple] = None


def _split(path: Tuple) -> Tuple[Tuple, Tuple]:
    """(the keys, the rows) of a plan path."""
    keys = tuple(k for k in path if isinstance(k, str))
    return keys, path[len(keys):]


def _unstack(node, depth: int):
    """A stacked tree as nested lists of per-layer views, ``depth`` deep;
    a Python list of layers (the xLSTM's) is one already."""
    if depth == 0 or isinstance(node, list):
        return node
    n = tree_leaves(node)[0].shape[0]
    return [_unstack(row, depth - 1) for row in tf.unstack_params(node, n)]


def _view(tree: Tree, path: Tuple, memo: Dict) -> Tree:
    """The block at ``path`` of ``tree``; each stack is cut into its views
    once, into ``memo``."""
    keys, rows = _split(path)
    if keys not in memo:
        memo[keys] = _unstack(functools.reduce(operator.getitem, keys, tree),
                              len(rows))
    return functools.reduce(operator.getitem, rows, memo[keys])


def _stack(caches: List[Tree]) -> Tree:
    """Per-layer caches stacked on a leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *caches)


def _stacked(one: Tree, lead: Tuple[int, ...]) -> Tree:
    """Zeros of the cache ``one`` stacked on the leading dims ``lead``."""
    return tree_map(lambda t: torch.zeros((*lead, *t.shape), dtype=t.dtype,
                                          device=t.device), one)


def _zero_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


class Family:
    """A family defines ``_plan()``, ``build(gen)`` (None on the meta
    device), ``axes()``, ``cache(batch, max_len)`` -> (zeros without the
    lengths, axes), ``forward(params, x, batch)`` -> (x, aux loss),
    ``prefill(..., max_len)`` -> (x, cache) and ``decode(params, cache,
    x, length)`` -> x, writing the cache in place. A family that sets
    ``pads_prefill`` also defines ``prefill_into(params, x, cache, slot,
    real)`` -> x: the prefill of one prompt padded at its end, written
    straight into row ``slot`` of the batch cache (``Model.prefill_into``).
    """

    #: whether the family's blocks take ``cfg.moe``
    experts = True
    #: whether the family defines ``prefill_into``
    pads_prefill = False

    def __init__(self, cfg, device: torch.device):
        scaled = (cfg.embedding_multiplier, cfg.attention_multiplier,
                  cfg.residual_multiplier, cfg.logits_scaling, cfg.norm_eps)
        if cfg.family not in SCALED_FAMILIES and \
                scaled != (1.0, None, 1.0, 1.0, None):
            raise ValueError(f"family {cfg.family!r} takes no multipliers "
                             f"nor norm_eps; only {SCALED_FAMILIES} do")
        if cfg.attn_layers and cfg.family != "hybrid_moe":
            raise ValueError("attn_layers is hybrid_moe's")
        if (cfg.mla is not None or cfg.dense_layers) and \
                cfg.family not in ("dense", "moe"):
            raise ValueError("latent attention and leading dense layers are "
                             "the decoder families' (dense, moe)")
        self.cfg, self.device, self.dt = cfg, device, cfg.tdtype
        self.bcfg = cfg.block_cfg(moe=self.experts)
        self.plan: Tuple[Layer, ...] = tuple(self._plan())

    def rows(self, *keys: str, cache: bool = False) -> Tuple[int, ...]:
        """The leading sizes of the stack at ``keys`` of the params tree
        (of the cache tree if ``cache``): the rows the plan puts there
        in each stacked dim; () if it puts none."""
        paths = (layer.cache if cache else layer.params for layer in self.plan)
        idx = [rows for keys_, rows in map(_split, filter(None, paths))
               if keys_ == keys]
        return tuple(max(dim) + 1 for dim in zip(*idx))

    def walk(self, params: Tree, cache: Optional[Tree] = None,
             kind: Optional[str] = None):
        """(layer, its params, its cache or None) for each block of the
        plan (of ``kind``) in order; each stack is cut into its per-layer
        views once a walk (:func:`transformer.unstack_params`)."""
        pv, cv = {}, {}
        for layer in self.plan:
            if kind in (None, layer.kind):
                lc = None if cache is None or layer.cache is None \
                    else _view(cache, layer.cache, cv)
                yield layer, _view(params, layer.params, pv), lc

    def _embed_params(self, gen) -> Tree:
        cfg = self.cfg
        return make_embed_params(gen, cfg.padded_vocab, cfg.d_model, self.dt,
                                 cfg.tie_embeddings, self.device)

    def _norm_params(self) -> Tree:
        cfg = self.cfg
        return make_norm_params(cfg.d_model, cfg.norm, self.dt, self.device)

    def _axes(self, **stacks) -> Tree:
        """The logical axes of the embedding, the final norm and ``stacks``."""
        cfg = self.cfg
        return {"embed": embed_axes(cfg.tie_embeddings),
                "final_norm": norm_axes(cfg.norm), **stacks}

    def _block(self, gen, **kw) -> Callable:
        """A maker of one decoder block (a cross block, given ``kw``)."""
        if kw:
            return lambda: tf.make_cross_block(gen, self.bcfg, self.dt,
                                               self.device, **kw)
        return lambda: tf.make_decoder_block(gen, self.bcfg, self.dt,
                                             self.device)

    def _kv_cache(self, batch: int, max_len: int, **kw) -> Tree:
        return tf.init_block_cache(batch, max_len, self.bcfg, self.dt,
                                   self.device, **kw)

    def _source_kv(self, batch: int) -> Tree:
        """Zero K and V of the frontend's states (audio, vision)."""
        cfg = self.cfg
        z = torch.zeros((batch, cfg.n_frontend_tokens, cfg.kv_heads, cfg.hd),
                        dtype=self.dt, device=self.device)
        return {"xk": z, "xv": z}


class Decoder(Family):
    """dense and moe: ``n_layers`` decoder blocks, stack ``layers``; in a
    moe model the first ``dense_layers`` of them have a dense MLP of width
    ``d_ff`` (stack ``dense_layers``; their cache rows stay in the one
    cache stack). With ``mla`` every block's attention is latent and so is
    its cache (:mod:`models.mla`'s blocks)."""

    pads_prefill = True

    def __init__(self, cfg, device):
        if cfg.dense_layers and cfg.moe is None:
            raise ValueError("dense_layers lead the expert layers of a moe "
                             "model")
        if cfg.mla is not None and cfg.kv_cache_quant:
            raise ValueError("latent attention keeps no int8 cache")
        super().__init__(cfg, device)
        #: the module of the blocks' entry points
        self.blocks = tf if cfg.mla is None else mla
        self.dense_bcfg = cfg.block_cfg(moe=False)

    def _plan(self):
        k = self.cfg.dense_layers
        return (Layer("attn", ("dense_layers", i) if i < k
                      else ("layers", i - k), ("layers", i))
                for i in range(self.cfg.n_layers))

    def _bcfg(self, layer: Layer):
        return self.dense_bcfg if layer.params[0] == "dense_layers" \
            else self.bcfg

    def build(self, gen):
        def block(bcfg):
            return lambda: self.blocks.make_decoder_block(gen, bcfg, self.dt,
                                                          self.device)
        params = {"embed": self._embed_params(gen)}
        if self.rows("dense_layers"):
            params["dense_layers"] = stack_params(self.rows("dense_layers"),
                                                  block(self.dense_bcfg))
        params["layers"] = stack_params(self.rows("layers"), block(self.bcfg))
        params["final_norm"] = self._norm_params()
        return params

    def axes(self):
        stacks = {"layers": prepend_axis(
            self.blocks.decoder_block_axes(self.bcfg))}
        if self.rows("dense_layers"):
            stacks["dense_layers"] = prepend_axis(
                self.blocks.decoder_block_axes(self.dense_bcfg))
        return self._axes(**stacks)

    def cache(self, batch, max_len):
        quantized = self.cfg.kv_cache_quant
        one = self.blocks.init_block_cache(batch, max_len, self.bcfg,
                                           self.dt, self.device,
                                           quantized=quantized)
        axes = tf.BLOCK_CACHE_AXES_Q if quantized else \
            self.blocks.BLOCK_CACHE_AXES
        return ({"layers": _stacked(one, self.rows("layers", cache=True))},
                {"layers": prepend_axis(axes)})

    def forward(self, params, x, batch):
        block = _maybe_remat(
            lambda lp, h, bcfg: self.blocks.apply_decoder_block(lp, h, bcfg),
            self.cfg.remat)
        aux = _zero_aux(x)
        for layer, lp, _ in self.walk(params):
            x, a = block(lp, constrain(x, ACT_AXES), self._bcfg(layer))
            aux = aux + a
        return x, aux

    def prefill(self, params, x, batch, max_len):
        caches = []
        for layer, lp, _ in self.walk(params):
            x, _, c = self.blocks.prefill_decoder_block(
                lp, constrain(x, ACT_AXES), self._bcfg(layer), max_len,
                quantized=self.cfg.kv_cache_quant)
            caches.append(c)
        return x, {"layers": _stack(caches)}

    def prefill_into(self, params, x, cache, slot, real):
        for layer, lp, lc in self.walk(params, cache):
            x = self.blocks.prefill_decoder_block_into(
                lp, x, self._bcfg(layer), lc, slot, real)
        return x

    def decode(self, params, cache, x, length):
        for layer, lp, lc in self.walk(params, cache):
            x, _ = self.blocks.decode_decoder_block(
                lp, constrain(x, ACT_AXES), lc, length, self._bcfg(layer))
        return x


# -- the Mamba2 mixers of hybrid and hybrid_moe: (params, h) -> (y, state) --

def _scan(cfg, with_state: bool) -> Callable:
    """The full-sequence mixer; the state is the layer's decode state with
    ``with_state``, else None. It passes ``use_ssm_kernel`` on, where the
    reference's hybrid prefill drops it and always runs the chunked path:
    both compute the same (tests/test_torch_mamba2.py), and serving is
    where the kernels run."""
    kw = dict(use_kernel=cfg.use_ssm_kernel, eps=cfg.norm_eps)
    if with_state:
        return lambda p, h: m2.apply_mamba2_with_state(p, h, cfg.ssm, **kw)
    return lambda p, h: (m2.apply_mamba2(p, h, cfg.ssm, **kw), None)


def _step(cfg, mc: Tree) -> Callable:
    """The one-token mixer of the layer whose cache is ``mc``: its new
    state is written back into ``mc`` in place (state None)."""
    def step(params, h):
        y, new = m2.decode_mamba2(params, h, mc, cfg.ssm, eps=cfg.norm_eps)
        for k, t in new.items():
            mc[k].copy_(t)
        return y, None
    return step


class _Mamba(Family):
    """hybrid and hybrid_moe: Mamba2 layers (``_mamba``) and decoder
    blocks, the residual stream unpinned between them."""

    #: the conv window's channel axis (hybrid_moe's hold x, B and C)
    conv_axis: Optional[str] = "inner"

    def cache(self, batch, max_len):
        cfg = self.cfg
        mamba = m2.init_mamba2_cache(batch, cfg.d_model, cfg.ssm, self.dt,
                                     self.device)
        cache = {"mamba": _stacked(mamba, self.rows("mamba", cache=True))}
        axes = {"mamba": {"h": ("layers", "batch", "inner", None, None),
                          "conv": ("layers", "batch", None, self.conv_axis)}}
        if self.rows("attn", cache=True):
            cache["attn"] = _stacked(self._kv_cache(batch, max_len),
                                     self.rows("attn", cache=True))
            axes["attn"] = prepend_axis(BLOCK_CACHE_AXES)
        return cache, axes

    def prefill(self, params, x, batch, max_len):
        """Each Mamba2 layer keeps its final SSM state and conv window,
        each attention layer its keys and values."""
        scan = _scan(self.cfg, with_state=True)
        states, caches = [], []
        for layer, lp, _ in self.walk(params):
            if layer.kind == "attn":
                x, _, c = tf.prefill_decoder_block(lp, x, self.bcfg, max_len)
                caches.append(c)
            else:
                x, st = self._mamba(lp, x, scan)[:2]
                states.append(st)
        cache = {"mamba": _stack(states)}
        if caches:
            cache["attn"] = _stack(caches)
        return x, cache

    def decode(self, params, cache, x, length):
        for layer, lp, lc in self.walk(params, cache):
            if layer.kind == "attn":
                x, _ = tf.decode_decoder_block(lp, x, lc, length, self.bcfg)
            else:
                x = self._mamba(lp, x, _step(self.cfg, lc))[0]
        return x


class Hybrid(_Mamba):
    """zamba2: a Mamba2 layer at every position (stack ``layers``), and one
    decoder block (``shared``) applied after every ``shared_attn_every``-th
    of them, each application with a KV cache of its own."""

    def __init__(self, cfg, device):
        super().__init__(cfg, device)
        self.bcfg = cfg.block_cfg(moe=False, d_ff=cfg.shared_attn_d_ff)

    def _plan(self):
        k = self.cfg.shared_attn_every
        for i in range(self.cfg.n_layers):
            yield Layer("mamba", ("layers", i), ("mamba", i))
            if i % k == k - 1:
                yield Layer("attn", ("shared",), ("attn", i // k))

    def build(self, gen):
        cfg = self.cfg
        return {"embed": self._embed_params(gen),
                "layers": stack_params(self.rows("layers"), lambda: {
                    "mamba": m2.make_mamba2_params(gen, cfg.d_model, cfg.ssm,
                                                   self.dt, self.device),
                    "norm": self._norm_params()}),
                "shared": self._block(gen)(),
                "final_norm": self._norm_params()}

    def axes(self):
        return self._axes(
            layers=prepend_axis({"mamba": m2.mamba2_axes(),
                                 "norm": norm_axes(self.cfg.norm)}),
            shared=tf.decoder_block_axes(self.bcfg))

    def _mamba(self, lp: Tree, x: torch.Tensor, mixer: Callable):
        """x + mixer(norm(x)) (span ``rt.mamba``), and the mixer's state."""
        with span("rt.mamba"):
            y, st = mixer(lp["mamba"], apply_norm(lp["norm"], x,
                                                  self.cfg.norm))
            return x + y, st

    def forward(self, params, x, batch):
        """Each position's Mamba2 layer and the shared block after it are
        rematerialised as one."""
        cfg, scan = self.cfg, _scan(self.cfg, with_state=False)

        def body(lp, h, shared):
            h = h + scan(lp["mamba"], apply_norm(lp["norm"], h, cfg.norm))[0]
            if shared is not None:
                h, _ = tf.apply_decoder_block(shared, h, self.bcfg)
            return h

        positions = []
        for layer, lp, _ in self.walk(params):
            if layer.kind == "mamba":
                positions.append([lp, None])
            else:
                positions[-1][1] = lp
        body = _maybe_remat(body, cfg.remat)
        for lp, shared in positions:
            x = body(lp, constrain(x, ACT_AXES), shared)
        return x, _zero_aux(x)


class HybridMoe(_Mamba):
    """granite-4.0-h: at each position a Mamba2 mixer (stack
    ``mamba_layers``: norm1, the mixer, norm2, the experts) or, on the
    layers ``attn_layers`` names, a decoder block with experts (stack
    ``attn_layers``)."""

    conv_axis = None

    def __init__(self, cfg, device):
        if cfg.ssm is None or cfg.moe is None:
            raise ValueError("hybrid_moe needs an ssm and a moe config")
        super().__init__(cfg, device)

    def _plan(self):
        row = {"attn": 0, "mamba": 0}
        for i in range(self.cfg.n_layers):
            kind = "attn" if i in self.cfg.attn_layers else "mamba"
            yield Layer(kind, (f"{kind}_layers", row[kind]), (kind, row[kind]))
            row[kind] += 1

    def build(self, gen):
        cfg, dev, dt = self.cfg, self.device, self.dt

        def mamba_layer():
            return {"mamba": m2.make_mamba2_params(gen, cfg.d_model, cfg.ssm,
                                                   dt, dev),
                    "norm1": self._norm_params(),
                    "norm2": self._norm_params(),
                    "moe": make_moe_params(gen, cfg.d_model, cfg.moe, dt,
                                           dev)}

        params = {"embed": self._embed_params(gen),
                  "mamba_layers": stack_params(self.rows("mamba_layers"),
                                               mamba_layer),
                  "final_norm": self._norm_params()}
        if self.rows("attn_layers"):
            params["attn_layers"] = stack_params(self.rows("attn_layers"),
                                                 self._block(gen))
        return params

    def axes(self):
        cfg, norm = self.cfg, norm_axes(self.cfg.norm)
        axes = self._axes(mamba_layers=prepend_axis(
            {"mamba": m2.mamba2_axes(cfg.ssm), "norm1": norm, "norm2": norm,
             "moe": moe_axes(cfg.moe)}))
        if self.rows("attn_layers"):
            axes["attn_layers"] = prepend_axis(
                tf.decoder_block_axes(self.bcfg))
        return axes

    def _mamba(self, lp: Tree, x: torch.Tensor, mixer: Callable):
        """A Mamba2 layer: x + r mixer(norm1(x)) (span ``rt.mamba``), then
        + r experts(norm2(.)). Returns (x, the mixer's state, aux)."""
        cfg, bcfg = self.cfg, self.bcfg
        with span("rt.mamba"):
            y, st = mixer(lp["mamba"],
                          apply_norm(lp["norm1"], x, cfg.norm, cfg.norm_eps))
            x = x + tf.residual(y, bcfg)
        f, aux = tf._ffn(lp, x, bcfg)
        return x + tf.residual(f, bcfg), st, aux

    def forward(self, params, x, batch):
        cfg, scan = self.cfg, _scan(self.cfg, with_state=False)
        attn = _maybe_remat(
            lambda lp, h: tf.apply_decoder_block(lp, h, self.bcfg), cfg.remat)

        def mamba(lp, h):
            h, _, a = self._mamba(lp, h, scan)
            return h, a

        mamba = _maybe_remat(mamba, cfg.remat)
        aux = _zero_aux(x)
        for layer, lp, _ in self.walk(params):
            block = attn if layer.kind == "attn" else mamba
            x, a = block(lp, constrain(x, ACT_AXES))
            aux = aux + a
        return x, aux


class Xlstm(Family):
    """ssm (xLSTM): mLSTM blocks with an sLSTM block every
    ``xlstm.slstm_every``-th. The layers are a Python list of dicts, as in
    the reference: the two kinds have different leaves, so they do not
    stack."""

    def _plan(self):
        k = self.cfg.xlstm.slstm_every
        return (Layer("slstm" if i % k == k - 1 else "mlstm", ("layers", i),
                      ("layers", i))
                for i in range(self.cfg.n_layers))

    def build(self, gen):
        """The layers are drawn before the embedding."""
        cfg = self.cfg
        make = {"mlstm": xl.make_mlstm_params, "slstm": xl.make_slstm_params}
        layers = [{"block": make[layer.kind](gen, cfg.d_model, cfg.xlstm,
                                             self.dt, self.device),
                   "norm": self._norm_params()} for layer in self.plan]
        return {"embed": self._embed_params(gen), "layers": layers,
                "final_norm": self._norm_params()}

    def axes(self):
        block = {"mlstm": xl.mlstm_axes, "slstm": xl.slstm_axes}
        return self._axes(layers=[{"block": block[layer.kind](),
                                   "norm": norm_axes(self.cfg.norm)}
                                  for layer in self.plan])

    def cache(self, batch, max_len):
        cfg, dev = self.cfg, self.device
        make = {"mlstm": lambda: xl.init_mlstm_cache(batch, cfg.d_model,
                                                     cfg.xlstm, self.dt, dev),
                "slstm": lambda: xl.init_slstm_state(batch, cfg.d_model,
                                                     cfg.xlstm, dev)}
        axes = {"mlstm": {"C": ("batch", "heads", None, None),
                          "n": ("batch", "heads", None),
                          "m": ("batch", "heads"),
                          "conv": ("batch", None, "inner")},
                "slstm": {k: ("batch", "heads", None)
                          for k in ("c", "n", "h", "m")}}
        return ({"layers": [make[layer.kind]() for layer in self.plan]},
                {"layers": [dict(axes[layer.kind]) for layer in self.plan]})

    def forward(self, params, x, batch):
        cfg = self.cfg

        def layer(lp, h, kind):
            hn = apply_norm(lp["norm"], h, cfg.norm)
            if kind == "mlstm":
                return h + xl.apply_mlstm(lp["block"], hn, cfg.xlstm)
            return h + xl.apply_slstm(lp["block"], hn, cfg.xlstm)[0]

        layer = _maybe_remat(layer, cfg.remat)
        for lay, lp, _ in self.walk(params):
            x = layer(lp, constrain(x, ACT_AXES), lay.kind)
        return x, _zero_aux(x)

    def prefill(self, params, x, batch, max_len):
        """Every mLSTM prefill takes the chunkwise form, which returns the
        matrix memory; the sLSTM runs its recurrence."""
        cfg = self.cfg
        run = {"mlstm": xl.apply_mlstm_with_state, "slstm": xl.apply_slstm}
        states = []
        for layer, lp, _ in self.walk(params):
            with span(f"rt.{layer.kind}"):
                hn = apply_norm(lp["norm"], x, cfg.norm)
                y, st = run[layer.kind](lp["block"], hn, cfg.xlstm)
                x = x + y
            states.append(st)
        return x, {"layers": states}

    def decode(self, params, cache, x, length):
        cfg = self.cfg
        run = {"mlstm": xl.decode_mlstm, "slstm": xl.decode_slstm}
        for layer, lp, st in self.walk(params, cache):
            with span(f"rt.{layer.kind}"):
                hn = apply_norm(lp["norm"], x, cfg.norm)
                y, _ = run[layer.kind](lp["block"], hn, st, cfg.xlstm)
                x = x + y
        return x


class Audio(Family):
    """audio (whisper): an encoder over the stub frame embeddings (stack
    ``enc_layers``), then decoder layers (``layers``) that attend to its
    states; the decoder's positions are learned (``embed.pos``)."""

    experts = False

    def _plan(self):
        cfg = self.cfg
        yield from (Layer("encoder", ("enc_layers", i))
                    for i in range(cfg.n_encoder_layers))
        yield from (Layer("cross", ("layers", i), ("layers", i))
                    for i in range(cfg.n_layers))

    def build(self, gen):
        cfg = self.cfg
        embed = self._embed_params(gen)
        embed["pos"] = dense_init(gen, cfg.max_pos, cfg.d_model, self.dt,
                                  self.device, scale=0.02)
        return {"embed": embed,
                "enc_layers": stack_params(self.rows("enc_layers"),
                                           self._block(gen)),
                "enc_norm": self._norm_params(),
                "layers": stack_params(self.rows("layers"),
                                       self._block(gen, self_attn=True)),
                "final_norm": self._norm_params()}

    def axes(self):
        axes = self._axes(
            enc_layers=prepend_axis(tf.decoder_block_axes(self.bcfg)),
            enc_norm=norm_axes(self.cfg.norm),
            layers=prepend_axis(tf.cross_block_axes(self.bcfg,
                                                    self_attn=True)))
        axes["embed"]["pos"] = (None, "embed")
        return axes

    def cache(self, batch, max_len):
        one = dict(self._kv_cache(batch, max_len), **self._source_kv(batch))
        axes = dict(BLOCK_CACHE_AXES, xk=("batch", None, None, None),
                    xv=("batch", None, None, None))
        return ({"layers": _stacked(one, self.rows("layers", cache=True))},
                {"layers": prepend_axis(axes)})

    def _start(self, params: Tree, x: torch.Tensor, batch: Dict):
        """(the encoder's states, x at the learned positions 0..s-1). The
        encoder runs over the frame embeddings (b, s_enc, d_model) plus
        sinusoidal positions; it is bidirectional: plain attention, never
        the causal kernel."""
        cfg, frames = self.cfg, batch["frames"]
        s, d = frames.shape[1], cfg.d_model
        pos = torch.arange(s, dtype=torch.float32, device=frames.device)
        dim = torch.arange(0, d, 2, dtype=torch.float32, device=frames.device)
        angle = pos[:, None] / torch.pow(10000.0, dim[None] / d)
        h = frames + torch.cat([torch.sin(angle), torch.cos(angle)],
                               dim=-1).to(frames.dtype)
        block = _maybe_remat(lambda lp, h: tf.apply_decoder_block(
            lp, h, self.bcfg, causal=False)[0], cfg.remat)
        for _, lp, _ in self.walk(params, kind="encoder"):
            h = block(lp, constrain(h, ACT_AXES))
        enc_out = apply_norm(params["enc_norm"], h, cfg.norm)
        return enc_out, x + params["embed"]["pos"][:x.shape[1]]

    def forward(self, params, x, batch):
        enc_out, x = self._start(params, x, batch)
        block = _maybe_remat(
            lambda lp, h, kv: tf.apply_cross_block(lp, h, kv, self.bcfg),
            self.cfg.remat)
        for _, lp, _ in self.walk(params, kind="cross"):
            x = block(lp, constrain(x, ACT_AXES), enc_out)
        return x, _zero_aux(x)

    def prefill(self, params, x, batch, max_len):
        enc_out, x = self._start(params, x, batch)
        caches = []
        for _, lp, _ in self.walk(params, kind="cross"):
            with span("rt.cross"):
                x, c = tf.prefill_cross_block(lp, constrain(x, ACT_AXES),
                                              enc_out, self.bcfg, max_len)
            caches.append(c)
        return x, {"layers": _stack(caches)}

    def decode(self, params, cache, x, length):
        pos = length.clamp(0, self.cfg.max_pos - 1).long()
        x = x + params["embed"]["pos"][pos][:, None, :]
        for _, lp, lc in self.walk(params, cache, kind="cross"):
            with span("rt.cross"):
                x, _ = tf.decode_cross_block(lp, constrain(x, ACT_AXES), lc,
                                             length, self.bcfg)
        return x


class Vlm(Family):
    """vlm (llama-3.2-vision): segments of ``cross_attn_every - 1``
    decoder blocks (``segments.self``, stacked over (segments, layers))
    and one gated cross layer (``segments.cross``) attending to the stub
    patch embeddings."""

    experts = False

    def _plan(self):
        cfg = self.cfg
        k = cfg.cross_attn_every
        if cfg.n_layers % k:
            raise ValueError("n_layers must divide cross cadence")
        for s in range(cfg.n_layers // k):
            for j in range(k - 1):
                yield Layer("attn", ("segments", "self", s, j), ("self", s, j))
            yield Layer("gated_cross", ("segments", "cross", s), ("cross", s))

    def build(self, gen):
        """Each stack is preallocated and its layers drawn into it in
        turn: all the decoder blocks, then the cross layers."""
        return {"embed": self._embed_params(gen),
                "segments": {
                    "self": stack_params(self.rows("segments", "self"),
                                         self._block(gen)),
                    "cross": stack_params(self.rows("segments", "cross"),
                                          self._block(gen, gated=True,
                                                      self_attn=False))},
                "final_norm": self._norm_params()}

    def axes(self):
        return self._axes(segments=prepend_axis(
            {"self": prepend_axis(tf.decoder_block_axes(self.bcfg)),
             "cross": tf.cross_block_axes(self.bcfg, gated=True,
                                          self_attn=False)}))

    def cache(self, batch, max_len):
        axes = {"self": prepend_axis(prepend_axis(BLOCK_CACHE_AXES, "seg")),
                "cross": {"xk": ("seg", "batch", None, None, None),
                          "xv": ("seg", "batch", None, None, None)}}
        return {"self": _stacked(self._kv_cache(batch, max_len),
                                 self.rows("self", cache=True)),
                "cross": _stacked(self._source_kv(batch),
                                  self.rows("cross", cache=True))}, axes

    def forward(self, params, x, batch):
        inner = _maybe_remat(
            lambda lp, h: tf.apply_decoder_block(lp, h, self.bcfg)[0],
            self.cfg.remat)
        for layer, lp, _ in self.walk(params):
            if layer.kind == "attn":
                x = inner(lp, constrain(x, ACT_AXES))
            else:
                x = tf.apply_cross_block(lp, x, batch["patches"], self.bcfg,
                                         gated=True)
        return x, _zero_aux(x)

    def prefill(self, params, x, batch, max_len):
        patches = batch["patches"]
        self_kv, seg_kv, cross = [], [], []
        for layer, lp, _ in self.walk(params):
            if layer.kind == "attn":
                x, _, c = tf.prefill_decoder_block(
                    lp, constrain(x, ACT_AXES), self.bcfg, max_len)
                seg_kv.append(c)
                continue
            self_kv.append(_stack(seg_kv))
            seg_kv = []
            with span("rt.cross"):
                xk, xv = tf.cross_source_kv(lp["cross_attn"], patches,
                                            self.bcfg)
                x = tf.apply_cross_block(lp, x, patches, self.bcfg,
                                         gated=True)
            cross.append({"xk": xk, "xv": xv})
        return x, {"self": _stack(self_kv), "cross": _stack(cross)}

    def decode(self, params, cache, x, length):
        for layer, lp, lc in self.walk(params, cache):
            if layer.kind == "attn":
                x, _ = tf.decode_decoder_block(lp, constrain(x, ACT_AXES), lc,
                                               length, self.bcfg)
            else:
                with span("rt.cross"):
                    x, _ = tf.decode_cross_block(lp, x, lc, length, self.bcfg,
                                                 gated=True)
        return x


#: each family's class, by ``ModelConfig.family``
FAMILIES = {"dense": Decoder, "moe": Decoder, "hybrid": Hybrid,
            "ssm": Xlstm, "audio": Audio, "vlm": Vlm, "hybrid_moe": HybridMoe}
