"""The port's cross-attention and encoder blocks against
``repro.models.transformer`` on bridged weights (fp32): whisper's decoder
layer (self + cross + MLP) and llama-vision's gated layer, the gated ones
with non-zero gates (they start at 0, where tanh(0) = 0 hides the cross
path)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.models import model as ref_model_mod
from repro.models import transformer as ref_tf
from repro_torch import bridge
from repro_torch.models import transformer as tf

#: the model forward tolerance of the reference (tests/test_kernels.py)
TOL = dict(atol=2e-4, rtol=2e-3)
GATES = {"gate_attn": 0.5, "gate_mlp": -0.75}
#: whisper's block (layernorm, biased GeLU MLP, QKV bias, no rope) and
#: llama-vision's (rmsnorm, SwiGLU, GQA, rope in the self layers), small
KINDS = {
    "whisper": dict(d_model=64, n_heads=4, kv_heads=4, head_dim=16, d_ff=128,
                    norm="layernorm", mlp="gelu", qkv_bias=True,
                    rope_theta=None),
    "vision": dict(d_model=64, n_heads=4, kv_heads=2, head_dim=16, d_ff=128,
                   rope_theta=500_000.0),
}
REF = {
    "apply": jax.jit(ref_tf.apply_cross_block, static_argnums=3,
                     static_argnames="gated"),
    "decode": jax.jit(ref_tf.decode_cross_block, static_argnums=4,
                      static_argnames="gated"),
    "source_kv": jax.jit(ref_tf.cross_source_kv, static_argnums=2),
    "encoder": jax.jit(ref_tf.apply_encoder_block, static_argnums=2),
}


def _cfgs(kind, **overrides):
    kw = dict(KINDS[kind], **overrides)
    return ref_tf.BlockConfig(**kw), tf.BlockConfig(**kw)


def _block(kind, gated, self_attn, seed=0):
    """(reference block params, bridged port params), gates opened."""
    ref_cfg, _ = _cfgs(kind)
    ref, _ = ref_tf.make_cross_block(jax.random.key(seed), ref_cfg,
                                     jnp.float32, gated=gated,
                                     self_attn=self_attn)
    if gated:
        ref = dict(ref, **{k: jnp.asarray(v, jnp.float32)
                           for k, v in GATES.items()})
    return ref, bridge.from_reference(jax.tree.map(np.asarray, ref),
                                      device="cpu")


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=msg,
                               **TOL)


CASES = [("whisper", False, True), ("vision", True, False),
         ("vision", False, True)]


@pytest.mark.parametrize("kind,gated,self_attn", CASES)
def test_make_cross_block_has_the_reference_layout(kind, gated, self_attn):
    ref, _ = _block(kind, gated, self_attn)
    _, cfg = _cfgs(kind, qk_norm=True)
    got = bridge.to_numpy(tf.make_cross_block(
        torch.Generator().manual_seed(0), cfg, torch.float32, "cpu",
        gated=gated, self_attn=self_attn))
    ref_cfg, _ = _cfgs(kind, qk_norm=True)
    want, _ = ref_tf.make_cross_block(jax.random.key(0), ref_cfg,
                                      jnp.float32, gated=gated,
                                      self_attn=self_attn)
    assert jax.tree.structure(got) == jax.tree.structure(
        jax.tree.map(np.asarray, want))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype
    if gated:   # the gates start closed, and only a gated block has qk-norm
        assert float(got["gate_attn"]) == float(got["gate_mlp"]) == 0.0
        assert "q_norm" in got["cross_attn"]
    assert "q_norm" not in got.get("self_attn", {})


@pytest.mark.parametrize("kind,gated,self_attn", CASES)
def test_apply_cross_block(kind, gated, self_attn):
    ref, params = _block(kind, gated, self_attn)
    ref_cfg, cfg = _cfgs(kind)
    x, src = _x(1, 2, 12, 64), _x(2, 2, 20, 64)
    got = tf.apply_cross_block(params, torch.from_numpy(x),
                               torch.from_numpy(src), cfg, gated=gated)
    want = REF["apply"](ref, jnp.asarray(x), jnp.asarray(src), ref_cfg,
                        gated=gated)
    _close(got, want)


def test_gates_scale_the_cross_and_mlp_residuals():
    """A gated block with closed gates is the identity; opened, it is not."""
    _, params = _block("vision", True, False)
    _, cfg = _cfgs("vision")
    x, src = torch.from_numpy(_x(1, 1, 5, 64)), torch.from_numpy(
        _x(2, 1, 7, 64))
    opened = tf.apply_cross_block(params, x, src, cfg, gated=True)
    assert float((opened - x).abs().max()) > 1e-2
    closed = dict(params, gate_attn=torch.zeros(()),
                  gate_mlp=torch.zeros(()))
    assert torch.equal(tf.apply_cross_block(closed, x, src, cfg, gated=True),
                       x)


@pytest.mark.parametrize("kind", KINDS)
def test_cross_source_kv_and_cached_attention(kind):
    """The source's K/V projected once equal the reference's, and the
    cached attention equals the uncached one."""
    ref, params = _block(kind, False, False)
    ref_cfg, cfg = _cfgs(kind)
    h, src = torch.from_numpy(_x(3, 2, 1, 64)), _x(4, 2, 20, 64)
    k, v = tf.cross_source_kv(params["cross_attn"], torch.from_numpy(src),
                              cfg)
    wk, wv = REF["source_kv"](ref["cross_attn"], jnp.asarray(src), ref_cfg)
    _close(k, wk)
    _close(v, wv)
    np.testing.assert_allclose(
        tf._cross_attend_cached(params["cross_attn"], h, k, v, cfg).numpy(),
        tf._cross_attend(params["cross_attn"], h, torch.from_numpy(src),
                         cfg).numpy(), **TOL)


def test_prefill_cross_block_is_the_reference_prefill():
    """Whisper's layer prefill: output and cache (self K/V padded to
    max_len, the source's K/V) against the reference's ``_prefill_cross``
    and ``cross_source_kv``, and the output against the full block."""
    ref, params = _block("whisper", False, True)
    ref_cfg, cfg = _cfgs("whisper")
    x, src = _x(5, 2, 10, 64), _x(6, 2, 20, 64)
    got, cache = tf.prefill_cross_block(params, torch.from_numpy(x),
                                        torch.from_numpy(src), cfg, 16)
    want, _, want_c = ref_model_mod.Model._prefill_cross(
        ref, jnp.asarray(x), jnp.asarray(src), ref_cfg, 16)
    want_c["xk"], want_c["xv"] = REF["source_kv"](
        ref["cross_attn"], jnp.asarray(src), ref_cfg)
    _close(got, want)
    assert sorted(cache) == ["k", "v", "xk", "xv"]
    for name in cache:
        _close(cache[name], want_c[name], name)
    _close(got, tf.apply_cross_block(params, torch.from_numpy(x),
                                     torch.from_numpy(src), cfg))


@pytest.mark.parametrize("kind,gated,self_attn", CASES)
def test_decode_cross_block_on_a_bridged_reference_cache(kind, gated,
                                                         self_attn):
    """One decode step from the reference's cache (self K/V filled to
    length 9 of 16, random beyond; the source's K/V), bridged: the output
    and the cache written in place equal the reference's."""
    ref, params = _block(kind, gated, self_attn)
    ref_cfg, cfg = _cfgs(kind)
    b, max_len, length = 2, 16, 9
    ref_cache = dict(zip(("xk", "xv"), REF["source_kv"](
        ref["cross_attn"], jnp.asarray(_x(7, b, 20, 64)), ref_cfg)))
    if self_attn:
        hkv, hd = ref_cfg.kv_heads, ref_cfg.head_dim
        kv = _x(8, 2, b, max_len, hkv, hd)
        kv[:, :, length:] = 0.0             # the slots past the fill are 0
        ref_cache.update(k=jnp.asarray(kv[0]), v=jnp.asarray(kv[1]))
    cache = bridge.cache_from_reference(jax.tree.map(np.asarray, ref_cache),
                                        device="cpu")
    x = _x(9, b, 1, 64)
    lens = np.full((b,), length, np.int32)
    want, want_c = REF["decode"](ref, jnp.asarray(x), ref_cache,
                                 jnp.asarray(lens), ref_cfg, gated=gated)
    got, got_c = tf.decode_cross_block(params, torch.from_numpy(x), cache,
                                       torch.from_numpy(lens), cfg,
                                       gated=gated)
    _close(got, want)
    assert got_c is cache
    for name in want_c:
        _close(got_c[name], want_c[name], name)


def test_apply_encoder_block_is_bidirectional():
    ref_cfg, cfg = _cfgs("whisper")
    ref, _ = ref_tf.make_decoder_block(jax.random.key(1), ref_cfg,
                                       jnp.float32)
    params = bridge.from_reference(jax.tree.map(np.asarray, ref),
                                   device="cpu")
    x = _x(10, 2, 12, 64)
    got = tf.apply_encoder_block(params, torch.from_numpy(x), cfg)
    _close(got, REF["encoder"](ref, jnp.asarray(x), ref_cfg))
    causal, _ = tf.apply_decoder_block(params, torch.from_numpy(x), cfg)
    assert not torch.allclose(got[:, :-1], causal[:, :-1], atol=1e-3)
