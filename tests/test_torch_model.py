"""The port's models against the JAX models on bridged weights: every
arch of the registry at its reduced size, the audio and vision families
with their frames / patches, the vision model with non-zero gates."""
import collections
import dataclasses
import functools
import itertools
import operator
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import registry as ref_registry
from repro.models.model import Model as RefModel
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, PORT_ARCH_IDS, reduced_config
from repro_torch.models import transformer as tf
from repro_torch.models.model import Model
from repro_torch.tree import tree_leaves

#: model forward tolerance (tests/test_kernels.py::test_model_attention_...)
FWD_TOL = dict(atol=2e-4, rtol=2e-3)
#: prefill/decode tolerance (tests/test_serving.py)
DEC_TOL = dict(atol=2e-3, rtol=2e-2)
#: reference attention impl for each of the port's
_REF_IMPL = {"plain": "xla", "kernel": "pallas_interpret"}


def _drop_free(cfg):
    """An MoE config at a drop-free capacity factor (tests/test_serving.py):
    a full forward and a 2-token decode batch drop different tokens."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


#: the vision model's cross-layer gates for every test: they start at 0
#: and tanh(0) = 0, so on fresh weights a broken cross path would add
#: nothing and pass unseen
GATES = {"gate_attn": 0.5, "gate_mlp": -0.75}


def open_gates(ref_params):
    """The reference's vlm params with GATES set in every segment; other
    families' params as they are."""
    if "segments" not in ref_params:
        return ref_params
    seg = ref_params["segments"]
    cross = dict(seg["cross"], **{k: jnp.full_like(seg["cross"][k], v)
                                  for k, v in GATES.items()})
    return dict(ref_params, segments=dict(seg, cross=cross))


def _pair(arch, impl="plain", drop_free=False, **overrides):
    """(port model, reference model, port params, reference params)."""
    ref_cfg = ref_registry.reduced_config(arch, attn_impl=_REF_IMPL[impl],
                                          **overrides)
    cfg = reduced_config(arch, attn_impl=impl, **overrides)
    if drop_free:
        ref_cfg, cfg = _drop_free(ref_cfg), _drop_free(cfg)
    ref_model = RefModel(ref_cfg)
    ref_params = open_gates(ref_model.init(jax.random.key(0)))
    port = Model(cfg, device="cpu")
    params = bridge.from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return port, ref_model, params, ref_params


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s))


def _extra(cfg, b, seed=2):
    """The stub frontend's input of the audio (``frames``) or vision
    (``patches``) family as numpy, or nothing."""
    name = {"audio": "frames", "vlm": "patches"}.get(cfg.family)
    if name is None:
        return {}
    shape = (b, cfg.n_frontend_tokens, cfg.d_model)
    return {name: np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)}


def _batches(cfg, tokens, extra):
    """The same inputs for the port (torch) and the reference (jax)."""
    arrays = {"tokens": tokens, **extra}
    return ({k: torch.from_numpy(v) for k, v in arrays.items()},
            {k: jnp.asarray(v) for k, v in arrays.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip(dtype):
    port, _, params, ref_params = _pair("qwen3-0.6b", dtype=dtype)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), ref_params)
    got = bridge.to_numpy(params)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)       # bf16 -> fp32 is exact
    assert params["layers"]["attn"]["wq"].dtype == getattr(torch, dtype)
    assert params["layers"]["attn"]["wq"].shape[0] == port.cfg.n_layers


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_forward_matches_reference(arch, impl):
    port, ref_model, params, ref_params = _pair(arch, impl)
    tb, jb = _batches(port.cfg, _tokens(port.cfg, 2, 64),
                      _extra(port.cfg, 2))
    want, want_aux = ref_model.forward(ref_params, jb)
    got, aux = port.forward(params, tb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    if port.cfg.moe is None:
        assert float(aux) == 0.0
    else:
        np.testing.assert_allclose(float(aux), float(want_aux), **FWD_TOL)
        assert float(aux) > 0.0


def test_loss_matches_reference():
    port, ref_model, params, ref_params = _pair("olmo-1b")
    tokens = _tokens(port.cfg, 2, 16)
    labels = np.where(np.arange(16) % 5 == 0, -1, tokens)
    want, _ = ref_model.loss(ref_params, {"tokens": jnp.asarray(tokens),
                                          "labels": jnp.asarray(labels)})
    got, _ = port.loss(params, {"tokens": torch.from_numpy(tokens),
                                "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(got), float(want), **FWD_TOL)


@pytest.mark.parametrize("arch", sorted(ARCH_IDS))
def test_prefill_decode_matches_reference_and_forward(arch):
    """logits(prefill k) + logits(decode k+1..n) == the reference's, and
    == the port's own forward(n): the cache path is the forward path. MoE
    archs at a drop-free capacity factor, as in tests/test_serving.py
    (tests/test_torch_moe.py holds the dropping case to the reference)."""
    port, ref_model, params, ref_params = _pair(arch, drop_free=True)
    b, k, n = 2, 12, 16
    tb, jb = _batches(port.cfg, _tokens(port.cfg, b, n), _extra(port.cfg, b))
    tt, jt = tb["tokens"], jb["tokens"]
    full, _ = port.forward(params, tb)

    got, cache = port.prefill(params, dict(tb, tokens=tt[:, :k]),
                              max_len=n + 4)
    want, ref_cache = ref_model.prefill(ref_params,
                                        dict(jb, tokens=jt[:, :k]),
                                        max_len=n + 4)
    np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want[:, 0]),
                               **DEC_TOL)
    np.testing.assert_allclose(got[:, 0].numpy(), full[:, k - 1].numpy(),
                               **DEC_TOL)
    got_c = jax.tree.leaves(bridge.to_numpy(cache))
    want_c = jax.tree.leaves(ref_cache)
    assert len(got_c) == len(want_c)
    for c, w in zip(got_c, want_c):
        np.testing.assert_allclose(c, np.asarray(w, np.float32), **DEC_TOL)
    for i in range(k, n):
        got, cache = port.decode_step(params, cache, tt[:, i:i + 1])
        want, ref_cache = ref_model.decode_step(ref_params, ref_cache,
                                                jt[:, i:i + 1])
        np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want[:, 0]),
                                   **DEC_TOL, err_msg=f"{arch} step {i}")
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, i].numpy(),
                                   **DEC_TOL, err_msg=f"{arch} step {i}")
    assert cache["length"].tolist() == [n] * b


def test_decode_on_a_bridged_reference_cache():
    """The port continues decoding from the reference's own cache."""
    port, ref_model, params, ref_params = _pair("qwen3-0.6b")
    tokens = jnp.asarray(_tokens(port.cfg, 2, 9))
    _, ref_cache = ref_model.prefill(ref_params, {"tokens": tokens[:, :8]},
                                     max_len=12)
    cache = bridge.cache_from_reference(jax.tree.map(np.asarray, ref_cache),
                                        device="cpu")
    want, _ = ref_model.decode_step(ref_params, ref_cache, tokens[:, 8:])
    got, _ = port.decode_step(params, cache,
                              torch.from_numpy(np.array(tokens[:, 8:])))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DEC_TOL)


def test_unported_family_and_int8_cache_raise():
    """Every family of the reference is ported, and one of the port alone
    (hybrid_moe), so only an unknown family raises (the name dates from
    when three were not ported; the int8 cache, ported since, is held in
    tests/test_torch_kv_int8.py)."""
    cfg = reduced_config("qwen3-0.6b")
    assert Model.FAMILIES == ("dense", "moe", "hybrid", "ssm", "audio",
                              "vlm", "hybrid_moe")
    with pytest.raises(ValueError, match="unknown family"):
        Model(dataclasses.replace(cfg, family="rnn"), device="cpu")


@pytest.mark.parametrize("arch", ARCH_IDS + PORT_ARCH_IDS)
def test_layer_plan_fills_the_parameter_and_cache_stacks(arch):
    """The layer plan walks the config's layers (and whisper's encoder
    layers; zamba2's shared block, rowless, at its applications), and the
    rows it names in each parameter and cache stack are that stack's
    leading dims, every one of them; what it names nothing of is the
    embedding, the norms and the lengths."""
    cfg = reduced_config(arch)
    model = Model(cfg, device="meta")
    plan = model.layer_plan()
    kinds = collections.Counter(layer.kind for layer in plan)
    assert kinds["encoder"] == cfg.n_encoder_layers
    assert sum(len(layer.params) > 1 for layer in plan
               if layer.kind != "encoder") == cfg.n_layers
    cache, _ = model.make_cache(2, 8)
    for tree, paths in ((model.init(), [layer.params for layer in plan]),
                        (cache, [layer.cache for layer in plan
                                 if layer.cache is not None])):
        stacks = collections.defaultdict(set)
        for path in paths:
            keys = tuple(k for k in path if isinstance(k, str))
            stacks[keys].add(path[len(keys):])
        for keys, rows in stacks.items():
            node = functools.reduce(operator.getitem, keys, tree)
            depth = len(next(iter(rows)))
            lead = ({(len(node),)} if isinstance(node, list) else
                    {tuple(t.shape[:depth]) for t in tree_leaves(node)})
            assert len(lead) == 1, (keys, lead)
            assert rows == set(itertools.product(*map(range, lead.pop()))), \
                keys
        assert set(tree) - {path[0] for path in paths} <= {
            "embed", "final_norm", "enc_norm", "length"}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m",
                                  "granite-4.0-h-small"])
def test_prefill_frees_the_embedding_after_the_first_layer(arch,
                                                           monkeypatch):
    """No frame holds the prompt's embedding past the block that takes it
    in: every decoder block of a prefill finds it freed unless it is that
    block's own input (a prompt's embedding is up to 28 MiB on the card)."""
    model = Model(reduced_config(arch), device="cpu")
    params = model.init(seed=0)
    embedded, seen = [], []
    embed, block = model._embed_tokens, tf.prefill_decoder_block

    def keep(*a):
        x = embed(*a)
        embedded.append(weakref.ref(x))
        return x

    def look(lp, x, *a, **k):
        seen.append(embedded[0]() is None or embedded[0]() is x)
        return block(lp, x, *a, **k)

    monkeypatch.setattr(model, "_embed_tokens", keep)
    monkeypatch.setattr(tf, "prefill_decoder_block", look)
    tokens = torch.from_numpy(_tokens(model.cfg, 1, 16))
    model.prefill(params, {"tokens": tokens}, max_len=20)
    assert seen and all(seen), seen
