"""The port's int8 KV cache against the JAX package's: quantisation bit
for bit, prefill caches, decode from either package's cache, the
reference's accuracy bound, and the serving engine on an int8 cache."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax
import jax.numpy as jnp

from repro.configs import registry as ref_registry
from repro.models import transformer as ref_tf
from repro.models.model import Model as RefModel
from repro.serving import RequestQueue as RefQueue
from repro.serving import ServeEngine as RefEngine
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.models import transformer as tf
from repro_torch.models.model import Model
from repro_torch.serving import RequestQueue, ServeEngine

#: prefill / decode (tests/test_serving.py)
DEC_TOL = dict(atol=2e-3, rtol=2e-2)
ARCHS = ("qwen3-0.6b", "granite-moe-3b-a800m")


def _kv(dtype):
    """(2, 5, 3, 16) keys: random rows, an all-zero row, and rows whose
    values sit on .5 steps of their scale (absmax 127 -> scale 1)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3
    x[0, 1, 2] = 0.0
    half = np.arange(16, dtype=np.float32) - 7.5           # -7.5 .. 7.5
    x[1, 0, 0] = np.concatenate([[127.0], half[1:]])
    x[1, 0, 1] = np.concatenate([[-127.0], -half[1:] * 2 + 0.5])
    if dtype == "bfloat16":        # values bf16 holds exactly, on both sides
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_and_dequantize_match_reference_exactly(dtype):
    x = _kv(dtype)
    want_q, want_s = ref_tf._quantize_kv(jnp.asarray(x, dtype))
    got_q, got_s = tf._quantize_kv(torch.from_numpy(x).to(getattr(torch,
                                                                  dtype)))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float16
    assert torch.equal(got_q, torch.from_numpy(np.array(want_q)))
    assert torch.equal(got_s, torch.from_numpy(np.array(want_s)))
    # round half to even on the .5 steps; the all-zero row's 1e-8 scale
    # is 0 in fp16 and dequantizes to zeros
    assert got_q[1, 0, 0, 1:].tolist() == [-6, -6, -4, -4, -2, -2, 0, 0, 2,
                                           2, 4, 4, 6, 6, 8]
    assert float(got_s[0, 1, 2]) == 0.0
    want = ref_tf._dequantize_kv(want_q, want_s, jnp.dtype(dtype))
    got = tf._dequantize_kv(got_q, got_s, getattr(torch, dtype))
    assert not bool(got[0, 1, 2].any())
    np.testing.assert_array_equal(bridge.to_numpy(got),
                                  np.asarray(want, np.float32))


def test_int8_cache_layout_and_axes():
    """make_cache hands out int8 payloads, fp16 scales and the axes that
    name their batch axis (the engine copies slots by them)."""
    model = Model(reduced_config("granite-moe-3b-a800m",
                                 kv_cache_quant=True), device="cpu")
    cache, axes = model.make_cache(3, 8)
    layers = cache["layers"]
    n, hkv, hd = model.cfg.n_layers, model.cfg.kv_heads, model.cfg.hd
    assert layers["k"].dtype == layers["v"].dtype == torch.int8
    assert layers["k"].shape == (n, 3, 8, hkv, hd)
    assert layers["k_scale"].dtype == torch.float16
    assert layers["k_scale"].shape == (n, 3, 8, hkv)
    assert axes["layers"]["k_scale"] == ("layers", "batch", "cache_seq", None)
    assert sorted(axes["layers"]) == sorted(layers)


def test_int8_decode_stays_within_five_percent_of_forward():
    """tests/test_perf_features.py's bound, on the port: decode logits
    through the int8 cache within 5% of the largest full-forward logit."""
    cfg = reduced_config("qwen1.5-32b")
    full_model = Model(cfg, device="cpu")
    model = Model(reduced_config("qwen1.5-32b", kv_cache_quant=True),
                  device="cpu")
    params = full_model.init(0)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 16)))
    full, _ = full_model.forward(params, {"tokens": tokens})
    lg, cache = model.prefill(params, {"tokens": tokens[:, :12]}, max_len=20)
    assert cache["layers"]["k"].dtype == torch.int8
    errs = [float((lg[:, 0] - full[:, 11]).abs().max())]
    for i in range(12, 16):
        lg, cache = model.decode_step(params, cache, tokens[:, i:i + 1])
        errs.append(float((lg[:, 0] - full[:, i]).abs().max()))
    rel = max(errs) / float(full.abs().max())
    assert rel < 0.05, (errs, rel)


def _pair(arch):
    ref_model = RefModel(ref_registry.reduced_config(arch,
                                                     kv_cache_quant=True))
    ref_params = ref_model.init(jax.random.key(0))
    model = Model(reduced_config(arch, kv_cache_quant=True), device="cpu")
    params = bridge.from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    return model, ref_model, params, ref_params


@pytest.mark.parametrize("arch", ARCHS)
def test_int8_prefill_cache_and_decode_match_reference(arch):
    """Prefill caches at most 1 LSB apart (the int8 payload; the fp16
    scales at the prefill tolerance), logits at the prefill tolerance,
    then decode steps from each package's own cache."""
    model, ref_model, params, ref_params = _pair(arch)
    tokens = np.random.default_rng(1).integers(0, model.cfg.vocab, (2, 14))
    tt, jt = torch.from_numpy(tokens), jnp.asarray(tokens)
    got, cache = model.prefill(params, {"tokens": tt[:, :10]}, max_len=16)
    want, ref_cache = ref_model.prefill(ref_params, {"tokens": jt[:, :10]},
                                        max_len=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DEC_TOL)
    for name in ("k", "v"):
        diff = (cache["layers"][name].int()
                - torch.from_numpy(np.array(ref_cache["layers"][name]))
                .int()).abs()
        assert int(diff.max()) <= 1, name
        np.testing.assert_allclose(
            cache["layers"][f"{name}_scale"].float().numpy(),
            np.asarray(ref_cache["layers"][f"{name}_scale"], np.float32),
            **DEC_TOL)
    for i in range(10, 14):
        got, cache = model.decode_step(params, cache, tt[:, i:i + 1])
        want, ref_cache = ref_model.decode_step(ref_params, ref_cache,
                                                jt[:, i:i + 1])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **DEC_TOL,
                                   err_msg=f"{arch} step {i}")
    assert cache["layers"]["k"].dtype == torch.int8


def test_decode_on_a_bridged_reference_int8_cache():
    """The port continues decoding from the reference's own int8 cache."""
    model, ref_model, params, ref_params = _pair("qwen3-0.6b")
    tokens = jnp.asarray(np.random.default_rng(2).integers(
        0, model.cfg.vocab, (2, 9)))
    _, ref_cache = ref_model.prefill(ref_params, {"tokens": tokens[:, :8]},
                                     max_len=12)
    cache = bridge.cache_from_reference(jax.tree.map(np.asarray, ref_cache),
                                        device="cpu")
    assert cache["layers"]["k"].dtype == torch.int8
    want, want_cache = ref_model.decode_step(ref_params, ref_cache,
                                             tokens[:, 8:])
    got, got_cache = model.decode_step(
        params, cache, torch.from_numpy(np.array(tokens[:, 8:])))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DEC_TOL)
    # the new position: int8 at most 1 LSB apart, as in prefill
    for name in ("k", "v"):
        new = got_cache["layers"][name][:, :, 8].int()
        ref_new = torch.from_numpy(np.array(
            want_cache["layers"][name][:, :, 8])).int()
        assert int((new - ref_new).abs().max()) <= 1


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_on_an_int8_cache_matches_reference_engine(arch):
    """Greedy tokens of the port's engine on an int8 cache equal the
    reference engine's; slots take their scales too."""
    model, ref_model, params, ref_params = _pair(arch)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, model.cfg.vocab, size=n) for n in (5, 9, 3)]
    ref_q, port_q = RefQueue(), RequestQueue()
    for prompt in prompts:
        ref_q.submit(prompt, max_new_tokens=6)
        port_q.submit(prompt, max_new_tokens=6)
    want = RefEngine(ref_model, ref_params, n_slots=2, max_len=32).run(ref_q)
    engine = ServeEngine(model, params, n_slots=2, max_len=32)
    got = engine.run(port_q)
    assert {r.uid: r.tokens for r in got} == {r.uid: r.tokens for r in want}
    layers = engine.cache["layers"]
    assert layers["k"].dtype == torch.int8
    for slot in range(2):
        assert bool((layers["k_scale"][:, slot, :3] > 0).all()), slot
