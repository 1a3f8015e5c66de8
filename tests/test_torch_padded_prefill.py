"""The padded admission on the CPU: ``Model.prefill_into`` (a prompt
padded to its bucket, written straight into a slot of the batch cache)
against the eager ``Model.prefill``, and ``ServeEngine`` serving through
it against today's admission. On a CUDA device the engine also captures
each bucket's prefill into a graph (``chip_smoke.py`` checks that); here
the padded path runs eagerly, engaged by adding the CPU to the engine's
padding devices."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing
from repro_torch.configs import reduced_config
from repro_torch.models.model import Model
from repro_torch.models.moe import RealTokens
from repro_torch.serving import RequestQueue, ServeEngine

#: the padded prefill's last logits and K/V rows against the eager
#: prefill's, fp32 on the CPU: the same arithmetic at other matmul shapes
#: (the padded width for the prompt's length), so only the order of a
#: product's sums may differ; the largest gap seen was 2.2e-6. Equal bit
#: for bit where the prompt fills its width.
PADDED_PREFILL_TOL = dict(atol=2e-5, rtol=1e-5)
ARCHS = ("qwen3-0.6b", "qwen2-moe-a2.7b", "granite-moe-3b-a800m")


@pytest.fixture
def pad_on_cpu(monkeypatch):
    monkeypatch.setattr(ServeEngine, "_PAD_DEVICES", ("cuda", "cpu"))


def _model(arch, **overrides):
    model = Model(reduced_config(arch, **overrides), device="cpu")
    return model, model.init(0)


def _prompt(model, n, seed):
    return np.random.default_rng(seed).integers(0, model.cfg.vocab, size=n)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s,width", [(5, 16), (63, 64), (64, 64),
                                     (100, 128)])
def test_prefill_into_matches_the_eager_prefill(arch, s, width):
    """A prompt of ``s`` tokens padded to ``width`` and prefilled into slot
    1 of a 3-slot cache whose rows hold other requests' state: its last
    logits and its K/V rows [0, s) match the eager prefill's within
    PADDED_PREFILL_TOL (bit for bit where s == width), its length is s,
    rows [s, width) hold the pads, and every other row of the cache is
    untouched bit for bit."""
    model, params = _model(arch)
    max_len = 160
    tokens = torch.as_tensor(_prompt(model, s, s))[None]
    want, eager = model.prefill(params, {"tokens": tokens}, max_len=max_len)
    cache, _ = model.make_cache(3, max_len)
    gen = torch.Generator().manual_seed(1)
    for name in ("k", "v"):
        cache["layers"][name].copy_(torch.randn(
            cache["layers"][name].shape, generator=gen))
    cache["length"].copy_(torch.tensor([7, 3, 9], dtype=torch.int32))
    before = {k: v.clone() for k, v in cache["layers"].items()}
    padded = torch.zeros((1, width), dtype=torch.long)
    padded[0, :s] = tokens[0]
    n, cap = model.real_counts(s)
    got = model.prefill_into(params, padded,
                             RealTokens(torch.tensor([n]),
                                        torch.tensor([cap])),
                             torch.tensor([1]), cache)
    assert got.shape == (1, 1, model.cfg.padded_vocab)
    assert cache["length"].tolist() == [7, s, 9]
    for name in ("k", "v"):
        rows = cache["layers"][name]
        np.testing.assert_allclose(rows[:, 1, :s].numpy(),
                                   eager["layers"][name][:, 0, :s].numpy(),
                                   **PADDED_PREFILL_TOL)
        if s == width:
            assert torch.equal(rows[:, 1, :s], eager["layers"][name][:, 0, :s])
        else:
            assert not torch.equal(rows[:, 1, s:width],
                                   before[name][:, 1, s:width])
        assert torch.equal(rows[:, 1, width:], before[name][:, 1, width:])
        for other in (0, 2):
            assert torch.equal(rows[:, other], before[name][:, other])
    np.testing.assert_allclose(got[0, 0].numpy(), want[0, -1].numpy(),
                               **PADDED_PREFILL_TOL)
    if s == width:
        assert torch.equal(got[0, 0], want[0, -1])


def _serve(engine, model, lengths, new_tokens=4):
    queue = RequestQueue()
    for i, n in enumerate(lengths):
        queue.submit(_prompt(model, n, 100 + i), max_new_tokens=new_tokens)
    return {r.uid: r.tokens for r in engine.run(queue)}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_todays_tokens_across_bucket_edges(pad_on_cpu, arch):
    """Prompts on both sides of the buckets' edges (63, 256, 257, 511 and
    1,025 tokens, whose bucket is max_len itself) served through the
    padded admission get the greedy tokens of today's admission, and the
    counters give each prompt's real tokens and the padding it took."""
    model, params = _model(arch)
    lengths = (63, 256, 257, 511, 1025)
    engine = ServeEngine(model, params, n_slots=2, max_len=1280)
    today = ServeEngine(model, params, n_slots=2, max_len=1280)
    today._pads = False
    assert engine._pads
    got = _serve(engine, model, lengths)
    assert got == _serve(today, model, lengths)
    widths = (256, 256, 512, 512, 1280)
    assert engine.prefill_real_tokens == sum(lengths)
    assert engine.prefill_pad_tokens == sum(widths) - sum(lengths)
    assert (engine.prefill_graph_captures, engine.prefill_graph_replays) \
        == (0, 0), "the CPU captures nothing"
    assert today.prefill_real_tokens == today.prefill_pad_tokens == 0


@pytest.mark.parametrize("arch,overrides", [
    ("zamba2-1.2b", {}), ("granite-4.0-h-small", {}), ("xlstm-350m", {}),
    ("qwen3-0.6b", {"kv_cache_quant": True})])
def test_undeclared_models_keep_todays_admission(pad_on_cpu, arch,
                                                 overrides):
    """The families that declare no padded prefill, and the int8 cache,
    admit through today's ``Model.prefill`` even where the device pads:
    the padded admission's counters stay 0."""
    model, params = _model(arch, **overrides)
    assert not model.pads_prefill
    engine = ServeEngine(model, params, n_slots=2, max_len=64)
    assert not engine._pads
    tokens = _serve(engine, model, (16, 32, 20), new_tokens=2)
    assert len(tokens) == 3
    assert (engine.prefill_real_tokens, engine.prefill_pad_tokens,
            engine.prefill_graph_captures,
            engine.prefill_graph_replays) == (0, 0, 0, 0)


@pytest.mark.parametrize("arch", ["whisper-tiny", "llama-3.2-vision-90b"])
def test_frontend_families_declare_no_padded_prefill(arch):
    model = Model(reduced_config(arch), device="meta")
    assert not model.pads_prefill
    with pytest.raises(ValueError, match="no padded prefill"):
        model.prefill_into({}, None, None, None, {})


def test_tracing_and_the_cpu_take_todays_admission(pad_on_cpu, monkeypatch):
    """While tracing is on the engine admits through today's prefill, so
    the model's spans record it; on a device outside the padding devices
    it never pads."""
    model, params = _model("granite-moe-3b-a800m")
    engine = ServeEngine(model, params, n_slots=2, max_len=64)
    tracing.enable()
    try:
        _serve(engine, model, (16, 40), new_tokens=2)
    finally:
        tracing.disable()
    assert engine.prefill_real_tokens == engine.prefill_pad_tokens == 0
    _serve(engine, model, (16,), new_tokens=2)
    assert (engine.prefill_real_tokens, engine.prefill_pad_tokens) == \
        (16, 48)
    monkeypatch.setattr(ServeEngine, "_PAD_DEVICES", ("cuda",))
    assert not ServeEngine(model, params, n_slots=2, max_len=64)._pads

