"""The port's own tracing: the ``rt.*`` spans of the model and the serving
engine, the MoE dispatch counters and the engine's split of a decode
step's wall time. Spans on or off, a step computes the same bits and
dispatches the same ops."""
import collections

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tracing
from repro_torch.models import moe
from repro_torch.models.model import Model
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.serving import RequestQueue, ServeEngine

from _torch_serve_cases import MAX_LEN, case_config, case_inputs

FAMILIES = ["granite-moe-3b-a800m", "olmo-1b", "zamba2-1.2b", "xlstm-350m",
            "whisper-tiny", "llama-3.2-vision-90b"]


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    moe.reset_moe_stats()
    yield
    tracing.disable()
    moe.reset_moe_stats()


def _setup(name):
    cfg = case_config(name)
    model = Model(cfg, device="cpu")
    params, batch = case_inputs(cfg)
    return model, params, batch


def _spans(prof):
    """(name, start ns, end ns) of the profile's ``rt.*`` ranges."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.is_user_annotation() and e.name().startswith("rt.")]


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.enable()
        try:
            out = fn()
        finally:
            tracing.disable()
    return out, _spans(prof)


def _block_spans(model):
    """The block spans one decode step of ``model`` opens, by name: a
    decoder block's attention and its MLP or experts, every other block
    of the model's layer plan its own span."""
    ffn = "rt.moe" if model.cfg.moe is not None else "rt.mlp"
    spans = {"attn": ("rt.attn", ffn), "mamba": ("rt.mamba",),
             "mlstm": ("rt.mlstm",), "slstm": ("rt.slstm",),
             "cross": ("rt.cross",), "gated_cross": ("rt.cross",),
             "encoder": ()}
    return dict(collections.Counter(name for layer in model.layer_plan()
                                    for name in spans[layer.kind]))


@pytest.mark.parametrize("name", FAMILIES)
def test_decode_step_opens_one_span_per_block_inside_rt_decode(name):
    model, params, batch = _setup(name)
    _, cache = model.prefill(params, batch, max_len=MAX_LEN)
    tokens = batch["tokens"][:, :1]
    _, spans = _traced(lambda: model.decode_step(params, cache, tokens))
    counts = collections.Counter(n for n, _, _ in spans)
    assert dict(counts) == {"rt.decode": 1, "rt.logits": 1,
                            **_block_spans(model)}
    (_, d0, d1), = [s for s in spans if s[0] == "rt.decode"]
    inner = [s for s in spans if s[0] != "rt.decode"]
    assert all(d0 <= a and b <= d1 for _, a, b in inner)
    # the blocks run in turn, each closed before the next opens, and the
    # logits come last
    inner.sort(key=lambda s: s[1])
    assert all(p[2] <= q[1] for p, q in zip(inner, inner[1:])), inner
    assert inner[-1][0] == "rt.logits"


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_spans_nest_in_rt_prefill(name):
    model, params, batch = _setup(name)
    _, spans = _traced(lambda: model.prefill(params, batch,
                                             max_len=MAX_LEN))
    (_, p0, p1), = [s for s in spans if s[0] == "rt.prefill"]
    counts = collections.Counter(n for n, _, _ in spans)
    assert counts["rt.logits"] == 1
    want = _block_spans(model)
    if model.cfg.family == "audio":       # the encoder's blocks too
        n = model.cfg.n_encoder_layers
        want.update({"rt.attn": n, "rt.mlp": n})
    assert {k: counts[k] for k in want} == want
    assert all(p0 <= a and b <= p1 for n, a, b in spans
               if n != "rt.prefill")


def test_spans_off_record_nothing_and_share_one_null_context():
    model, params, batch = _setup("granite-moe-3b-a800m")
    a, b = tracing.span("rt.x"), tracing.span("rt.y", "3")
    assert a is b and not tracing.enabled()
    with a as got:
        assert got is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, cache = model.prefill(params, batch, max_len=MAX_LEN)
        model.decode_step(params, cache, batch["tokens"][:, :1])
    assert _spans(prof) == []
    assert moe.read_moe_stats() == {}
    tracing.enable()
    assert tracing.enabled() and tracing.span("rt.x") is not a
    tracing.disable()


def _prefill_and_decode(model, params, batch, steps=3):
    logits, cache = model.prefill(params, batch, max_len=MAX_LEN)
    outs = [logits]
    tokens = batch["tokens"][:, :1]
    for _ in range(steps):
        logits, cache = model.decode_step(params, cache, tokens)
        outs.append(logits)
        tokens = logits.argmax(-1)
    return outs, cache


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "zamba2-1.2b"])
def test_outputs_bit_identical_with_tracing_on_and_off(name):
    model, params, batch = _setup(name)
    off, cache_off = _prefill_and_decode(model, params, batch)
    (on, cache_on), spans = _traced(
        lambda: _prefill_and_decode(model, params, batch))
    assert spans
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(cache_off), tree_leaves(cache_on)):
        assert torch.equal(a, b)


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if not name.startswith("profiler."):
            self.ops.append(name)
        return func(*args, **(kwargs or {}))


def test_decode_step_dispatches_the_same_ops_on_and_off():
    """The spans and the MoE counters add no op to a step: the counters
    keep the step's own row maps and sum them only when read."""
    model, params, batch = _setup("granite-moe-3b-a800m")
    _, cache = model.prefill(params, batch, max_len=MAX_LEN)
    tokens = batch["tokens"][:, :1]
    logs = []
    for on in (False, True):
        c = tree_map(lambda t: t.clone(), cache)
        (tracing.enable if on else tracing.disable)()
        with _OpLog() as log:
            model.decode_step(params, c, tokens)
        tracing.disable()
        logs.append(log.ops)
    assert len(logs[0]) > 100 and logs[0] == logs[1]
    stats = moe.read_moe_stats()
    assert set(stats) == {"decode"}
    assert stats["decode"]["routed_pairs"] == (
        model.cfg.n_layers * tokens.numel() * model.cfg.moe.top_k)


def _routed_moe(dispatch):
    """A 4-expert top-1 layer whose router sends token t to expert
    ``route[t]``: 20 tokens to expert 0, past its capacity of 10; 2 to
    expert 1, which fills its other rows with tokens it was not routed;
    5 each to experts 2 and 3."""
    cfg = moe.MoEConfig(n_experts=4, top_k=1, expert_ff=8, dispatch=dispatch)
    gen = torch.Generator().manual_seed(0)
    params = moe.make_moe_params(gen, 4, cfg, torch.float32, "cpu")
    params["router"] = torch.eye(4)
    route = np.array([0] * 20 + [1] * 2 + [2] * 5 + [3] * 5)
    route = route[np.random.default_rng(0).permutation(len(route))]
    x = 8.0 * torch.eye(4)[torch.as_tensor(route)]          # (32, 4)
    return params, cfg, x, route


@pytest.mark.parametrize("dispatch", ["global", "grouped"])
def test_moe_counters_equal_an_independent_count(dispatch):
    params, cfg, x, route = _routed_moe(dispatch)
    n = len(route)
    cap = moe._capacity(n, cfg, 8 if dispatch == "global" else 4)
    assert cap == 10
    by_hand = sum(min(int(np.sum(route == e)), cap) for e in range(4))
    assert by_hand == 22
    tracing.enable()
    moe.apply_moe(params, x[None], cfg)                     # (1, 32, d)
    if dispatch == "global":                                # 32 rows of one
        moe.apply_moe(params, x[:, None], cfg)              # (32, 1, d)
    tracing.disable()
    # the same count through the dispatch's own row map
    _, _, top_idx, tok_ec = (moe._dispatch_global(params, x, cfg)
                             if dispatch == "global" else
                             moe._dispatch_grouped(params, x[None], cfg))
    rows = moe._token_rows(tok_ec.reshape(-1, cap), top_idx, n)
    assert int((rows >= 0).sum()) == by_hand
    want = {"capacity_rows": 4 * cap, "routed_pairs": n,
            "taken_pairs": by_hand}
    stats = moe.read_moe_stats()
    assert stats["prefill"] == want
    if dispatch == "global":
        assert stats["decode"] == want
    assert all(type(v) is int for st in stats.values() for v in st.values())
    # read again: the kept maps were folded in once
    assert moe.read_moe_stats() == stats
    moe.reset_moe_stats()
    assert moe.read_moe_stats() == {}


def test_moe_counts_nothing_with_tracing_off():
    params, cfg, x, _ = _routed_moe("global")
    moe.apply_moe(params, x[None], cfg)
    assert moe.read_moe_stats() == {}


def _engine(n_slots):
    model, params, _ = _setup("granite-moe-3b-a800m")
    return ServeEngine(model, params, n_slots=n_slots, max_len=MAX_LEN)


def test_engine_splits_decode_time_and_sums_queue_waits():
    eng = _engine(n_slots=1)
    q = RequestQueue()
    rng = np.random.default_rng(0)
    reqs = [q.submit(rng.integers(0, eng.model.cfg.vocab, size=8),
                     max_new_tokens=3) for _ in range(3)]
    assert all(r.submitted_at is not None for r in reqs)
    # one call at a time, to see each admission's wait and prefill
    waits, prefills = [], []
    while len(q) or any(eng.slots):
        w, p, n = eng.queue_wait_s, eng.prefill_s, eng.n_prefills
        eng.run(q, max_steps=1)
        if eng.n_prefills > n:
            waits.append(eng.queue_wait_s - w)
            prefills.append(eng.prefill_s - p)
    assert len(waits) == 3 and eng.decode_steps == 6
    # a request waits behind every admission before it (one slot)
    for i in range(1, 3):
        assert waits[i] >= sum(prefills[:i]) > 0
    enq, rb = eng.decode_enqueue_s, eng.decode_readback_s
    assert enq > 0 and rb > 0
    assert enq + rb <= eng.decode_s
    assert eng.decode_s - enq - rb >= 0


def test_engine_spans_cover_admission_readback_and_sampling():
    eng = _engine(n_slots=2)
    q = RequestQueue()
    rng = np.random.default_rng(1)
    for _ in range(2):
        q.submit(rng.integers(0, eng.model.cfg.vocab, size=8),
                 max_new_tokens=3)
    _, spans = _traced(lambda: eng.run(q))
    counts = collections.Counter(n for n, _, _ in spans)
    assert counts["rt.admit"] == counts["rt.prefill"] == 2
    assert counts["rt.decode"] == counts["rt.readback"] == \
        counts["rt.sample"] == eng.decode_steps == 2
    admits = [s for s in spans if s[0] == "rt.admit"]
    for name, a, b in spans:
        if name == "rt.prefill":
            assert any(x <= a and b <= y for _, x, y in admits)


def test_request_equality_ignores_the_submission_stamp():
    q = RequestQueue()
    a = q.submit(np.arange(3), max_new_tokens=2)
    b = type(a)(uid=a.uid, prompt=a.prompt, max_new_tokens=2)
    assert b.submitted_at is None and a == b
