"""The port's serving engine: the reference engine's tests, and the same
greedy tokens as the reference engine on bridged weights."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax

from repro.configs import registry as ref_registry
from repro.models.model import Model as RefModel
from repro.serving import RequestQueue as RefQueue
from repro.serving import ServeEngine as RefEngine
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.models.model import Model
from repro_torch.serving import RequestQueue, ServeEngine
from repro_torch.serving.scheduler import PoissonArrivals, TraceArrivals


def _model(arch):
    model = Model(reduced_config(arch), device="cpu")
    return model, model.init(0)


def test_engine_continuous_batching_refills_slots():
    model, params = _model("olmo-1b")
    eng = ServeEngine(model, params, n_slots=2, max_len=48)
    q = RequestQueue()
    rng = np.random.default_rng(0)
    reqs = [q.submit(rng.integers(0, model.cfg.vocab, size=6),
                     max_new_tokens=5) for _ in range(5)]
    results = eng.run(q)
    assert len(results) == 5
    assert all(len(r.tokens) == 5 for r in results)
    assert sorted(r.uid for r in results) == [r.uid for r in reqs]
    assert eng.n_prefills == 5 and eng.decode_steps > 0


def test_engine_honors_timed_arrivals():
    model, params = _model("olmo-1b")
    eng = ServeEngine(model, params, n_slots=2, max_len=48)
    q = RequestQueue()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, model.cfg.vocab, size=6) for _ in range(3)]
    # arrivals at t=0 and far beyond the first request's decode window
    reqs = q.submit_process([0.0, 50.0, 50.0], prompts, max_new_tokens=4)
    results = eng.run(q, step_duration_s=1.0)
    assert sorted(r.uid for r in results) == sorted(r.uid for r in reqs)
    assert all(len(r.tokens) == 4 for r in results)
    # ignoring the clock admits everything immediately and still drains
    q2 = RequestQueue()
    q2.submit_process(TraceArrivals([0.0, 50.0]), prompts[:2],
                      max_new_tokens=4)
    eng2 = ServeEngine(model, params, n_slots=2, max_len=48)
    assert len(eng2.run(q2)) == 2


def test_queue_orders_out_of_order_arrivals():
    q = RequestQueue()
    late = q.submit(np.asarray([1, 2], np.int32), arrival=100.0)
    early = q.submit(np.asarray([3, 4], np.int32), arrival=0.0)
    assert q.next_arrival() == 0.0
    assert q.pop(now=0.0).uid == early.uid
    assert q.pop(now=0.0) is None          # late one hasn't arrived
    assert q.pop(now=100.0).uid == late.uid
    # equal arrivals keep FIFO order
    q2 = RequestQueue()
    a = q2.submit(np.asarray([1], np.int32), arrival=5.0)
    b = q2.submit(np.asarray([2], np.int32), arrival=5.0)
    assert q2.pop(now=5.0).uid == a.uid
    assert q2.pop(now=5.0).uid == b.uid
    # a Poisson process stamps sorted, seeded arrivals
    q3 = RequestQueue()
    stamped = q3.submit_process(PoissonArrivals(2.0, 3, seed=1),
                                [[1], [2], [3]])
    times = [r.arrival for r in stamped]
    assert times == sorted(times) and times == [
        r.arrival for r in RequestQueue().submit_process(
            PoissonArrivals(2.0, 3, seed=1), [[1], [2], [3]])]


def test_engine_rejects_nonpositive_step_duration():
    model, params = _model("olmo-1b")
    eng = ServeEngine(model, params, n_slots=1, max_len=16)
    q = RequestQueue()
    q.submit(np.asarray([1, 2], np.int32), arrival=1.0)
    with pytest.raises(ValueError, match="step_duration_s"):
        eng.run(q, step_duration_s=0.0)


def test_engine_greedy_matches_manual_decode():
    """Engine slot path reproduces a manual prefill+argmax loop."""
    model, params = _model("qwen3-0.6b")
    prompt = np.asarray([5, 9, 2, 7], np.int32)
    logits, cache = model.prefill(
        params, {"tokens": torch.from_numpy(prompt).long()[None]}, max_len=32)
    manual = [int(logits[0, -1].argmax())]
    for _ in range(4):
        logits, cache = model.decode_step(
            params, cache, torch.tensor([[manual[-1]]]))
        manual.append(int(logits[0, 0].argmax()))
    eng = ServeEngine(model, params, n_slots=1, max_len=32)
    q = RequestQueue()
    q.submit(prompt, max_new_tokens=5)
    (res,) = eng.run(q)
    assert res.tokens == manual


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "olmo-1b"])
def test_engine_greedy_tokens_match_reference_engine(arch):
    ref_model = RefModel(ref_registry.reduced_config(arch))
    ref_params = ref_model.init(jax.random.key(0))
    model = Model(reduced_config(arch), device="cpu")
    params = bridge.from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, model.cfg.vocab, size=n) for n in (5, 9, 3)]
    ref_q, port_q = RefQueue(), RequestQueue()
    for prompt in prompts:
        ref_q.submit(prompt, max_new_tokens=6)
        port_q.submit(prompt, max_new_tokens=6)
    want = RefEngine(ref_model, ref_params, n_slots=2, max_len=32).run(ref_q)
    got = ServeEngine(model, params, n_slots=2, max_len=32).run(port_q)
    assert {r.uid: r.tokens for r in got} == {r.uid: r.tokens for r in want}


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-3b-a800m",
                                  "zamba2-1.2b", "xlstm-350m"])
def test_engine_decodes_in_place(arch):
    """Across decode steps and admissions the engine keeps one cache dict
    whose leaves (``length`` included) and whose ``last_tokens`` keep
    their storage, and ``length`` counts each occupied slot's tokens: the
    step reads and writes the same tensors every time, as a CUDA graph of
    it must. On the CPU the step runs eagerly: nothing is captured or
    replayed."""
    from repro_torch.models.transformer import tree_leaves
    model, params = _model(arch)
    eng = ServeEngine(model, params, n_slots=2, max_len=48)
    cache = eng.cache
    ptrs = [t.data_ptr() for t in tree_leaves(cache)]
    tokens_ptr = eng.last_tokens.data_ptr()
    q = RequestQueue()
    rng = np.random.default_rng(4)
    reqs = [q.submit(rng.integers(0, model.cfg.vocab, size=n),
                     max_new_tokens=new)
            for n, new in ((6, 4), (9, 7), (3, 3), (12, 5))]
    admitted = set()
    while q or any(s is not None for s in eng.slots):
        eng.run(q, max_steps=1)
        assert eng.cache is cache
        assert [t.data_ptr() for t in tree_leaves(eng.cache)] == ptrs
        assert eng.last_tokens.data_ptr() == tokens_ptr
        for slot, req in enumerate(eng.slots):
            if req is None:
                continue
            admitted.add(req.uid)
            assert int(cache["length"][slot]) == \
                len(req.prompt) + len(req.generated) - 1
            assert int(eng.last_tokens[slot, 0]) == req.generated[-1]
    assert admitted == {r.uid for r in reqs}
    assert all(len(r.generated) == r.max_new_tokens for r in reqs)
    assert eng.decode_steps > 0
    assert eng.decode_graph_captures == eng.decode_graph_replays == 0
