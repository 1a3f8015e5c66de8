"""The one traffic generator: deterministic per seed, the same work in
another order for every seed, prompt lengths the model takes."""
import json

import numpy as np
import pytest

from conftest import BENCH
from perfbench import generator

MIXES = {p.stem: json.loads(p.read_text())
         for p in (BENCH / "traffic").glob("*.json")}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_same_seed_same_requests(mix):
    a = generator.make_requests(MIXES[mix], 50, 2**31 + 7, vocab=1000,
                                rate=3.0)
    b = generator.make_requests(MIXES[mix], 50, 2**31 + 7, vocab=1000,
                                rate=3.0)
    for x, y in zip(a, b):
        assert np.array_equal(x.prompt, y.prompt)
        assert (x.max_new_tokens, x.arrival) == (y.max_new_tokens, y.arrival)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_seeds_permute_one_set_of_work(mix):
    runs = [generator.make_requests(MIXES[mix], 64, seed, vocab=1000,
                                    rate=5.0) for seed in (1, 2)]
    lens = [sorted(len(r.prompt) for r in run) for run in runs]
    outs = [sorted(r.max_new_tokens for r in run) for run in runs]
    assert lens[0] == lens[1] and outs[0] == outs[1]
    assert [len(r.prompt) for r in runs[0]] != [len(r.prompt)
                                                for r in runs[1]]
    spec = MIXES[mix]
    assert min(lens[0]) >= spec["prompt"]["min"]
    assert max(lens[0]) <= spec["prompt"]["max"]
    assert min(outs[0]) >= spec["output"]["min"]
    assert max(outs[0]) <= spec["output"]["max"]


def test_prompt_multiple_honoured():
    mix = MIXES["docqa-poisson"]
    reqs = generator.make_requests(mix, 200, 3, vocab=32000, rate=4.0,
                                   prompt_multiple=128)
    assert all(len(r.prompt) % 128 == 0 or len(r.prompt) <= 128
               for r in reqs)
    assert max(len(r.prompt) for r in reqs) <= mix["prompt"]["max"] + 64
    assert generator.round_prompt(100, 128) == 100
    assert generator.round_prompt(130, 128) == 128
    assert generator.round_prompt(200, 128) == 256
    assert generator.round_prompt(513, 1) == 513


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_context_fits_the_model(mix):
    """Prompt and output stay within the configurations' context."""
    spec = MIXES[mix]
    longest = spec["prompt"]["max"] + spec["output"]["max"]
    for conf in (BENCH / "configs").glob("*.json"):
        assert longest <= json.loads(conf.read_text())["context_length"]


def test_poisson_schedule():
    mix = MIXES["docqa-poisson"]
    rate, n = 4.0, generator.open_loop_count(4.0, 40.0)
    assert n == 160
    reqs = generator.make_requests(mix, n, 11, vocab=100, rate=rate)
    t = np.array([r.arrival for r in reqs])
    assert np.all(np.diff(t) > 0)
    gaps = np.diff(np.concatenate([[0.0], t]))
    # the gaps are the n quantiles of an exponential of mean 1 / rate
    want = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    assert np.allclose(np.sort(gaps), np.sort(want))
    assert abs(t[-1] - n / rate) < 0.05 * n / rate


def test_bursty_schedule():
    """Gamma gaps: the same mean as the Poisson mix's, a wider spread."""
    mix = dict(MIXES["docqa-poisson"], arrivals={"dist": "gamma", "cv": 3.0})
    rate, n = 4.0, 400
    gaps = np.diff([0.0] + [r.arrival for r in generator.make_requests(
        mix, n, 11, vocab=100, rate=rate)])
    assert abs(gaps.mean() - 1 / rate) < 0.02 / rate
    assert 2.5 < gaps.std() / gaps.mean() < 3.1
    one = dict(mix, arrivals={"dist": "gamma", "cv": 1.0})
    g1 = np.sort(generator._gaps(one["arrivals"], n, rate))
    assert np.allclose(g1, np.sort(generator._gaps({"dist": "exponential"},
                                                   n, rate)))


def test_blocks_hold_the_same_work():
    """A closed loop's pool: every block of n_slots requests holds the
    same lengths, in another order on every seed."""
    mix, block = MIXES["chat-closed"], 8
    runs = [generator.make_requests(mix, 4 * block, seed, vocab=100,
                                    block=block) for seed in (1, 2)]
    blocks = [[sorted(len(r.prompt) for r in run[i:i + block])
               for i in range(0, 4 * block, block)] for run in runs]
    assert all(b == blocks[0][0] for bs in blocks for b in bs)
    assert [len(r.prompt) for r in runs[0]] != [len(r.prompt)
                                                for r in runs[1]]


def test_closed_loop_schedule():
    reqs = generator.make_requests(MIXES["chat-closed"], 32, 5, vocab=100)
    assert all(r.arrival == 0.0 for r in reqs)
    with pytest.raises(ValueError):
        generator.make_requests(MIXES["docqa-poisson"], 4, 5, vocab=100)
