"""The plain reference against the program's plain CPU path, at reduced
fp32 sizes: the MoE decoder's batch replay against prefill, slot copy
and batched decode steps (an idle slot included, capacity cuts in the
prefill), with the embeddings tied as the benchmark runs them and
untied."""
import dataclasses

import pytest
import torch

from perfbench.reference import decoder
from perfbench.reference.common import Precision, exact_fp32
from perfbench.weights import make_weights
from repro_torch.configs import reduced_config
from repro_torch.models.model import Model

F32 = Precision("fp32")


def model_dict(cfg) -> dict:
    """The ``model`` group of a configuration file, for a program config."""
    m = {k: getattr(cfg, k) for k in (
        "family", "n_layers", "d_model", "n_heads", "kv_heads", "d_ff",
        "vocab", "rope_theta", "shared_attn_every", "shared_attn_d_ff")}
    m.update(head_dim=cfg.hd, norm_eps=1e-6)
    m["ssm"] = dataclasses.asdict(cfg.ssm) if cfg.ssm else None
    m["moe"] = (dict(dataclasses.asdict(cfg.moe), capacity_floor=8)
                if cfg.moe else None)
    return m


def built(name, seed=3, **over):
    cfg = reduced_config(name, **over)
    model = Model(cfg, device="cpu")
    params = make_weights(Model(cfg, device="meta").init(), seed, "cpu")
    return cfg, model, params


def _insert(cache, one, slot):
    for name in ("k", "v"):
        cache["layers"][name][:, slot] = one["layers"][name][:, 0]
    cache["length"][slot] = one["length"][0]


@pytest.mark.parametrize("tie", [True, False])
def test_moe_replay_follows_the_served_batch(tie):
    cfg, model, params = built("granite-moe-3b-a800m", tie_embeddings=tie)
    assert ("out" in params["embed"]) != tie
    m = model_dict(cfg)
    assert m["moe"]["dispatch"] == "global"
    n_slots, max_len = 3, 64
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen)
               for n in (40, 23)]
    with torch.inference_mode():
        cache, _ = model.make_cache(n_slots, max_len)
        ref = decoder.Replay(params, m, n_slots, max_len, F32, "cpu")
        got, want = [], []
        with exact_fp32():
            for slot, p in enumerate(prompts):
                lg, one = model.prefill(params, {"tokens": p[None]},
                                        max_len=max_len)
                _insert(cache, one, slot)
                got.append(lg[0, -1, :cfg.vocab])
                want.append(ref.prefill(slot, p))
            feed = torch.tensor([5, 7, 0])          # slot 2 stays idle
            for _ in range(4):
                lg, cache = model.decode_step(params, cache, feed[:, None])
                got.append(lg[:, 0, :cfg.vocab])
                want.append(ref.decode(feed))
                feed = lg[:, 0, :cfg.vocab].argmax(-1)
                feed[2] = 0
    for g, w in zip(got, want):
        assert torch.allclose(g, w, atol=2e-4, rtol=1e-4), (g - w).abs().max()


def test_moe_capacity_cuts_tokens():
    """A prompt whose experts overflow: the reference drops exactly the
    tokens past each expert's capacity."""
    cfg, _, params = built("granite-moe-3b-a800m")
    m = model_dict(cfg)
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = torch.randn(40, cfg.d_model, generator=torch.Generator().manual_seed(4))
    with exact_fp32():
        out = decoder.moe(lp, x, m, F32)
        big = dict(m, moe=dict(m["moe"], capacity_factor=100.0))
        full = decoder.moe(lp, x, big, F32)
    per_token = (out - full).abs().amax(-1)
    assert 0 < int((per_token > 1e-6).sum()) < 40


@pytest.mark.parametrize("kind", ["fp32", "fp8"])
def test_precision_kinds(kind):
    x = torch.randn(4, 16)
    w = torch.randn(16, 8)
    y = Precision(kind).mm(x, w)
    err = (y - x @ w).abs().max() / (x @ w).abs().max()
    assert (err < 1e-6) if kind == "fp32" else (1e-3 < err < 0.2)
