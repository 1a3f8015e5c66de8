"""DeepSeek-V2's multi-head latent attention (``models/mla.py``), its YaRN
rope and its leading dense layer, on the CPU: the program's fp32 path
against the plain reference of the benchmark
(``perfbench/reference/deepseek_v2.py``) on seeded random weights, at a
tiny size: d 256, 4 heads of 32 nope + 16 rope dims against a 64-wide
latent, values of 32; 8 experts top-2 and 2 shared ones; layer 0 dense;
3 layers.

Tolerances, of the largest logit (``close``): both sides compute in fp32,
so what differs is the order of sums and where the program takes another
route to the same product: its decode folds W_uk into the query and W_uv
after the attention (the reference's ``forward`` expands keys and values
from the latent), and its prefill runs each projection as one matmul.
Seen: 1.2e-6 to 1.8e-6 of the largest logit. ``REL`` = 2e-5 keeps a
margin of ~10 and fails on any piece of the mathematics left out or
misplaced (a rope left interleaved, no YaRN ramp, no mscale in the
scores: each moved them by 0.7 to 1.1 of the largest, at 300 tokens).
"""
import dataclasses

import pytest
import torch

from perfbench.reference import deepseek_v2 as ref
from perfbench.reference.common import Precision, exact_fp32
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import mla
from repro_torch.models.layers import (YarnConfig, apply_rope, deinterleave,
                                       yarn_correction_range)
from repro_torch.models.model import Model
from repro_torch.models.moe import MoEConfig, RealTokens, capacity

NAME = "deepseek-v2-lite"
F32 = Precision("fp32")
REL = 2e-5
#: the published YaRN scaling, and positions past its original 4,096
YARN = get_config(NAME).yarn
PAST = 4096


def tiny(capacity_factor: float = 1.25, **over):
    """The tiny config. capacity_factor 4 (= E / k) lets every expert take
    every token of a call, so that one pass over a sequence and a prefill
    followed by decode steps route alike."""
    kw = dict(d_model=256, n_heads=4, kv_heads=4, head_dim=48, d_ff=128,
              n_layers=3, vocab=512, vocab_pad=64,
              mla=mla.MLAConfig(kv_rank=64, nope_dim=32, rope_dim=16,
                                v_dim=32),
              moe=MoEConfig(n_experts=8, top_k=2, expert_ff=64,
                            shared_ff=128, shared_gated=False,
                            norm_topk=False,
                            capacity_factor=capacity_factor))
    return reduced_config(NAME, **dict(kw, **over))


def model_dict(cfg) -> dict:
    """The ``model`` group of a configuration file, for a program config."""
    return {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "vocab": cfg.vocab,
            "rope_theta": cfg.rope_theta, "norm_eps": cfg.norm_eps or 1e-6,
            "dense_layers": cfg.dense_layers, "dtype": cfg.dtype,
            "mla": dataclasses.asdict(cfg.mla),
            "yarn": dataclasses.asdict(cfg.yarn),
            "moe": dict(dataclasses.asdict(cfg.moe), capacity_floor=8)}


def built(cfg, seed=5):
    from perfbench.weights import make_weights
    params = make_weights(Model(cfg, device="meta").init(), seed, "cpu")
    return Model(cfg, device="cpu"), params


def close(got, want, rel=REL):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=rel * float(want.abs().max()))


def tokens(n, seed=0):
    return torch.randint(0, 512, (n,),
                         generator=torch.Generator().manual_seed(seed + n))


def test_yarn_constants_at_the_published_widths():
    """For the 64 rope dims over 4,096 original positions the ramp runs
    from frequency 10 to 23, and the scores are scaled by 192^-1/2 (0.1 x
    0.707 ln 40 + 1)^2 = 0.114721; the reference derives both alike."""
    cfg = get_config(NAME)
    assert yarn_correction_range(64, 10000.0, YARN) == (10, 23)
    assert cfg.attn_scale == pytest.approx(0.114721, abs=5e-7)
    assert ref.softmax_scale(model_dict(cfg)) == cfg.attn_scale
    m = model_dict(cfg)
    from repro_torch.models.layers import yarn_frequencies
    torch.testing.assert_close(yarn_frequencies(64, 10000.0, YARN, "cpu"),
                               ref.yarn_inv_freq(m, "cpu"), rtol=0, atol=0)


def test_rope_is_deepseeks():
    """De-interleaved then rotated split-half: the pair (2i, 2i + 1) turns
    by position x frequency i into dims (i, i + d/2); the reference's
    rope, the same."""
    x = torch.randn(5, 2, 16)
    pos = torch.arange(4090, 4095)
    got = apply_rope(deinterleave(x)[None], pos[None], 10000.0, YARN)[0]
    m = {"mla": {"rope_dim": 16}, "rope_theta": 10000.0,
         "yarn": dataclasses.asdict(YARN)}
    torch.testing.assert_close(got, ref.rope(x, pos, m), rtol=0, atol=1e-6)
    inv = ref.yarn_inv_freq(m, "cpu")
    ang = pos[:, None].float() * inv
    a, b = x[..., 0::2], x[..., 1::2]
    want = torch.cat([a * ang.cos()[:, None] - b * ang.sin()[:, None],
                      a * ang.sin()[:, None] + b * ang.cos()[:, None]], -1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("s", [37, PAST])
def test_prefill_then_decode_matches_the_expanded_forward(s):
    """A prefill, then 6 decode steps through the latent cache (absorbed),
    against the reference's expanded forward over the prompt and the fed
    tokens; at s = 4,096 the steps sit past YaRN's original context."""
    cfg = tiny(capacity_factor=4.0)
    model, params = built(cfg)
    t = tokens(s + 6, seed=1)
    got = []
    with torch.inference_mode(), exact_fp32():
        lg, cache = model.prefill(params, {"tokens": t[None, :s]},
                                  max_len=s + 8)
        got.append(lg[0, -1, :cfg.vocab])
        for i in range(s, s + 6):
            lg, cache = model.decode_step(params, cache, t[None, i:i + 1])
            got.append(lg[0, 0, :cfg.vocab])
        want = ref.forward(params, model_dict(cfg), t,
                           torch.arange(s - 1, s + 6), F32)
    close(torch.stack(got), want)


def test_absorbed_decode_matches_the_expanded_prefill():
    """In fp32 the decode step's absorbed product, (q_nope W_uk^T) . c and
    (sum p c) W_uv, equals the expanded attention of a prefill over the
    same tokens, slot by slot of a batch of 3 ragged prompts."""
    from repro_torch.serving.engine import _insert_slot
    cfg = tiny(capacity_factor=4.0)
    model, params = built(cfg)
    with torch.inference_mode():
        cache, axes = model.make_cache(3, 64)
        prompts = [tokens(n, seed=2) for n in (20, 41, 7)]
        for slot, p in enumerate(prompts):
            _, one = model.prefill(params, {"tokens": p[None]}, max_len=64)
            _insert_slot(cache, one, slot, axes)
        feed = torch.tensor([[3], [9], [11]])
        got, _ = model.decode_step(params, cache, feed)
        for slot, p in enumerate(prompts):
            whole = torch.cat([p, feed[slot]])
            want, _ = model.prefill(params, {"tokens": whole[None]},
                                    max_len=64)
            close(got[slot, 0], want[0, -1])


@pytest.mark.parametrize("s,width", [(37, 64), (64, 64), (100, 256)])
def test_prefill_into_a_padded_row_matches_the_unpadded_prefill(s, width):
    """A prompt padded at its end to ``width`` and prefilled straight into
    row 1 of a 3-slot cache: its logits, latent rows and length are the
    unpadded prefill's, the pads' rows lie past the length, and the other
    rows are untouched. At the published capacity, so the MoE takes the
    real tokens alone."""
    cfg = tiny()
    model, params = built(cfg)
    t = tokens(s, seed=3)
    with torch.inference_mode():
        want, one = model.prefill(params, {"tokens": t[None]}, max_len=256)
        cache, _ = model.make_cache(3, 256)
        cache["layers"]["latent"].fill_(0.5)
        padded = torch.zeros((1, width), dtype=torch.long)
        padded[0, :s] = t
        real = RealTokens(torch.tensor([s]),
                          torch.tensor([capacity(s, cfg.moe)]))
        got = model.prefill_into(params, padded, real, torch.tensor([1]),
                                 cache)
    close(got[0, 0], want[0, -1])
    lat = cache["layers"]["latent"]
    torch.testing.assert_close(lat[:, 1, :s], one["layers"]["latent"][:, 0,
                                                                      :s])
    assert int(cache["length"][1]) == s
    assert (lat[:, 0] == 0.5).all() and (lat[:, 2] == 0.5).all()
    assert (lat[:, 1, width:] == 0.5).all()


def test_replay_follows_the_served_batch():
    """The reference's batch replay (expanded prefill, absorbed decode,
    latent rows in the model's type) against the program's prefill, slot
    copy and batched decode steps at the published capacity, one slot idle
    and fed token 0."""
    from repro_torch.serving.engine import _insert_slot
    cfg = tiny()
    model, params = built(cfg)
    m = model_dict(cfg)
    n_slots, max_len = 3, 96
    prompts = [tokens(n, seed=4) for n in (70, 23)]
    cache, axes = model.make_cache(n_slots, max_len)
    got, want = [], []
    with torch.inference_mode(), exact_fp32():
        rep = ref.Replay(params, m, n_slots, max_len, F32, "cpu")
        for slot, p in enumerate(prompts):
            lg, one = model.prefill(params, {"tokens": p[None]},
                                    max_len=max_len)
            _insert_slot(cache, one, slot, axes)
            got.append(lg[0, -1, :cfg.vocab])
            want.append(rep.prefill(slot, p))
        feed = torch.tensor([5, 7, 0])
        for _ in range(5):
            lg, cache = model.decode_step(params, cache, feed[:, None])
            got.append(lg[:, 0, :cfg.vocab])
            want.append(rep.decode(feed))
            feed = lg[:, 0, :cfg.vocab].argmax(-1)
            feed[2] = 0
    for g, w in zip(got, want):
        close(g, w)


def test_the_fp8_control_reads_far_off():
    """The control (every product on e4m3 inputs) moves the logits by far
    more than the tolerance: it is what the cell's limit must refuse."""
    cfg = tiny()
    _, params = built(cfg)
    t = tokens(40)
    m = model_dict(cfg)
    pos = torch.tensor([39])
    with torch.inference_mode(), exact_fp32():
        want = ref.forward(params, m, t, pos, F32)
        gap = (ref.forward(params, m, t, pos, Precision("fp8"))
               - want).abs().max()
    assert gap > 100 * REL * float(want.abs().max())


def test_active_params_count_the_dense_layer_whole():
    """At V2-Lite's widths: 15.71 B parameters, of which the routed
    experts' unchosen 58 of 64 in the 26 expert layers are inactive; the
    leading dense layer has no experts, so none of it is."""
    cfg = get_config(NAME)
    total = cfg.n_params()
    assert total == 15_706_484_224
    per_expert = 3 * 2048 * 1408
    assert cfg.n_active_params() == total - (64 - 6) * per_expert * 26
    assert cfg.n_active_params() == 2_661_150_208


def test_the_layer_plan_leads_with_the_dense_layer():
    """Layer 0 draws its parameters from the dense stack (a SwiGLU of
    d_ff), the others from the expert stack; all 27 cache rows are one
    stack of latent rows, kv_rank + rope wide."""
    cfg = get_config(NAME)
    model = Model(cfg, device="meta")
    plan = model.layer_plan()
    assert [layer.params[0] for layer in plan] == \
        ["dense_layers"] + ["layers"] * 26
    assert [layer.cache for layer in plan] == [("layers", i)
                                               for i in range(27)]
    params = model.init()
    assert params["dense_layers"]["mlp"]["gate"].shape == (1, 2048, 10944)
    assert params["layers"]["moe"]["gate"].shape == (26, 64, 2048, 1408)
    assert params["layers"]["attn"]["wkv_b"].shape == (26, 512, 16 * 256)
    cache, axes = model.make_cache(2, 32)
    assert cache["layers"]["latent"].shape == (27, 2, 32, 576)
    assert axes["layers"]["latent"] == ("layers", "batch", "cache_seq", None)


@pytest.mark.parametrize("bad", [dict(family="hybrid_moe"),
                                 dict(kv_cache_quant=True),
                                 dict(moe=None)])
def test_what_latent_attention_does_not_take(bad):
    """Latent attention and leading dense layers are the decoder
    families'; the latent cache has no int8 form; dense layers lead
    expert ones."""
    with pytest.raises(ValueError):
        Model(tiny(**bad), device="meta")


def test_yarn_at_factor_one_is_plain_rope():
    """The plain rope is YaRN with nothing scaled: a factor of 1 moves no
    frequency and no magnitude."""
    x = torch.randn(3, 7, 2, 16)
    pos = torch.arange(7).expand(3, 7)
    plain = apply_rope(x, pos, 10000.0)
    flat = YarnConfig(factor=1.0, original_max_pos=4096)
    torch.testing.assert_close(apply_rope(x, pos, 10000.0, flat), plain)
