"""The hybrid_moe family (granite-4.0-h-small) on the CPU: its published
sizes and parameter counts, the published Mamba2 mixer's conv over x, B
and C against a direct token-by-token loop, the padding of a prompt to a
whole number of chunks, the ungated shared expert, Granite's scalars,
and the cache the engine serves from. Its plain reference lives with the
benchmark (perfbench/tests/test_perfbench_hybrid_moe.py)."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F

from repro_torch.configs import (ARCH_IDS, PORT_ARCH_IDS, get_config,
                                 reduced_config)
from repro_torch.models import mamba2 as m2
from repro_torch.models.model import Model
from repro_torch.models.moe import MoEConfig, apply_moe, make_moe_params

NAME = "granite-4.0-h-small"


def test_published_widths():
    cfg = get_config(NAME)
    assert NAME in PORT_ARCH_IDS and NAME not in ARCH_IDS
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads,
            cfg.hd, cfg.vocab, cfg.rope_theta, cfg.tie_embeddings) == \
        ("hybrid_moe", 40, 4096, 32, 8, 128, 100352, None, True)
    assert cfg.ssm == m2.SSMConfig(state=128, head_dim=64, expand=2,
                                   conv_kernel=4, chunk=128, conv_xbc=True,
                                   pad_to_chunk=True)
    assert m2.n_heads(cfg.d_model, cfg.ssm) == 128
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.expert_ff,
            cfg.moe.shared_ff, cfg.moe.shared_gated, cfg.moe.norm_topk) == \
        (72, 10, 768, 1536, False, True)
    assert cfg.attn_layers == (5, 15, 25, 35)
    assert (cfg.embedding_multiplier, cfg.attention_multiplier,
            cfg.residual_multiplier, cfg.logits_scaling, cfg.norm_eps) == \
        (12.0, 0.0078125, 0.22, 16.0, 1e-5)
    kinds = [layer.kind for layer in Model(cfg, device="meta").layer_plan()]
    assert kinds.count("attn") == 4 and kinds.count("mamba") == 36


def test_parameter_counts_are_the_published_sizes():
    """32 B total and 9 B active, as published (the shapes give 32.2 B and
    8.8 B: experts on every layer, the shared expert active, the conv
    bias, the tied embedding once); the 20-layer cut holds 16.3 B."""
    cfg = get_config(NAME)
    assert abs(cfg.n_params() / 32e9 - 1) < 0.03
    assert abs(cfg.n_active_params() / 9e9 - 1) < 0.03
    cut = get_config(NAME, n_layers=20)
    assert abs(cut.n_params() / 16.3e9 - 1) < 0.005
    params = Model(cfg, device="meta").init()
    assert "out" not in params["embed"]
    assert params["mamba_layers"]["mamba"]["conv"]["b"].shape == (36, 8448)
    assert "shared_router" not in params["mamba_layers"]["moe"]


def test_cache_holds_keys_on_attention_layers_and_states_on_mamba2():
    model = Model(get_config(NAME, n_layers=20), device="meta")
    cache, axes = model.make_cache(64, 4096)
    assert cache["mamba"]["h"].shape == (18, 64, 128, 128, 64)
    assert cache["mamba"]["conv"].shape == (18, 64, 3, 8192 + 256)
    assert cache["attn"]["k"].shape == (2, 64, 4096, 8, 128)
    total = sum(t.numel() * t.element_size() for part in ("mamba", "attn")
                for t in cache[part].values())
    assert 4.5e9 < total < 4.7e9
    assert all("batch" in a for part in ("mamba", "attn")
               for a in axes[part].values())


def _published_loop(p, x, cfg: m2.SSMConfig, eps):
    """The published mixer token by token, in fp32: the conv of x, B and C
    with its bias over a window of k positions, SiLU, then the SSM
    recurrence h = exp(dt A) h + dt B x^T, y = C h + D x."""
    di = p["x_proj"].shape[1]
    nh, hp, n, k = di // cfg.head_dim, cfg.head_dim, cfg.state, \
        cfg.conv_kernel
    pre = torch.cat([x @ p["x_proj"], x @ p["b_proj"], x @ p["c_proj"]], -1)
    h = torch.zeros(x.shape[0], nh, n, hp)
    ys = []
    for t in range(x.shape[1]):
        conv = p["conv"]["b"].clone()
        for i in range(k):
            if t - (k - 1) + i >= 0:
                conv = conv + p["conv"]["taps"][i] * pre[:, t - (k - 1) + i]
        xs, bm, cm = F.silu(conv).split([di, n, n], -1)
        dt = F.softplus(x[:, t] @ p["dt_proj"] + p["dt_bias"])
        a = torch.exp(dt * -torch.exp(p["A_log"]))
        xs = xs.reshape(-1, nh, hp)
        h = h * a[..., None, None] + torch.einsum("bh,bn,bhp->bhnp", dt, bm,
                                                  xs)
        y = torch.einsum("bn,bhnp->bhp", cm, h) + p["D"][:, None] * xs
        y = y.reshape(-1, di) * F.silu(x[:, t] @ p["z_proj"])
        ys.append(m2.rms_norm(y, p["norm_w"], eps) @ p["out_proj"])
    return torch.stack(ys, 1), h


def _mixer(seed=0):
    cfg = reduced_config(NAME).ssm
    gen = torch.Generator().manual_seed(seed)
    p = m2.make_mamba2_params(gen, 64, cfg, torch.float32, "cpu")
    p["conv"]["b"] = torch.randn(p["conv"]["b"].shape, generator=gen)
    p["A_log"] = torch.rand(p["A_log"].shape, generator=gen)
    p["dt_bias"] = torch.randn(p["dt_bias"].shape, generator=gen) - 2
    return cfg, p


@pytest.mark.parametrize("s", [1, 3, 37, 64])
def test_conv_over_xbc_with_its_bias_matches_a_direct_loop(s):
    """The chunked prefill (chunk 32: s = 37 pads to 64) and then 3
    recurrent steps, against the loop; the state after the padding is the
    state at the last true position, and the conv window the last k - 1
    true positions. Tolerance: fp32 against fp32 in another order of sums
    (chunks against steps), ~1e-6 of outputs of ~1."""
    cfg, p = _mixer()
    x = torch.randn(2, s + 3, 64, generator=torch.Generator().manual_seed(s))
    with torch.no_grad():
        want, h_want = _published_loop(p, x, cfg, 1e-5)
        _, h_pre = _published_loop(p, x[:, :s], cfg, 1e-5)
        out, st = m2.apply_mamba2_with_state(p, x[:, :s], cfg, eps=1e-5)
        torch.testing.assert_close(out, want[:, :s], atol=2e-5, rtol=1e-4)
        torch.testing.assert_close(st["h"], h_pre, atol=2e-5, rtol=1e-4)
        for t in range(s, s + 3):
            y, st = m2.decode_mamba2(p, x[:, t:t + 1], st, cfg, eps=1e-5)
            torch.testing.assert_close(y[:, 0], want[:, t], atol=2e-5,
                                       rtol=1e-4)
        torch.testing.assert_close(st["h"], h_want, atol=2e-5, rtol=1e-4)


def test_padding_is_counted_and_only_where_the_option_is_on():
    cfg, p = _mixer()
    x = torch.randn(1, 37, 64)
    real, pad = m2.ssd_real_tokens, m2.ssd_pad_tokens
    with torch.no_grad():
        m2.apply_mamba2(p, x, cfg)
    assert (m2.ssd_real_tokens - real, m2.ssd_pad_tokens - pad) == (37, 27)
    with torch.no_grad(), pytest.raises(ValueError, match="not divisible"):
        m2.apply_mamba2(p, x, dataclasses.replace(cfg, pad_to_chunk=False))


@pytest.mark.parametrize("gated", [False, True])
def test_shared_expert_gated_or_not(gated):
    """Ungated (Granite 4.0-H): the experts' share plus the shared SwiGLU
    as it is; gated (Qwen2-MoE): the shared SwiGLU through the sigmoid of
    its own router, whose weight only the gated expert has."""
    cfg = MoEConfig(n_experts=8, top_k=2, expert_ff=32, shared_ff=48,
                    norm_topk=True, shared_gated=gated)
    p = make_moe_params(torch.Generator().manual_seed(1), 64, cfg,
                        torch.float32, "cpu")
    assert ("shared_router" in p) == gated
    x = torch.randn(1, 10, 64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        out, _ = apply_moe(p, x, cfg)
        routed, _ = apply_moe(p, x, dataclasses.replace(cfg, shared_ff=0))
    xf = x[0]
    sh = (F.silu(xf @ p["shared_gate"]) * (xf @ p["shared_up"])) \
        @ p["shared_down"]
    if gated:
        sh = torch.sigmoid(xf @ p["shared_router"]) * sh
    torch.testing.assert_close(out[0], routed[0] + sh)


def _prefill_decode(cfg, steps=4):
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    t = torch.randint(0, cfg.vocab, (1, 40),
                      generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        full, _ = model.forward(params, {"tokens": t})
        lg, cache = model.prefill(params, {"tokens": t[:, :40 - steps]},
                                  max_len=64)
        outs = [lg[0, -1]]
        for i in range(40 - steps, 39):
            lg, cache = model.decode_step(params, cache, t[:, i:i + 1])
            outs.append(lg[0, 0])
    return full[0, 40 - steps - 1:39], torch.stack(outs)


@pytest.mark.parametrize("arch", [NAME, "granite-moe-3b-a800m"])
@pytest.mark.parametrize("scalars", ["published", "off"])
def test_granite_scalars_in_prefill_decode_and_forward(arch, scalars):
    """Granite's four scalars on (as granite-4.0-h-small publishes them)
    and off, in the hybrid_moe family and the moe family (granite-moe):
    prefill and decode through the cache give what one forward pass
    gives. Capacity covers every token (factor E / k), so the pass and
    the steps route alike; fp32, so ~1e-6 apart."""
    base = reduced_config(arch)
    scal = dict(embedding_multiplier=12.0, attention_multiplier=0.0078125,
                residual_multiplier=0.22, logits_scaling=16.0, norm_eps=1e-5)
    if scalars == "off":
        scal = dict(embedding_multiplier=1.0, attention_multiplier=None,
                    residual_multiplier=1.0, logits_scaling=1.0,
                    norm_eps=None)
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=4.0), **scal)
    full, steps = _prefill_decode(cfg)
    torch.testing.assert_close(steps, full, atol=2e-5, rtol=1e-4)


def test_scalars_scale_what_they_name():
    """In the moe family: ``logits_scaling`` divides the logits, an
    ``attention_multiplier`` of head_dim^-1/2 is the default scale, and
    the defaults leave every other registered model as it was."""
    cfg = reduced_config("granite-moe-3b-a800m")
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    t = torch.randint(0, cfg.vocab, (1, 12))
    with torch.no_grad():
        want, _ = model.forward(params, {"tokens": t})
        div, _ = Model(dataclasses.replace(cfg, logits_scaling=4.0),
                       device="cpu").forward(params, {"tokens": t})
        explicit = dataclasses.replace(cfg, attention_multiplier=cfg.hd ** -0.5)
        scaled, _ = Model(explicit, device="cpu").forward(params,
                                                          {"tokens": t})
    live = want[..., :cfg.vocab]
    torch.testing.assert_close(div[..., :cfg.vocab], live / 4.0)
    # a product by the scale against a quotient by its inverse: scores one
    # rounding apart, ~1e-6 after the layers
    torch.testing.assert_close(scaled, want, atol=1e-5, rtol=1e-4)
    for arch in ARCH_IDS:
        c = get_config(arch)
        assert (c.embedding_multiplier, c.attention_multiplier,
                c.residual_multiplier, c.logits_scaling, c.norm_eps,
                c.attn_layers) == (1.0, None, 1.0, 1.0, None, ())


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m", "qwen3-0.6b"])
def test_families_without_scalars_refuse_them(arch):
    with pytest.raises(ValueError, match="takes no multipliers"):
        Model(dataclasses.replace(reduced_config(arch), logits_scaling=16.0),
              device="cpu")


def test_the_engine_serves_the_reduced_model():
    """Prompts of several lengths (padded where longer than a chunk) in
    three slots; every request gets its tokens and the SSM states stay
    finite."""
    from repro_torch.serving import RequestQueue, ServeEngine
    cfg = reduced_config(NAME)
    model = Model(cfg, device="cpu")
    eng = ServeEngine(model, model.init(seed=0), n_slots=3, max_len=96)
    q = RequestQueue()
    gen = torch.Generator().manual_seed(4)
    reqs = [q.submit(torch.randint(0, cfg.vocab, (n,), generator=gen)
                     .numpy(), max_new_tokens=5) for n in (1, 37, 70, 9)]
    eng.run(q)
    assert all(len(r.generated) == 5 for r in reqs)
    assert all(bool(torch.isfinite(t).all())
               for t in eng.cache["mamba"].values())
    assert math.isfinite(eng.decode_s)


def test_spans_of_a_decode_step_and_a_prefill():
    """With the port's tracing on, each layer opens its mixer's span
    (``rt.mamba`` or ``rt.attn``), then ``rt.moe`` with ``rt.shared``
    inside it; the MoE counters count every layer."""
    import collections
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import tracing
    from repro_torch.models import moe
    cfg = reduced_config(NAME)
    model = Model(cfg, device="cpu")
    params = model.init(seed=0)
    t = torch.randint(0, cfg.vocab, (2, 40))
    moe.reset_moe_stats()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as prof:
        tracing.enable()
        try:
            _, cache = model.prefill(params, {"tokens": t}, max_len=48)
            model.decode_step(params, cache, t[:, :1])
        finally:
            tracing.disable()
    counts = collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.is_user_annotation() and e.name().startswith("rt."))
    kinds = [layer.kind for layer in model.layer_plan()]
    assert counts["rt.mamba"] == 2 * kinds.count("mamba")
    assert counts["rt.attn"] == 2 * kinds.count("attn")
    assert counts["rt.moe"] == counts["rt.shared"] == 2 * cfg.n_layers
    stats = moe.read_moe_stats()
    moe.reset_moe_stats()
    assert stats["prefill"]["routed_pairs"] == cfg.n_layers * 80 * 2
    assert stats["decode"]["routed_pairs"] == cfg.n_layers * 2 * 2
