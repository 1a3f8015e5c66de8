"""deepseek-v2-lite's cell on the CPU: the configuration file against the
program's registry, the counts of ``flops_mla.py``, and a tiny run of the
harness on the cell's files (the model cut to a few layers of small
width in fp32, the long-chat mix cut to short prompts), sound and with
each fault of ``harness.FAULTS``. The reference itself is held to the
program in ``tests/test_torch_mla.py``.
"""
import dataclasses
import json
import shutil
from types import SimpleNamespace

import pytest
import torch

from conftest import BENCH, ROOT
from perfbench import flops_mla, peaks, spec
from perfbench.harness import FAULTS, check_config, run_cell
from repro_torch.configs import get_config

NAME = "deepseek-v2-lite"
MIX = "longchat-closed"
CELL = f"{NAME}.{MIX}"
#: the cell's per-layer metrics, in BENCHMARK.json's order
METRICS = ["engine.decode_step_ms.lchat", "engine.prefill_ms.lchat",
           "engine.itl_p95_ms.lchat", "device.idle_share.lchat",
           "mfu.lchat", "mla_decode_roofline.lchat",
           "mla_prefill_attention_roofline.lchat"]


def config_file() -> dict:
    return json.loads((BENCH / "configs" / f"{NAME}.json").read_text())


def test_the_configuration_file_states_the_model_as_run():
    """Every width of the catalog's config.json is in the file under its
    own key, nothing is reduced, and the ``model`` group is the
    registry's config: the groups ``check_config`` compares, and the
    latent attention, YaRN and dense-layer settings it does not."""
    conf = config_file()
    cfg = get_config(conf["arch"], attn_impl="kernel")
    check_config(cfg, conf["model"])
    m = conf["model"]
    assert conf["reduced"] == []
    assert m["mla"] == dataclasses.asdict(cfg.mla)
    assert m["yarn"] == dataclasses.asdict(cfg.yarn)
    assert m["dense_layers"] == cfg.dense_layers == conf[
        "first_k_dense_replace"]
    assert (conf["kv_lora_rank"], conf["qk_nope_head_dim"],
            conf["qk_rope_head_dim"], conf["v_head_dim"]) == (
        m["mla"]["kv_rank"], m["mla"]["nope_dim"], m["mla"]["rope_dim"],
        m["mla"]["v_dim"])
    y = conf["rope_scaling"]
    assert (y["factor"], y["original_max_position_embeddings"],
            y["beta_fast"], y["beta_slow"], y["mscale_all_dim"]) == (
        m["yarn"]["factor"], m["yarn"]["original_max_pos"],
        m["yarn"]["beta_fast"], m["yarn"]["beta_slow"],
        m["yarn"]["mscale_all_dim"])
    # the port and the reference scale cos and sin by mscale /
    # mscale_all_dim only where that is 1
    assert y["mscale"] == y["mscale_all_dim"]
    assert (conf["n_routed_experts"], conf["num_experts_per_tok"],
            conf["moe_intermediate_size"] * conf["n_shared_experts"],
            conf["norm_topk_prob"]) == (
        m["moe"]["n_experts"], m["moe"]["top_k"], m["moe"]["shared_ff"],
        m["moe"]["norm_topk"])
    assert (conf["hidden_size"], conf["intermediate_size"],
            conf["num_hidden_layers"], conf["vocab_size"]) == (
        m["d_model"], m["d_ff"], m["n_layers"], m["vocab"])


def test_the_cell_fills_the_context():
    """Prompt and output of the long-chat mix fit the cell's cache and the
    model's context, the longest exactly."""
    mix = json.loads((BENCH / "traffic" / f"{MIX}.json").read_text())
    data = json.loads((BENCH / "cells" / f"{CELL}.json").read_text())
    assert mix["prompt"]["max"] + mix["output"]["max"] == data["max_len"]
    assert data["max_len"] <= config_file()["context_length"]


def test_counts():
    """The latent row, a decode row's and a prefill's attention at the
    published widths, and the prefill's own sum."""
    m = config_file()["model"]
    assert flops_mla.row_width(m) == 576
    one = flops_mla.mla_decode_call(m, 1000)
    assert one["bytes"] == 2 * (1000 * 576 + 16 * 576 + 16 * 512)
    assert one["flops"] == 2 * 16 * 1000 * (576 + 512)
    f = flops_mla.flash_call(m, 4)
    assert f["flops"] == 2 * 16 * 10 * (192 + 128)
    assert f["bytes"] == 2 * 4 * 16 * (2 * 192 + 2 * 128)
    assert flops_mla.decode_flops(m, [100, 100]) == \
        2 * flops_mla.decode_flops(m, [100])
    per_token = (flops_mla.prefill_flops(m, 2) - flops_mla.prefill_flops(
        m, 1) - 27 * (flops_mla.flash_call(m, 2)["flops"]
                      - flops_mla.flash_call(m, 1)["flops"])) / 2
    # a token's multiply-adds are the program's active parameters but the
    # two embedding tables (the logits are the last position's alone) and
    # the norms' weights
    cfg = get_config(NAME)
    norms = 27 * 2 * 2048 + 27 * 512 + 2048
    assert per_token == cfg.n_active_params() - 2 * 102400 * 2048 - norms


def test_the_reference_splits_an_activation_into_three_bf16_parts():
    """``deepseek_v2._parts``: three bf16 tensors whose sum is the fp32
    activation to within half its last bit (2^-24 of it), over magnitudes
    from 2^-20 to 2^20."""
    from perfbench.reference.deepseek_v2 import _parts
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4096, generator=g) * 2.0 ** torch.randint(
        -20, 21, (4096,), generator=g).float()
    total = sum(p.double() for p in _parts(x))
    assert all(p.dtype == torch.bfloat16 for p in _parts(x))
    assert ((total - x.double()).abs() <= 2.0 ** -24 * x.double().abs()).all()


@pytest.mark.parametrize("kind", ["fp32", "fp8"])
def test_the_reference_dispatch_is_the_decoders(kind):
    """``deepseek_v2.moe``, its products through the precision's ``mm``,
    gives ``decoder.moe``'s bits off the card, for the program's
    reference and the fp8 control alike."""
    from perfbench.reference import decoder, deepseek_v2
    from perfbench.reference.common import Precision
    from perfbench.reference.hybrid_moe import _Uncached
    g = torch.Generator().manual_seed(2)
    d, e, f, t = 32, 8, 16, 40
    w = lambda *shape: torch.randn(*shape, generator=g).to(torch.bfloat16)
    p = {"router": torch.randn(d, e, generator=g), "gate": w(e, d, f),
         "up": w(e, d, f), "down": w(e, f, d)}
    m = {"moe": dict(n_experts=e, top_k=2, capacity_factor=1.25,
                     capacity_floor=4, norm_topk=False)}
    x = torch.randn(t, d, generator=g)
    prec = Precision(kind)
    assert torch.equal(deepseek_v2.moe(p, x, m, deepseek_v2._Prec(prec)),
                       decoder.moe(p, x, m, _Uncached(prec)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the split products run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("batched", [False, True])
def test_the_reference_products_on_the_card_are_fp32_products(cuda, batched):
    """``deepseek_v2.fmm`` of an fp32 activation and bf16 weights against
    the fp64 product: each element within fp32's worst-case bound for a
    sum of K products in any order with each addition truncated, (K + 2)
    2^-23 of the sum of the products' magnitudes (two more additions sum
    the three parts); and the mean error within 2^-13 of the mean
    magnitude, which an output rounded to bf16 (2^-9 an element) would
    exceed."""
    from perfbench.reference.common import exact_fp32
    from perfbench.reference.deepseek_v2 import fmm
    g = torch.Generator(device=cuda).manual_seed(1)
    lead = (3,) if batched else ()
    k = 2048
    x = torch.randn(*lead, 48, k, generator=g, device=cuda)
    y = torch.randn(*lead, k, 1408, generator=g,
                    device=cuda).to(torch.bfloat16)
    want = x.double() @ y.double()
    with exact_fp32():
        err = (fmm(x, y).double() - want).abs()
    assert (err <= (k + 2) * 2.0 ** -23
            * (x.double().abs() @ y.double().abs())).all()
    assert err.mean() <= 2.0 ** -13 * want.abs().mean()


def _reader(name):
    return spec.reader(BENCH, name)


def _trace(kernels):
    """A reduced trace of one 1 ms sub-window holding ``kernels``: (name,
    count, ns each), laid end to end."""
    from perfbench import devtrace
    dev, t = [], 0
    for name, n, ns in kernels:
        for _ in range(n):
            dev.append((name, t, t + ns))
            t += ns
    return devtrace.reduce([("pb.window", 0, 1_000_000)], dev)


def test_the_mla_rooflines_on_a_synthetic_trace():
    """Two decode steps of two rows and one prefill, at the published
    widths: the bound of each read over the device time of its kernels;
    None where the trace holds another count of them (a program without
    the kernels)."""
    m = config_file()["model"]
    steps = [[1000, 3000], [1001, 3001]]
    dec = 2 * 27 * 2
    ctx = SimpleNamespace(model=m, decodes=steps, prefills=[4000],
                          trace=_trace([("mla_decode_partial<576, 512>",
                                         dec // 2, 300),
                                        ("mla_decode_merge<512>", dec // 2,
                                         100),
                                        ("flash_fwd_mma<192, 128>", 27,
                                         10_000)]))
    calls = [flops_mla.mla_decode_call(m, c) for step in steps for c in step]
    bound = sum(27 * peaks.bound_s(c["flops"], c["bytes"]) for c in calls)
    got = _reader("mla_decode_roofline.lchat")(ctx)
    assert got == pytest.approx(100 * bound / (dec * 200e-9))
    call = flops_mla.flash_call(m, 4000)
    got = _reader("mla_prefill_attention_roofline.lchat")(ctx)
    assert got == pytest.approx(
        100 * 27 * peaks.bound_s(call["flops"], call["bytes"]) / 270e-6)
    ctx.trace = _trace([("mla_decode_partial", 3, 300),
                        ("flash_fwd_mma", 26, 10_000)])
    assert _reader("mla_decode_roofline.lchat")(ctx) is None
    assert _reader("mla_prefill_attention_roofline.lchat")(ctx) is None


# --------------------------------------------------------------------------
# a tiny run of the harness on this cell
# --------------------------------------------------------------------------

#: the configuration cut to three layers (the dense one leading) of small
#: width
TINY = {"n_layers": 3, "d_model": 64, "n_heads": 4, "kv_heads": 4,
        "head_dim": 24, "d_ff": 32, "vocab": 300,
        "mla": {"kv_rank": 32, "nope_dim": 16, "rope_dim": 8, "v_dim": 16},
        "moe": {"n_experts": 8, "top_k": 2, "expert_ff": 32,
                "shared_ff": 64}}
#: the long-chat mix cut to the tiny model's sizes
TINY_MIX = {"prompt": {"min": 8, "max": 40, "median": 16},
            "output": {"min": 4, "max": 12, "median": 8}}
#: fp32 program against the fp32 reference: a sound run reads ~0
LIMIT = 1e-3


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A checkout-like tree with this cell alone, cut to TINY and
    TINY_MIX, its limit at LIMIT; returns the cell."""
    root = tmp_path_factory.mktemp("mla") / "root"
    bench = root / "perfbench"
    for sub in ("layer_metrics", "reference"):
        shutil.copytree(BENCH / sub, bench / sub)
    for sub in ("configs", "traffic", "cells"):
        (bench / sub).mkdir(parents=True)
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["configs"] = [c for c in b["configs"] if c["name"] == NAME]
    b["workloads"] = [w for w in b["workloads"] if w["name"] == CELL]
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    conf = config_file()
    conf["overrides"] = dict(conf["overrides"], dtype="float32",
                             vocab_pad=64, remat="none", **TINY)
    for k, v in TINY.items():
        conf["model"][k] = dict(conf["model"][k], **v) \
            if isinstance(v, dict) else v
    conf["model"]["dtype"] = "float32"
    (bench / "configs" / f"{NAME}.json").write_text(json.dumps(conf))
    mix = json.loads((BENCH / "traffic" / f"{MIX}.json").read_text())
    for k, v in TINY_MIX.items():
        mix[k] = dict(mix[k], **v)
    (bench / "traffic" / f"{MIX}.json").write_text(json.dumps(mix))
    data = json.loads((BENCH / "cells" / f"{CELL}.json").read_text())
    data.update(n_slots=6, max_len=40 + 12, check_tokens=20,
                limits={k: LIMIT for k in data["limits"]})
    (bench / "cells" / f"{CELL}.json").write_text(json.dumps(data))
    return spec.load_cell(root, CELL, bench)


@pytest.mark.parametrize("fault", [None] + sorted(FAULTS))
def test_tiny_run_is_correct_only_without_a_fault(tiny, fault):
    """A sound run reads ~0 and is correct, its fp8 control is not; each
    fault (a token altered where it is produced, a decode step that keeps
    its state, half a batch left out) reads far off."""
    res = run_cell(tiny, 2**31 + 21, 1.5, False, device="cpu",
                   control=fault is None,
                   faults=() if fault is None else (fault,))
    assert res["n_compared"] > 0
    if fault is None:
        assert res["correct"], res["readings"]
        assert res["control_correct"] is False, res["readings"]
    else:
        assert not res["correct"], res["readings"]
        assert res["readings"]["logit_gap_mean"] > 10 * LIMIT


def test_tiny_traced_run_reads_every_new_metric(tiny):
    """A traced run on the CPU: the engine's numbers and the token gaps
    are read; the trace holds no device kernels, so the kernels' rooflines
    read nothing."""
    res = run_cell(tiny, 2**31 + 22, 1.5, True, device="cpu")
    assert res["correct"], res["readings"]
    assert [m["name"] for m in tiny.per_layer] == METRICS
    for name in ("engine.decode_step_ms.lchat", "engine.prefill_ms.lchat",
                 "engine.itl_p95_ms.lchat"):
        assert res["layer"][name] > 0, name
    assert res["layer"]["device.idle_share.lchat"] == 100.0
    for name in ("mla_decode_roofline.lchat",
                 "mla_prefill_attention_roofline.lchat"):
        assert name not in res["layer"]
