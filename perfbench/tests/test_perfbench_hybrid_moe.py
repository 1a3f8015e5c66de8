"""granite-4.0-h-small's plain reference (``reference/hybrid_moe.py``)
against the program's plain CPU path at reduced fp32 sizes, on weights
the benchmark draws (``weights.py``); the SSD counts of
``flops_hybrid.py``; and a tiny run of the harness on the configuration, sound and with each fault of ``harness.FAULTS``, with
Granite's scalars as the configuration file states them (the embeddings
not multiplied) and as published.

Tolerance: fp32 program against fp32 reference, so what differs is the
order of sums (the program's scan in chunks of 32, padded, the
reference's in chunks of 256; separate in-projections) and the program's
own fp32 roundings: 1e-6 (Granite's scalars on) to 1e-5 (off) of the
largest logit here. ``REL`` = 5e-5 of the largest logit leaves a margin
of 5 to 50 and still fails on any step of the mathematics left out (a
missing conv bias, gate or multiplier moves them by 1e-2 or more).
"""
import dataclasses
import json
import shutil

import pytest
import torch

from conftest import BENCH, ROOT, TINY_MIX
from perfbench import flops_hybrid, spec
from perfbench.harness import FAULTS, run_cell
from perfbench.reference import hybrid_moe as ref
from perfbench.reference.common import Precision, exact_fp32
from perfbench.weights import make_weights
from repro_torch.configs import reduced_config
from repro_torch.models.model import Model
from repro_torch.serving.engine import _insert_slot as insert_slot

NAME = "granite-4.0-h-small"
CELL = NAME + ".chat-closed"
F32 = Precision("fp32")
REL = 5e-5
#: Granite's scalars off: each at the value that changes nothing
OFF = dict(embedding_multiplier=1.0, attention_multiplier=None,
           residual_multiplier=1.0, logits_scaling=1.0)


def model_dict(cfg) -> dict:
    """The ``model`` group of a configuration file, for a program config."""
    m = {k: getattr(cfg, k) for k in (
        "n_layers", "d_model", "n_heads", "kv_heads", "vocab",
        "embedding_multiplier", "residual_multiplier", "logits_scaling")}
    m.update(head_dim=cfg.hd, norm_eps=cfg.norm_eps or 1e-6,
             attention_multiplier=cfg.attention_multiplier or cfg.hd ** -0.5,
             layer_types=["attention" if i in cfg.attn_layers else "mamba"
                          for i in range(cfg.n_layers)],
             ssm=dataclasses.asdict(cfg.ssm),
             moe=dict(dataclasses.asdict(cfg.moe), capacity_floor=8))
    return m


def close(got, want):
    torch.testing.assert_close(got, want, rtol=0,
                               atol=REL * float(want.abs().max()))


def built(seed=3, **over):
    cfg = reduced_config(NAME, **over)
    params = make_weights(Model(cfg, device="meta").init(), seed, "cpu")
    return cfg, Model(cfg, device="cpu"), params


def prompt(n, seed=0):
    return torch.randint(0, 512, (n,), generator=torch.Generator()
                         .manual_seed(seed + n))


@pytest.mark.parametrize("scalars", ["on", "off"])
@pytest.mark.parametrize("s", [1, 37, 128, 200])
def test_prefill_matches_the_reference_forward(s, scalars):
    """Prompts of 1, 37, 128 and 200 tokens at chunk 32: shorter than a
    chunk, padded (37 -> 64, 200 -> 224) and whole; Granite's scalars on
    (as published) and off."""
    cfg, model, params = built(**({} if scalars == "on" else OFF))
    t = prompt(s)
    with torch.inference_mode(), exact_fp32():
        got, _ = model.prefill(params, {"tokens": t[None]}, max_len=256)
        want = ref.forward(params, model_dict(cfg), t, torch.tensor([s - 1]),
                           F32)
    close(got[0, -1, :cfg.vocab], want[0])


@pytest.mark.parametrize("s", [37, 200])
def test_prefill_then_decode_matches_the_reference_forward(s):
    """8 decode steps through the cache against one forward pass over the
    prompt and the fed tokens. The experts' capacity covers every token
    (factor E / k) so that one pass and the steps route alike."""
    moe = dataclasses.replace(reduced_config(NAME).moe, capacity_factor=4.0)
    cfg, model, params = built(moe=moe)
    t = prompt(s + 8, seed=1)
    got = []
    with torch.inference_mode(), exact_fp32():
        lg, cache = model.prefill(params, {"tokens": t[None, :s]},
                                  max_len=256)
        got.append(lg[0, -1, :cfg.vocab])
        for i in range(s, s + 8):
            lg, cache = model.decode_step(params, cache, t[None, i:i + 1])
            got.append(lg[0, 0, :cfg.vocab])
        want = ref.forward(params, model_dict(cfg), t,
                           torch.arange(s - 1, s + 8), F32)
    close(torch.stack(got), want)


def test_replay_follows_the_served_batch():
    """The batch replay against prefill, slot copy and batched decode
    steps, at the published capacity (the prefills cut tokens, the rows of
    a step share capacity), one slot idle and fed token 0."""
    cfg, model, params = built()
    m = model_dict(cfg)
    n_slots, max_len = 3, 96
    prompts = [prompt(n, seed=2) for n in (70, 23)]
    cache, axes = model.make_cache(n_slots, max_len)
    got, want = [], []
    with torch.inference_mode(), exact_fp32():
        rep = ref.Replay(params, m, n_slots, max_len, F32, "cpu")
        for slot, p in enumerate(prompts):
            lg, one = model.prefill(params, {"tokens": p[None]},
                                    max_len=max_len)
            insert_slot(cache, one, slot, axes)
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
    more than the tolerance above: it is what the cell's limit must
    refuse."""
    cfg, model, params = built()
    t = prompt(40)
    with torch.inference_mode(), exact_fp32():
        m = model_dict(cfg)
        pos = torch.tensor([39])
        gap = (ref.forward(params, m, t, pos, Precision("fp8"))
               - ref.forward(params, m, t, pos, F32)).abs().max()
    assert gap > 100 * REL * float(ref.forward(params, m, t, pos, F32)
                                   .abs().max())


def test_ssd_counts():
    """One chunk of 4 rows at n = p = 2, one head: 10 causal pairs of
    (n + p) multiply-adds, 2 q n p for the state and its read, n p for the
    update; then a second, partial chunk of 1 row."""
    m = {"d_model": 2, "ssm": {"expand": 1, "head_dim": 2, "state": 2,
                               "chunk": 4, "conv_kernel": 4}}
    c = flops_hybrid.ssd_call(m, 4)
    assert c["flops"] == 2 * (10 * 4 + 2 * 4 * 4 + 4)
    assert c["bytes"] == 2 * (2 * 4 * 2 + 2 * 4 * 2) + 4 * (2 * 4 + 4)
    assert flops_hybrid.ssd_call(m, 5)["flops"] == \
        c["flops"] + 2 * (1 * 4 + 2 * 4 + 4)


def test_layer_counts_follow_layer_types():
    conf = json.loads((BENCH / "configs" / f"{NAME}.json").read_text())
    m = conf["model"]
    assert flops_hybrid.kinds(m).count("attention") == 2
    assert flops_hybrid.kinds(m).count("mamba") == 18
    one = flops_hybrid.decode_flops(m, [100])
    assert flops_hybrid.decode_flops(m, [100, 100]) == 2 * one
    assert flops_hybrid.prefill_flops(m, 1000) > 1000 * one * 0.9


# --------------------------------------------------------------------------
# a tiny run of the harness on this configuration
# --------------------------------------------------------------------------

#: the configuration cut to a few layers of small width: 7 layers keep
#: the published pattern's attention layer (5) between Mamba2 layers;
#: chunk 16 makes the mix's prompts (4-32 tokens) pad
TINY = {"n_layers": 7, "d_model": 64, "n_heads": 4, "kv_heads": 2,
        "head_dim": 16, "d_ff": 32, "vocab": 300,
        "ssm": {"state": 8, "head_dim": 16, "chunk": 16},
        "moe": {"n_experts": 8, "top_k": 2, "expert_ff": 32,
                "shared_ff": 32}}
#: fp32 program against the fp32 reference: a sound run reads ~0
LIMIT = 1e-3


def tiny_bench(tmp, scalars: dict) -> tuple:
    """A checkout-like tree under ``tmp`` with this cell alone, cut to
    TINY with Granite's ``scalars`` and to the tiny chat mix, its limit at
    LIMIT; returns (root, the cell)."""
    root = tmp / "root"
    bench = root / "perfbench"
    for sub in ("layer_metrics", "reference"):
        shutil.copytree(BENCH / sub, bench / sub)
    for sub in ("configs", "traffic", "cells"):
        (bench / sub).mkdir(parents=True)
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    b["configs"] = [c for c in b["configs"] if c["name"] == NAME]
    b["workloads"] = [w for w in b["workloads"] if w["name"] == CELL]
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    conf = json.loads((BENCH / "configs" / f"{NAME}.json").read_text())
    conf["overrides"] = dict(conf["overrides"], dtype="float32",
                             vocab_pad=64, remat="none", **TINY, **scalars)
    for k, v in dict(TINY, **scalars).items():
        conf["model"][k] = dict(conf["model"][k], **v) \
            if isinstance(v, dict) else v
    conf["model"]["dtype"] = "float32"
    (bench / "configs" / f"{NAME}.json").write_text(json.dumps(conf))
    mix = json.loads((BENCH / "traffic" / "chat-closed.json").read_text())
    for k, v in TINY_MIX["chat-closed"].items():
        mix[k] = dict(mix[k], **v)
    (bench / "traffic" / "chat-closed.json").write_text(json.dumps(mix))
    data = json.loads((BENCH / "cells" / f"{CELL}.json").read_text())
    data.update(n_slots=6, max_len=32 + 12, check_tokens=20,
                limits={k: LIMIT for k in data["limits"]})
    (bench / "cells" / f"{CELL}.json").write_text(json.dumps(data))
    return root, spec.load_cell(root, CELL, bench)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """Granite's scalars as the configuration file runs them: the
    embeddings not multiplied, the other three as published."""
    return tiny_bench(tmp_path_factory.mktemp("hybrid"), {})


@pytest.fixture(scope="module")
def tiny_published(tmp_path_factory):
    """Granite's four scalars as published (the embeddings x12)."""
    return tiny_bench(tmp_path_factory.mktemp("published"),
                      {"embedding_multiplier": 12.0})


def test_the_configuration_file_runs_the_embeddings_unmultiplied():
    """The cell's configuration cuts the embedding multiplier alone, and
    says so: the program and the reference read the same 1."""
    conf = json.loads((BENCH / "configs" / f"{NAME}.json").read_text())
    assert conf["overrides"]["embedding_multiplier"] == 1.0
    assert conf["model"]["embedding_multiplier"] == 1.0
    assert conf["embedding_multiplier"] == 1
    assert conf["published_embedding_multiplier"] == 12
    assert "embedding_multiplier" in conf["reduced"]
    m = conf["model"]
    assert (m["attention_multiplier"], m["residual_multiplier"],
            m["logits_scaling"]) == (1 / 128, 0.22, 16.0)


@pytest.mark.parametrize("fault", [None] + sorted(FAULTS))
def test_tiny_run_is_correct_only_without_a_fault(tiny, fault):
    """At the configuration file's scalars (the embeddings not
    multiplied) the check sees the model's numerics: a sound run reads
    0.0, the fp8 control (~0.004) and each fault (0.046-0.19) fail the
    limit."""
    _, cell = tiny
    res = run_cell(cell, 2**31 + 11, 1.5, False, device="cpu",
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
    """A traced run on the CPU: the trace holds no device kernels, so the
    readers that need them read nothing, and the engine's decode step
    time and the token gaps are read."""
    _, cell = tiny
    res = run_cell(cell, 2**31 + 12, 1.5, True, device="cpu")
    assert res["correct"], res["readings"]
    assert [m["name"] for m in cell.per_layer] == [
        "engine.decode_step_ms.hchat", "engine.itl_p95_ms.hchat",
        "device.idle_share.hchat", "mfu.hchat", "ssd_scan_roofline.hchat"]
    assert res["layer"]["engine.decode_step_ms.hchat"] > 0
    assert res["layer"]["engine.itl_p95_ms.hchat"] > 0
    assert "ssd_scan_roofline.hchat" not in res["layer"]


#: what the check decides at the published scalars: True where it reads
#: correct
SEEN_AT_PUBLISHED = {None: True, "half_batch": False, "stale_state": True,
                     "token": False}


@pytest.mark.parametrize("fault", [None] + sorted(FAULTS))
def test_published_scalars_hide_the_state_from_the_check(tiny_published,
                                                         fault):
    """Why the cell's configuration does not multiply the embeddings. On
    the benchmark's random weights (``tok`` std d^-1/2) the x12 embedding
    and the tied unembedding make the fed token's own logit lead at every
    position, so program, reference and fp8 control all serve back the
    token they were fed, whatever the state: the check's gaps below the
    reference's top-1 read 0.0 for a sound run, for the fp8 control and
    for a decode step that leaves its state unchanged. A token altered
    where it is produced, or half a batch left out, still reads far off.
    A check that reads the logits themselves would turn ``stale_state``
    and the control to not correct here."""
    _, cell = tiny_published
    assert set(SEEN_AT_PUBLISHED) == {None} | set(FAULTS)
    res = run_cell(cell, 2**31 + 11, 1.5, False, device="cpu",
                   control=fault is None,
                   faults=() if fault is None else (fault,))
    assert res["n_compared"] > 0
    assert res["correct"] is SEEN_AT_PUBLISHED[fault], res["readings"]
    if fault is None:
        assert res["control_correct"] is True, res["readings"]
        assert res["readings"]["control_logit_gap_mean"] == 0.0
    if SEEN_AT_PUBLISHED[fault]:
        assert res["readings"]["logit_gap_mean"] == 0.0
    else:
        assert res["readings"]["logit_gap_mean"] > 10 * LIMIT
