"""Operations and bytes of single calls against hand-computed values, and
the trace arithmetic of the per-layer readers on a synthetic trace."""
from types import SimpleNamespace

import pytest

from perfbench import devtrace, flops, peaks, readers


def test_flash_call():
    # b=1, s=4, h=2, hkv=1, d=8: 10 causal pairs, 2 products of 2 flops
    # per multiply-add over d for each head; q, o (2 heads), k, v (1)
    c = flops.flash_call(1, 4, 2, 1, 8)
    assert c["flops"] == 4 * 2 * 8 * 10 == 640
    assert c["bytes"] == 2 * 4 * 8 * (2 + 2 + 1 + 1) == 384


DENSE = {"family": "dense", "n_layers": 2, "d_model": 4, "n_heads": 2,
         "kv_heads": 1, "head_dim": 2, "d_ff": 8, "vocab": 10, "moe": None}


def test_decode_step_and_prefill_of_a_dense_model():
    # per token and layer: q, o 4*4 each, k, v 4*2 each = 48; MLP 3*4*8
    per_row = 2 * 2 * (48 + 96) + 2 * 4 * 10
    attn = 4 * 2 * 2 * 2                       # per attended position
    assert flops.decode_flops(DENSE, [3, 5]) == 2 * per_row + attn * 8
    assert flops.prefill_flops(DENSE, 3) == (2 * 3 * 2 * (48 + 96)
                                             + 2 * 4 * 10
                                             + 2 * 4 * 2 * 2 * 6)


def test_moe_counts_only_the_active_experts():
    m = dict(DENSE, family="moe",
             moe={"n_experts": 4, "top_k": 2, "expert_ff": 3})
    ffn = 4 * 4 + 2 * 3 * 4 * 3                 # router + 2 experts
    assert flops.decode_flops(m, [1]) == (2 * 2 * (48 + ffn) + 2 * 4 * 10
                                          + 4 * 2 * 2 * 2)


SPANS = [("pb.window", 0, 100), ("pb.engine", 10, 90), ("pb.decode", 20, 50),
         ("pb.bookkeeping", 90, 95), ("pb.sleep", 95, 100)]
DEVICE = [("gemm", 25, 40), ("gemm", 35, 60), ("flash_fwd_mma", 70, 80),
          ("late", 120, 130)]


def test_trace_reduction():
    tr = devtrace.reduce(SPANS, DEVICE)
    assert tr.window_s == pytest.approx(100e-9)
    assert tr.busy_s == pytest.approx(45e-9)
    assert tr.kernels("flash_fwd") == (1, pytest.approx(10e-9))
    assert tr.idle_by_label == pytest.approx(
        {"engine_other": 35e-9, "harness": 20e-9})
    assert tr.top_ops()[0] == ["gemm", pytest.approx(40e-9)]


def test_roofline_reader_checks_the_launch_count():
    tr = devtrace.reduce(SPANS, DEVICE)
    call = flops.flash_call(1, 4, 2, 1, 8)
    ctx = SimpleNamespace(trace=tr, launches={"flash": 1})
    want = 100.0 * peaks.bound_s(call["flops"], call["bytes"]) / 10e-9
    assert readers.roofline(ctx, [("flash_fwd", "flash", [call])]) \
        == pytest.approx(want)
    ctx.launches["flash"] = 2
    assert readers.roofline(ctx, [("flash_fwd", "flash", [call])]) is None
    assert readers.roofline(ctx, [("flash_fwd", "flash", [])]) is None
    assert readers.idle_share(ctx) == pytest.approx(55.0)
