"""The decode-attention roofline readers on hand-made traces: the bound of
the decode steps' rows over the decode_attn kernels' device time, and
nothing where the trace does not hold two kernels per attention layer and
step (the parent's trace holds none)."""
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench import decode_attn, devtrace, peaks, spec

BENCH = Path(__file__).resolve().parents[1]
MODEL = {"n_layers": 3, "n_heads": 24, "kv_heads": 8, "head_dim": 64,
         "layer_types": ["mamba", "attention", "mamba"]}
DECODES = [[100, 2000], [101, 2001]]


def _ctx(n_kernels, decodes=DECODES, model=MODEL):
    """A 1 ms window holding ``n_kernels`` decode_attn kernels of 10 us
    each, alternately partial and merge, and a GEMM."""
    names = ["void decode_attn_partial<bf16, 64, 4>(...)",
             "void decode_attn_merge<bf16, 64>(...)"]
    dev = [(names[i % 2], 20_000 * i, 20_000 * i + 10_000)
           for i in range(n_kernels)] + [("gemm", 5_000, 9_000)]
    tr = devtrace.reduce([("pb.window", 0, 1_000_000)], dev)
    return SimpleNamespace(trace=tr, decodes=decodes, model=model)


def test_row_bound_is_the_live_rows_bytes():
    """Each row reads its ctx positions of K and V for 8 kv heads of 64 and
    its q and output in bf16: bytes bound it, far below 295 FLOP/byte."""
    nbytes = 2 * (2 * 1000 * 8 * 64 + 2 * 24 * 64)
    assert decode_attn.row_bound_s(MODEL, 1000) == pytest.approx(
        nbytes / peaks.HBM_BYTES_PER_S)


@pytest.mark.parametrize("reader,n_attn", [
    ("decode_attention_roofline.chat", 3),
    ("decode_attention_roofline.hchat", 1)])
def test_reader_reads_the_bound_over_the_kernels_time(reader, n_attn):
    """Every layer attends in the chat cell's decoder, the attention
    layers of ``layer_types`` alone in the hybrid's; a step's worth of
    kernels more or fewer (the sub-window's edges) still reads."""
    read = spec.reader(BENCH, reader)
    want_n = 2 * n_attn * len(DECODES)
    bound = n_attn * sum(decode_attn.row_bound_s(MODEL, c)
                         for step in DECODES for c in step)
    for n in (want_n - 2 * n_attn, want_n, want_n + 2 * n_attn):
        assert read(_ctx(n)) == pytest.approx(100.0 * bound / (n * 10e-6))


@pytest.mark.parametrize("n", [0, 5, 20])
def test_reader_reads_nothing_without_the_kernels(n, capsys):
    """The parent (no decode_attn kernel), or a count off by more than a
    step's worth, reads None with a line on standard error."""
    read = spec.reader(BENCH, "decode_attention_roofline.chat")
    assert read(_ctx(n)) is None
    assert "decode_attention_roofline" in capsys.readouterr().err


def test_reader_reads_nothing_without_decode_steps():
    read = spec.reader(BENCH, "decode_attention_roofline.chat")
    assert read(_ctx(12, decodes=[])) is None
    assert read(SimpleNamespace(trace=None, decodes=DECODES,
                                model=MODEL)) is None
