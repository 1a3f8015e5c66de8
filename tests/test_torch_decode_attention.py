"""The decode-attention entry point and its route on the CPU: the plain
version is the model's plain decode attention bit for bit, ignores what
the cache holds past each slot's length, and the decoder block's decode
step takes it exactly where the kernel route applies. The kernel itself
is held to the plain version on the card (tests/test_torch_cuda.py)."""
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
from _torch_ranks import run_ranks

from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.models import transformer as tf
from repro_torch.models.moe import MoEConfig

SRC = Path(__file__).resolve().parents[1] / "src"
#: the two cells' attention: granite-moe-3b (24/8, d 64) and granite-4.0-h
#: (32/8, d 128, scores scaled by 1/128)
HEADS = [(24, 8, 64, None), (32, 8, 128, 1 / 128)]
DTYPES = [torch.float32, torch.bfloat16]
#: cache depth; slot lengths at the start, in the middle, at the last row
#: and past the end (an idle slot, which reads all S rows)
S = 40
LENGTHS = [0, 17, S - 1, S + 3]


def _block(h, hkv, d, scale, impl, moe=False):
    return tf.BlockConfig(
        d_model=96, n_heads=h, kv_heads=hkv, head_dim=d, d_ff=64,
        attn_impl=impl, attn_scale=scale,
        moe=MoEConfig(n_experts=4, top_k=2, expert_ff=32) if moe else None)


def _qkv(gen, h, hkv, d, dtype, b=len(LENGTHS)):
    q = torch.randn((b, 1, h, d), generator=gen).to(dtype)
    k = torch.randn((b, S, hkv, d), generator=gen).to(dtype)
    v = torch.randn((b, S, hkv, d), generator=gen).to(dtype)
    return q, k, v, torch.tensor(LENGTHS[:b], dtype=torch.int32)


@pytest.mark.parametrize("h,hkv,d,scale", HEADS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quantized", [False, True])
def test_kernel_route_decodes_as_the_plain_route(h, hkv, d, scale, dtype,
                                                 quantized):
    """decode_decoder_block with attn_impl="kernel" on the CPU gives the
    plain route's output and cache bit for bit (an int8 cache takes the
    plain route on both)."""
    cfgs = [_block(h, hkv, d, scale, impl) for impl in ("plain", "kernel")]
    gen = torch.Generator().manual_seed(0)
    params = tf.make_decoder_block(gen, cfgs[0], dtype, "cpu")
    x = torch.randn((len(LENGTHS), 1, 96), generator=gen).to(dtype)
    rows = torch.randn((len(LENGTHS), S, hkv, d), generator=gen).to(dtype)
    length = torch.tensor(LENGTHS, dtype=torch.int32)
    outs = []
    for cfg in cfgs:
        cache = tf.init_block_cache(len(LENGTHS), S, cfg, dtype, "cpu",
                                    quantized=quantized)
        if not quantized:       # earlier rows, and stale ones past length
            cache["k"].copy_(rows)
            cache["v"].copy_(rows.flip(1))
        with torch.no_grad():
            outs.append(tf.decode_decoder_block(params, x, cache, length,
                                                cfg))
    (want, want_cache), (got, got_cache) = outs
    assert torch.equal(got, want)
    assert all(torch.equal(got_cache[n], want_cache[n]) for n in want_cache)


@pytest.mark.parametrize("impl,quantized,called", [
    ("kernel", False, True), ("plain", False, False),
    ("kernel", True, False)])
def test_decode_takes_the_entry_point_where_the_kernel_route_applies(
        monkeypatch, impl, quantized, called):
    """attn_impl="kernel" on an unquantized cache calls the decode-attention
    entry point once per block step; the plain route and the int8 cache
    (dequantized whole, as in the reference) do not call it."""
    calls = []
    real = tf.decode_ops.decode_attention
    monkeypatch.setattr(tf.decode_ops, "decode_attention",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    cfg = _block(24, 8, 64, None, impl, moe=True)
    gen = torch.Generator().manual_seed(1)
    params = tf.make_decoder_block(gen, cfg, torch.float32, "cpu")
    cache = tf.init_block_cache(2, S, cfg, torch.float32, "cpu",
                                quantized=quantized)
    x = torch.randn((2, 1, 96), generator=gen)
    with torch.no_grad():
        tf.decode_decoder_block(params, x, cache,
                                torch.tensor([3, 9], dtype=torch.int32), cfg)
    assert len(calls) == int(called)
    if called:
        q, k, v, length = calls[0]
        assert k is cache["k"] and v is cache["v"]     # read in place


@pytest.mark.parametrize("h,hkv,d,scale", HEADS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("poison", [math.nan, 1e4])
def test_plain_version_ignores_rows_past_length(h, hkv, d, scale, dtype,
                                                poison):
    """What the cache holds past each slot's length (NaN, or 1e4) does not
    reach the output: it equals that of the clean cache bit for bit, at
    lengths 0, mid, S - 1 and past the end."""
    q, k, v, length = _qkv(torch.Generator().manual_seed(2), h, hkv, d,
                           dtype)
    want = decode_attention_ref(q, k, v, length, scale=scale)
    k2, v2 = k.clone(), v.clone()
    for r, n in enumerate(LENGTHS):
        k2[r, n + 1:] = poison
        v2[r, n + 1:] = poison
    assert not torch.equal(k2, k)
    got = dec_ops.decode_attention(q, k2, v2, length, scale=scale)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_plain_version_attends_the_live_rows_alone():
    """Slot r's output is plain softmax attention over rows 0 ..
    min(length[r], S - 1) alone, each q head over its kv head (group 3)."""
    q, k, v, length = _qkv(torch.Generator().manual_seed(3), 6, 2, 32,
                           torch.float64)
    out = decode_attention_ref(q, k, v, length)
    for r, n in enumerate(LENGTHS):
        live = min(n, S - 1) + 1
        for ih in range(6):
            kr, vr = k[r, :live, ih // 3], v[r, :live, ih // 3]
            p = torch.softmax(kr @ q[r, 0, ih] / math.sqrt(32), dim=0)
            torch.testing.assert_close(out[r, 0, ih], p @ vr)


def test_entry_point_refuses_autograd_and_takes_meta_tensors():
    """Under grad an input that requires grad is refused; a meta tensor
    (the dry run's) takes the plain version; the CPU never launches."""
    q, k, v, length = _qkv(torch.Generator().manual_seed(4), 24, 8, 64,
                           torch.float32)
    before = dec_ops.launches
    with pytest.raises(ValueError, match="decode_attention: .*no backward"):
        dec_ops.decode_attention(q.requires_grad_(), k, v, length)
    m = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
    out = dec_ops.decode_attention(m(q), m(k), m(v), m(length))
    assert out.device.type == "meta" and out.shape == q.shape
    assert dec_ops.launches == before


_REFUSE = """
    import pytest
    from torch.distributed.tensor import distribute_tensor, Replicate
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.kernels.decode_attention import ops as dec_ops
    mesh = make_test_mesh((2,), ("model",), device_type="cpu")
    d = lambda t: distribute_tensor(t, mesh, [Replicate()])
    q, k, v = (torch.randn(2, n, 2, 32) for n in (1, 8, 8))
    length = torch.tensor([3, 7], dtype=torch.int32)
    for args in ((d(q), k, v, length), (q, d(k), v, length),
                 (q, k, v, d(length))):
        with pytest.raises(ValueError,
                           match="decode_attention: takes plain tensors"):
            dec_ops.decode_attention(*args)
    assert dec_ops.launches == 0
"""


def test_entry_point_refuses_dtensors(tmp_path):
    """A DTensor among q, k, v or length is refused by name: on a mesh the
    call belongs on each rank's local shards."""
    run_ranks(_REFUSE, 2, tmp_path, timeout=120)


def test_import_and_plain_calls_need_no_nvcc():
    """The module imports, and its plain version runs, in a process whose
    PATH holds no nvcc and where no CUDA toolkit is read: the library is
    built only at a kernel's first launch."""
    code = (
        "import torch\n"
        "from repro_torch.kernels import _build\n"
        "from repro_torch.kernels.decode_attention import kernel, ops\n"
        "_build.load = None\n"
        "q, k, v = (torch.randn(2, n, 4, 32) for n in (1, 8, 8))\n"
        "out = ops.decode_attention(q, k, v, torch.tensor([2, 9], "
        "dtype=torch.int32))\n"
        "assert out.shape == (2, 1, 4, 32)\n"
        "assert kernel._lib.cache_info().currsize == 0\n")
    env = dict(os.environ, PYTHONPATH=str(SRC), PATH=os.path.dirname(
        sys.executable), CUDA_HOME="/nonexistent")
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
