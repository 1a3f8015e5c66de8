"""The port's kernels on the card against their plain versions.

Needs a CUDA card (with nvcc and triton); skips without one. Imports no
JAX, so it runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import fused_rmsnorm_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import (ssd_inter_scan_ref,
                                              ssd_intra_ref, ssd_scan_ref)
from repro_torch.models.mamba2 import chunk_recurrence

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-4),
       torch.bfloat16: dict(atol=6e-2, rtol=6e-2)}
#: SSM states (tests/test_kernels.py::test_ssd_scan_sweep)
STATE_TOL = dict(atol=1e-3, rtol=1e-2)
#: the chunk cumsum against torch.cumsum
CUM_TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _normal(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
        device, dtype)


@pytest.mark.parametrize("b,sq,h,hkv,d", [
    (2, 256, 4, 2, 64), (1, 512, 8, 2, 128), (2, 128, 4, 4, 32),
    (1, 256, 6, 1, 64), (1, 37, 16, 8, 128), (4, 200, 16, 8, 128),
    (1, 1000, 16, 8, 128), (1, 512, 32, 32, 64),
    # whisper-tiny's decoder prefill (6/6, d=64) at its longest prompt, and
    # llama-3.2-vision's self layers (64/8, d=128: a GQA group of 8)
    (1, 448, 6, 6, 64), (1, 512, 64, 8, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, b, sq, h, hkv, d, dtype):
    rng = np.random.default_rng(0)
    q = _normal(rng, (b, sq, h, d), dtype, cuda)
    k = _normal(rng, (b, sq, hkv, d), dtype, cuda)
    v = _normal(rng, (b, sq, hkv, d), dtype, cuda)
    before = flash_ops.launches
    out = flash_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    ref = attention_ref(q, k, v)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **TOL[dtype])


def test_flash_kernel_takes_strided_views(cuda):
    """q/k/v sliced out of one fused projection (head_dim contiguous)."""
    rng = np.random.default_rng(1)
    qkv = _normal(rng, (2, 100, 16 + 8 + 8, 64), torch.float32, cuda)
    q, k, v = qkv[:, :, :16], qkv[:, :, 16:24], qkv[:, :, 24:]
    out = flash_ops.flash_attention(q, k, v)
    ref = attention_ref(q, k, v)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               **TOL[torch.float32])


@pytest.mark.parametrize("s", [1, 37, 64, 1000])
@pytest.mark.parametrize("h,hkv", [(16, 8), (16, 1), (32, 32)])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_flash_bf16_kernel_takes_strided_views(cuda, s, h, hkv, d):
    """The tensor-core route on q/k/v sliced out of one fused projection,
    ragged lengths and GQA, MQA and MHA head counts."""
    rng = np.random.default_rng(5)
    qkv = _normal(rng, (2, s, h + 2 * hkv, d), torch.bfloat16, cuda)
    q, k, v = qkv[:, :, :h], qkv[:, :, h:h + hkv], qkv[:, :, h + hkv:]
    before = flash_ops.launches
    out = flash_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1 and out.dtype == torch.bfloat16
    _close(out, attention_ref(q, k, v), TOL[torch.bfloat16])


@pytest.mark.parametrize("cut", ["start", "head_stride"])
def test_flash_bf16_kernel_rejects_misaligned_rows(cuda, cut):
    """A row that does not start on a 16-byte boundary raises; the wrapper
    never copies it into place."""
    width = 72 if cut == "start" else 68
    base = torch.zeros((1, 64, 4, width), dtype=torch.bfloat16, device=cuda)
    q = base[..., 4:68] if cut == "start" else base[..., :64]
    before = flash_ops.launches
    with pytest.raises(ValueError, match="16-byte"):
        flash_ops.flash_attention(q, q, q)
    assert flash_ops.launches == before


def test_flash_kernel_rejects_unsupported_head_dim(cuda):
    q = torch.zeros((1, 8, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_ops.flash_attention(q, q, q)


@pytest.mark.parametrize("shape", [(2, 64, 128), (4, 100, 256), (512, 384),
                                   (1, 7, 64), (2048, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    rng = np.random.default_rng(2)
    x = _normal(rng, shape, dtype, cuda)
    r = _normal(rng, shape, dtype, cuda)
    w = _normal(rng, shape[-1:], dtype, cuda)
    before = rms_ops.launches
    y, s = rms_ops.fused_rmsnorm(x, r, w)
    torch.cuda.synchronize()
    assert rms_ops.launches == before + 1
    yr, sr = fused_rmsnorm_ref(x, r, w)
    for got, want in ((y, yr), (s, sr)):
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **TOL[dtype])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), **tol)


def _scan_inputs(rng, b, s, h, p, n, dtype, device):
    """tests/test_kernels.py::test_ssd_scan_sweep's distributions."""
    xh, bm, cm = (_normal(rng, shape, dtype, device)
                  for shape in ((b, s, h, p), (b, s, n), (b, s, n)))
    dt = torch.nn.functional.softplus(
        _normal(rng, (b, s, h), torch.float32, device))
    log_a = -dt * torch.exp(_normal(rng, (b, s, h), torch.float32,
                                    device) * 0.3)
    return xh, bm, cm, log_a, dt


#: (b, s, h, p, n, chunk): tests/test_kernels.py's sweep, then zamba2's
#: full width over 4 chunks and one short prompt (q = s < chunk)
SSD_SHAPES = [(2, 128, 4, 32, 16, 32), (1, 256, 8, 64, 64, 128),
              (2, 64, 2, 16, 8, 16), (1, 512, 64, 64, 64, 128),
              (1, 77, 64, 64, 64, 128)]


def _chunked(xh, bm, cm, log_a, dt, chunk):
    b, s, h, p = xh.shape
    n = bm.shape[-1]
    q = min(chunk, s)
    c = s // q
    return (xh.reshape(b, c, q, h, p), bm.reshape(b, c, q, n),
            cm.reshape(b, c, q, n), log_a.reshape(b, c, q, h),
            dt.reshape(b, c, q, h))


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_passes_match_plain(cuda, b, s, h, p, n, chunk, dtype, with_h0):
    """Both passes against their plain versions. ``log_a`` lies on the
    2^-10 grid, where every cumsum is exact, so the intra outputs are
    compared on the pass's own arithmetic whatever the summation order.
    The inter pass runs the chunk recurrence itself: its last state equals
    ``chunk_recurrence``'s bit for bit, from zeros or from a given h0."""
    rng = np.random.default_rng(3)
    xh, bm, cm, log_a, dt = _scan_inputs(rng, b, s, h, p, n, dtype, cuda)
    log_a = torch.round(log_a * 1024) / 1024
    xc, bc, cc, la, dc = _chunked(xh, bm, cm, log_a, dt, chunk)
    cum = torch.cumsum(la, dim=2)
    before = ssd_ops.intra_launches
    got = ssd_ops.ssd_intra(xc, bc, cc, la, dc)
    torch.cuda.synchronize()
    assert ssd_ops.intra_launches == before + 1
    _close(got[3], cum, CUM_TOL)
    want = ssd_intra_ref(xc, bc, cc, cum, dc)
    for g, w, tol in zip(got, want, (TOL[torch.float32], STATE_TOL,
                                     TOL[torch.float32])):
        _close(g, w, tol)
    y_intra, s_chunk, dec, _ = got
    h0 = _normal(rng, (b, h, n, p), torch.float32, cuda) if with_h0 else None
    before = ssd_ops.inter_launches
    y, h_last = ssd_ops.ssd_inter(cc, cum, s_chunk, dec, y_intra, dtype, h0)
    torch.cuda.synchronize()
    assert ssd_ops.inter_launches == before + 1
    assert y.dtype == dtype and h_last.dtype == torch.float32
    assert torch.equal(h_last, chunk_recurrence(s_chunk, dec, h0)[1])
    want_y, _ = ssd_inter_scan_ref(cc, cum, s_chunk, dec, y_intra, dtype, h0)
    _close(y, want_y, TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_intra_cum_matches_torch_cumsum(cuda, dtype):
    """Unquantised ``log_a``: the kernel sums each chunk in index order in
    fp32, as torch.cumsum does along a non-innermost axis."""
    xh, bm, cm, log_a, dt = _scan_inputs(np.random.default_rng(6), 2, 512,
                                         64, 64, 64, dtype, cuda)
    xc, bc, cc, la, dc = _chunked(xh, bm, cm, log_a, dt, 128)
    _close(ssd_ops.ssd_intra(xc, bc, cc, la, dc)[3],
           torch.cumsum(la, dim=2), CUM_TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_scan_matches_plain(cuda, b, s, h, p, n, chunk, dtype, with_h0):
    rng = np.random.default_rng(4)
    xh, bm, cm, log_a, dt = _scan_inputs(rng, b, s, h, p, n, dtype, cuda)
    h0 = _normal(rng, (b, h, n, p), torch.float32, cuda) if with_h0 else None
    before = (ssd_ops.intra_launches, ssd_ops.inter_launches)
    y, hf = ssd_ops.ssd_scan(xh, bm, cm, log_a, dt, chunk=chunk, h0=h0)
    torch.cuda.synchronize()
    assert (ssd_ops.intra_launches, ssd_ops.inter_launches) == (
        before[0] + 1, before[1] + 1)
    # the chunked path on the inputs cast to fp32, the arithmetic of the
    # Pallas bodies: at bf16 the chunked path itself rounds C B^T to bf16
    yr, hr = ssd_scan_ref(xh.float(), bm.float(), cm.float(), log_a, dt,
                          chunk=chunk, h0=h0)
    assert y.dtype == dtype and hf.dtype == torch.float32
    _close(y, yr, TOL[dtype])
    _close(hf, hr, STATE_TOL)


@pytest.mark.parametrize("name", ["xh", "bm", "cm"])
def test_ssd_bf16_intra_rejects_misaligned_input(cuda, name):
    """A contiguous bf16 input that starts 8 bytes off a 16-byte boundary
    raises; the wrapper never copies it into place."""
    shapes = dict(xh=(1, 1, 64, 4, 32), bm=(1, 1, 64, 16), cm=(1, 1, 64, 16))
    ins = {k: torch.zeros(v, dtype=torch.bfloat16, device=cuda)
           for k, v in shapes.items()}
    n = ins[name].numel()
    ins[name] = torch.zeros(n + 4, dtype=torch.bfloat16,
                            device=cuda)[4:].view(shapes[name])
    la = torch.zeros((1, 1, 64, 4), device=cuda)
    before = ssd_ops.intra_launches
    with pytest.raises(ValueError, match="16-byte"):
        ssd_ops.ssd_intra(ins["xh"], ins["bm"], ins["cm"], la, la)
    assert ssd_ops.intra_launches == before


@pytest.mark.parametrize("name", ["cm", "s_chunk", "y_intra"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_inter_rejects_misaligned_input(cuda, name, dtype):
    """An input the inter pass copies in 16-byte pieces that starts off a
    16-byte boundary raises; the wrapper never copies it into place."""
    b, c, q, h, p, n = 1, 2, 64, 4, 32, 16
    shapes = dict(cm=(b, c, q, n), s_chunk=(b, c, h, n, p),
                  y_intra=(b, c, q, h, p))
    ins = {k: torch.zeros(v, dtype=dtype if k == "cm" else torch.float32,
                          device=cuda) for k, v in shapes.items()}
    t = ins[name]
    ins[name] = torch.zeros(t.numel() + 4, dtype=t.dtype,
                            device=cuda)[2:2 + t.numel()].view(t.shape)
    cum = torch.zeros((b, c, q, h), device=cuda)
    dec = torch.ones((b, c, h), device=cuda)
    before = ssd_ops.inter_launches
    with pytest.raises(ValueError, match="16-byte"):
        ssd_ops.ssd_inter(ins["cm"], cum, ins["s_chunk"], dec, ins["y_intra"],
                          dtype)
    assert ssd_ops.inter_launches == before


@pytest.mark.parametrize("b,c,q,h,p,n", [(1, 1, 256, 4, 64, 64),
                                         (1, 2, 32, 4, 48, 16),
                                         (1, 2, 32, 4, 32, 64)])
def test_ssd_kernels_reject_unsupported_shapes(cuda, b, c, q, h, p, n):
    xh = torch.zeros((b, c, q, h, p), device=cuda)
    bm = torch.zeros((b, c, q, n), device=cuda)
    cum = torch.zeros((b, c, q, h), device=cuda)
    with pytest.raises(ValueError, match="SSD kernels take"):
        ssd_ops.ssd_intra(xh, bm, bm, cum, cum)
    with pytest.raises(ValueError, match="SSD kernels take"):
        ssd_ops.ssd_inter(bm, cum, torch.zeros((b, c, h, n, p), device=cuda),
                          torch.zeros((b, c, h), device=cuda), xh,
                          torch.float32)


# --------------------------------------------------------------------------
# no kernel has a backward pass: the entry points refuse autograd
# --------------------------------------------------------------------------

def _refused_calls(cuda):
    """Each kernel entry point on CUDA inputs, one of which requires grad;
    returns {name: (call, launch counter)}."""
    rng = np.random.default_rng(9)
    q = _normal(rng, (1, 64, 4, 64), torch.bfloat16, cuda)
    x, r = (_normal(rng, (4, 256), torch.bfloat16, cuda) for _ in range(2))
    w = _normal(rng, (256,), torch.bfloat16, cuda)
    b, c, qn, h, p, n = 1, 2, 64, 4, 64, 64
    xh = _normal(rng, (b, c * qn, h, p), torch.float32, cuda)
    bm, cm = (_normal(rng, (b, c * qn, n), torch.float32, cuda)
              for _ in range(2))
    dt = torch.nn.functional.softplus(
        _normal(rng, (b, c * qn, h), torch.float32, cuda))
    log_a = -dt * 0.5
    chunk = lambda t: t.reshape(b, c, qn, *t.shape[2:])
    with torch.no_grad():
        y_intra, s_chunk, dec, cum = ssd_ops.ssd_intra(
            chunk(xh), chunk(bm), chunk(cm), chunk(log_a), chunk(dt))
    for t in (q, w, xh, s_chunk):
        t.requires_grad_(True)
    return {
        "flash_attention": (lambda: flash_ops.flash_attention(q, q, q),
                            lambda: flash_ops.launches),
        "fused_rmsnorm": (lambda: rms_ops.fused_rmsnorm(x, r, w),
                          lambda: rms_ops.launches),
        "ssd_scan": (lambda: ssd_ops.ssd_scan(xh, bm, cm, log_a, dt,
                                              chunk=qn),
                     lambda: ssd_ops.intra_launches),
        "ssd_intra": (lambda: ssd_ops.ssd_intra(
            chunk(xh), chunk(bm), chunk(cm), chunk(log_a), chunk(dt)),
                      lambda: ssd_ops.intra_launches),
        "ssd_inter": (lambda: ssd_ops.ssd_inter(
            chunk(cm), cum, s_chunk, dec, y_intra, torch.float32),
                      lambda: ssd_ops.inter_launches)}


@pytest.mark.parametrize("name", ["flash_attention", "fused_rmsnorm",
                                  "ssd_scan", "ssd_intra", "ssd_inter"])
def test_kernel_entry_points_refuse_autograd(cuda, name):
    """Under grad, with an input that requires grad, the call raises and
    launches nothing; under no_grad the same call launches its kernel."""
    call, count = _refused_calls(cuda)[name]
    before = count()
    with pytest.raises(ValueError, match="use_ssm_kernel=False"):
        call()
    assert count() == before
    with torch.no_grad():
        call()
    torch.cuda.synchronize()
    assert count() == before + 1


def test_train_step_on_the_card_matches_cpu(cuda):
    """One reduced qwen3-0.6b step (fp32, remat "dots") on the card and on
    the CPU from the same state and batch: loss and grad_norm at the
    reference's gradient tolerance, params within 2 lr (+1e-6), as Adam's
    first step moves every element by about +-lr."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import tree_leaves, tree_map
    from repro_torch.training import (AdamWConfig, SyntheticDataset,
                                      adamw_init, make_train_step)
    lr = 1e-3
    out = {}
    for device in ("cpu", cuda):
        model = Model(reduced_config("qwen3-0.6b", n_layers=2,
                                     remat="dots"), device=device)
        params = tree_map(lambda t: t.to(device),
                          Model(model.cfg, device="cpu").init(seed=0))
        ds = SyntheticDataset(vocab=model.cfg.vocab, seq_len=16,
                              global_batch=8, device=device)
        step = make_train_step(model, AdamWConfig(lr=lr))
        out[str(device)] = step(adamw_init(params), ds.batch_at(0))
    (cpu_state, cpu_m), (gpu_state, gpu_m) = out["cpu"], out["cuda"]
    assert gpu_state["step"].is_cuda and int(gpu_state["step"]) == 1
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(gpu_m[k]), float(cpu_m[k]),
                                   atol=1e-5, rtol=1e-4)
    for a, b in zip(tree_leaves(gpu_state["params"]),
                    tree_leaves(cpu_state["params"])):
        assert float((a.cpu() - b).abs().max()) <= 2 * lr + 1e-6


# --------------------------------------------------------------------------
# the MoE family and the int8 KV cache on the card
# --------------------------------------------------------------------------

#: model forward (tests/test_kernels.py) and prefill / decode
#: (tests/test_serving.py)
MODEL_TOL = dict(atol=2e-4, rtol=2e-3)
DEC_TOL = dict(atol=2e-3, rtol=2e-2)


def _on_both(arch, cuda, **overrides):
    """A reduced model on the CPU and on the card, with the same weights."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import tree_map
    cfg = reduced_config(arch, **overrides)
    cpu = Model(cfg, device="cpu")
    params = cpu.init(seed=0)
    return cpu, params, Model(cfg, device=cuda), tree_map(
        lambda t: t.to(cuda), params)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_reduced_moe_on_the_card_matches_cpu(cuda, arch, impl):
    """Forward logits and aux, prefill and decode of a reduced MoE model
    (fp32, default capacity: tokens are dropped) on the card against the
    same model on the CPU, where the kernel route runs its plain version."""
    cpu, params, gpu, gparams = _on_both(arch, cuda, attn_impl=impl)
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(0, cpu.cfg.vocab, (2, 64)))
    want, want_aux = cpu.forward(params, {"tokens": tokens})
    got, aux = gpu.forward(gparams, {"tokens": tokens.to(cuda)})
    _close(got, want, MODEL_TOL)
    _close(aux, want_aux, MODEL_TOL)
    want, cache = cpu.prefill(params, {"tokens": tokens[:, :60]},
                              max_len=64)
    got, gcache = gpu.prefill(gparams, {"tokens": tokens[:, :60].to(cuda)},
                              max_len=64)
    _close(got, want, DEC_TOL)
    for i in range(60, 64):
        want, cache = cpu.decode_step(params, cache, tokens[:, i:i + 1])
        got, gcache = gpu.decode_step(gparams, gcache,
                                      tokens[:, i:i + 1].to(cuda))
        _close(got, want, DEC_TOL)


@pytest.mark.parametrize("dispatch", ["global", "grouped"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_dispatch_and_its_backward_repeat_bit_for_bit(cuda, dispatch,
                                                          dtype):
    """granite's routing (40 experts, top 8, renormalised) at d = 256 over
    512 tokens, twice: the scatter back to tokens and the gather's
    backward sum each row in a fixed order, so output and gradients are
    equal bit for bit."""
    from repro_torch.models import moe
    cfg = moe.MoEConfig(n_experts=40, top_k=8, expert_ff=128,
                        norm_topk=True, dispatch=dispatch)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = moe.make_moe_params(gen, 256, cfg, dtype, cuda)
    x = torch.randn((2, 256, 256), generator=gen, device=cuda).to(dtype)
    runs = []
    for _ in range(2):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        xg = x.detach().requires_grad_()
        out, aux = moe.apply_moe(leaves, xg, cfg)
        grads = torch.autograd.grad(out.float().square().sum() + aux,
                                    [xg, *leaves.values()])
        runs.append((out, aux, *grads))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert bool(torch.isfinite(runs[0][0]).all())


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "granite-moe-3b-a800m"])
def test_int8_decode_on_the_card_matches_cpu(cuda, arch):
    """The int8 cache on the card: prefill caches at most 1 LSB from the
    CPU's, decode logits at the decode tolerance."""
    cpu, params, gpu, gparams = _on_both(arch, cuda, kv_cache_quant=True)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cpu.cfg.vocab, (2, 40)))
    want, cache = cpu.prefill(params, {"tokens": tokens[:, :32]}, max_len=48)
    got, gcache = gpu.prefill(gparams, {"tokens": tokens[:, :32].to(cuda)},
                              max_len=48)
    _close(got, want, DEC_TOL)
    for name in ("k", "v"):
        assert gcache["layers"][name].dtype == torch.int8
        diff = gcache["layers"][name].cpu().int() - cache["layers"][name].int()
        assert int(diff.abs().max()) <= 1, name
    for i in range(32, 40):
        want, cache = cpu.decode_step(params, cache, tokens[:, i:i + 1])
        got, gcache = gpu.decode_step(gparams, gcache,
                                      tokens[:, i:i + 1].to(cuda))
        _close(got, want, DEC_TOL)


# --------------------------------------------------------------------------
# the xLSTM, whisper and llama-vision families on the card
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["xlstm-350m", "whisper-tiny",
                                  "llama-3.2-vision-90b"])
@pytest.mark.parametrize("impl", ["plain", "kernel"])
def test_reduced_new_family_on_the_card_matches_cpu(cuda, arch, impl):
    """Forward logits, prefill and decode of a reduced model (fp32) on the
    card against the same model on the CPU; the vision model's gates set
    to 0.5 and -0.75 (at init they are 0, and the cross path would add
    nothing), the audio / vision stub input drawn from a seed."""
    cpu, params, gpu, gparams = _on_both(arch, cuda, attn_impl=impl)
    if "segments" in params:
        for tree in (params, gparams):
            tree["segments"]["cross"]["gate_attn"].fill_(0.5)
            tree["segments"]["cross"]["gate_mlp"].fill_(-0.75)
    cfg = cpu.cfg
    rng = np.random.default_rng(8)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)))
    extra = {}
    name = {"audio": "frames", "vlm": "patches"}.get(cfg.family)
    if name is not None:
        extra[name] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
    on = lambda batch, dev: {k: v.to(dev) for k, v in batch.items()}
    want, _ = cpu.forward(params, {"tokens": tokens, **extra})
    got, _ = gpu.forward(gparams, on({"tokens": tokens, **extra}, cuda))
    _close(got, want, MODEL_TOL)
    batch = {"tokens": tokens[:, :60], **extra}
    want, cache = cpu.prefill(params, batch, max_len=64)
    got, gcache = gpu.prefill(gparams, on(batch, cuda), max_len=64)
    _close(got, want, DEC_TOL)
    for i in range(60, 64):
        want, cache = cpu.decode_step(params, cache, tokens[:, i:i + 1])
        got, gcache = gpu.decode_step(gparams, gcache,
                                      tokens[:, i:i + 1].to(cuda))
        _close(got, want, DEC_TOL)


# --------------------------------------------------------------------------
# distribution: the sharded train step on a one-rank NCCL mesh
# --------------------------------------------------------------------------

def test_sharded_train_step_on_a_one_rank_nccl_mesh(cuda):
    """build_train_step's step of a reduced qwen3-0.6b (fp32, remat
    "dots") on a (data=1, model=1) mesh of a one-rank NCCL group against
    the plain step on the card from the same state and batch, at the
    reference's sharded-step tolerances; the new state stays DTensors
    placed as the old."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import reduced_config
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import Model
    from repro_torch.models.transformer import tree_leaves
    from repro_torch.training import (AdamWConfig, SyntheticDataset,
                                      adamw_init, make_train_step)
    cfg = reduced_config("qwen3-0.6b", n_layers=2, remat="dots")
    opt = AdamWConfig(lr=1e-3)
    model = Model(cfg, device=cuda)
    state0 = adamw_init(model.init(seed=0))
    batch = SyntheticDataset(vocab=cfg.vocab, seq_len=16, global_batch=8,
                             device=cuda).batch_at(0)
    ref_state, ref_m = make_train_step(model, opt)(state0, batch)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1),
                                mesh_dim_names=("data", "model"))
        bundle = build_train_step(cfg, Shape("t", 16, 8, "train"), mesh,
                                  opt_cfg=opt)
        state, dbatch = bundle.place(state0, batch)
        new, m = bundle.step(state, dbatch)
        np.testing.assert_allclose(float(m["loss"].full_tensor()),
                                   float(ref_m["loss"]), rtol=1e-4)
        for a, b, s in zip(tree_leaves(new), tree_leaves(ref_state),
                           tree_leaves(state)):
            assert isinstance(a, DTensor) and a.placements == s.placements
            np.testing.assert_allclose(a.full_tensor().cpu().numpy(),
                                       b.cpu().numpy(), atol=1e-4,
                                       rtol=1e-3)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# distribution, serving side: the kernel routes on local shards
# --------------------------------------------------------------------------

@pytest.fixture
def one_rank_mesh(cuda):
    """A (data=1, model=1) mesh of a one-rank NCCL group, destroyed
    after the test."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cuda", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _on_mesh(t, mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor
    return distribute_tensor(t, mesh, [Replicate(), Replicate()])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_route_on_a_local_shard_is_the_unsharded_launch(
        one_rank_mesh, dtype):
    """sdpa's kernel route on DTensors runs the kernel once, through
    per_shard on the local shards, and gives the unsharded launch's
    output bit for bit."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.attention import sdpa
    rng = np.random.default_rng(0)
    q = _normal(rng, (2, 512, 16, 128), dtype, "cuda")
    k = _normal(rng, (2, 512, 8, 128), dtype, "cuda")
    v = _normal(rng, (2, 512, 8, 128), dtype, "cuda")
    want = flash_ops.flash_attention(q, k, v)
    before = flash_ops.launches
    got = sdpa(*(_on_mesh(t, one_rank_mesh) for t in (q, k, v)),
               causal=True, impl="kernel")
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    assert isinstance(got, DTensor)
    assert torch.equal(got.full_tensor(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_route_on_a_local_shard_is_the_unsharded_launch(
        one_rank_mesh, dtype):
    """A Mamba2 block's kernel route (zamba2's head shape, 2 x 256
    tokens) on DTensor params and input runs each SSD pass once, through
    per_shard on the local shards, and gives the unsharded call's output
    bit for bit."""
    from repro_torch.models import mamba2 as m2
    cfg = m2.SSMConfig(state=64, head_dim=64, expand=2, conv_kernel=4,
                       chunk=128)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = m2.make_mamba2_params(gen, 512, cfg, dtype, torch.device("cuda"))
    x = torch.randn((2, 256, 512), generator=gen, device="cuda").to(dtype)
    with torch.no_grad():
        want = m2.apply_mamba2(params, x, cfg, use_kernel=True)
        before = (ssd_ops.intra_launches, ssd_ops.inter_launches)
        got = m2.apply_mamba2(
            {k: _on_mesh(t, one_rank_mesh) for k, t in params.items()},
            _on_mesh(x, one_rank_mesh), cfg, use_kernel=True)
        torch.cuda.synchronize()
    assert (ssd_ops.intra_launches, ssd_ops.inter_launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(got.full_tensor(), want)


def test_campaign_on_the_card_matches_cpu(cuda, monkeypatch):
    """A reduced portfolio campaign (4 workflows of size 6, aarc and
    maff) with its replays swept on the card gives the rows of the same
    campaign swept on the CPU, every replay one card sweep."""
    from repro_torch.core import engine as engine_mod
    from repro_torch.core.campaign import (CampaignSpec, PortfolioSpec,
                                           ReplaySpec, run_campaign)
    spec = CampaignSpec(
        portfolio=PortfolioSpec(n_workflows=4, size=6,
                                slo_slacks=(1.5, 2.5)),
        replay=ReplaySpec(n_instances=24, rate=0.2),
        searchers=("aarc", "maff"),
        searcher_kwargs={"aarc": {"batch_size": 4}}, seed=11)
    sweeps = []
    real = engine_mod.fast_plane_sweep

    def counted(*args, device=None, **kw):
        sweeps.append(device)
        return real(*args, device=device, **kw)

    monkeypatch.setattr(engine_mod, "fast_plane_sweep", counted)
    card = run_campaign(spec)
    assert sweeps == [None] * len(card.results)
    cpu = run_campaign(spec, device="cpu")

    def rows(report):
        return [{k: v for k, v in row.items() if k != "wall_time_s"}
                for row in report.to_rows()]

    assert rows(card) == rows(cpu)


def test_online_run_on_the_card_matches_cpu(cuda, monkeypatch):
    """A reduced input-mix online run (2 workflows, 4 epochs, drift at
    epoch 2) on the card: its deploy replays and challenger validations
    sweep there, and its payload equals the same run swept on the CPU."""
    from repro_torch.core import engine as engine_mod
    from repro_torch.core.campaign import PortfolioSpec, ReplaySpec
    from repro_torch.core.online import OnlineSpec, run_online
    from repro_torch.serverless.generator import input_mix_schedule
    spec = OnlineSpec(
        portfolio=PortfolioSpec(n_workflows=2, size=6, slo_slacks=(2.0,)),
        replay=ReplaySpec(n_instances=16, rate=0.5), n_epochs=4,
        drift=input_mix_schedule(2, 1.5), seed=0, total_budget=128)
    sweeps = []
    real = engine_mod.fast_plane_sweep

    def counted(*args, device=None, **kw):
        sweeps.append(device)
        return real(*args, device=device, **kw)

    monkeypatch.setattr(engine_mod, "fast_plane_sweep", counted)
    card = run_online(spec)
    assert len(sweeps) > 1 and set(sweeps) == {None}
    monkeypatch.setattr(engine_mod, "fast_plane_sweep", real)
    assert card.to_payload() == run_online(spec, device="cpu").to_payload()
