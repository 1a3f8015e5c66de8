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
from repro_torch.kernels.ssd_scan.ref import (ssd_inter_ref, ssd_intra_ref,
                                              ssd_scan_ref)

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-4),
       torch.bfloat16: dict(atol=6e-2, rtol=6e-2)}
#: SSM states (tests/test_kernels.py::test_ssd_scan_sweep)
STATE_TOL = dict(atol=1e-3, rtol=1e-2)


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
    (1, 1000, 16, 8, 128), (1, 512, 32, 32, 64)])
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


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_passes_match_plain(cuda, b, s, h, p, n, chunk, dtype):
    rng = np.random.default_rng(3)
    xh, bm, cm, log_a, dt = _scan_inputs(rng, b, s, h, p, n, dtype, cuda)
    q = min(chunk, s)
    c = s // q
    xc = xh.reshape(b, c, q, h, p)
    bc, cc = (t.reshape(b, c, q, n) for t in (bm, cm))
    dc = dt.reshape(b, c, q, h)
    cum = torch.cumsum(log_a.reshape(b, c, q, h), dim=2)
    before = ssd_ops.intra_launches
    got = ssd_ops.ssd_intra(xc, bc, cc, cum, dc)
    torch.cuda.synchronize()
    assert ssd_ops.intra_launches == before + 1
    want = ssd_intra_ref(xc, bc, cc, cum, dc)
    for g, w, tol in zip(got, want, (TOL[torch.float32], STATE_TOL,
                                     TOL[torch.float32])):
        _close(g, w, tol)
    hprev = _normal(rng, (b, c, h, n, p), torch.float32, cuda)
    before = ssd_ops.inter_launches
    y = ssd_ops.ssd_inter(cc, cum, hprev, got[0], dtype)
    torch.cuda.synchronize()
    assert ssd_ops.inter_launches == before + 1 and y.dtype == dtype
    _close(y, ssd_inter_ref(cc, cum, hprev, got[0], dtype), TOL[dtype])


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_matches_plain(cuda, b, s, h, p, n, chunk, dtype):
    xh, bm, cm, log_a, dt = _scan_inputs(np.random.default_rng(4), b, s, h,
                                         p, n, dtype, cuda)
    before = (ssd_ops.intra_launches, ssd_ops.inter_launches)
    y, hf = ssd_ops.ssd_scan(xh, bm, cm, log_a, dt, chunk=chunk)
    torch.cuda.synchronize()
    assert (ssd_ops.intra_launches, ssd_ops.inter_launches) == (
        before[0] + 1, before[1] + 1)
    # the chunked path on the inputs cast to fp32, the arithmetic of the
    # Pallas bodies: at bf16 the chunked path itself rounds C B^T to bf16
    yr, hr = ssd_scan_ref(xh.float(), bm.float(), cm.float(), log_a, dt,
                          chunk=chunk)
    assert y.dtype == dtype and hf.dtype == torch.float32
    _close(y, yr, TOL[dtype])
    _close(hf, hr, STATE_TOL)


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
                          xh, torch.float32)
