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

TOL = {torch.float32: dict(atol=2e-5, rtol=2e-4),
       torch.bfloat16: dict(atol=6e-2, rtol=6e-2)}


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
    (1, 1000, 16, 8, 128)])
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
