"""The port's kernel packages on the CPU (their plain versions) against the
JAX kernels in interpret mode, on the same inputs. The CUDA and Triton
kernels themselves are held against these plain versions on the card by
tests/test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro.kernels.rmsnorm.ops import fused_rmsnorm as jax_rmsnorm
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops

#: tests/test_kernels.py's tolerances
TOL = {"float32": dict(atol=2e-5, rtol=2e-4),
       "bfloat16": dict(atol=6e-2, rtol=6e-2)}


def _pair(rng, shape, dtype):
    """One numpy draw as a torch and a JAX array of ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            jnp.asarray(x).astype(dtype))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **TOL[dtype])


@pytest.mark.parametrize("b,s,h,hkv,d", [
    (2, 256, 4, 2, 64),
    (1, 512, 8, 2, 128),
    (2, 128, 4, 4, 32),
    (1, 256, 6, 1, 64),          # MQA extreme
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_pallas(b, s, h, hkv, d, dtype):
    rng = np.random.default_rng(0)
    (q, jq), (k, jk), (v, jv) = (_pair(rng, (b, s, n, d), dtype)
                                 for n in (h, hkv, hkv))
    want = jax_flash(jq, jk, jv, interpret=True)
    before = flash_ops.launches
    _close(flash_ops.flash_attention(q, k, v), want, dtype)
    _close(attention_ref(q, k, v), want, dtype)
    assert flash_ops.launches == before          # no kernel on the CPU


@pytest.mark.parametrize("block_q,block_kv", [(64, 64), (128, 64),
                                              (64, 128)])
def test_flash_attention_matches_pallas_block_shapes(block_q, block_kv):
    rng = np.random.default_rng(1)
    (q, jq), (k, jk), (v, jv) = (_pair(rng, (1, 256, n, 64), "float32")
                                 for n in (4, 2, 2))
    want = jax_flash(jq, jk, jv, block_q=block_q, block_kv=block_kv,
                     interpret=True)
    _close(flash_ops.flash_attention(q, k, v), want, "float32")


@pytest.mark.parametrize("sq", [37, 200])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_ragged_length(sq, dtype):
    """Any length, where the Pallas kernel needs whole blocks."""
    rng = np.random.default_rng(2)
    (q, jq), (k, jk), (v, jv) = (_pair(rng, (2, sq, n, 128), dtype)
                                 for n in (16, 8, 8))
    _close(flash_ops.flash_attention(q, k, v), jax_attention(jq, jk, jv),
           dtype)


@pytest.mark.parametrize("shape", [(2, 64, 128), (4, 100, 256), (512, 384),
                                   (1, 7, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_rmsnorm_matches_pallas(shape, dtype):
    rng = np.random.default_rng(4)
    (x, jx), (r, jr), (w, jw) = (_pair(rng, s, dtype)
                                 for s in (shape, shape, shape[-1:]))
    want_y, want_s = jax_rmsnorm(jx, jr, jw, interpret=True)
    before = rms_ops.launches
    y, s = rms_ops.fused_rmsnorm(x, r, w)
    assert rms_ops.launches == before
    assert y.dtype == s.dtype == x.dtype and y.shape == x.shape
    _close(y, want_y, dtype)
    _close(s, want_s, dtype)
