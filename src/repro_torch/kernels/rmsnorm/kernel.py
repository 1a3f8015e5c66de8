"""Fused residual-add + RMSNorm in Triton.

Replaces the TPU Pallas kernel repro/kernels/rmsnorm/kernel.py
(_rmsnorm_kernel, launched by fused_rmsnorm_2d). One program normalises
a block of rows: it reads x, the residual and w once, sums and reduces
in fp32 in registers, and writes the normed rows and the new residual
once. It is bound by those bytes (about 5 row-widths per row moved
against a few flops per element); the design keeps every intermediate
out of device memory and lets the row count be anything (the ragged
last block is masked), where the TPU kernel needed row blocks that
divide the rows.

Triton is imported on the first launch, never when this module is
imported: machines without a GPU import the package too.
"""
from __future__ import annotations

import functools

import torch

#: bound to ``triton.language`` by :func:`_kernel` on the first launch; the
#: kernel body below reads it as a module global, as Triton requires
tl = None


def _rmsnorm_fwd(x_ptr, r_ptr, w_ptr, y_ptr, s_ptr, rows, d, eps,
                 BLOCK_R: "tl.constexpr", BLOCK_D: "tl.constexpr"):
    offs_r = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    offs_d = tl.arange(0, BLOCK_D)
    col_ok = offs_d < d
    mask = (offs_r[:, None] < rows) & col_ok[None, :]
    idx = offs_r[:, None].to(tl.int64) * d + offs_d[None, :]
    x = tl.load(x_ptr + idx, mask=mask, other=0.0).to(tl.float32)
    r = tl.load(r_ptr + idx, mask=mask, other=0.0).to(tl.float32)
    s = x + r
    var = tl.sum(s * s, axis=1) / d
    w = tl.load(w_ptr + offs_d, mask=col_ok, other=0.0).to(tl.float32)
    y = s * tl.rsqrt(var + eps)[:, None] * w[None, :]
    tl.store(y_ptr + idx, y.to(y_ptr.dtype.element_ty), mask=mask)
    tl.store(s_ptr + idx, s.to(s_ptr.dtype.element_ty), mask=mask)


@functools.lru_cache(maxsize=None)
def _kernel():
    global tl
    import triton
    import triton.language
    tl = triton.language
    return triton.jit(_rmsnorm_fwd)


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def fused_rmsnorm_cuda(x: torch.Tensor, residual: torch.Tensor,
                       w: torch.Tensor, *, eps: float = 1e-6):
    """x/residual: (rows, d) contiguous CUDA tensors; w: (d,).
    Returns (normed, x + residual) of x's type."""
    rows, d = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused RMSNorm takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if residual.shape != x.shape or residual.dtype != x.dtype \
            or w.shape != (d,):
        raise ValueError(f"x {tuple(x.shape)}/{x.dtype}, residual "
                         f"{tuple(residual.shape)}/{residual.dtype} and w "
                         f"{tuple(w.shape)} do not match")
    if not (x.is_contiguous() and residual.is_contiguous()
            and w.is_contiguous()):
        raise ValueError("fused RMSNorm takes contiguous tensors")
    block_d = _next_pow2(d)
    block_r = max(1, min(16, 4096 // block_d))
    y = torch.empty_like(x)
    s = torch.empty_like(x)
    grid = (-(-rows // block_r),)
    _kernel()[grid](x, residual, w, y, s, rows, d, eps,
                    BLOCK_R=block_r, BLOCK_D=block_d,
                    num_warps=4 if block_d <= 1024 else 8)
    return y, s
