"""ctypes launch of the CUDA flash-attention kernel (csrc/flash_attention.cu)."""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 128)
#: (q.k, v) head dims of the bf16 route with a narrower v: latent
#: attention's expanded prefill (DeepSeek-V2)
SPLIT_HEAD_DIMS = ((192, 128),)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _fn():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int64), ctypes.c_float,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, sq, h, d); k: (b, skv, hkv, d); v: (b, skv, hkv, dv), any
    strides with the head dims contiguous (in bf16, rows on 16-byte
    boundaries). Returns a contiguous (b, sq, h, dv) tensor of q's type.
    float32 runs the scalar route, bfloat16 the tensor-core route; dv is
    d, or in bf16 one of ``SPLIT_HEAD_DIMS``. The scores are scaled by
    ``scale`` (None: d^-1/2) in fp32 inside the kernel, never in q's
    type."""
    b, sq, h, d = q.shape
    skv, hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes float32 or bfloat16 q/k/v of "
                        f"one type, got {q.dtype}/{k.dtype}/{v.dtype}")
    if dv == d and d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} is not one of {HEAD_DIMS}")
    if dv != d and ((d, dv) not in SPLIT_HEAD_DIMS
                    or q.dtype != torch.bfloat16):
        raise ValueError(f"head dims (q.k {d}, v {dv}) are not one of "
                         f"{SPLIT_HEAD_DIMS} in bfloat16")
    if k.shape != (b, skv, hkv, d) or v.shape != (b, skv, hkv, dv) \
            or h % hkv:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not form GQA attention")
    if any(t.device != q.device or t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k, v must share one CUDA device and have a "
                         "contiguous head_dim")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(
                    st % 8 for st, n in zip(t.stride()[:3], t.shape[:3])
                    if n > 1):
                raise ValueError(
                    f"{name}: the bf16 kernel copies rows in 16-byte pieces, "
                    f"so its start and its batch, seq and head strides must "
                    f"be multiples of 16 bytes (strides {t.stride()})")
    o = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 12)(*[s for t in (q, k, v, o)
                                      for s in t.stride()[:3]])
    err = _fn()(_DTYPES[q.dtype], d, dv, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), o.data_ptr(), b, sq, skv, h, hkv, strides,
                d ** -0.5 if scale is None else scale, int(causal),
                torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash attention launch failed: CUDA error {err}")
    return o
