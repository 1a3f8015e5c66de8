"""ctypes launch of the CUDA decode-attention kernels
(csrc/decode_attention.cu)."""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("decode_attention")
    lib.decode_attention_chunk.argtypes = []
    lib.decode_attention_chunk.restype = ctypes.c_int
    fn = lib.decode_attention_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int64), ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          length: torch.Tensor, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """q: (b, 1, h, d); k/v: (b, S, hkv, d), the cache read in place (any
    batch, sequence and head strides, head_dim contiguous, every row on a
    16-byte boundary); length: (b,) int32 on q's device. Slot r attends
    rows 0 .. min(length[r], S - 1). Returns a contiguous (b, 1, h, d)
    tensor of q's type; the scores are scaled by ``scale`` (None: d^-1/2)
    in fp32. Nothing is read back to the host, so the call captures into
    a CUDA graph."""
    b, sq, h, d = q.shape
    S, hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode attention takes float32 or bfloat16 q/k/v "
                        f"of one type, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} is not one of {HEAD_DIMS}")
    if (sq != 1 or k.shape != (b, S, hkv, d) or v.shape != k.shape
            or h % hkv or length.shape != (b,)):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} length {tuple(length.shape)} "
                         f"do not form one-position GQA decode attention")
    if length.dtype != torch.int32:
        raise TypeError(f"length must be int32, got {length.dtype}")
    if any(t.device != q.device for t in (k, v, length)) or any(
            t.stride(-1) != 1 for t in (q, k, v, length)):
        raise ValueError("q, k, v and length must share one CUDA device, "
                         "q, k, v have a contiguous head_dim and length is "
                         "contiguous")
    size = q.element_size()
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(
                st * size % 16 for st, n in zip(t.stride()[:3], t.shape[:3])
                if n > 1):
            raise ValueError(
                f"{name}: the kernel reads rows in 16-byte pieces, so its "
                f"start and its batch, seq and head strides must be "
                f"multiples of 16 bytes (strides {t.stride()})")
    lib = _lib()
    splits = -(-S // lib.decode_attention_chunk())
    o = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    o_part = torch.empty((b, h, splits, d), dtype=torch.float32,
                         device=q.device)
    ml_part = torch.empty((b, h, splits, 2), dtype=torch.float32,
                          device=q.device)
    strides = (ctypes.c_int64 * 8)(q.stride(0), q.stride(2), *k.stride()[:3],
                                   *v.stride()[:3])
    err = lib.decode_attention_fwd(
        _DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        length.data_ptr(), o.data_ptr(), o_part.data_ptr(),
        ml_part.data_ptr(), b, S, h, hkv, strides,
        d ** -0.5 if scale is None else scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"decode attention launch failed: CUDA error "
                           f"{err}")
    return o
