"""ctypes launch of the CUDA MLA decode kernels (csrc/mla_decode.cu)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

#: the (row width, value width) pairs the kernels are built for:
#: DeepSeek-V2's [c (512), k_pe (64)] rows
SHAPES = ((576, 512),)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("mla_decode")
    lib.mla_decode_chunk.argtypes = []
    lib.mla_decode_chunk.restype = ctypes.c_int
    fn = lib.mla_decode_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int64), ctypes.c_float,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def mla_decode_cuda(q: torch.Tensor, cache: torch.Tensor,
                    length: torch.Tensor, *, v_dim: int,
                    scale: float) -> torch.Tensor:
    """q: (b, h, R) with R contiguous; cache: (b, S, R) read in place (any
    batch and sequence strides, R contiguous, every row on a 16-byte
    boundary); length: (b,) int32 on q's device; bf16 q and cache, h a
    multiple of 16. Returns a contiguous (b, h, v_dim) bf16 tensor.
    Nothing is read back to the host, so the call captures into a CUDA
    graph."""
    b, h, R = q.shape
    S = cache.shape[1]
    if q.dtype != torch.bfloat16 or cache.dtype != q.dtype:
        raise TypeError(f"MLA decode takes bfloat16 q and cache, got "
                        f"{q.dtype}/{cache.dtype}")
    if (R, v_dim) not in SHAPES:
        raise ValueError(f"(row, value) widths {(R, v_dim)} are not one of "
                         f"{SHAPES}")
    if (cache.shape != (b, S, R) or h % 16 or length.shape != (b,)):
        raise ValueError(f"shapes q {tuple(q.shape)} cache "
                         f"{tuple(cache.shape)} length {tuple(length.shape)} "
                         f"do not form MLA decode attention of 16-head "
                         f"groups")
    if length.dtype != torch.int32:
        raise TypeError(f"length must be int32, got {length.dtype}")
    if any(t.device != q.device for t in (cache, length)) or any(
            t.stride(-1) != 1 for t in (q, cache, length)):
        raise ValueError("q, cache and length must share one CUDA device "
                         "and have a contiguous last dim")
    if q.data_ptr() % 16 or cache.data_ptr() % 16 or any(
            st * 2 % 16 for st, n in zip((*q.stride()[:2],
                                          *cache.stride()[:2]),
                                         (b, h, b, S)) if n > 1):
        raise ValueError(f"the kernel reads rows in 16-byte pieces, so q's "
                         f"and the cache's starts and row strides must be "
                         f"multiples of 16 bytes (strides {q.stride()}, "
                         f"{cache.stride()})")
    lib = _lib()
    splits = -(-S // lib.mla_decode_chunk())
    o = torch.empty((b, h, v_dim), dtype=q.dtype, device=q.device)
    o_part = torch.empty((b, splits, h, v_dim), dtype=torch.float32,
                         device=q.device)
    ml_part = torch.empty((b, splits, h, 2), dtype=torch.float32,
                          device=q.device)
    strides = (ctypes.c_int64 * 4)(q.stride(0), q.stride(1),
                                   cache.stride(0), cache.stride(1))
    err = lib.mla_decode_fwd(
        R, v_dim, q.data_ptr(), cache.data_ptr(), length.data_ptr(),
        o.data_ptr(), o_part.data_ptr(), ml_part.data_ptr(), b, S, h,
        strides, scale, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"MLA decode launch failed: CUDA error {err}")
    return o
