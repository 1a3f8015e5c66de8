"""ctypes launches of the two CUDA SSD-scan passes (csrc/ssd_scan.cu)."""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

#: (state n, head_dim p) pairs the kernels are built for
SHAPES = ((8, 16), (16, 32), (64, 64), (128, 64))
#: longest chunk q a block holds
Q_MAX = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(_build.load("ssd_scan"), name)
    # (tensor pointers, trailing ints): intra (bc, q, h), inter (b, c, q, h)
    n_ptrs, n_ints = {"ssd_intra_fwd": (9, 3), "ssd_inter_fwd": (8, 4)}[name]
    fn.argtypes = [_I, _I, _I] + [_P] * n_ptrs + [_I] * n_ints + [_P]
    fn.restype = ctypes.c_int
    return fn


def _check(q: int, n: int, p: int, model_dtype, tensors, shapes) -> None:
    if (n, p) not in SHAPES or not 1 <= q <= Q_MAX:
        raise ValueError(f"the SSD kernels take (n, p) in {SHAPES} and a "
                         f"chunk of 1..{Q_MAX}, got q={q} n={n} p={p}")
    if model_dtype not in _DTYPES:
        raise TypeError(f"the SSD kernels take float32 or bfloat16 inputs, "
                        f"got {model_dtype}")
    device = next(iter(tensors.values())).device
    for name, t in tensors.items():
        want_dtype, want_shape = shapes[name]
        if t.dtype != want_dtype or tuple(t.shape) != want_shape:
            raise ValueError(f"{name}: want {want_dtype} {want_shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != device:
            raise ValueError(f"{name} must be contiguous and on the device "
                             f"of the others")


def _check_aligned(kernel: str, tensors) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: the {kernel} copies rows in 16-byte "
                             f"pieces, so it must start on a 16-byte "
                             f"boundary")


def _launch(name: str, dtype, n: int, p: int, ptrs, ints, device) -> None:
    err = _fn(name)(_DTYPES[dtype], n, p, *ptrs, *ints,
                    torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def ssd_intra_cuda(xh: torch.Tensor, bm: torch.Tensor, cm: torch.Tensor,
                   log_a: torch.Tensor, dt: torch.Tensor):
    """xh: (b, c, q, h, p); bm/cm: (b, c, q, n) of xh's type; log_a/dt:
    (b, c, q, h) fp32. Returns fp32 (y_intra (b, c, q, h, p),
    S (b, c, h, n, p), chunk decay (b, c, h), cum (b, c, q, h), the
    in-order cumsum of log_a over each chunk). float32 inputs run the
    scalar route, bfloat16 the tensor-core route."""
    b, c, q, h, p = xh.shape
    n = bm.shape[-1]
    f32 = torch.float32
    _check(q, n, p, xh.dtype,
           dict(xh=xh, bm=bm, cm=cm, log_a=log_a, dt=dt),
           dict(xh=(xh.dtype, (b, c, q, h, p)), bm=(xh.dtype, (b, c, q, n)),
                cm=(xh.dtype, (b, c, q, n)), log_a=(f32, (b, c, q, h)),
                dt=(f32, (b, c, q, h))))
    if xh.dtype == torch.bfloat16:
        _check_aligned("bf16 kernel", dict(xh=xh, bm=bm, cm=cm))
    y = torch.empty((b, c, q, h, p), dtype=f32, device=xh.device)
    s = torch.empty((b, c, h, n, p), dtype=f32, device=xh.device)
    dec = torch.empty((b, c, h), dtype=f32, device=xh.device)
    cum = torch.empty((b, c, q, h), dtype=f32, device=xh.device)
    _launch("ssd_intra_fwd", xh.dtype, n, p,
            [t.data_ptr() for t in (xh, bm, cm, log_a, dt, y, s, dec, cum)],
            (b * c, q, h), xh.device)
    return y, s, dec, cum


def ssd_inter_cuda(cm: torch.Tensor, cum: torch.Tensor,
                   s_chunk: torch.Tensor, chunk_decay: torch.Tensor,
                   y_intra: torch.Tensor, out_dtype,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inter-chunk pass with the chunk recurrence folded in. cm:
    (b, c, q, n) of ``out_dtype``; cum: (b, c, q, h), s_chunk:
    (b, c, h, n, p), chunk_decay: (b, c, h) and y_intra: (b, c, q, h, p),
    all fp32 from the intra pass; h0: (b, h, n, p) fp32 or None (zeros).
    Returns (y (b, c, q, h, p) in ``out_dtype``, the last state
    (b, h, n, p) fp32). float32 runs the scalar route, bfloat16 the
    tensor-core route."""
    b, c, q, n = cm.shape
    h, p = cum.shape[-1], y_intra.shape[-1]
    f32 = torch.float32
    tensors = dict(cm=cm, cum=cum, s_chunk=s_chunk, chunk_decay=chunk_decay,
                   y_intra=y_intra)
    shapes = dict(cm=(out_dtype, (b, c, q, n)), cum=(f32, (b, c, q, h)),
                  s_chunk=(f32, (b, c, h, n, p)),
                  chunk_decay=(f32, (b, c, h)),
                  y_intra=(f32, (b, c, q, h, p)))
    if h0 is not None:
        tensors["h0"] = h0
        shapes["h0"] = (f32, (b, h, n, p))
    _check(q, n, p, out_dtype, tensors, shapes)
    _check_aligned("inter kernel", dict(cm=cm, s_chunk=s_chunk,
                                        y_intra=y_intra))
    y = torch.empty((b, c, q, h, p), dtype=out_dtype, device=cm.device)
    h_last = torch.empty((b, h, n, p), dtype=f32, device=cm.device)
    ptrs = [t.data_ptr() for t in (cm, cum, s_chunk, chunk_decay, y_intra)]
    ptrs += [None if h0 is None else h0.data_ptr(), y.data_ptr(),
             h_last.data_ptr()]
    _launch("ssd_inter_fwd", out_dtype, n, p, ptrs, (b, c, q, h), cm.device)
    return y, h_last
