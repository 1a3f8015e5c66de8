"""ctypes launches of the two CUDA SSD-scan passes (csrc/ssd_scan.cu)."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

#: (state n, head_dim p) pairs the kernels are built for
SHAPES = ((8, 16), (16, 32), (64, 64))
#: longest chunk q a block holds
Q_MAX = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    fn = getattr(_build.load("ssd_scan"), name)
    n_ptrs = {"ssd_intra_fwd": 9, "ssd_inter_fwd": 5}[name]
    fn.argtypes = [_I, _I, _I] + [_P] * n_ptrs + [_I, _I, _I, _P]
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


def _launch(name: str, dtype, n: int, p: int, ptrs, bc: int, q: int, h: int,
            device) -> None:
    err = _fn(name)(_DTYPES[dtype], n, p, *ptrs, bc, q, h,
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
        for name, t in (("xh", xh), ("bm", bm), ("cm", cm)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: the bf16 kernel copies rows in "
                                 f"16-byte pieces, so it must start on a "
                                 f"16-byte boundary")
    y = torch.empty((b, c, q, h, p), dtype=f32, device=xh.device)
    s = torch.empty((b, c, h, n, p), dtype=f32, device=xh.device)
    dec = torch.empty((b, c, h), dtype=f32, device=xh.device)
    cum = torch.empty((b, c, q, h), dtype=f32, device=xh.device)
    _launch("ssd_intra_fwd", xh.dtype, n, p,
            [t.data_ptr() for t in (xh, bm, cm, log_a, dt, y, s, dec, cum)],
            b * c, q, h, xh.device)
    return y, s, dec, cum


def ssd_inter_cuda(cm: torch.Tensor, cum: torch.Tensor, h_prevs: torch.Tensor,
                   y_intra: torch.Tensor, out_dtype) -> torch.Tensor:
    """cm: (b, c, q, n) of ``out_dtype``; cum: (b, c, q, h) fp32; h_prevs:
    (b, c, h, n, p) fp32; y_intra: (b, c, q, h, p) fp32. Returns y
    (b, c, q, h, p) in ``out_dtype``."""
    b, c, q, n = cm.shape
    h, p = cum.shape[-1], h_prevs.shape[-1]
    f32 = torch.float32
    _check(q, n, p, out_dtype,
           dict(cm=cm, cum=cum, h_prevs=h_prevs, y_intra=y_intra),
           dict(cm=(out_dtype, (b, c, q, n)), cum=(f32, (b, c, q, h)),
                h_prevs=(f32, (b, c, h, n, p)),
                y_intra=(f32, (b, c, q, h, p))))
    y = torch.empty((b, c, q, h, p), dtype=out_dtype, device=cm.device)
    _launch("ssd_inter_fwd", out_dtype, n, p,
            [t.data_ptr() for t in (cm, cum, h_prevs, y_intra, y)],
            b * c, q, h, cm.device)
    return y
