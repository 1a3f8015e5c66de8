"""Public SSD scan: intra-chunk pass (which also takes the chunk cumsum)
-> inter-chunk pass (which also runs the chunk recurrence), the
counterpart of ``repro.kernels.ssd_scan.ops``.

Each entry point takes the plain version for a CPU tensor and for a meta
tensor (the dry run's), which has no data, so nothing is hidden; a CUDA
tensor launches the kernel or raises. Each refuses autograd (no
backward) and DTensors (call it on local shards)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import (PLAIN_DEVICES, refuse_autograd,
                                 refuse_dtensor)
from repro_torch.kernels.ssd_scan.kernel import ssd_inter_cuda, ssd_intra_cuda
from repro_torch.kernels.ssd_scan.ref import ssd_inter_scan_ref, ssd_intra_ref
from repro_torch.models.mamba2 import chunk_len

#: launches of each CUDA pass since the counts were last set to 0
intra_launches = 0
inter_launches = 0


def ssd_intra(xh, bm, cm, log_a, dt):
    """The intra-chunk pass with the chunk cumsum folded in: returns
    (y_intra, S, chunk decay, cum). The CUDA kernel for a CUDA tensor (or
    the call raises); for a CPU tensor, ``torch.cumsum`` and the plain
    version, which takes ``cum`` as the Pallas kernel does. Refuses
    autograd (no backward)."""
    global intra_launches
    refuse_autograd("ssd_intra", xh, bm, cm, log_a, dt)
    refuse_dtensor("ssd_intra", xh, bm, cm, log_a, dt)
    if xh.device.type in PLAIN_DEVICES:
        cum = torch.cumsum(log_a, dim=2)
        return (*ssd_intra_ref(xh, bm, cm, cum, dt), cum)
    out = ssd_intra_cuda(xh, bm, cm, log_a, dt)
    intra_launches += 1
    return out


def ssd_inter(cm, cum, s_chunk, chunk_decay, y_intra, out_dtype, h0=None):
    """The inter-chunk pass with the chunk recurrence folded in: returns
    (y, the last state). Dispatched as :func:`ssd_intra`; for a CPU
    tensor, ``chunk_recurrence`` and the plain pass. Refuses autograd."""
    global inter_launches
    refuse_autograd("ssd_inter", cm, cum, s_chunk, chunk_decay, y_intra, h0)
    refuse_dtensor("ssd_inter", cm, cum, s_chunk, chunk_decay, y_intra, h0)
    if cm.device.type in PLAIN_DEVICES:
        return ssd_inter_scan_ref(cm, cum, s_chunk, chunk_decay, y_intra,
                                  out_dtype, h0)
    out = ssd_inter_cuda(cm, cum, s_chunk, chunk_decay, y_intra, out_dtype,
                         h0)
    inter_launches += 1
    return out


def ssd_scan(xh: torch.Tensor, b_mat: torch.Tensor, c_mat: torch.Tensor,
             log_a: torch.Tensor, dt: torch.Tensor, *, chunk: int = 128,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (Mamba2).

    xh: (b, s, h, p); b_mat/c_mat: (b, s, n); log_a/dt: (b, s, h).
    Returns (y (b, s, h, p) in xh's type, final state (b, h, n, p) fp32).
    The chunk recurrence from ``h0`` (zeros if None), which the reference
    runs in a ``lax.scan`` between its kernels, runs inside the inter
    pass: the states entering each chunk are never stored. Refuses
    autograd (no backward).
    """
    refuse_autograd("ssd_scan", xh, b_mat, c_mat, log_a, dt, h0)
    refuse_dtensor("ssd_scan", xh, b_mat, c_mat, log_a, dt, h0)
    bsz, s, h, p = xh.shape
    n = b_mat.shape[-1]
    q = chunk_len(s, chunk)
    c = s // q

    xc = xh.reshape(bsz, c, q, h, p)
    bc = b_mat.reshape(bsz, c, q, n)
    cc = c_mat.reshape(bsz, c, q, n)
    la = log_a.reshape(bsz, c, q, h).float()
    dc = dt.reshape(bsz, c, q, h).float()

    y_intra, s_chunk, chunk_decay, cum = ssd_intra(xc, bc, cc, la, dc)
    y, h_last = ssd_inter(cc, cum, s_chunk, chunk_decay, y_intra, xh.dtype,
                          None if h0 is None else h0.float())
    return y.reshape(bsz, s, h, p), h_last
