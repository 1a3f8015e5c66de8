"""Plain torch versions of the SSD-scan kernels.

``ssd_intra_ref`` and ``ssd_inter_ref`` repeat the arithmetic of the two
Pallas kernel bodies (``repro/kernels/ssd_scan/kernel.py``,
``_intra_kernel`` and ``_inter_kernel``): every input is cast to fp32
first, and the decay exponent is masked before the ``exp``.
``ssd_inter_scan_ref`` is the chunk recurrence followed by
``ssd_inter_ref``, the work of the CUDA inter pass. They are what ``ops``
runs on a CPU tensor and what the CUDA kernels are held against on the
card. ``ssd_scan_ref`` is the chunked model path and ``ssd_scan_naive``
the per-token recurrence that defines the semantics.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models.mamba2 import (SSMConfig, _ssd_chunked,
                                      chunk_recurrence)


def ssd_intra_ref(xh, bm, cm, cum, dt):
    """xh: (b, c, q, h, p); bm/cm: (b, c, q, n); cum/dt: (b, c, q, h).

    Returns fp32 (y_intra (b, c, q, h, p), S (b, c, h, n, p),
    chunk decay (b, c, h)).
    """
    xh, bm, cm, cum, dt = (t.float() for t in (xh, bm, cm, cum, dt))
    q = xh.shape[2]
    # decay matrix L[i, j, h] = exp(cum_i - cum_j), lower-triangular
    li = cum[:, :, :, None, :] - cum[:, :, None, :, :]           # (b,c,q,k,h)
    tril = torch.ones((q, q), dtype=torch.bool,
                      device=xh.device).tril()[:, :, None]
    l_mat = torch.where(tril, torch.exp(torch.where(tril, li, 0.0)), 0.0)
    g_mat = torch.einsum("bcqn,bckn->bcqk", cm, bm)               # C_i . B_j
    m_mat = g_mat[..., None] * l_mat * dt[:, :, None, :, :]       # (b,c,q,k,h)
    y = torch.einsum("bcqkh,bckhp->bcqhp", m_mat, xh)
    # chunk summary S[h, n, p] = sum_j exp(cum_last - cum_j) dt_j B_j x_j^T
    w = torch.exp(cum[:, :, -1:, :] - cum) * dt                   # (b,c,q,h)
    wx = xh * w[..., None]
    s = torch.einsum("bcqn,bcqhp->bchnp", bm, wx)
    return y, s, torch.exp(cum[:, :, -1, :])


def ssd_inter_ref(cm, cum, h_prevs, y_intra, out_dtype):
    """y[i, h, p] = y_intra[i, h, p] + exp(cum_i) (C_i . h_prev[h]), cast
    to ``out_dtype``. cm: (b, c, q, n); cum: (b, c, q, h); h_prevs:
    (b, c, h, n, p); y_intra: (b, c, q, h, p)."""
    ch = torch.einsum("bcqn,bchnp->bcqhp", cm.float(), h_prevs.float())
    y_inter = ch * torch.exp(cum.float())[..., None]
    return (y_intra.float() + y_inter).to(out_dtype)


def ssd_inter_scan_ref(cm, cum, s_chunk, chunk_decay, y_intra, out_dtype,
                       h0: Optional[torch.Tensor] = None):
    """``chunk_recurrence`` from ``h0`` (zeros if None), then
    ``ssd_inter_ref`` on the states entering each chunk. Returns (y in
    ``out_dtype``, the last state fp32)."""
    h_prevs, h_last = chunk_recurrence(s_chunk, chunk_decay, h0)
    return ssd_inter_ref(cm, cum, h_prevs, y_intra, out_dtype), h_last


def ssd_scan_ref(xh, b_mat, c_mat, log_a, dt, *, chunk: int = 128,
                 h0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked model path (``models.mamba2._ssd_chunked``)."""
    cfg = SSMConfig(state=b_mat.shape[-1], head_dim=xh.shape[-1], chunk=chunk)
    return _ssd_chunked(xh, b_mat, c_mat, log_a, dt, cfg, h0=h0)


def ssd_scan_naive(xh, b_mat, c_mat, log_a, dt):
    """O(s) per-token recurrence, the ground-truth semantics. Returns
    (y in xh's type, final state fp32)."""
    b, s, h, p = xh.shape
    n = b_mat.shape[-1]
    xf, bf, cf, laf, dtf = (t.float() for t in (xh, b_mat, c_mat, log_a, dt))
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(s):
        state = (state * torch.exp(laf[:, t])[:, :, None, None]
                 + torch.einsum("bh,bn,bhp->bhnp", dtf[:, t], bf[:, t],
                                xf[:, t]))
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, t], state))
    return torch.stack(ys, dim=1).to(xh.dtype), state
