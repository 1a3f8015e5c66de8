"""The fleet engine's fast-plane longest-path sweep, in fp64 on the card.

The reference's ``FleetEngine.run_many`` replays C candidate
configurations x I workflow instances of one template on an infinite,
warm cluster with one longest-path sweep: every node's absolute finish
time, for every (candidate, instance), is the max of its predecessors'
finishes (the instance's arrival for a source) plus the node's runtime
under that candidate. ``plane_backend="jax"`` runs that sweep as a
jitted ``lax.scan`` over topological ranks (``_jax_sweep_fn`` and
``_sweep_jax``, ``src/repro/core/engine.py:999-1036`` and
``:2083-2102``), the only JAX code inside the reference's numpy stack.

:func:`fast_plane_sweep` is its port: the same inputs, the same index
tables, a (C, I, V) fp64 finish tensor on the device advanced one rank
at a time. Its ops are gathers, ``where``, ``amax`` and one add per
rank; fp64 add and max are exactly rounded and max is associative, so
the result equals :func:`numpy_plane_sweep` (the reference's numpy sweep,
``src/repro/core/engine.py:1994-2014``, its ``noise is None`` branch)
bit for bit. The numpy version is kept beside it for the tests and for
``chip_smoke.py``'s bitwise check; the card's path never calls it.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _sweep_tables(template, order: Sequence[str], col: Dict[str, int]
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(order_idx, pred_idx, pred_mask)``: each rank's node column, and
    its predecessors' columns padded to the widest fan-in, as
    ``_sweep_jax`` builds them. ``template`` is read only for
    ``predecessors``."""
    order_idx = np.array([col[name] for name in order], dtype=np.int64)
    max_p = max((len(template.predecessors(n)) for n in order), default=1)
    max_p = max(max_p, 1)
    pred_idx = np.zeros((len(order), max_p), dtype=np.int64)
    pred_mask = np.zeros((len(order), max_p), dtype=bool)
    for k, name in enumerate(order):
        for j, p in enumerate(template.predecessors(name)):
            pred_idx[k, j] = col[p]
            pred_mask[k, j] = True
    return order_idx, pred_idx, pred_mask


def fast_plane_sweep(template, order: Sequence[str], col: Dict[str, int],
                     t_all: np.ndarray, rt: np.ndarray, *,
                     device: DeviceLike = None) -> np.ndarray:
    """Latest finish of every (candidate, instance): ``rt`` is (C, V)
    fp64 runtimes by node column, ``t_all`` the (I,) arrival times.
    Returns a (C, I) fp64 ndarray. ``device=None`` means the CUDA card
    (and raises without one)."""
    dev = resolve_device(device)
    order_idx, pred_idx, pred_mask = _sweep_tables(template, order, col)
    t = torch.as_tensor(np.asarray(t_all, dtype=np.float64), device=dev)
    r = torch.as_tensor(np.asarray(rt, dtype=np.float64), device=dev)
    pidx = torch.as_tensor(pred_idx, device=dev)
    pmask = torch.as_tensor(pred_mask, device=dev)
    fin = torch.zeros((r.shape[0], t.shape[0], r.shape[1]),
                      dtype=torch.float64, device=dev)
    neg_inf = torch.tensor(-np.inf, dtype=torch.float64, device=dev)
    for k, v in enumerate(order_idx.tolist()):
        # a source has no live predecessor: its start is the arrival
        # instant; everything else max-reduces over its predecessors'
        # finishes, the recurrence of the numpy sweep
        pf = torch.where(pmask[k], fin[:, :, pidx[k]], neg_inf)
        start = pf.amax(dim=-1)
        start = torch.where(torch.isneginf(start), t[None, :], start)
        fin[:, :, v] = start + r[:, v, None]
    return fin.amax(dim=2).cpu().numpy()


def numpy_plane_sweep(template, order: Sequence[str], col: Dict[str, int],
                      t_all: np.ndarray, rt: np.ndarray) -> np.ndarray:
    """The plain numpy sweep: :func:`fast_plane_sweep`'s result, as the
    reference's numpy plane computes it."""
    finish_by_node: Dict[str, np.ndarray] = {}
    for name in order:
        preds = template.predecessors(name)
        if preds:
            start = finish_by_node[preds[0]]
            for p in preds[1:]:
                start = np.maximum(start, finish_by_node[p])
        else:
            start = t_all[None, :]
        finish_by_node[name] = start + rt[:, col[name]][:, None]
    inst_finish = None
    for arr in finish_by_node.values():
        inst_finish = arr if inst_finish is None \
            else np.maximum(inst_finish, arr)
    return inst_finish
