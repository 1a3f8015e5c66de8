"""Explicit collectives: int8-compressed gradient all-reduce with error
feedback, for the slow cross-pod links (counterpart of
``repro.distributed.collectives``).

The intra-pod gradient reduction is DTensor's own; compression has to
be explicit, so the cross-pod sync is an all-reduce over the process
group of the ``pod`` mesh dim only:

    per-pod grads --quantize(int8 + per-leaf scale)--> sum over "pod"
    --dequantize--> mean; the quantization error is fed back into the
    next step's gradients (error feedback keeps SGD unbiased in the
    long run — Karimireddy et al. 2019).

The reference's ``psum`` is an ``all_reduce(SUM)`` over the pod group,
its ``pmax`` an ``all_reduce(MAX)``, and the float operations run in the
reference's order, so both give the same bits. A DTensor leaf reduces
its local shard over the pod group: the shard is replicated over the pod
dim, as the reference's ``shard_map`` in-spec ``P()`` makes it, and its
scale is the absmax over the whole tensor, as GSPMD's ``auto`` axes see
it.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed.sharding import mesh_axes
from repro_torch.tree import tree_map

Tree = Any


def _int8_scale(x: torch.Tensor) -> torch.Tensor:
    """max(absmax / 127, 1e-12) in fp32, over the whole tensor (a
    DTensor's absmax is gathered from every shard)."""
    absmax = x.float().abs().max()
    if isinstance(absmax, DTensor):
        absmax = absmax.full_tensor()
    return torch.clamp(absmax / 127.0, min=1e-12)


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) clipped to ±127, in fp32 (``torch.round`` rounds
    half to even, as ``jnp.round`` does)."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    scale = _int8_scale(x)
    return _quantize(x, scale).to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """A reduced copy of ``x`` over ``group``; a DTensor reduces its
    local shard and keeps its placements."""
    if isinstance(x, DTensor):
        local = x.to_local().clone()
        dist.all_reduce(local, op=op, group=group)
        return DTensor.from_local(local, x.device_mesh, x.placements)
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def psum_int8(tree: Tree, group) -> Tree:
    """Quantized all-reduce-mean of a tree over ``group``.

    int8 payloads are summed in int32 (no overflow below ~2^23 pods);
    per-leaf scales are max-reduced so every pod dequantizes alike.
    """
    n = dist.get_world_size(group)

    def one(x):
        scale = _all_reduce(_int8_scale(x), dist.ReduceOp.MAX, group)
        # requantize against the agreed scale so the sum is consistent
        q = _quantize(x, scale)
        total = _all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, group)
        return (total.float() * scale / n).to(x.dtype)

    return tree_map(one, tree)


def cross_pod_grad_sync(grads: Tree, error: Optional[Tree], group
                        ) -> Tuple[Tree, Tree]:
    """int8 all-reduce-mean over ``group`` with error feedback.

    Standard EF-SGD form: ``g_eff = g + e;  q = Q(g_eff);
    sync = sum(q)/n;  e' = g_eff - deQ(q)`` (the locally-dropped
    quantization residual re-enters next step). Returns (synced mean in
    each gradient's type, new fp32 error).
    """
    if error is not None:
        grads = tree_map(lambda g, e: (g.float() + e).to(g.dtype),
                         grads, error)
    n = dist.get_world_size(group)

    def one(x):
        scale = _all_reduce(_int8_scale(x), dist.ReduceOp.MAX,
                            group)                      # agreed scale
        q = _quantize(x, scale)
        local_dq = q * scale
        total = _all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, group)
        synced = (total.float() * scale / n).to(x.dtype)
        new_err = x.float() - local_dq
        return synced, new_err

    # tree_map recurses into dicts and lists only, so the pairs are leaves
    pairs = tree_map(one, grads)
    return tree_map(lambda t: t[0], pairs), tree_map(lambda t: t[1], pairs)


def make_compressed_sync(mesh):
    """grads, error -> (synced grads, new error) over the mesh's ``pod``
    dim. A DTensor leaf is first replicated over the pod dim and its
    pending sums done (as the reference's in-spec ``P()`` makes GSPMD do),
    its other placements kept, and its results come back to those
    placements. Returns None if the mesh has no pod axis or a pod axis of
    size 1."""
    if mesh_axes(mesh).get("pod", 1) == 1:
        return None
    group = mesh.get_group("pod")
    pod = list(mesh_axes(mesh)).index("pod")

    def reduced(x):
        return [Replicate() if p.is_partial() else p for p in x.placements]

    def over_pods(x):
        if not isinstance(x, DTensor):
            return x
        place = reduced(x)
        place[pod] = Replicate()
        return x.redistribute(x.device_mesh, place)

    def back(t, g):
        if not isinstance(g, DTensor):
            return t
        return t.redistribute(g.device_mesh, reduced(g))

    def sync(grads: Tree, error: Tree) -> Tuple[Tree, Tree]:
        synced, new_error = cross_pod_grad_sync(
            tree_map(over_pods, grads),
            None if error is None else tree_map(over_pods, error), group)
        return tree_map(back, synced, grads), tree_map(back, new_error, grads)

    return sync
