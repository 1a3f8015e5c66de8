"""Random weights made by the benchmark from ``--seed``, on the device.

The tree's keys, shapes and types are the program's parameter layout
(read on the meta device, where nothing is drawn); the values are the
benchmark's own, so the program and the reference are handed the same
tensors. Every normal leaf of one type is a view of one flat buffer
filled by a few large draws of a ``torch.Generator`` on the device, in
the type it is served in, then scaled leaf by leaf:

  * ``tok`` (vocab, d): std d^-1/2; every other matrix (..., in, out):
    std in^-1/2, the usual fan-in scale;
  * norm weights 1, biases and gates 0;
  * Mamba2: A = -exp(A_log) with A in [1, 16], dt_bias the inverse
    softplus of dt log-uniform in [1e-3, 1e-1], D = 1 (Mamba2's init).
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

ONES = {"w", "norm_w", "q_norm", "k_norm", "D"}
ZEROS = {"b", "bq", "bk", "bv", "up_b", "down_b", "gate_attn", "gate_mlp"}
#: elements per draw
CHUNK = 1 << 28


def _leaves(tree, path=()) -> List[Tuple[tuple, torch.Tensor]]:
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _leaves(v, path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    return [(path, tree)]


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def _copy_structure(tree):
    if isinstance(tree, dict):
        return {k: _copy_structure(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy_structure(v) for v in tree]
    return None


def make_weights(abstract, seed: int, device) -> Dict:
    """Concrete weights of the shapes and types of ``abstract`` (a tree of
    meta tensors)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = _copy_structure(abstract)
    normal: Dict[torch.dtype, List[Tuple[tuple, torch.Tensor]]] = {}
    special = []
    for path, leaf in _leaves(abstract):
        name = path[-1]
        if name in ONES:
            _set(out, path, torch.ones(leaf.shape, dtype=leaf.dtype,
                                       device=device))
        elif name in ZEROS:
            _set(out, path, torch.zeros(leaf.shape, dtype=leaf.dtype,
                                        device=device))
        elif name in ("A_log", "dt_bias"):
            special.append((path, leaf))
        elif leaf.dim() >= 2:
            normal.setdefault(leaf.dtype, []).append((path, leaf))
        else:
            raise ValueError(f"no rule for the weight {path}")
    for dtype, leaves in normal.items():
        total = sum(leaf.numel() for _, leaf in leaves)
        flat = torch.empty(total, dtype=dtype, device=device)
        for i in range(0, total, CHUNK):
            part = flat[i:i + CHUNK]
            part.normal_(generator=gen)
        at = 0
        for path, leaf in leaves:
            view = flat[at:at + leaf.numel()].view(leaf.shape)
            at += leaf.numel()
            fan = leaf.shape[-1] if path[-1] == "tok" else leaf.shape[-2]
            view.mul_(fan ** -0.5)
            _set(out, path, view)
    for path, leaf in special:
        u = torch.rand(leaf.shape, generator=gen, dtype=torch.float32,
                       device=device)
        if path[-1] == "A_log":
            val = torch.log(1.0 + 15.0 * u)
        else:
            dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1)
                                                 - math.log(1e-3)))
            val = dt + torch.log(-torch.expm1(-dt))      # softplus^-1(dt)
        _set(out, path, val.to(leaf.dtype))
    return out
