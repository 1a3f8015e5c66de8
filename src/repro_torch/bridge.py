"""Maps the JAX package's parameter and cache trees onto the port's.

The trees arrive as numpy arrays (``np.asarray`` of each JAX leaf), so
this module needs nothing of JAX. Keys and layouts are the same in both
packages (dicts, and lists where the reference keeps a list, as for the
xLSTM layers), so the map is leaf by leaf. A JAX bf16 array becomes an
``ml_dtypes.bfloat16`` numpy array, which ``torch.from_numpy`` rejects:
it goes through float32, which holds every bf16 value exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _leaf(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    # a copy: the array may be a read-only view of a JAX buffer, and the
    # port writes into its caches in place
    return torch.from_numpy(np.array(a)).to(device)


def _map(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _map(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, device) for v in tree]
    return _leaf(tree, device)


def from_reference(params, device: DeviceLike = None):
    """The reference's param tree (numpy leaves) as the port's."""
    return _map(params, resolve_device(device))


#: the reference's decode cache (numpy leaves) as the port's: a cache is a
#: tree of the same kind
cache_from_reference = from_reference


def to_numpy(tree):
    """The port's tree as numpy leaves (bf16 as float32), for comparing
    with the reference."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
