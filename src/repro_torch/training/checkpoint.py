"""Atomic checkpointing in the reference's on-disk format (counterpart
of ``repro.training.checkpoint``).

Layout: ``<dir>/step_<k>/`` holding ``manifest.json`` (leaf paths,
shapes, dtypes, step metadata) and ``shard_<i>.npz`` chunks. Writes go
to ``step_<k>.tmp`` and are ``os.replace``d into place, and the manifest
is written last, so a crash mid-save never corrupts the latest
checkpoint: restore picks the highest *complete* step.

Leaf paths are spelled as ``jax.tree_util.keystr`` spells them
(``['params']['layers']['wq']``; a list index as ``[0]``, as in
``['params']['layers'][0]['block']['up']``), in its sorted-key order, so
either package reads the other's files. A bfloat16 leaf is stored as the
reference stores it: its raw 2-byte words under the ``.npy`` descr
``<V2``, with ``"dtype": "bfloat16"`` in the manifest. Restore rebuilds
it from those words (viewed as int16, then as ``torch.bfloat16``),
never by a numeric cast of the raw bits. (The reference itself cannot
restore such a leaf: numpy has no cast from ``V2``.)

A sharded state (DTensor leaves) is saved whole: every rank gathers each
leaf with ``full_tensor()`` (a collective), rank 0 writes, and a barrier
follows, so the files are those of the same state saved unsharded.
``restore_checkpoint(..., shardings=)`` places each leaf on its mesh
with ``distribute_tensor``, whatever mesh it was saved from.
"""
from __future__ import annotations

import json
import os
import shutil
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

Tree = Dict[str, object]

_MANIFEST = "manifest.json"
#: max elements per npz shard (~512 MB of fp32)
_SHARD_ELEMS = 128 * 1024 * 1024
#: the .npy descr numpy writes for an ml_dtypes bfloat16 array
_BF16_DESCR = "<V2"


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, object]]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in _flatten_with_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, list):
        return [leaf for i, v in enumerate(tree)
                for leaf in _flatten_with_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _host_array(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(host array, manifest dtype); a bf16 tensor as its raw int16 words."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    t = leaf.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _write_npz(path: str, shard: Dict[str, Tuple[np.ndarray, str]]) -> None:
    """``np.savez``'s zip layout, with bf16 words under the ``<V2`` descr."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (arr, dtype) in shard.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                if dtype == "bfloat16":
                    np.lib.format.write_array_header_1_0(
                        f, {"descr": _BF16_DESCR, "fortran_order": False,
                            "shape": arr.shape})
                    f.write(arr.tobytes())
                else:
                    np.lib.format.write_array(f, arr, allow_pickle=False)


def save_checkpoint(directory: str, step: int, state: Tree,
                    extra: Optional[Dict] = None, keep: int = 3) -> str:
    """Atomically write ``state`` under ``directory/step_<step>``. With
    DTensor leaves every rank must call this (each leaf is gathered);
    rank 0 writes and all ranks leave after it has."""
    final = os.path.join(directory, f"step_{step:08d}")
    leaves = _flatten_with_paths(state)
    sharded = any(isinstance(leaf, DTensor) for _, leaf in leaves)
    if sharded and dist.get_rank() != 0:
        for _, leaf in leaves:
            if isinstance(leaf, DTensor):
                leaf.full_tensor()            # rank 0 gathers this leaf
        dist.barrier()
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    manifest = {"step": step, "extra": extra or {}, "leaves": [], "shards": 0}
    shard: Dict[str, Tuple[np.ndarray, str]] = {}
    shard_elems = 0
    shard_idx = 0

    def flush():
        nonlocal shard, shard_elems, shard_idx
        if shard:
            _write_npz(os.path.join(tmp, f"shard_{shard_idx}.npz"), shard)
            shard_idx += 1
            shard, shard_elems = {}, 0

    for i, (path, leaf) in enumerate(leaves):
        arr, dtype = _host_array(leaf)
        key = f"leaf_{i}"
        manifest["leaves"].append({"path": path, "key": key,
                                   "shard": shard_idx,
                                   "shape": list(arr.shape), "dtype": dtype})
        shard[key] = (arr, dtype)
        shard_elems += int(arr.size)
        if shard_elems >= _SHARD_ELEMS:
            flush()
    flush()
    manifest["shards"] = shard_idx
    # manifest last => its presence marks the checkpoint complete
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _cleanup(directory, keep)
    if sharded:
        dist.barrier()
    return final


def _cleanup(directory: str, keep: int) -> None:
    steps = sorted(_complete_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def _complete_steps(directory: str) -> List[int]:
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, _MANIFEST)):
                out.append(int(name[len("step_"):]))
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = _complete_steps(directory)
    return max(steps) if steps else None


def restore_checkpoint(directory: str, like: Tree,
                       step: Optional[int] = None,
                       shardings: Optional[Tree] = None
                       ) -> Tuple[Tree, int, Dict]:
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf takes the type of its ``like`` leaf, and its device, or with
    ``shardings`` (a tree of Shardings matching ``like``) the placement
    on its mesh, which may differ from the mesh it was saved from.
    Returns (state, step, extra)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    shards: Dict[int, object] = {}

    def load(kpath: str, leaf: torch.Tensor, sharding) -> torch.Tensor:
        entry = by_path.get(kpath)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {kpath}")
        si = entry["shard"]
        if si not in shards:
            shards[si] = np.load(os.path.join(path, f"shard_{si}.npz"))
        arr = shards[si][entry["key"]]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {kpath}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        if entry["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        if sharding is None:
            return t.to(device=leaf.device, dtype=leaf.dtype)
        t = t.to(device=sharding.mesh.device_type, dtype=leaf.dtype)
        return distribute_tensor(t, sharding.mesh, sharding.placements)

    def rebuild(tree, shd, prefix: str = ""):
        if isinstance(tree, dict):
            return {k: rebuild(v, None if shd is None else shd[k],
                               f"{prefix}[{k!r}]") for k, v in tree.items()}
        if isinstance(tree, list):
            return [rebuild(v, None if shd is None else shd[i],
                            f"{prefix}[{i}]") for i, v in enumerate(tree)]
        return load(prefix, tree, shd)

    try:
        state = rebuild(like, shardings)
    finally:
        for z in shards.values():
            z.close()
    return state, step, manifest.get("extra", {})
