"""Logical-axis sharding on DTensor (counterpart of
``repro.distributed.sharding``): map logical param/activation axes to
the axes of a torch ``DeviceMesh``.

Logical axes used across the substrate:

  batch       activation batch dim              -> ("pod", "data")
  act_seq     activation sequence dim           -> None (or "model" for SP)
  cache_seq   KV-cache sequence dim             -> "model" (flash-decode SP)
  embed       d_model dims of weights           -> fsdp: ("pod","data") else None
  mlp         FFN hidden dim                    -> "model" (TP)
  qkv         attention q-heads dim (h*hd)      -> "model" (TP)
  kv_qkv      attention kv-heads dim (hkv*hd)   -> "model" when divisible
  vocab       (padded) vocabulary dim           -> "model"
  heads_act   attention-score head dim          -> "model"
  expert      MoE expert dim                    -> "model" when divisible (EP)
  inner       SSM/mLSTM expanded dim            -> "model"
  state       SSM state dim N                   -> None (tiny)
  ssm_heads   SSM head dim                      -> None
  heads       per-head tables                   -> None
  head_dim, conv, gates, null, layers, seg      -> None

The rules and their spec algorithm are the reference's, so a spec here
equals the reference's ``PartitionSpec`` entry for entry. A spec becomes
DTensor placements with one ``Shard(dim)`` or ``Replicate()`` per mesh
dim (:func:`placements`); a :class:`Sharding`, the pair (mesh,
placements), stands where the reference holds a ``NamedSharding``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard, distribute_tensor)

from repro_torch.tree import tree_map

Tree = Any
MeshAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """The reference's ``jax.sharding.PartitionSpec``: one entry per
    leading tensor dim, each None, a mesh axis name, or a tuple of names
    for a dim sharded over several mesh axes. Specs compare as tuples."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Sharding(NamedTuple):
    """Where a tensor lives on a mesh: the DTensor mesh and placements."""
    mesh: Any
    placements: Tuple[Placement, ...]


def mesh_axes(mesh) -> Dict[str, int]:
    """Name -> size of a mesh's axes, in mesh order. Takes a
    ``DeviceMesh`` (its ``shape`` is a tuple, named by
    ``mesh_dim_names``) or any object whose ``shape`` already is that
    mapping, as the tests' duck-typed meshes."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    if mesh.mesh_dim_names is None:
        raise ValueError("the sharding rules need a mesh with named dims")
    return dict(zip(mesh.mesh_dim_names, shape))


def _base_rules(fsdp: bool) -> Dict[str, MeshAxes]:
    return {
        "batch": ("pod", "data"),
        "act_seq": None,
        "cache_seq": "model",
        "embed": ("pod", "data") if fsdp else None,
        "mlp": "model",
        "qkv": "model",
        "kv_qkv": "model",
        "vocab": "model",
        "heads_act": "model",
        "expert": "model",
        "inner": "model",
        "state": None,
        "ssm_heads": None,
        "heads": None,
        "head_dim": None,
        "conv": None,
        "gates": None,
        "null": None,
        "layers": None,
        "seg": None,
    }


def placements(spec: Sequence, mesh) -> Tuple[Placement, ...]:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` on every
    mesh dim of more than one device that a tensor dim's entry names,
    ``Replicate()`` on the rest. A mesh dim of one device shards nothing,
    and DTensor would still refuse views across a dim "sharded" over it
    (torch 2.11 refuses einsum's flatten of (batch, heads) on a (1, 1)
    mesh).

    DTensor shards a dim over several mesh dims outer mesh dim first, as
    JAX does only when the entry names them in mesh order, as every base
    rule does; an entry out of mesh order raises ``ValueError``.
    """
    sizes = mesh_axes(mesh)
    names = list(sizes)
    out: list = [Replicate()] * len(names)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"mesh axes {missing} of dim {dim} are not in "
                             f"the mesh {names}")
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"mesh axes {axes} of dim {dim} are not in mesh "
                             f"order {names}")
        for i in order:
            if sizes[names[i]] > 1:
                out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass
class ShardingRules:
    """Logical-name -> mesh-axes table, divisibility-safe.

    ``spec(axes, shape)`` drops any rule whose mesh axes do not divide
    the corresponding dim (e.g. 40 experts on a 16-way model axis fall
    back to replicated + TP on the ffn dim), so one rule table serves
    every architecture. A mesh axis is never assigned twice in one spec.
    """

    table: Dict[str, MeshAxes]

    def override(self, **kw: MeshAxes) -> "ShardingRules":
        t = dict(self.table)
        t.update(kw)
        return ShardingRules(t)

    def spec(self, logical_axes: Sequence[Optional[str]],
             shape: Sequence[int], mesh) -> PartitionSpec:
        sizes = mesh_axes(mesh)
        parts = []
        used: set = set()
        for dim, name in zip(shape, logical_axes):
            axes = self.table.get(name) if name is not None else None
            if isinstance(axes, str):
                axes = (axes,)
            if axes:
                # only keep axes that exist in this mesh, are unused, and divide
                kept = []
                prod = 1
                for a in axes:
                    if a in sizes and a not in used:
                        kept.append(a)
                        prod *= sizes[a]
                if kept and dim % prod == 0 and dim > 0:
                    used.update(kept)
                    parts.append(tuple(kept) if len(kept) > 1 else kept[0])
                    continue
            parts.append(None)
        # trailing Nones can be dropped (canonical form)
        while parts and parts[-1] is None:
            parts.pop()
        return PartitionSpec(*parts)

    def sharding(self, logical_axes: Sequence[Optional[str]],
                 shape: Sequence[int], mesh) -> Sharding:
        spec = self.spec(logical_axes, shape, mesh)
        return Sharding(mesh, placements(spec, mesh))


FSDP_RULES = ShardingRules(_base_rules(fsdp=True))
TP_RULES = ShardingRules(_base_rules(fsdp=False))

#: sequence-parallel activations for prefill/serving: attention scores
#: shard over the query sequence when the head count does not divide the
#: model axis
SERVING_RULES = FSDP_RULES.override(act_seq="model")


def logical_to_sharding(axes_tree: Tree, shape_tree: Tree, mesh,
                        rules: ShardingRules) -> Tree:
    """Mirror an axes tree + a tree of shaped leaves (tensors, meta
    tensors) into Shardings."""
    return tree_map(lambda axes, t: rules.sharding(axes, t.shape, mesh),
                    axes_tree, shape_tree)


def tree_shardings(mesh, rules: ShardingRules, axes_tree: Tree,
                   tree: Tree) -> Tree:
    """Shardings for an existing tensor tree."""
    return logical_to_sharding(axes_tree, tree, mesh, rules)


def shard_batch_spec(mesh, rules: ShardingRules, batch: int,
                     ndim: int) -> Sharding:
    """Sharding for a (batch, ...) activation: batch over data axes if it
    divides, everything else replicated."""
    return rules.sharding(("batch",) + (None,) * (ndim - 1),
                          (batch,) + (1,) * (ndim - 1), mesh)


def distribute_tree(tree: Tree, shardings: Tree) -> Tree:
    """Place every tensor of ``tree`` on its mesh by its Sharding: a full
    tensor by ``distribute_tensor`` (every rank passes the same full
    tensor), a DTensor (a step's output fed to the next step) by
    ``redistribute``."""
    return tree_map(lambda t, s: t.redistribute(s.mesh, s.placements)
                    if isinstance(t, DTensor)
                    else distribute_tensor(t, s.mesh, s.placements),
                    tree, shardings)


def with_sharding_constraint(x, mesh, rules: ShardingRules,
                             logical_axes: Sequence[Optional[str]]):
    """Give an intermediate a logical sharding: a DTensor is
    redistributed to it, a plain tensor (the same on every rank) is
    distributed by it."""
    place = rules.sharding(logical_axes, x.shape, mesh).placements
    if isinstance(x, DTensor):
        return x.redistribute(mesh, place)
    return distribute_tensor(x, mesh, place)


# --------------------------------------------------------------------------
# activation-sharding context: model code constrains intermediates by
# logical axes without threading (mesh, rules) through every call.
# --------------------------------------------------------------------------

_ACT_CTX = threading.local()


@contextlib.contextmanager
def activation_sharding(mesh, rules: ShardingRules):
    """Install (mesh, rules) for :func:`constrain` while the step runs."""
    prev = getattr(_ACT_CTX, "value", None)
    _ACT_CTX.value = (mesh, rules)
    try:
        yield
    finally:
        _ACT_CTX.value = prev


def constrain(x, logical_axes: Sequence[Optional[str]],
              shape: Optional[Sequence[int]] = None):
    """Pin an intermediate to its logical sharding: a DTensor is
    redistributed to the rule's placements. A no-op outside
    :func:`activation_sharding` and on a plain tensor.

    ``shape`` is the shape the axes name when ``x`` is about to be viewed
    with its last dim split (heads x head_dim): the spec is worked out
    for that view, whose leading dims are ``x``'s, so a dim whose split
    does not divide the mesh axis is replicated before the view, which
    DTensor could not take with a shard ending inside a head.

    The pins keep the data-parallel batch dim and the vocab/model dims of
    large intermediates sharded, as the reference's GSPMD hints do.
    """
    ctx = getattr(_ACT_CTX, "value", None)
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    spec = rules.spec(logical_axes, x.shape if shape is None else shape,
                      mesh)
    return x.redistribute(mesh, placements(spec, mesh))


def _map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def replicated(fn, *args):
    """``fn(*args)`` with every DTensor argument gathered whole
    (``Replicate()`` on every mesh dim, differentiably) and ``fn`` run on
    the local tensors; its tensor outputs come back as replicated
    DTensors. Without a DTensor argument, plain ``fn(*args)``.

    For the ops of a sublayer that have no DTensor sharding strategy:
    every rank computes the whole sublayer, the same on each.
    """
    meshes = []

    def whole(t):
        if isinstance(t, DTensor):
            meshes.append(t.device_mesh)
            return t.full_tensor()
        return t

    out = fn(*_map(whole, args))
    if not meshes:
        return out
    mesh = meshes[0]
    place = [Replicate()] * mesh.ndim
    return _map(lambda t: DTensor.from_local(t, mesh, place, run_check=False)
                if isinstance(t, torch.Tensor) else t, out)


def per_shard(fn, args: Sequence, roles: Sequence, out_roles):
    """``fn(*args)`` on each rank's local shards, for a function that is
    independent along the dims its roles name (each argument's roles: a
    name per dim, None for a dim ``fn`` mixes or reduces; None for an
    argument that is not a tensor).

    A mesh dim keeps sharding a role when the first DTensor argument
    shards that role's dim over it and every argument's dim of that role
    divides it; the arguments are redistributed to that (a plain tensor
    is taken as replicated), and every other mesh dim replicates. The
    outputs come back as DTensors placed by the same rule; ``out_roles``
    mirrors the output, whose tuples and dicts may nest. An argument that
    lacks a sharded role (a weight shared by the batch) gets its gradient
    as a partial sum over that mesh dim, each rank's being its shard's
    share. Without a DTensor argument, plain ``fn(*args)``.

    For the ops torch 2.11's DTensor cannot take sharded: an einsum
    flattens its batch dims (batch, heads) into one, which it refuses
    while both are sharded; a pad along an unsharded dim; the backward of
    an embedding lookup.
    """
    lead = next((i for i, a in enumerate(args) if isinstance(a, DTensor)),
                None)
    if lead is None:
        return fn(*args)
    mesh = args[lead].device_mesh
    sharded = []
    for m, p in enumerate(args[lead].placements):
        role = roles[lead][p.dim] if isinstance(p, Shard) else None
        if role is not None and any(
                a.shape[d] % mesh.size(m)
                for a, rl in zip(args, roles) if rl is not None
                for d, r in enumerate(rl) if r == role):
            role = None
        sharded.append(role)

    def place(rl):
        return [Shard(rl.index(r)) if r is not None and r in rl
                else Replicate() for r in sharded]

    def grad_place(rl):
        # an argument without a sharded role gets, on each rank, the
        # gradient of that rank's shard only: a partial sum
        return [Partial() if r is not None and r not in rl else p
                for r, p in zip(sharded, place(rl))]

    local = []
    for a, rl in zip(args, roles):
        if rl is not None:
            if not isinstance(a, DTensor):
                a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                       run_check=False)
            a = a.redistribute(mesh, place(rl)).to_local(
                grad_placements=grad_place(rl))
        local.append(a)

    def wrap(t, rl):
        if isinstance(t, torch.Tensor):
            return DTensor.from_local(t, mesh, place(rl), run_check=False)
        if isinstance(t, dict):
            return {k: wrap(v, rl[k]) for k, v in t.items()}
        if isinstance(t, tuple):
            return tuple(wrap(v, r) for v, r in zip(t, rl))
        return t

    return wrap(fn(*local), out_roles)
