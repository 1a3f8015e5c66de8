"""Three-term roofline of a step run on a mesh (counterpart of
``repro.roofline.analysis``):

  compute    = FLOPs per rank / peak bf16 FLOP/s
  memory     = bytes per rank / HBM bandwidth
  collective = sum of per-op payload x alg_factor / (NVLink link
               bandwidth x links per chip)

Torch has no compiled artifact to ask, so the step is run (the dry run
runs it on the meta device, over a fake process group) under the two
dispatch modes of :func:`count_step`:

* the outer one sees every op the step calls, a DTensor op at its global
  shape. It counts the op's FLOPs with ``torch.utils.flop_counter``'s
  registry and scales them to one rank: a mesh dim over which the op's
  output is sharded (``Shard``) or its contraction split (``Partial``)
  divides the work by that dim's size, a replicated one does not. An op
  on plain tensors (inside ``sharding.per_shard``, on local shards) is
  counted as it is. It also counts bytes: each op's tensor inputs read
  once and its outputs written once, at their local (per-rank) sizes,
  views not counted, an indexing op charged only what it gathers or
  scatters; and the live bytes of what the ops allocate, whose peak is
  the step's temporary memory.
* the inner one returns ``NotImplemented`` for a DTensor op, so DTensor
  runs the op with it still active, and it sees the collectives DTensor
  issues on local tensors (``_c10d_functional``'s all-gather,
  all-reduce, reduce-scatter and all-to-all), implicit ones included. For
  each it records the *result* buffer's bytes, as the reference's
  ``collective_bytes`` reads them from the HLO text.

What the count leaves out: the FLOP registry counts matmul-like ops (mm,
bmm, addmm, baddbmm, convolutions, SDPA), while XLA's ``cost_analysis``
also counts elementwise work, so ``flops_per_chip`` here is not the
reference's number. Bytes charge a DTensor input at its local size even
where DTensor gathers it first (that traffic shows as a collective). The
collective term uses NVLink's constants (``H100_SXM``), which describe
one 8-card node, not a fabric of hundreds of cards.

MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference), N the active params,
gives the useful-compute ratio, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Dict, Iterable, List, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Shard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.hw import H100_SXM, HardwareSpec

_DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.float8_e4m3fn: 1,
    torch.float8_e5m2: 1, torch.int16: 2, torch.bfloat16: 2,
    torch.float16: 2, torch.int32: 4, torch.float32: 4, torch.int64: 8,
    torch.float64: 8, torch.complex64: 8, torch.complex128: 16,
}

#: ring-algorithm traffic factor per collective kind (payload multiples
#: crossing a chip's links): all-reduce = reduce-scatter + all-gather.
_ALG_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

#: the functional collectives DTensor issues, by the reference's kinds
_COLLECTIVE_KIND = {
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
}


#: indexing ops whose traffic is what they gather (the indices, and the
#: output read and written) or what they scatter (the indices and values,
#: read and written), not the whole tensor indexed
_GATHERS = {"aten::index", "aten::gather", "aten::embedding",
            "aten::index_select"}
_SCATTERS = {"aten::index_put_", "aten::index_put", "aten::_index_put_impl_"}


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    return []


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def local_bytes(tree) -> int:
    """Bytes of every tensor of ``tree`` on one rank (a DTensor's local
    shard)."""
    return sum(_local(t).numel() * _DTYPE_BYTES[t.dtype]
               for t in _tensors(tree))


def collective_bytes(ops: Iterable[Tuple[str, int]]
                     ) -> Tuple[float, Dict[str, float], Dict[str, int]]:
    """(kind, result bytes) records of a step's collectives -> the
    reference's (weighted_bytes, bytes_by_kind, count_by_kind);
    weighted_bytes already includes the per-kind algorithm factor."""
    by_kind_bytes: Dict[str, float] = {}
    by_kind_count: Dict[str, int] = {}
    weighted = 0.0
    for kind, nbytes in ops:
        by_kind_bytes[kind] = by_kind_bytes.get(kind, 0.0) + nbytes
        by_kind_count[kind] = by_kind_count.get(kind, 0) + 1
        weighted += nbytes * _ALG_FACTOR[kind]
    return weighted, by_kind_bytes, by_kind_count


def _rank_share(out) -> float:
    """One rank's share of the work of an op whose first output is
    ``out``: 1 / size of every mesh dim that shards the output or splits
    its contraction; 1 for a plain tensor (already local)."""
    first = _tensors(out)
    if not first or not isinstance(first[0], DTensor):
        return 1.0
    t = first[0]
    share = 1.0
    for dim, p in enumerate(t.placements):
        if isinstance(p, (Shard, Partial)):
            share /= t.device_mesh.size(dim)
    return share


class _Live:
    """Live bytes of what a step allocates, and their peak."""

    def __init__(self):
        self.live = 0
        self.peak = 0

    def alloc(self, t: torch.Tensor, nbytes: int) -> None:
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, nbytes)

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes


class _Collectives(TorchDispatchMode):
    """The inner mode: the collectives DTensor runs on local tensors."""

    def __init__(self, live: _Live):
        super().__init__()
        self.ops: List[Tuple[str, int]] = []
        self.live = live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # DTensor runs it, this mode active
        out = func(*args, **(kwargs or {}))
        kind = _COLLECTIVE_KIND.get(func.name())
        if kind is not None:
            for t in _tensors(out):
                nbytes = t.numel() * _DTYPE_BYTES[t.dtype]
                self.ops.append((kind, nbytes))
                self.live.alloc(t, nbytes)
        return out


class _Work(TorchDispatchMode):
    """The outer mode: FLOPs, bytes and allocations per rank."""

    def __init__(self, live: _Live):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.live = live

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.name() in _COLLECTIVE_KIND or func.is_view:
            return out                   # counted by the inner mode / free
        share = _rank_share(out)
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out) * share
        ins = _tensors((args, kwargs))
        fresh = [t for t in _tensors(out) if not any(t is a for a in ins)]
        name = func.name()
        if name in _GATHERS:              # reads only what it gathers
            self.bytes += local_bytes(ins[1:]) + 2 * local_bytes(fresh)
        elif name in _SCATTERS:           # writes only its values
            self.bytes += local_bytes(ins[1:]) + local_bytes(ins[-1])
        else:
            self.bytes += local_bytes(ins) + local_bytes(fresh)
        for t in fresh:
            self.live.alloc(t, local_bytes(t))
        return out


@dataclasses.dataclass
class StepCounts:
    """What one run of a step costs one rank."""
    flops: float
    bytes: float
    collectives: List[Tuple[str, int]]
    argument_bytes: int
    output_bytes: int
    alias_bytes: int
    temp_bytes: int
    seconds: float

    def collective_bytes(self):
        return collective_bytes(self.collectives)


def _storages(tree) -> set:
    return {_local(t).untyped_storage()._cdata for t in _tensors(tree)}


def count_step(step, *args) -> Tuple[Any, StepCounts]:
    """Run ``step(*args)`` under the counting modes; returns its output
    and what it cost one rank. ``alias_bytes`` are the output bytes that
    live in an input's storage (a cache updated in place)."""
    live = _Live()
    inner, outer = _Collectives(live), _Work(live)
    t0 = time.perf_counter()
    with torch.no_grad(), inner, outer:
        out = step(*args)
    seconds = time.perf_counter() - t0
    in_storages = _storages(args)
    aliased = [t for t in _tensors(out)
               if _local(t).untyped_storage()._cdata in in_storages]
    return out, StepCounts(
        flops=outer.flops, bytes=outer.bytes, collectives=inner.ops,
        argument_bytes=local_bytes(args), output_bytes=local_bytes(out),
        alias_bytes=local_bytes(aliased), temp_bytes=live.peak,
        seconds=seconds)


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_weighted: float
    collective_by_kind: Dict[str, float]
    collective_counts: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float = 0.0
    useful_ratio: float = 0.0
    peak_memory_per_chip: float = 0.0

    @property
    def bound_time(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   coll_weighted_bytes: float,
                   hw: HardwareSpec = H100_SXM) -> Tuple[float, float, float]:
    compute = flops_per_chip / hw.peak_flops_bf16
    memory = bytes_per_chip / hw.hbm_bandwidth
    collective = coll_weighted_bytes / (hw.nvlink_link_bandwidth *
                                        hw.nvlink_links_per_chip)
    return compute, memory, collective


def dominant_term(compute_s: float, memory_s: float,
                  collective_s: float) -> str:
    return max((("compute", compute_s), ("memory", memory_s),
                ("collective", collective_s)), key=lambda kv: kv[1])[0]


def analyze_step(step, args, *, arch: str, shape: str, mesh_desc: str,
                 chips: int, model_flops: float = 0.0,
                 hw: HardwareSpec = H100_SXM) -> RooflineReport:
    """Roofline terms of one run of ``step(*args)`` (the counterpart of
    the reference's ``analyze_lowered``)."""
    _, counts = count_step(step, *args)
    weighted, by_kind, n_by_kind = counts.collective_bytes()
    compute_s, memory_s, collective_s = roofline_terms(
        counts.flops, counts.bytes, weighted, hw)
    useful = (model_flops / chips / counts.flops) if counts.flops else 0.0
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_desc, chips=chips,
        flops_per_chip=counts.flops, bytes_per_chip=counts.bytes,
        collective_bytes_weighted=weighted, collective_by_kind=by_kind,
        collective_counts=n_by_kind, compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s,
        dominant=dominant_term(compute_s, memory_s, collective_s),
        model_flops=model_flops, useful_ratio=useful,
        peak_memory_per_chip=float(counts.temp_bytes + counts.argument_bytes
                                   + counts.output_bytes
                                   - counts.alias_bytes))


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N·D for inference steps.

    N = active params; D = tokens processed by the step (decode: one
    token per sequence).
    """
    n = cfg.n_active_params()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch          # one new token per sequence
    return 2.0 * n * tokens
