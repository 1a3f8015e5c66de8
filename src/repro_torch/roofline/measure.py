"""Per-cell cost measurement via two-point depth extrapolation (the
counterpart of ``repro.roofline.measure``).

Every arch is a stack of identical *units* (dense layer; MoE layer;
zamba2's 6-mamba+shared-attn group; xLSTM's 7-mLSTM+sLSTM group;
llama-vision's 4-self+cross segment; whisper's enc+dec layer pair), so
every cost is linear in the unit count u:

    F(u) = a + b*u      (a: embed/logits-fixed, b: per-unit)

Counting F at u=1 and u=2 recovers (a, b) and F(target) exactly, for
FLOPs, bytes and per-kind collective bytes alike. The stage graphs of
:mod:`repro_torch.autotune.stages` group layers by the same units.

The reference extrapolates because XLA's cost analysis counts a rolled
loop's body once; the port's count (:func:`repro_torch.roofline.analysis.
count_step`) sees every op, so its full-depth count and the extrapolated
one agree, and the two small runs are simply cheaper. ``with_units``
drops the reference's ``scan_unroll=-1``, and ``UNROLL_QBLOCK_SCAN``
has no counterpart: torch has no scan to unroll.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from repro_torch.roofline.analysis import StepCounts, count_step


def unit_layers(cfg) -> int:
    """Layers per homogeneous unit for each family."""
    return {"dense": 1, "moe": 1,
            "hybrid": cfg.shared_attn_every,
            "ssm": cfg.xlstm.slstm_every if cfg.xlstm else 1,
            "vlm": cfg.cross_attn_every,
            "audio": 1}[cfg.family]


def with_units(cfg, units: int):
    """Config truncated to ``units`` homogeneous units."""
    unit = unit_layers(cfg)
    kw = {"n_layers": unit * units}
    if cfg.family == "audio":
        kw["n_encoder_layers"] = units
    return dataclasses.replace(cfg, **kw)


def target_units(cfg) -> int:
    return cfg.n_layers // unit_layers(cfg)


def _extract(counts: StepCounts) -> Dict[str, Any]:
    weighted, by_kind, n_by_kind = counts.collective_bytes()
    return {"flops": counts.flops, "bytes": counts.bytes,
            "coll_weighted": weighted, "coll_by_kind": by_kind,
            "coll_counts": n_by_kind}


def extrapolate(m1: Dict, m2: Dict, u_target: int) -> Dict[str, Any]:
    """Linear extrapolation from u=1, u=2 measurements to u_target."""
    def lin(a1, a2):
        slope = a2 - a1
        return max(a1 + slope * (u_target - 1), 0.0)

    out = {"flops": lin(m1["flops"], m2["flops"]),
           "bytes": lin(m1["bytes"], m2["bytes"]),
           "coll_weighted": lin(m1["coll_weighted"], m2["coll_weighted"])}
    kinds = set(m1["coll_by_kind"]) | set(m2["coll_by_kind"])
    out["coll_by_kind"] = {k: lin(m1["coll_by_kind"].get(k, 0.0),
                                  m2["coll_by_kind"].get(k, 0.0))
                           for k in kinds}
    out["coll_counts"] = {k: int(lin(m1["coll_counts"].get(k, 0),
                                     m2["coll_counts"].get(k, 0)))
                          for k in set(m1["coll_counts"])
                          | set(m2["coll_counts"])}
    return out


def measure_units(cfg, shape, mesh, build_fn, units: int, **build_kw
                  ) -> Dict[str, Any]:
    """The counts of one run of ``cfg`` cut to ``units`` units, its inputs
    the bundle's meta specs placed on ``mesh``."""
    bundle = build_fn(with_units(cfg, units), shape, mesh, **build_kw)
    _, counts = count_step(bundle.step, *bundle.place(*bundle.in_specs))
    return _extract(counts)


def measure_extrapolated(cfg, shape, mesh, build_fn, **build_kw
                         ) -> Dict[str, Any]:
    """A cell's per-rank costs via depth extrapolation.

    ``build_fn(cfg, shape, mesh, **kw) -> StepBundle``; the depth-1 and
    depth-2 variants run on their bundles' meta specs.
    """
    results = [measure_units(cfg, shape, mesh, build_fn, units, **build_kw)
               for units in (1, 2)]
    out = extrapolate(results[0], results[1], target_units(cfg))
    out["measured_units"] = (1, 2)
    out["target_units"] = target_units(cfg)
    return out
