"""Per-family homogeneous units of a model's layer stack.

Every arch is a stack of identical *units* (dense layer; MoE layer;
zamba2's 6-mamba+shared-attn group; xLSTM's 7-mLSTM+sLSTM group;
llama-vision's 4-self+cross segment; whisper's enc+dec layer pair), so
a step's cost is linear in the unit count. The stage graphs of
:mod:`repro_torch.autotune.stages` group layers by these units.

The port's copy of ``src/repro/roofline/measure.py`` (lines 28-47):
``unit_layers``, ``with_units`` and ``target_units``. ``with_units``
drops the reference's ``scan_unroll=-1`` (a JAX cost-analysis knob the
port's ``ModelConfig`` does not have); the two-point extrapolation that
calls it is not ported here.
"""
from __future__ import annotations

import dataclasses


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
