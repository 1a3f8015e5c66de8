"""Stage graphs: decompose a model's step into an AARC workflow DAG.

Stages are layer groups plus embed/head nodes; families with parallel
structure get parallel branches (the critical-path machinery needs
them): whisper's encoder runs beside the decoder-prompt embed, MoE
layers split into routed/shared expert branches, zamba2 interleaves the
shared-attention block beside the mamba trunk.

Per-stage workload numbers (FLOPs, parameter/activation bytes) are
analytic from the config dims — the same napkin math as the roofline —
or, when a dry-run artifact is supplied, calibrated to the measured
per-unit slope.

The port's copy of ``src/repro/autotune/stages.py`` (lines 1-141). The
optimizer stage's ``cfg.n_params()`` counts the port's parameters on the
meta device, where the reference runs ``jax.eval_shape``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.dag import Workflow
from repro_torch.roofline.measure import target_units, unit_layers


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """Analytic workload of one stage (whole-step, all chips)."""
    name: str
    flops: float                 # total FLOPs for this stage's work
    param_bytes: float           # weights it must stream
    act_bytes: float             # full (no-remat) activation residency
    min_chips: int = 1           # sharding floor (divisibility)


def _tokens(shape) -> int:
    return shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                 else 1)


def _layer_flops(cfg, shape, train: bool) -> float:
    """Per-layer matmul FLOPs (fwd; x3 for train fwd+bwd)."""
    d = cfg.d_model
    t = _tokens(shape)
    hd = cfg.hd
    attn_proj = 2 * t * d * hd * (cfg.n_heads + 2 * cfg.kv_heads) \
        + 2 * t * cfg.n_heads * hd * d
    if shape.kind == "decode":
        s_ctx = shape.seq_len
        attn_score = 2 * shape.global_batch * cfg.n_heads * hd * s_ctx * 2
    else:
        attn_score = 2 * t * shape.seq_len // 2 * cfg.n_heads * hd * 2
    if cfg.moe is not None:
        ffn = 3 * 2 * t * d * cfg.moe.expert_ff * cfg.moe.top_k \
            + 3 * 2 * t * d * cfg.moe.shared_ff
    elif cfg.d_ff:
        n_mats = 3 if cfg.mlp == "swiglu" else 2
        ffn = n_mats * 2 * t * d * cfg.d_ff
    else:  # xlstm: block-internal projections ~ 8 d^2 per token
        ffn = 2 * t * d * d * 8
    if cfg.ssm is not None:
        di = cfg.ssm.expand * d
        ffn = 2 * t * d * di * 3 + 2 * t * di * cfg.ssm.state * 2
    total = attn_proj + attn_score + ffn
    return total * (3.0 if train else 1.0)


def _layer_param_bytes(cfg) -> float:
    d, hd = cfg.d_model, cfg.hd
    attn = d * hd * (cfg.n_heads + 2 * cfg.kv_heads) + cfg.n_heads * hd * d
    if cfg.moe is not None:
        ffn = 3 * d * cfg.moe.expert_ff * cfg.moe.n_experts \
            + 3 * d * cfg.moe.shared_ff
    elif cfg.d_ff:
        ffn = (3 if cfg.mlp == "swiglu" else 2) * d * cfg.d_ff
    else:
        ffn = 8 * d * d
    if cfg.ssm is not None:
        ffn = 3 * d * cfg.ssm.expand * d
    return (attn + ffn) * 2.0            # bf16


def _layer_act_bytes(cfg, shape) -> float:
    t = _tokens(shape)
    return t * cfg.d_model * 2.0 * 4.0   # residual + a few intermediates


def build_stage_graph(cfg, shape, *, group_units: Optional[int] = None,
                      train: Optional[bool] = None) -> Workflow:
    """Workflow whose nodes carry StageSpecs for (cfg, shape)."""
    train = shape.kind == "train" if train is None else train
    units = target_units(cfg)
    ul = unit_layers(cfg)
    group_units = group_units or max(1, units // 4)
    t = _tokens(shape)
    d, v = cfg.d_model, cfg.padded_vocab

    wf = Workflow(f"{cfg.name}:{shape.name}")
    lf = _layer_flops(cfg, shape, train) * ul
    lp = _layer_param_bytes(cfg) * ul
    la = _layer_act_bytes(cfg, shape) * ul

    embed = StageSpec("embed", flops=2 * t * d, param_bytes=2.0 * v * d,
                      act_bytes=t * d * 2.0)
    wf.add_function("embed", payload=embed)
    prev = "embed"

    if cfg.family == "audio":
        # encoder branch runs parallel to the decoder-side embed
        enc = StageSpec("encoder",
                        flops=_layer_flops(cfg, shape, train)
                        * cfg.n_encoder_layers,
                        param_bytes=_layer_param_bytes(cfg)
                        * cfg.n_encoder_layers,
                        act_bytes=_layer_act_bytes(cfg, shape)
                        * cfg.n_encoder_layers)
        wf.add_function("encoder", payload=enc)

    n_groups = max(1, units // group_units)
    for g in range(n_groups):
        k = group_units if g < n_groups - 1 else \
            units - group_units * (n_groups - 1)
        spec = StageSpec(f"layers_{g}", flops=lf * k, param_bytes=lp * k,
                         act_bytes=la * k)
        name = f"layers_{g}"
        wf.add_function(name, payload=spec)
        wf.add_edge(prev, name)
        if cfg.family == "audio" and g == 0:
            wf.add_edge("encoder", name)     # cross-attn needs enc out
        prev = name

    head_flops = 2 * t * d * v * (3.0 if train else 1.0)
    head = StageSpec("head", flops=head_flops, param_bytes=2.0 * v * d,
                     act_bytes=t * v * 4.0 * (1.0 if train else 0.1))
    wf.add_function("head", payload=head)
    wf.add_edge(prev, "head")

    if train:
        opt = StageSpec("optimizer", flops=cfg.n_params() * 8.0,
                        param_bytes=cfg.n_params() * 18.0,
                        act_bytes=0.0)
        wf.add_function("optimizer", payload=opt)
        wf.add_edge("head", "optimizer")
    return wf
