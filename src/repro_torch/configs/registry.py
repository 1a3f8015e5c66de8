"""Architecture registry of the port: ``--arch <id>`` -> ModelConfig.

All ten archs of the reference registry, in its six families
(``ARCH_IDS``), and the archs of the port alone (``PORT_ARCH_IDS``:
granite-4.0-h-small, family hybrid_moe; deepseek-v2-lite, family moe
with latent attention), which the reference lacks.
``get_config(id)`` returns the full published config;
``reduced_config(id)`` a tiny same-family fp32 config for CPU tests, with
no rematerialisation. The values are the reference
registry's, so configs compare field by field.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs import (deepseek_v2_lite, granite_4p0_h_small,
                                 granite_moe_3b_a800m, llama3p2_vision_90b,
                                 olmo_1b, qwen1p5_32b, qwen2_moe_a2p7b,
                                 qwen3_0p6b, starcoder2_7b, whisper_tiny,
                                 xlstm_350m, zamba2_1p2b)
from repro_torch.models.mamba2 import SSMConfig
from repro_torch.models.mla import MLAConfig
from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.xlstm import XLSTMConfig

_MODULES = [zamba2_1p2b, qwen2_moe_a2p7b, granite_moe_3b_a800m, xlstm_350m,
            starcoder2_7b, qwen3_0p6b, qwen1p5_32b, olmo_1b, whisper_tiny,
            llama3p2_vision_90b]

#: archs of the port alone
_PORT_MODULES = [granite_4p0_h_small, deepseek_v2_lite]

ARCH_IDS: List[str] = [m.CONFIG.name for m in _MODULES]
PORT_ARCH_IDS: List[str] = [m.CONFIG.name for m in _PORT_MODULES]
CONFIGS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG
                                   for m in _MODULES + _PORT_MODULES}


def get_config(name: str, **overrides) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; choose from "
                       f"{ARCH_IDS + PORT_ARCH_IDS}")
    cfg = CONFIGS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def reduced_config(name: str, **overrides) -> ModelConfig:
    """Tiny same-family config: same block structure, laptop-sized dims,
    fp32 so CPU numerics are tight."""
    cfg = get_config(name)
    r = dict(d_model=128, n_heads=4, kv_heads=min(cfg.kv_heads, 4),
             head_dim=32, d_ff=256, vocab=512, vocab_pad=64, n_layers=4,
             dtype="float32", remat="none",
             max_pos=256 if cfg.max_pos else 0,
             n_frontend_tokens=16 if cfg.n_frontend_tokens else 0,
             n_encoder_layers=2 if cfg.n_encoder_layers else 0)
    if cfg.moe is not None:
        r["moe"] = MoEConfig(
            n_experts=8, top_k=2, expert_ff=64,
            shared_ff=128 if cfg.moe.shared_ff else 0,
            norm_topk=cfg.moe.norm_topk, shared_gated=cfg.moe.shared_gated)
        r["d_ff"] = 64
    if cfg.ssm is not None:
        r["ssm"] = SSMConfig(state=16, head_dim=32, expand=2, conv_kernel=4,
                             chunk=32, conv_xbc=cfg.ssm.conv_xbc,
                             pad_to_chunk=cfg.ssm.pad_to_chunk)
    if cfg.mla is not None:
        # heads of 16 + 16 rope dims against a 64-wide latent
        r.update(mla=MLAConfig(kv_rank=64, nope_dim=16, rope_dim=16,
                               v_dim=32), head_dim=32)
    if cfg.attn_layers:
        # one attention layer among three Mamba2 ones, a GQA group of 2
        r.update(attn_layers=(1,), kv_heads=2)
    if cfg.xlstm is not None:
        r["xlstm"] = XLSTMConfig(n_heads=4, expand=2, conv_kernel=4,
                                 slstm_every=2,
                                 ffn_factor=cfg.xlstm.ffn_factor)
    if cfg.shared_attn_every:
        r["shared_attn_every"] = 2
        r["shared_attn_d_ff"] = 256
    if cfg.cross_attn_every:
        r["cross_attn_every"] = 2
    r.update(overrides)
    return dataclasses.replace(cfg, **r)
