"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4.

24L d_model=2048 16H (GQA kv=16) expert d_ff=1408 vocab=151936
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]. Shared-expert width 5632 (4x1408),
sigmoid-gated; QKV bias per the Qwen1.5 lineage.
"""
from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab=151936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=60, top_k=4, expert_ff=1408, shared_ff=5632,
                  norm_topk=False),
)
