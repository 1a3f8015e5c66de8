"""granite-moe-3b-a800m [moe] — 40 routed experts, top-8.

32L d_model=1536 24H (GQA kv=8) expert d_ff=512 vocab=49155
[hf:ibm-granite; spec line followed where it differs from the HF
pointer]. Top-k gate renormalization; no shared experts.
"""
from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=40, top_k=8, expert_ff=512, shared_ff=0,
                  norm_topk=True),
)
