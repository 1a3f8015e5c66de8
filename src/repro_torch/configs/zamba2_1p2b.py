"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]. The single *shared* transformer block (attn +
MLP, d_ff=8192) is applied every 6th backbone layer; Mamba2 state
N=64, head_dim=64, expand=2. Sub-quadratic => runs long_500k.
"""
from repro_torch.models.mamba2 import SSMConfig
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab=32000,
    norm="rmsnorm",
    mlp="swiglu",
    rope_theta=10000.0,
    ssm=SSMConfig(state=64, head_dim=64, expand=2, conv_kernel=4, chunk=128),
    shared_attn_every=6,
    shared_attn_d_ff=8192,
    sub_quadratic=True,
)
