"""starcoder2-7b [dense] — GQA kv=4, RoPE, LayerNorm + biased GeLU MLP.

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152
[arXiv:2402.19173; hf]. Full attention => long_500k skipped.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab=49152,
    norm="layernorm",
    mlp="gelu",
    qkv_bias=True,
    rope_theta=100_000.0,
)
