"""llama-3.2-vision-90b [vlm] — gated cross-attention image layers; the
vision tower is a stub.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]. Every 5th layer is a
tanh-gated cross-attention layer over precomputed patch embeddings
(B, 1601, 8192). The 100 layers count the interleaved cross layers (20
cross + 80 self). Full attention => long_500k skipped. About 90B
parameters: one 80 GB card holds it only with its depth cut.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    rope_theta=500_000.0,
    cross_attn_every=5,
    n_frontend_tokens=1601,
)
