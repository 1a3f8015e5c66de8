"""olmo-1b [dense] — non-parametric LayerNorm, tied embeddings.

16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304
[arXiv:2402.00838; hf]. Full attention => long_500k skipped.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab=50304,
    norm="nonparametric",
    mlp="swiglu",
    tie_embeddings=True,
    rope_theta=10000.0,
)
