"""qwen3-0.6b [dense] — per-head qk-norm, GQA, tied embeddings.

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936
[hf:Qwen/Qwen3-8B; hf]. head_dim=128 (decoupled from d_model/n_heads,
as in the HF config). Full attention => long_500k skipped.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)
