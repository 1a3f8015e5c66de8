"""qwen1.5-32b [dense] — QKV bias, full MHA-equivalent GQA (kv=40).

64L d_model=5120 40H (GQA kv=40) d_ff=27392 vocab=152064
[hf:Qwen/Qwen1.5-0.5B; hf]. Full attention => long_500k skipped.
The heaviest dense cell (~32B params) — the FSDP/ZeRO sizing case.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
