"""whisper-tiny [audio] — encoder-decoder backbone; the conv frontend is
a stub.

4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865 [arXiv:2212.04356;
unverified]. The modality frontend is a stub: the encoder takes
precomputed frame embeddings (B, 1500, 384), 30 s of audio at the
post-conv 50 Hz frame rate. The decoder uses learned positions (the
table is extended to 32k for the synthetic decode_32k cell; the real
model stops at 448). Full attention => long_500k skipped.
"""
from repro_torch.models.model import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    n_encoder_layers=4,
    d_model=384,
    n_heads=6,
    kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab=51865,
    norm="layernorm",
    mlp="gelu",
    qkv_bias=True,
    rope_theta=None,
    tie_embeddings=True,
    n_frontend_tokens=1500,
    max_pos=32_768,
)
