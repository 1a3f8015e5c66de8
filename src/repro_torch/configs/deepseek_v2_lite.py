"""deepseek-v2-lite [moe] — multi-head latent attention, a leading dense
layer, then 64 routed experts (top-6) and 2 shared ones in every layer.

27L d_model=2048, 16 heads, vocab=102400, untied embeddings
[hf:deepseek-ai/DeepSeek-V2-Lite config.json]. Attention is latent
(MLA) with no query compression: q is 16 x (128 + 64 rope) dims; the
keys and values come from a 512-wide latent (RMSNorm at eps 1e-6) and
one 64-wide rope key shared by the heads, then 16 x (128 k_nope + 128 v);
the decode cache keeps one 576-wide row a position. The rope dims turn
under YaRN (factor 40 over 4,096 original positions, beta 32 / 1,
mscale = mscale_all_dim = 0.707, theta 10,000: a 163,840 context; the
equal mscales leave cos and sin unscaled), and the scores are scaled by
192^-1/2 times the mscale squared. Layer 0 has
a dense SwiGLU of width 10944 (``first_k_dense_replace`` 1); layers
1-26 a softmax router over 64 experts of width 1408, the top-6 weights
not renormalised (scale 1), plus the 2 shared experts as one ungated
SwiGLU of width 2816. ``head_dim`` is the q.k width, 128 + 64.
"""
from repro_torch.models.layers import YarnConfig
from repro_torch.models.mla import MLAConfig
from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    kv_heads=16,
    head_dim=192,
    d_ff=10944,
    vocab=102400,
    rope_theta=10000.0,
    tie_embeddings=False,
    moe=MoEConfig(n_experts=64, top_k=6, expert_ff=1408, shared_ff=2816,
                  shared_gated=False, norm_topk=False),
    mla=MLAConfig(kv_rank=512, nope_dim=128, rope_dim=64, v_dim=128),
    yarn=YarnConfig(factor=40.0, original_max_pos=4096, beta_fast=32.0,
                    beta_slow=1.0, mscale_all_dim=0.707),
    dense_layers=1,
)
