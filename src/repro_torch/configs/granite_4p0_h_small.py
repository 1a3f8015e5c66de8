"""granite-4.0-h-small [hybrid_moe] — Mamba2 mixers, attention on 4 of
40 layers, 72 routed experts (top-10) and a shared expert after every
mixer.

40L d_model=4096, vocab=100352, tied embeddings
[hf:ibm-granite/granite-4.0-h-small config.json]. Mamba2 on 36 layers:
128 heads of 64 (expand 2), state 128, one group, conv 4 over x, B and C
with a bias. GQA attention 32/8 heads of 128 on layers 5, 15, 25 and 35,
with no position embedding (NoPE). Experts of width 768, the top-10
renormalised (softmax over the top-k), a shared expert of width 1536
added ungated. Granite's scalars: embeddings x12, attention scores
x0.0078125, each sublayer's output x0.22 before its residual add, the
logits /16; every RMSNorm at eps 1e-5.

The published chunk of the SSD scan is 256; the port's kernels hold at
most 128 rows a chunk, so the chunk here is 128. The chunked scan is an
exact rewriting of the recurrence: the chunk changes only the order of
the sums, not the result.
"""
from repro_torch.models.mamba2 import SSMConfig
from repro_torch.models.model import ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family="hybrid_moe",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    kv_heads=8,
    head_dim=128,
    d_ff=768,
    vocab=100352,
    rope_theta=None,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=72, top_k=10, expert_ff=768, shared_ff=1536,
                  norm_topk=True, shared_gated=False),
    ssm=SSMConfig(state=128, head_dim=64, expand=2, conv_kernel=4, chunk=128,
                  conv_xbc=True, pad_to_chunk=True),
    attn_layers=(5, 15, 25, 35),
    embedding_multiplier=12.0,
    attention_multiplier=0.0078125,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    norm_eps=1e-5,
)
