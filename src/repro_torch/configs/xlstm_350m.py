"""xlstm-350m [ssm] — sLSTM + mLSTM blocks (Beck et al. 2024).

24L d_model=1024 4H d_ff=0 vocab=50304 [arXiv:2405.04517; unverified].
d_ff=0: the xLSTM blocks carry their own projections (mLSTM: 2x
up-projection + gated down; sLSTM: a GeLU FFN of factor 4/3 after the
recurrence). Every 8th block is a recurrent sLSTM, the rest are
chunkwise-parallel mLSTM. Sub-quadratic => runs long_500k.
"""
from repro_torch.models.model import ModelConfig
from repro_torch.models.xlstm import XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    kv_heads=4,
    d_ff=0,
    vocab=50304,
    rope_theta=None,
    xlstm=XLSTMConfig(n_heads=4, expand=2, conv_kernel=4, slstm_every=8,
                      ffn_factor=4.0 / 3.0),
    sub_quadratic=True,
)
