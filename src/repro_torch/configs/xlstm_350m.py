"""xLSTM-350M — sLSTM + mLSTM blocks, attention-free. [arXiv:2405.04517]

d_ff=0 per the assignment: xLSTM blocks carry their own up/down projections
(proj_factor), there is no separate transformer FFN.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig, register

CONFIG = register(ModelConfig(
    arch_id="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50304,
    xlstm=XLSTMConfig(slstm_every=6, proj_factor=2.0, conv_kernel=4),
    dp_over_model=True,   # 4 heads can't TP-shard over model=16
    source="arXiv:2405.04517; unverified",
))
