"""Zamba2-2.7B — Mamba2 backbone + shared attention block. [arXiv:2411.15242]

54 Mamba2 (SSD) layers; a single *shared* attention+MLP block is applied
every ``shared_attn_every`` layers (weight-tied across applications), as in
the Zamba2 design.  ssm_state=64.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    arch_id="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=10240,                  # shared block MLP width
    vocab_size=32000,
    shared_attn_every=6,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    source="arXiv:2411.15242; hf",
))
