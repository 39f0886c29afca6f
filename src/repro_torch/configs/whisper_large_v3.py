"""Whisper-large-v3 backbone — encoder-decoder transformer. [arXiv:2212.04356]

The conv/mel frontend is a STUB per the assignment: the batch provides
precomputed frame embeddings of shape (batch, encoder_seq, d_model) and the
encoder consumes them directly.  MHA (n_kv_heads == n_heads), learned
positional embeddings (no RoPE) as in the original.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="whisper-large-v3",
    family="audio",
    n_layers=32,                 # decoder layers
    n_encoder_layers=32,
    encoder_seq_len=1500,        # whisper 30 s of audio -> 1500 frames
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    rope_theta=0.0,              # 0 -> learned/sinusoidal positions, no RoPE
    dp_over_model=True,          # 20 heads can't TP-shard over model=16
    source="arXiv:2212.04356; unverified",
))
