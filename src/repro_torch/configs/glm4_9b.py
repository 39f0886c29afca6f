"""GLM4-9B — dense transformer, aggressive GQA (kv=2), RoPE. [hf:THUDM/glm-4-9b]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    rope_theta=1e6,
    source="hf:THUDM/glm-4-9b; hf",
))
