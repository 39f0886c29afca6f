"""InternLM2-1.8B — dense GQA transformer. [arXiv:2403.17297; hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92544,
    rope_theta=1e6,
    source="arXiv:2403.17297; hf",
))
