"""SmolLM-135M — llama-architecture small dense model. [hf:HuggingFaceTB/SmolLM-135M]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
    dp_over_model=True,   # 9 heads can't TP-shard over model=16
    rope_theta=1e4,
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
))
