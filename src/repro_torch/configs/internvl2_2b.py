"""InternVL2-2B — InternViT frontend (STUB) + InternLM2 backbone. [arXiv:2404.16821]

The ViT frontend is a stub per the assignment: the batch provides
precomputed patch embeddings (batch, n_image_patches, d_model) which are
prepended to the token embeddings.  Backbone matches internlm2 at 2B scale.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    arch_id="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    n_image_patches=256,         # one 448x448 tile -> 256 visual tokens
    rope_theta=1e6,
    source="arXiv:2404.16821; hf",
))
