"""DBRX-132B — fine-grained MoE, 16 experts top-4, GQA kv=8. [hf:databricks/dbrx-base]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    arch_id="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,                  # (unused: every layer is MoE; kept for report)
    vocab_size=100352,
    rope_theta=5e5,
    moe=MoEConfig(
        n_experts=16,
        n_experts_per_tok=4,
        d_ff_expert=10752,
        n_shared_experts=0,
        n_dense_layers=0,
        capacity_factor=1.25,
    ),
    remat="full",
    prefill_chunks=8,
    source="hf:databricks/dbrx-base; unverified",
))
