"""DeepSeek-V3 671B — MLA + fine-grained MoE (1 shared + 256 routed, top-8).
[arXiv:2412.19437; hf]

First 3 layers are dense (d_ff=18432); remaining 58 are MoE with per-expert
hidden 2048.  MLA dims per the tech report.  MTP head omitted from the
compute graph (training objective substrate implements next-token CE; MTP is
an auxiliary head, noted in DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig, register

CONFIG = register(ModelConfig(
    arch_id="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,              # MLA: latent KV, head count == n_heads
    head_dim=128,                # nope head dim; rope part in MLAConfig
    d_ff=18432,                  # dense layers' FFN width
    vocab_size=129280,
    rope_theta=1e4,
    moe=MoEConfig(
        n_experts=256,
        n_experts_per_tok=8,
        d_ff_expert=2048,
        n_shared_experts=1,
        n_dense_layers=3,
        capacity_factor=1.25,
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    remat="full",
    prefill_chunks=8,
    source="arXiv:2412.19437; hf",
))
