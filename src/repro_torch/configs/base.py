"""Config system: architecture + shape + run configs.

Every assigned architecture is described by one :class:`ModelConfig`.  The
same dataclass covers dense / MoE / enc-dec / VLM / SSM / hybrid families so
that the model builder (``repro_torch.models.model``) can be driven purely by
config — no per-arch model code outside the block library.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0              # routed experts
    n_experts_per_tok: int = 0      # top-k
    d_ff_expert: int = 0            # per-expert hidden
    n_shared_experts: int = 0       # DeepSeek-style always-on experts
    n_dense_layers: int = 0         # leading layers that stay dense
    capacity_factor: float = 1.25   # dispatch capacity multiplier
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 Multi-head Latent Attention dimensions."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block dimensions."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256


@dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 6            # every k-th block is sLSTM, rest mLSTM
    proj_factor: float = 2.0        # mLSTM up-projection factor
    conv_kernel: int = 4


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                     # dense | moe | audio | vlm | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    # enc-dec (whisper)
    n_encoder_layers: int = 0
    encoder_seq_len: int = 0        # frames fed to the encoder (stub frontend)
    # vlm
    n_image_patches: int = 0        # patch embeddings prepended (stub frontend)
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # hybrid (zamba2): a shared attention+MLP block applied every k ssm layers
    shared_attn_every: int = 0
    # numerics / runtime
    dtype: str = "bfloat16"
    remat: str = "dots"             # nothing | dots | full
    # analysis mode: python-loop the layer stacks instead of lax.scan so
    # cost_analysis sees every layer (roofline correction pass only)
    unroll_stacks: bool = False
    # prefill processes the request batch in this many sequential chunks
    # (lax.map) — bounds prefill activation peak for MoE archs at 32k
    prefill_chunks: int = 1
    # activations shard batch over (dp axes + model): for archs whose head
    # counts don't divide the model axis (smollm 9H, whisper 20H, xlstm 4H)
    # TP replicates activation compute 16x — pure-DP activations instead
    # (§Perf iteration: weights stay rule-sharded; XLA gathers them per
    # layer, which is cheap for <=1.5B-param models)
    dp_over_model: bool = False
    # source provenance, for documentation only
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_enc_dec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
        )
        if self.n_encoder_layers:
            kw["n_encoder_layers"] = 2
            kw["encoder_seq_len"] = 16
        if self.n_image_patches:
            kw["n_image_patches"] = 8
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, n_experts_per_tok=2, d_ff_expert=64,
                n_dense_layers=min(self.moe.n_dense_layers, 1))
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                  qk_nope_head_dim=16, qk_rope_head_dim=8,
                                  v_head_dim=16)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=16,
                                            chunk_size=32)
        if self.xlstm is not None:
            kw["xlstm"] = dataclasses.replace(self.xlstm, slstm_every=2)
        if self.shared_attn_every:
            kw["shared_attn_every"] = 2
        return self.replace(**kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> Tuple[str, ...]:
    """The assigned shape cells for this arch (skips per DESIGN.md §4)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.is_subquadratic:
        names.append("long_500k")
    return tuple(names)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get_config(arch_id: str) -> ModelConfig:
    # import the arch modules lazily so `configs.base` has no import cycle
    from repro_torch import configs as _c  # noqa: F401  (triggers registration)
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def all_arch_ids():
    from repro_torch import configs as _c  # noqa: F401
    return sorted(_REGISTRY)
