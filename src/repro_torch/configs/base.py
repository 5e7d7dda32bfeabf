"""Model config dataclass (port of ``repro/configs/base.py``).

``ModelConfig`` matches the reference field for field so the same
architecture description drives both packages; ``with_blast`` and
``reduced`` derive the block shape and the smoke variant exactly as the
reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

from repro_torch.core.prune_grow import BlastSpec


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- MLP flavour
    mlp_kind: Literal["glu", "mlp2"] = "glu"
    mlp_act: str = "silu"
    # --- attention details
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0      # gemma2: 50.0
    final_logit_softcap: float = 0.0     # gemma2: 30.0
    attn_scale: float = 0.0              # 0 -> 1/sqrt(head_dim)
    # pad q (and MHA kv) heads with zero-init heads (exact: padded wo
    # rows are zero)
    pad_heads_to: int = 0
    sliding_window: int = 0              # 0 = full attention
    layer_pattern: Literal["uniform", "local_global"] = "uniform"
    norm_kind: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    tie_embeddings: bool = False
    scale_embeddings: bool = False       # gemma2: x *= sqrt(d_model)
    # --- MoE
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    # --- SSM / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_expand: int = 2
    attn_every: int = 0                  # zamba2: shared block period
    conv_kernel: int = 4
    # --- encoder-decoder (whisper)
    num_encoder_layers: int = 0
    # --- VLM
    num_patches: int = 0
    # --- BLaST
    blast: BlastSpec = dataclasses.field(
        default_factory=lambda: BlastSpec(enabled=False))
    # --- numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # --- misc
    remat: bool = True
    remat_policy: str = "nothing_saveable"
    chunk_size: int = 64                 # linear-attention chunk length
    max_position: int = 1 << 20

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def n_params(self) -> int:
        """Total parameter count (from the param spec tree)."""
        from repro_torch.models import registry
        return registry.count_params(self)

    def n_active_params(self) -> int:
        """Params touched per token (MoE: only the routed top_k
        experts)."""
        from repro_torch.models import registry
        return registry.count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How the model maps onto the device mesh."""
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    pod_axis: str | None = None          # extra DP axis on multi-pod mesh
    tp: int = 16                         # size of the model axis
    # activation sharding of the sequence dim (SP)
    shard_seq: bool = False
    remat_policy: str = "dots_with_no_batch_dims_saveable"

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return (self.pod_axis,) + self.data_axes if self.pod_axis \
            else self.data_axes


def derive_block_shape(d_in: int, d_out: int, tp: int,
                       shard_out: bool = True) -> tuple[int, int]:
    """Largest (b_in, b_out) in {128,64,32,16,8} tiling the per-shard
    weight; one block shape per model."""
    def largest(dim: int) -> int:
        for b in (128, 64, 32, 16, 8):
            if dim % b == 0:
                return b
        raise ValueError(f"dim {dim} not tileable")
    local_out = d_out // tp if shard_out else d_out
    return largest(d_in), largest(local_out)


def with_blast(cfg: ModelConfig, tp: int = 16, **overrides) -> ModelConfig:
    """Attach a BlastSpec with the per-arch derived block shape (MoE
    experts are not split by tp, so their d_ff is not divided)."""
    ff = cfg.moe_d_ff if cfg.is_moe else cfg.d_ff
    b_in, b_out = derive_block_shape(cfg.d_model, ff, tp,
                                     shard_out=not cfg.is_moe)
    spec = dataclasses.replace(
        BlastSpec(enabled=True, b_in=b_in, b_out=b_out), **overrides)
    return dataclasses.replace(cfg, blast=spec)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test variant: same family/topology, tiny dims."""
    kv = max(1, min(cfg.num_kv_heads, 2))
    heads = max(kv, 4)
    small = dict(
        num_layers=min(cfg.num_layers, 4) if cfg.attn_every == 0
        else max(cfg.attn_every, 4),
        d_model=64, num_heads=heads, num_kv_heads=kv, head_dim=16,
        d_ff=128, vocab_size=256,
        num_experts=min(cfg.num_experts, 8),
        top_k=min(cfg.top_k, 2),
        moe_d_ff=64 if cfg.is_moe else 0,
        num_shared_experts=min(cfg.num_shared_experts, 1),
        ssm_state=min(cfg.ssm_state, 16),
        ssm_heads=min(cfg.ssm_heads, 4) if cfg.ssm_heads else 0,
        num_encoder_layers=min(cfg.num_encoder_layers, 2),
        num_patches=min(cfg.num_patches, 8),
        sliding_window=min(cfg.sliding_window, 32) if cfg.sliding_window
        else 0,
        chunk_size=16,
        remat=False,
        compute_dtype="float32",
        name=cfg.name + "-smoke",
    )
    if cfg.blast.enabled:
        small["blast"] = dataclasses.replace(
            cfg.blast, b_in=16, b_out=16, total_steps=20, step_size=5,
            dense_last=1)
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
