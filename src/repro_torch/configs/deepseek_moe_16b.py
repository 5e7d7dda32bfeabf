"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (MHA kv=16) d_ff=1408,
vocab=102400, 64 routed experts top-6 + 2 shared (fine-grained).
[arXiv:2401.06066]

Shared experts are replicated (small) and BLaST-sparsified like routed
ones. The real model's dense layer 0 is simplified to MoE-everywhere
(noted deviation)."""
from repro_torch.configs.base import ModelConfig, reduced, with_blast

CONFIG = with_blast(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102_400,
    mlp_kind="glu",
    mlp_act="silu",
    rope_theta=10_000.0,
    norm_kind="rmsnorm",
    num_experts=64,
    top_k=6,
    moe_d_ff=1408,
    num_shared_experts=2,
))

SMOKE = reduced(CONFIG)
SKIP_SHAPES = {"long_500k": "pure full-attention MoE decoder (DESIGN.md §6)"}
