"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4)
moe_d_ff=1536, vocab=151936, MoE 128 experts top-8. [hf:Qwen/Qwen3-*]

Every layer is MoE; per-expert BLaST block masks (paper §2.2 treats MoE
as a functional equivariant of the MLP). Experts are EP-sharded, so the
block shape is derived against the *unsharded* expert d_ff -> (128,128).
"""
from repro_torch.configs.base import ModelConfig, reduced, with_blast

CONFIG = with_blast(ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151_936,
    mlp_kind="glu",
    mlp_act="silu",
    qk_norm=True,
    rope_theta=1_000_000.0,
    norm_kind="rmsnorm",
    num_experts=128,
    top_k=8,
    moe_d_ff=1536,
))

SMOKE = reduced(CONFIG)
SKIP_SHAPES = {"long_500k": "pure full-attention MoE decoder; 512k KV "
                            "cache is the quadratic regime (DESIGN.md §6)"}
