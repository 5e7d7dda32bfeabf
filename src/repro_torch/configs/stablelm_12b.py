"""stablelm-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=13824,
vocab=100352. [hf:stabilityai/stablelm-2-12b]"""
from repro_torch.configs.base import ModelConfig, reduced, with_blast

CONFIG = with_blast(ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13_824,
    vocab_size=100_352,
    mlp_kind="glu",
    mlp_act="silu",
    rope_theta=10_000.0,
    norm_kind="layernorm",
    qk_norm=True,
))

SMOKE = reduced(CONFIG)
SKIP_SHAPES = {"long_500k": "pure full-attention dense decoder (DESIGN.md §6)"}
