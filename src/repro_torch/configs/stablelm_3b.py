"""stablelm-3b [dense] — 32L d_model=2560 32H (MHA kv=32) d_ff=6912,
vocab=50304. [hf:stabilityai/stablelm-*]

d_ff/TP = 432 forces b_out=16 at TP=16 (DESIGN.md §6); the padded-d_ff
variant re-enabling 128-wide blocks is a §Perf lever."""
from repro_torch.configs.base import ModelConfig, reduced, with_blast

CONFIG = with_blast(ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50_304,
    mlp_kind="glu",
    mlp_act="silu",
    rope_theta=10_000.0,
    norm_kind="layernorm",
))

SMOKE = reduced(CONFIG)
SKIP_SHAPES = {"long_500k": "pure full-attention dense decoder (DESIGN.md §6)"}
