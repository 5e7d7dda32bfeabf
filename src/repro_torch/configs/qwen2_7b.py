"""qwen2-7b [dense] — 28L d_model=3584 28H (GQA kv=4) d_ff=18944,
vocab=152064; QKV bias. [arXiv:2407.10671]

``pad_heads_to=32`` pads the 28 query heads to 32 (zero-initialised, see
models/attention.py), so decode attention sees G = 8 query heads per kv
head."""
from repro_torch.configs.base import ModelConfig, reduced, with_blast

CONFIG = with_blast(ModelConfig(
    name="qwen2-7b",
    family="dense",
    num_layers=28,
    d_model=3584,
    num_heads=28,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18_944,
    vocab_size=152_064,
    mlp_kind="glu",
    mlp_act="silu",
    qkv_bias=True,
    pad_heads_to=32,
    rope_theta=1_000_000.0,
    norm_kind="rmsnorm",
))

SMOKE = reduced(CONFIG)
SKIP_SHAPES = {"long_500k": "pure full-attention dense decoder (DESIGN.md §6)"}
