"""gemma2-27b [dense] — 46L d_model=4608 32H (GQA kv=16) d_ff=36864,
vocab=256000; local+global alternating attention, logit softcaps, GeGLU.
[arXiv:2408.00118]

Layers are scanned in (local, global) PAIRS (23 pairs) to keep the
scan body homogeneous (DESIGN.md §5)."""
from repro_torch.configs.base import ModelConfig, reduced, with_blast

CONFIG = with_blast(ModelConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36_864,
    vocab_size=256_000,
    mlp_kind="glu",
    mlp_act="gelu",              # GeGLU
    rope_theta=10_000.0,
    norm_kind="rmsnorm",
    attn_scale=0.0625,           # query_pre_attn_scalar=256
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    sliding_window=4096,
    layer_pattern="local_global",
    tie_embeddings=True,
    scale_embeddings=True,
))

SMOKE = reduced(CONFIG)
SKIP_SHAPES = {"long_500k": "alternating GLOBAL layers still need the full "
                            "512k KV cache -> effectively full attention "
                            "(DESIGN.md §6)"}
