"""internvl2-2b [vlm] — InternLM2-1.8B backbone: 24L d_model=2048 16H
(GQA kv=8) d_ff=8192, vocab=92553; InternViT frontend is a STUB
(input_specs() provides 256 precomputed patch embeddings prepended to the
text sequence, counted inside the stated seq_len). [arXiv:2404.16821]"""
from repro_torch.configs.base import ModelConfig, reduced, with_blast

CONFIG = with_blast(ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92_560,   # 92553 padded to /16 for vocab-parallel logits
    mlp_kind="glu",
    mlp_act="silu",
    rope_theta=1_000_000.0,
    norm_kind="rmsnorm",
    num_patches=256,
))

SMOKE = reduced(CONFIG)
SKIP_SHAPES = {"long_500k": "full-attention VLM decoder (DESIGN.md §6)"}
