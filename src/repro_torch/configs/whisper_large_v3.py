"""whisper-large-v3 [audio] — enc-dec, 32 encoder + 32 decoder layers,
d_model=1280 20H (MHA) d_ff=5120, vocab=51866; conv frontend is a STUB
(input_specs() provides precomputed frame embeddings). [arXiv:2212.04356]

Shape mapping (DESIGN.md §6): train/prefill split seq 50/50 between
encoder frames and decoder tokens; decode = 1 new decoder token vs 16k
encoder memory + 16k decoder self-cache."""
from repro_torch.configs.base import ModelConfig, reduced, with_blast

CONFIG = with_blast(ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,             # decoder layers
    num_encoder_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51_872,   # 51866 padded to /16 for vocab-parallel logits
    pad_heads_to=32,
    rope_theta=0.0,            # learned absolute positions, no rope
    mlp_kind="mlp2",
    mlp_act="gelu",
    norm_kind="layernorm",
))

SMOKE = reduced(CONFIG)
SKIP_SHAPES = {"long_500k": "enc-dec; decoder context << 512k by "
                            "construction (DESIGN.md §6)"}
