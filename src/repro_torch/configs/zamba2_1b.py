"""zamba2-1.2b [hybrid] — 38 Mamba2 layers d_model=2048 + ONE shared
transformer block (32H attn + d_ff=8192 MLP) applied every 6 layers,
ssm_state=64, vocab=32000. [arXiv:2411.15242]

BLaST sparsifies the shared block's MLP; Mamba2 in/out projections are
state-mixer (attention-analogue) weights and stay dense (DESIGN.md §5).
Per-invocation LoRA on the shared block is omitted (noted deviation).
Runs ``long_500k``: O(1) SSM state; the shared attn block keeps a KV
cache (6x fewer cached layers than a dense transformer)."""
from repro_torch.configs.base import ModelConfig, reduced, with_blast

CONFIG = with_blast(ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32_000,
    mlp_kind="glu",
    mlp_act="gelu",
    norm_kind="rmsnorm",
    ssm_state=64,
    ssm_heads=64,             # d_inner 4096 / head 64
    ssm_expand=2,
    attn_every=6,
))

SMOKE = reduced(CONFIG)
SKIP_SHAPES: dict[str, str] = {}   # hybrid: all four shapes run
