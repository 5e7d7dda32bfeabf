"""rwkv6-3b (Finch) [ssm] — 32L d_model=2560 (attention-free, 40 heads of
64) d_ff=8960 (channel-mix), vocab=65536; data-dependent decay.
[arXiv:2404.05892]

BLaST sparsifies the channel-mix matrices (the RWKV MLP analogue); the
time-mix projections stay dense (attention analogue — DESIGN.md §5).
Runs ``long_500k``: O(1) recurrent state per layer."""
from repro_torch.configs.base import ModelConfig, reduced, with_blast

CONFIG = with_blast(ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,          # time-mix heads (head size 64)
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65_536,
    pad_heads_to=48,
    mlp_kind="mlp2",       # channel-mix: square-relu 2-matrix MLP
    mlp_act="relu",
    norm_kind="layernorm",
))

SMOKE = reduced(CONFIG)
SKIP_SHAPES: dict[str, str] = {}   # sub-quadratic: all four shapes run
