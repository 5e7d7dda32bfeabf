"""The paper's own evaluation models (port of
``repro/configs/paper_models.py``): GPT-2 family + Llama-3.2 1B."""
from repro_torch.configs.base import ModelConfig, reduced, with_blast


def _gpt2(name, layers, d_model, heads):
    return ModelConfig(
        name=name, family="dense", num_layers=layers, d_model=d_model,
        num_heads=heads, num_kv_heads=heads, head_dim=d_model // heads,
        d_ff=4 * d_model, vocab_size=50_257, mlp_kind="mlp2",
        mlp_act="gelu", norm_kind="layernorm", tie_embeddings=True)


GPT2_SMALL = with_blast(_gpt2("gpt2-small", 12, 768, 12))
GPT2_MEDIUM = with_blast(_gpt2("gpt2-medium", 24, 1024, 16))
GPT2_LARGE = with_blast(_gpt2("gpt2-large", 36, 1280, 20))
GPT2_XL = with_blast(_gpt2("gpt2-xl", 48, 1600, 25))

LLAMA32_1B = with_blast(ModelConfig(
    name="llama3.2-1b", family="dense", num_layers=16, d_model=2048,
    num_heads=32, num_kv_heads=8, head_dim=64, d_ff=8192,
    vocab_size=128_256, mlp_kind="glu", mlp_act="silu",
    rope_theta=500_000.0, norm_kind="rmsnorm", tie_embeddings=True))

GPT2_SMALL_SMOKE = reduced(GPT2_SMALL)
LLAMA32_1B_SMOKE = reduced(LLAMA32_1B)

# Llama 3.x MLP dims (d_model, d_ff), the Fig. 5 MLP-speedup benchmark's
LLAMA_FAMILY_MLP = {
    "llama3.2-1b": (2048, 8192),
    "llama3.2-3b": (3072, 8192),
    "llama3.1-8b": (4096, 14336),
    "llama3.1-70b": (8192, 28672),
    "llama3.1-405b": (16384, 53248),
}
