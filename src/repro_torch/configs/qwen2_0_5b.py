"""qwen2-0.5b [dense; arXiv:2407.10671]: 24L, d=896, 14H GQA kv=2,
d_ff=4864, vocab 151936, QKV bias, tied embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    attn_tp=False,  # 14 heads don't divide 16-way TP
    param_dtype="float32",
    optimizer="adamw",
    remat="full",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
    vocab_size=256, remat="none",
)
