"""rwkv6-3b "Finch" [ssm; arXiv:2404.05892]: attention-free, 32L, d=2560,
data-dependent per-channel decay, d_ff=8960, vocab 65536."""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,        # d_model / rwkv.head_dim
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, gate_lora=64),
    attn_tp=False,       # per-head state ops stay local; channel-mix has TP
    param_dtype="float32",
    optimizer="adamw",
    remat="full",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=256, rwkv=RWKVConfig(head_dim=16, decay_lora=8, gate_lora=8),
    remat="none",
)
