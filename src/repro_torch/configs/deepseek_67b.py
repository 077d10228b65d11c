"""deepseek-67b [dense; arXiv:2401.02954]: llama-arch, 95L, d=8192, 64H GQA
kv=8, d_ff=22016, vocab 102400."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    num_layers=95,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=102400,
    param_dtype="bfloat16",
    optimizer="adafactor",
    remat="full",
    seq_shard_activations=True,
    grad_accum=8,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    param_dtype="float32", remat="none", grad_accum=1, seq_shard_activations=False,
)
