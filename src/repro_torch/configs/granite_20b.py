"""granite-20b [dense; arXiv:2405.04324]: code model, 52L, d=6144, 48H,
MQA (kv=1), d_ff=24576, vocab 49152."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    param_dtype="bfloat16",
    optimizer="adafactor",
    remat="full",
    seq_shard_activations=True,
    grad_accum=4,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=256,
    param_dtype="float32", remat="none", grad_accum=1, seq_shard_activations=False,
)
