"""qwen3-moe-235b-a22b [moe; hf:Qwen/Qwen3-30B-A3B family]: 94L, d=4096,
64H GQA kv=4 (head_dim 128), 128 experts top-8 (expert d_ff 1536),
vocab 151936."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536),
    param_dtype="bfloat16",
    optimizer="adafactor",
    remat="full",
    seq_shard_activations=True,
    grad_accum=8,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=64, vocab_size=256,
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=4.0, d_ff_expert=32),
    param_dtype="float32", remat="none", grad_accum=1, seq_shard_activations=False,
)
