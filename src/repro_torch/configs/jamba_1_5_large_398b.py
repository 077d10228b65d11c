"""jamba-1.5-large-398b [hybrid; arXiv:2403.19887]: 72L, d=8192, 64H GQA
kv=8, d_ff=24576, MoE 16 experts top-2.  Mamba:attention 7:1 interleave
(one attention layer per 8-layer group, offset 4, as in the Jamba paper);
MoE on every other layer (period 2, first layer dense)."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    attn_period=8,
    attn_offset=4,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576, moe_period=2, first_dense=1),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    param_dtype="bfloat16",
    optimizer="adafactor",
    remat="full",
    seq_shard_activations=True,
    grad_accum=8,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    moe=MoEConfig(num_experts=4, top_k=2, capacity_factor=2.0, d_ff_expert=64, moe_period=2, first_dense=1),
    ssm=SSMConfig(d_state=4, d_conv=4, expand=2),
    param_dtype="float32", remat="none", grad_accum=1, seq_shard_activations=False,
)
