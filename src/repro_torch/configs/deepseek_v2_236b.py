"""deepseek-v2-236b [moe; arXiv:2405.04434]: 60L, d=5120, 128H MLA
(kv_lora=512, rope 64, nope 128, v 128), MoE 160 routed top-6 + 2 shared
(expert d_ff 1536), first layer dense (d_ff 12288), vocab 102400."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,   # MLA: per-head KV decompressed from the latent
    d_ff=12288,         # the single dense layer's FFN width
    vocab_size=102400,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536, num_shared=2,
                  first_dense=1),
    param_dtype="bfloat16",
    optimizer="adafactor",
    remat="full",
    seq_shard_activations=True,
    grad_accum=8,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=256,
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8,
                  nope_head_dim=16, v_head_dim=16),
    moe=MoEConfig(num_experts=8, top_k=2, capacity_factor=4.0, d_ff_expert=32, num_shared=2,
                  first_dense=1),
    param_dtype="float32", remat="none", grad_accum=1, seq_shard_activations=False,
)
