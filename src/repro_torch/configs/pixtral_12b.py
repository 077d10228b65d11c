"""pixtral-12b [vlm; hf:mistralai/Pixtral-12B-2409]: 40L, d=5120, 32H GQA
kv=8, d_ff=14336, vocab 131072.  Pixtral-ViT frontend is a STUB: input
patch embeddings are provided precomputed (per assignment)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    frontend="vision_stub",
    num_stub_patches=256,
    param_dtype="bfloat16",
    optimizer="adafactor",
    remat="full",
    seq_shard_activations=True,
    grad_accum=4,
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, num_stub_patches=4,
    param_dtype="float32", remat="none", grad_accum=1, seq_shard_activations=False,
)
