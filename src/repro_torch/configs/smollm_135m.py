"""smollm-135m [dense; hf:HuggingFaceTB/SmolLM-135M]: llama-arch small,
30L, d=576, 9H GQA kv=3, d_ff=1536, vocab 49152."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
    attn_tp=False,  # 9 heads don't divide 16-way TP
    param_dtype="float32",
    optimizer="adamw",
    remat="full",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, d_model=48, num_heads=3, num_kv_heads=3, d_ff=96,
    vocab_size=256, remat="none",
)
