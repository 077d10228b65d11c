"""whisper-tiny [audio; arXiv:2212.04356]: enc-dec, 4+4 layers, d=384, 6H,
d_ff=1536, vocab 51865.  Conv frontend is a STUB: input_specs() provides
precomputed (B, 1500, 384) frame embeddings (per assignment)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    num_layers=4,          # decoder layers
    encoder_layers=4,
    encoder_seq=1500,
    frontend="audio_stub",
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    qkv_bias=True,
    tie_embeddings=True,
    attn_tp=False,         # 6 heads don't divide 16-way TP; DP/FSDP + mlp TP
    param_dtype="float32",
    optimizer="adamw",
    remat="full",
)

SMOKE_CONFIG = CONFIG.replace(
    num_layers=2, encoder_layers=2, encoder_seq=16, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=256, remat="none",
)
