"""Model / run configuration schema: the port's own copy of the JAX package's
``configs/base.py`` (plain frozen dataclasses, the same fields and defaults).
The training fields (``remat``, ``grad_accum``, ``optimizer``) are read by
the train step; the sharding fields (``attn_tp``, ...) are carried so a
configuration reads the same in both packages.  ``ShapeConfig`` and
``SHAPES`` are the assigned input-shape cells.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0          # shared (always-on) experts, deepseek-v2 style
    capacity_factor: float = 1.25
    moe_period: int = 1          # every `moe_period`-th layer is MoE
    first_dense: int = 0         # first k layers use dense FFN
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:  # Mamba-1 (Jamba's mixer)
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class RWKVConfig:  # RWKV-6 "Finch"
    head_dim: int = 64
    decay_lora: int = 64
    gate_lora: int = 64


@dataclass(frozen=True)
class RetrievalConfig:
    """kNN-LM datastore retrieval (the paper's technique at the LM head)."""

    enabled: bool = False
    k: int = 8
    lam: float = 0.25           # p = lam * p_knn + (1 - lam) * p_lm
    temperature: float = 10.0
    datastore_size: int = 65536  # per model shard
    key_dim: int = 0             # 0 -> d_model
    quantized: bool = False      # int8 datastore (beyond-paper)
    kernel: bool = True          # route distances through kernels/ops dispatch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    rwkv: RWKVConfig | None = None
    attn_period: int = 1         # hybrid: one attention layer per attn_period
    attn_offset: int = 0         # position of the attention layer in the group
    encoder_layers: int = 0      # enc-dec only
    encoder_seq: int = 1500      # stub frontend sequence length
    frontend: str | None = None  # audio_stub | vision_stub
    num_stub_patches: int = 256  # vlm stub patches replacing leading tokens
    tie_embeddings: bool = False
    # --- numerics / memory policy ---
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"          # full | dots | none
    scan_layers: bool = True
    # --- sharding profile ---
    attn_tp: bool = True         # shard attention heads over 'tensor'
    mlp_tp: bool = True
    seq_shard_activations: bool = False  # sequence-shard residual stream
    constrain_sublayer_outputs: bool = False  # force RS (not AR) after TP ops
    moe_a2a: bool = False        # all-to-all EP dispatch (vs psum combine)
    grad_accum: int = 1
    optimizer: str = "adamw"     # adamw | adafactor
    retrieval: RetrievalConfig = field(default_factory=RetrievalConfig)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab_size // 128) * 128

    def is_attn_layer(self, i: int) -> bool:
        """Hybrid interleave: which decoder layers are attention."""
        if self.family != "hybrid":
            return self.family != "ssm"
        return i % self.attn_period == self.attn_offset

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None or i < self.moe.first_dense:
            return False
        return (i - self.moe.first_dense) % self.moe.moe_period == 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned (input-shape) cell."""

    name: str                    # train_4k | prefill_32k | decode_32k | long_500k
    kind: str                    # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

# long_500k needs sub-quadratic attention: SSM / hybrid only
LONG_CONTEXT_FAMILIES = ("ssm", "hybrid")


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> bool:
    if shape.name == "long_500k":
        return model.family in LONG_CONTEXT_FAMILIES
    return True
