"""Block assembly of the port for every architecture family (the JAX
package's ``repro/models/transformer.py``): the stage plan and one module
per sub-layer kind.

Sub-layer kinds:
  gqa_dense / gqa_moe    - GQA attention + SwiGLU or MoE FFN (llama family)
  mla_dense / mla_moe    - DeepSeek-V2 latent attention + FFN
  mamba_dense / mamba_moe- Mamba mixer + FFN (Jamba)
  rwkv                   - RWKV6 time-mix + channel-mix
  wenc / wdec            - whisper encoder / decoder (LayerNorm + GELU)

The JAX package scans each stage over weights stacked on a layer axis; the
port keeps one module per sub-layer, in the plan's order, in an
``nn.ModuleList`` walked by a Python loop (``params_from_jax`` unstacks the
layer axis).  Each module's ``forward`` returns its slice of the cache, a
flat dict with the batch on axis 0 of every leaf; ``decode`` updates that
slice in place.  Router losses add into ``aux`` as ``stage_forward`` sums
them.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import logical_constraint
from repro_torch.models import rwkv
from repro_torch.models.attention import GQA, MLA, DecodeStep
from repro_torch.models.layers import GeluMLP, SwiGLU, dtype_of, layer_norm, rms_norm
from repro_torch.models.mamba import Mamba
from repro_torch.models.moe import MoE

Tensor = torch.Tensor


@dataclass(frozen=True)
class Stage:
    unit: tuple[str, ...]  # sub-layer kinds within one unit
    n: int                 # unit repeats
    scan: bool


def plan_stages(cfg: ModelConfig) -> list[Stage]:
    """The JAX package's stage plan: dense first layers, then the scanned
    stage; the hybrid's unit of ``attn_period`` kinds; one stage for RWKV
    and for whisper's decoder (its encoder is ``encoder_stage``)."""
    if cfg.family == "encdec":
        return [Stage(("wdec",), cfg.num_layers, cfg.scan_layers)]
    if cfg.family == "ssm":
        return [Stage(("rwkv",), cfg.num_layers, cfg.scan_layers)]
    if cfg.family == "hybrid":
        gsize = cfg.attn_period
        if cfg.num_layers % gsize:
            raise ValueError(f"{cfg.name}: num_layers {cfg.num_layers} is not a multiple "
                             f"of attn_period {gsize}")
        unit = tuple(
            ("gqa" if j == cfg.attn_offset else "mamba")
            + ("_moe" if cfg.is_moe_layer(j) else "_dense")
            for j in range(gsize)
        )
        return [Stage(unit, cfg.num_layers // gsize, cfg.scan_layers)]
    base = "mla" if cfg.mla is not None else "gqa"
    if cfg.moe is None:
        return [Stage((f"{base}_dense",), cfg.num_layers, cfg.scan_layers)]
    stages = []
    fd = cfg.moe.first_dense
    if fd:
        stages.append(Stage((f"{base}_dense",), fd, False))
    stages.append(Stage((f"{base}_moe",), cfg.num_layers - fd, cfg.scan_layers))
    return stages


def encoder_stage(cfg: ModelConfig) -> Stage | None:
    if cfg.family != "encdec":
        return None
    return Stage(("wenc",), cfg.encoder_layers, cfg.scan_layers)


@dataclass
class Seq:
    """What every layer of one full-sequence pass shares: the RoPE tables
    of its positions ((None, None) where nothing rotates) and whisper's
    encoder output."""

    rope: tuple[Tensor | None, Tensor | None]
    enc: Tensor | None = None


def _norm(d: int, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros((d,), dtype=torch.float32, device=device))


def _add_aux(aux: dict, losses: dict) -> None:
    for name, v in losses.items():
        aux[name] = aux[name] + v


def _post(cfg: ModelConfig, h: Tensor) -> Tensor:
    """Sequence-parallel TP (Korthikanti et al.): pin a sub-layer's output to
    the seq-sharded layout, where ``cfg.constrain_sublayer_outputs`` asks
    (the identity outside the dry-run's sharded run)."""
    if cfg.constrain_sublayer_outputs:
        return logical_constraint(h, ("batch", "seq", "embed"))
    return h


class Block(nn.Module):
    """``gqa|mla|mamba`` x ``dense|moe``: x + mix(norm(x)), then
    x + ffn(norm(x)), with RMSNorm."""

    def __init__(self, kind: str, cfg: ModelConfig, device=None):
        super().__init__()
        mix, ffn = kind.split("_")
        self.mix = mix
        self.cfg = cfg
        self.eps = cfg.norm_eps
        self.ln1 = _norm(cfg.d_model, device)
        self.ln2 = _norm(cfg.d_model, device)
        if mix == "gqa":
            self.attn = GQA(cfg, device)
        elif mix == "mla":
            self.attn = MLA(cfg, device)
        else:
            self.mamba = Mamba(cfg, device)
        if ffn == "dense":
            self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, dtype_of(cfg.param_dtype), device)
        else:
            self.moe = MoE(cfg, device)

    def _ffn(self, x: Tensor, aux: dict | None) -> Tensor:
        if hasattr(self, "mlp"):
            return self.mlp(x)
        out, losses = self.moe(x)
        if aux is not None:
            _add_aux(aux, losses)
        return out

    def forward(self, x: Tensor, seq: Seq, aux: dict) -> tuple[Tensor, dict]:
        h_in = rms_norm(x, self.ln1, self.eps)
        if self.mix == "mamba":
            h, cache = self.mamba(h_in)
        else:
            h, (a, b) = self.attn(h_in, seq.rope)
            cache = {"c_kv": a, "k_rope": b} if self.mix == "mla" else {"k": a, "v": b}
        x = x + _post(self.cfg, h)
        return x + _post(self.cfg, self._ffn(rms_norm(x, self.ln2, self.eps), aux)), cache

    def decode(self, x: Tensor, cache: dict[str, Tensor], step: DecodeStep) -> Tensor:
        h_in = rms_norm(x, self.ln1, self.eps)
        h = self.mamba.decode(h_in, cache) if self.mix == "mamba" else \
            self.attn.decode(h_in, cache, step)
        x = x + h
        return x + self._ffn(rms_norm(x, self.ln2, self.eps), None)

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype, device) -> dict:
        c = self.cfg
        z = dict(dtype=dtype, device=device)
        if self.mix == "gqa":
            shape = (batch, max_len, c.num_kv_heads, c.resolved_head_dim)
            return {"k": torch.zeros(shape, **z), "v": torch.zeros(shape, **z)}
        if self.mix == "mla":
            return {"c_kv": torch.zeros((batch, max_len, c.mla.kv_lora_rank), **z),
                    "k_rope": torch.zeros((batch, max_len, c.mla.rope_head_dim), **z)}
        return self.mamba.init_state(batch, dtype, device)


class RWKVBlock(nn.Module):
    """``rwkv``: x + time_mix(norm(x)), then x + channel_mix(norm(x))."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.eps = cfg.norm_eps
        self.ln1 = _norm(cfg.d_model, device)
        self.tm = rwkv.TimeMix(cfg, device)
        self.ln2 = _norm(cfg.d_model, device)
        self.cm = rwkv.ChannelMix(cfg, device)

    def forward(self, x: Tensor, seq: Seq, aux: dict) -> tuple[Tensor, dict]:
        h, tm_shift, tm_wkv = self.tm(rms_norm(x, self.ln1, self.eps))
        x = x + _post(self.cfg, h)
        h, cm_shift = self.cm(rms_norm(x, self.ln2, self.eps))
        return x + _post(self.cfg, h), {"tm_shift": tm_shift, "tm_wkv": tm_wkv, "cm_shift": cm_shift}

    def decode(self, x: Tensor, cache: dict[str, Tensor], step: DecodeStep) -> Tensor:
        h, tm_shift, tm_wkv = self.tm(rms_norm(x, self.ln1, self.eps),
                                      cache["tm_shift"], cache["tm_wkv"])
        x = x + h
        h, cm_shift = self.cm(rms_norm(x, self.ln2, self.eps), cache["cm_shift"])
        cache["tm_shift"].copy_(tm_shift)
        cache["tm_wkv"].copy_(tm_wkv)
        cache["cm_shift"].copy_(cm_shift)
        return x + h

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype, device) -> dict:
        d, h, hd = self.cfg.d_model, self.tm.h, self.tm.hd
        return {"tm_shift": torch.zeros((batch, 1, d), dtype=dtype, device=device),
                "tm_wkv": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
                "cm_shift": torch.zeros((batch, 1, d), dtype=dtype, device=device)}


class WhisperLayer(nn.Module):
    """``wenc`` (bidirectional self-attention + GELU MLP) and ``wdec``
    (causal self-attention, cross-attention over the encoder output, GELU
    MLP), LayerNorms with biases, no rope.  The decoder's cache holds its
    self-attention K/V and the cross K/V of the encoder output ("ck", "cv",
    (B, encoder_seq, KV, hd))."""

    def __init__(self, kind: str, cfg: ModelConfig, device=None):
        super().__init__()
        d, pdt = cfg.d_model, dtype_of(cfg.param_dtype)
        self.cfg = cfg
        self.eps = cfg.norm_eps
        self.dec = kind == "wdec"
        self.ln1, self.lb1 = _norm(d, device), _norm(d, device)
        self.attn = GQA(cfg, device, rope=False, causal=self.dec)
        self.ln2, self.lb2 = _norm(d, device), _norm(d, device)
        if self.dec:
            self.cross = GQA(cfg, device, rope=False, causal=False)
            self.ln3, self.lb3 = _norm(d, device), _norm(d, device)
        self.mlp = GeluMLP(d, cfg.d_ff, pdt, device)

    def _ln(self, x: Tensor, i: int) -> Tensor:
        return layer_norm(x, getattr(self, f"ln{i}"), getattr(self, f"lb{i}"), self.eps)

    def forward(self, x: Tensor, seq: Seq, aux: dict) -> tuple[Tensor, dict | None]:
        h, (k, v) = self.attn(self._ln(x, 1), (None, None))
        x = x + h
        if not self.dec:
            return x + self.mlp(self._ln(x, 2)), None
        ck, cv = self.cross.cross_kv(seq.enc)
        x = x + self.cross.cross(self._ln(x, 2), ck, cv)
        return x + self.mlp(self._ln(x, 3)), {"k": k, "v": v, "ck": ck, "cv": cv}

    def decode(self, x: Tensor, cache: dict[str, Tensor], step: DecodeStep) -> Tensor:
        x = x + self.attn.decode(self._ln(x, 1), cache, step)
        x = x + self.cross.cross(self._ln(x, 2), cache["ck"], cache["cv"])
        return x + self.mlp(self._ln(x, 3))

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype, device) -> dict:
        c = self.cfg
        kv, hd = c.num_kv_heads, c.resolved_head_dim
        lens = {"k": max_len, "v": max_len, "ck": c.encoder_seq, "cv": c.encoder_seq}
        return {n: torch.zeros((batch, s, kv, hd), dtype=dtype, device=device)
                for n, s in lens.items()}


def make_layer(kind: str, cfg: ModelConfig, device=None) -> nn.Module:
    if kind == "rwkv":
        return RWKVBlock(cfg, device)
    if kind in ("wenc", "wdec"):
        return WhisperLayer(kind, cfg, device)
    return Block(kind, cfg, device)


def stage_layers(stages: list[Stage], cfg: ModelConfig, device=None) -> nn.ModuleList:
    """One module per sub-layer of ``stages``, in order (unit by unit)."""
    return nn.ModuleList(
        make_layer(kind, cfg, device) for st in stages for _ in range(st.n) for kind in st.unit
    )


@torch.no_grad()
def init_layer_(layer: nn.Module, g: torch.Generator) -> None:
    """The JAX package's init distributions for every sub-module of a layer
    (norm scales and biases start at zero)."""
    for p in layer.parameters(recurse=False):
        p.zero_()
    for mod in layer.children():
        mod.init_(g)


def cast_layer(layer: nn.Module, dtype: torch.dtype) -> None:
    for mod in layer.children():
        mod.cast(dtype)

