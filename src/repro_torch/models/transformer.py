"""Block assembly of the port: stage planning and the dense GQA decoder
layer (``gqa_dense``: pre-norm attention and SwiGLU MLP, residuals), the
part of the JAX package's ``repro/models/transformer.py`` the dense
architectures run.

The JAX package scans one stage over weights stacked on a layer axis; the
port keeps one module per layer in an ``nn.ModuleList`` and walks it with a
Python loop (``params_from_jax`` unstacks the layer axis).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import GQA, DecodeStep
from repro_torch.models.layers import dense_init_, mlp_swiglu, rms_norm

Tensor = torch.Tensor


@dataclass(frozen=True)
class Stage:
    unit: tuple[str, ...]  # sub-layer kinds within one unit
    n: int                 # unit repeats
    scan: bool


def plan_stages(cfg: ModelConfig) -> list[Stage]:
    """The JAX package's stage plan for the families the port runs (dense
    GQA); the others raise, naming the slice that brings them."""
    if cfg.family != "dense" or cfg.moe is not None or cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (moe={cfg.moe is not None}, "
            f"mla={cfg.mla is not None}) is not ported yet; the MoE, MLA, Mamba, "
            "RWKV and encoder-decoder modules come with the LM-substrate slice"
        )
    return [Stage(("gqa_dense",), cfg.num_layers, cfg.scan_layers)]


class DenseLayer(nn.Module):
    """One ``gqa_dense`` sub-layer: x + attn(norm(x)), then x + mlp(norm(x))."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        f32 = dict(dtype=torch.float32, device=device)
        self.eps = cfg.norm_eps
        self.ln1 = nn.Parameter(torch.zeros((d,), **f32), requires_grad=False)
        self.ln2 = nn.Parameter(torch.zeros((d,), **f32), requires_grad=False)
        self.attn = GQA(cfg, device)
        self.w_in = nn.Parameter(torch.empty((d, f), **f32), requires_grad=False)
        self.w_gate = nn.Parameter(torch.empty((d, f), **f32), requires_grad=False)
        self.w_out = nn.Parameter(torch.empty((f, d), **f32), requires_grad=False)
        self.c: dict[str, Tensor] = {}

    def init_(self, g: torch.Generator) -> None:
        self.ln1.zero_()
        self.ln2.zero_()
        self.attn.init_(g)
        for w in (self.w_in, self.w_gate, self.w_out):
            dense_init_(w, g)

    def cast(self, dtype: torch.dtype) -> None:
        self.attn.cast(dtype)
        self.c = {"w_gate_in": torch.cat([self.w_gate, self.w_in], 1).to(dtype),
                  "w_out": self.w_out.to(dtype)}

    def _mlp(self, x: Tensor) -> Tensor:
        return mlp_swiglu(self.c["w_gate_in"], self.c["w_out"], x)

    def forward(self, x: Tensor, rope: tuple[Tensor, Tensor]) -> tuple[Tensor, tuple[Tensor, Tensor]]:
        h, kv = self.attn(rms_norm(x, self.ln1, self.eps), rope)
        x = x + h
        x = x + self._mlp(rms_norm(x, self.ln2, self.eps))
        return x, kv

    def decode(self, x: Tensor, cache: dict[str, Tensor], step: DecodeStep) -> Tensor:
        x = x + self.attn.decode(rms_norm(x, self.ln1, self.eps), cache, step)
        return x + self._mlp(rms_norm(x, self.ln2, self.eps))
