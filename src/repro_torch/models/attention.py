"""GQA attention of the port (the llama-family part of the JAX package's
``repro/models/attention.py``): QKV projections with optional bias, RoPE,
prefill through ``chunked_attention`` and one-token decode against a KV
cache at per-row positions.

The weights keep the JAX package's layouts: wq (D, H, hd), wk and wv
(D, KV, hd), wo (H, hd, D), biases (H, hd) and (KV, hd).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    chunked_attention,
    decode_attention,
    decode_mask,
    dense_init_,
    rope_tables,
    rotate,
)

Tensor = torch.Tensor


class DecodeStep:
    """What every layer of one decode step shares, computed once per step
    from the (B,) positions ``pos`` (the serving engine steps every slot at
    its own position): the RoPE tables, the cache rows to write and the
    attention mask of positions ``<= pos``."""

    def __init__(self, pos: Tensor, max_len: int, head_dim: int, theta: float):
        b = pos.shape[0]
        self.cos, self.sin = rope_tables(pos[:, None], head_dim, theta)
        self.rows = torch.arange(b, device=pos.device)
        self.keep = ((pos >= 0) & (pos < max_len))[:, None, None]
        self.at = pos.clamp(0, max_len - 1)
        self.mask = decode_mask(pos + 1, max_len)

    def write_(self, cache: Tensor, new: Tensor) -> Tensor:
        """``new`` (B, 1, KV, hd) into ``cache`` (B, S, KV, hd) at each row's
        position, in place; a position outside the cache writes nothing."""
        old = cache[self.rows, self.at]
        cache[self.rows, self.at] = torch.where(self.keep, new[:, 0].to(cache.dtype), old)
        return cache


class GQA(nn.Module):
    """Grouped-query attention with the JAX package's parameter layout.

    ``cast(dtype)`` makes the compute-dtype copies of the projections once,
    Q, K and V side by side in one (D, (H + 2 KV) hd) matrix (the JAX
    package casts f32 params at every use and projects three times; a cast
    is exact and each output column is the same dot product)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        self.cfg = cfg
        self.split = (h * hd, kv * hd, kv * hd)
        f32 = dict(dtype=torch.float32, device=device)
        self.wq = nn.Parameter(torch.empty((d, h, hd), **f32), requires_grad=False)
        self.wk = nn.Parameter(torch.empty((d, kv, hd), **f32), requires_grad=False)
        self.wv = nn.Parameter(torch.empty((d, kv, hd), **f32), requires_grad=False)
        self.wo = nn.Parameter(torch.empty((h, hd, d), **f32), requires_grad=False)
        self.bias = cfg.qkv_bias
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros((h, hd), **f32), requires_grad=False)
            self.bk = nn.Parameter(torch.zeros((kv, hd), **f32), requires_grad=False)
            self.bv = nn.Parameter(torch.zeros((kv, hd), **f32), requires_grad=False)
        self.c: dict[str, Tensor] = {}

    def init_(self, g: torch.Generator) -> None:
        d, h, hd = self.wq.shape
        dense_init_(self.wq, g, d**-0.5)
        dense_init_(self.wk, g, d**-0.5)
        dense_init_(self.wv, g, d**-0.5)
        dense_init_(self.wo, g, (h * hd) ** -0.5)
        if self.bias:
            for b in (self.bq, self.bk, self.bv):
                b.zero_()

    def cast(self, dtype: torch.dtype) -> None:
        d = self.wq.shape[0]
        self.c = {
            "wqkv": torch.cat([w.reshape(d, -1) for w in (self.wq, self.wk, self.wv)], 1).to(dtype),
            "wo": self.wo.reshape(-1, d).to(dtype),
        }
        if self.bias:
            self.c["bqkv"] = torch.cat([b.reshape(-1) for b in (self.bq, self.bk, self.bv)]).to(dtype)

    def qkv(self, x: Tensor, cos: Tensor, sin: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        b, s, _ = x.shape
        hd = self.wq.shape[2]
        y = x @ self.c["wqkv"]
        if self.bias:
            y = y + self.c["bqkv"]
        q, k, v = (t.reshape(b, s, -1, hd) for t in torch.split(y, self.split, dim=-1))
        return rotate(q, cos, sin), rotate(k, cos, sin), v

    def _out(self, o: Tensor) -> Tensor:
        return o.reshape(o.shape[0], o.shape[1], -1) @ self.c["wo"]

    def forward(self, x: Tensor, rope: tuple[Tensor, Tensor]) -> tuple[Tensor, tuple[Tensor, Tensor]]:
        """Full-sequence causal attention (prefill) with the sequence's RoPE
        tables. Returns (out, (k, v))."""
        q, k, v = self.qkv(x, *rope)
        return self._out(chunked_attention(q, k, v, causal=True)), (k, v)

    def decode(self, x: Tensor, cache: dict[str, Tensor], step: DecodeStep) -> Tensor:
        """One token per row at the step's positions; writes this token's K/V
        into ``cache`` in place and attends over positions ``<= pos``."""
        q, k, v = self.qkv(x, step.cos, step.sin)
        step.write_(cache["k"], k)
        step.write_(cache["v"], v)
        return self._out(decode_attention(q, cache["k"], cache["v"], step.mask))
