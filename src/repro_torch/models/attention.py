"""Attention of the port (the JAX package's ``repro/models/attention.py``):
GQA (the llama family, MQA at one KV head, whisper's unrotated encoder,
decoder and cross attention, the hybrid's attention layers) and MLA
(DeepSeek-V2 multi-head latent attention, with the absorbed decode that
attends over the compressed cache).

The weights keep the JAX package's layouts: wq (D, H, hd), wk and wv
(D, KV, hd), wo (H, hd, D), biases (H, hd) and (KV, hd); MLA's wdq
(D, q_lora), wuq (q_lora, H, nope + rope), wdkv (D, lora), wk_rope
(D, rope), wuk (lora, H, nope), wuv (lora, H, v), wo (H, v, D).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import logical_constraint
from repro_torch.models.layers import (
    NEG_INF,
    CastWeights,
    chunked_attention,
    decode_attention,
    decode_mask,
    dense_init_,
    dtype_of,
    param,
    rope_tables,
    rotate,
)

Tensor = torch.Tensor


class DecodeStep:
    """What every layer of one decode step shares, computed once per step
    from the (B,) positions ``pos`` (the serving engine steps every slot at
    its own position): the RoPE tables of width ``head_dim`` (none when it
    is 0: whisper and RWKV rotate nothing), the cache rows to write and the
    attention mask of positions ``<= pos``."""

    def __init__(self, pos: Tensor, max_len: int, head_dim: int, theta: float):
        b = pos.shape[0]
        self.pos = pos
        self.cos = self.sin = None
        if head_dim:
            self.cos, self.sin = rope_tables(pos[:, None], head_dim, theta)
        self.rows = torch.arange(b, device=pos.device)
        self.keep = (pos >= 0) & (pos < max_len)
        self.at = pos.clamp(0, max_len - 1)
        self.mask = decode_mask(pos + 1, max_len)

    def write_(self, cache: Tensor, new: Tensor) -> Tensor:
        """``new`` (B, 1, ...) into ``cache`` (B, S, ...) at each row's
        position, in place; a position outside the cache writes nothing
        (the JAX package's masked select, ``cache_update``)."""
        old = cache[self.rows, self.at]
        keep = self.keep.reshape((-1,) + (1,) * (old.ndim - 1))
        cache[self.rows, self.at] = torch.where(keep, new[:, 0].to(cache.dtype), old)
        return cache


class GQA(CastWeights):
    """Grouped-query attention (MQA at ``num_kv_heads = 1``).

    Q, K and V are stored side by side in one (D, (H + 2 KV) hd) matrix in
    ``cfg.param_dtype``, so one product projects all three; ``wq``, ``wk``
    and ``wv`` are views of it in the JAX package's layouts (``bq``, ``bk``,
    ``bv`` likewise of ``bqkv``; ``JAX_VIEWS``).  ``rope=False`` rotates
    nothing and ``causal=False`` masks nothing (whisper)."""

    JAX_VIEWS = {"wqkv": ("wq", "wk", "wv"), "bqkv": ("bq", "bk", "bv")}

    def __init__(self, cfg: ModelConfig, device=None, *, rope: bool = True,
                 causal: bool = True):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        pdt = dtype_of(cfg.param_dtype)
        self.hd, self.rope, self.causal = hd, rope, causal
        self.split = (h * hd, kv * hd, kv * hd)
        self.wqkv = param((d, sum(self.split)), pdt, device)
        self.wo = param((h, hd, d), pdt, device)
        self.bias = cfg.qkv_bias
        if cfg.qkv_bias:
            self.bqkv = param((sum(self.split),), pdt, device)
        self.c: dict[str, Tensor] = {}

    def jax_view(self, name: str, t: Tensor) -> Tensor:
        """The JAX leaf ``name`` (wq/wk/wv or bq/bk/bv) of a tensor shaped
        like ``wqkv`` or ``bqkv`` (the parameter, or its gradient)."""
        i = "qkv".index(name[1])
        lo = sum(self.split[:i])
        return t[..., lo:lo + self.split[i]].unflatten(-1, (-1, self.hd))

    wq = property(lambda self: self.jax_view("wq", self.wqkv))
    wk = property(lambda self: self.jax_view("wk", self.wqkv))
    wv = property(lambda self: self.jax_view("wv", self.wqkv))
    bq = property(lambda self: self.jax_view("bq", self.bqkv))
    bk = property(lambda self: self.jax_view("bk", self.bqkv))
    bv = property(lambda self: self.jax_view("bv", self.bqkv))

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        d, h, hd = self.wq.shape
        for w in (self.wq, self.wk, self.wv):
            dense_init_(w, g, d**-0.5)
        dense_init_(self.wo, g, (h * hd) ** -0.5)
        if self.bias:
            self.bqkv.zero_()

    def weights(self, dtype: torch.dtype) -> dict[str, Tensor]:
        w = {"wqkv": self.wqkv.to(dtype), "wo": self.wo.flatten(0, 1).to(dtype)}
        if self.bias:
            w["bqkv"] = self.bqkv.to(dtype)
        return w

    def qkv(self, w: dict, x: Tensor, cos: Tensor | None, sin: Tensor | None):
        b, s, _ = x.shape
        y = x @ w["wqkv"]
        if self.bias:
            y = y + w["bqkv"]
        q, k, v = (t.reshape(b, s, -1, self.hd) for t in torch.split(y, self.split, dim=-1))
        if self.rope:
            q, k = rotate(q, cos, sin), rotate(k, cos, sin)
        # the fused projection carries no heads layout: the queries' heads
        # split is stated here (the JAX package's ``wq`` leaf carries it)
        return logical_constraint(q, ("batch", "seq", "heads", None)), k, v

    def forward(self, x: Tensor, rope) -> tuple[Tensor, tuple[Tensor, Tensor]]:
        """Full-sequence attention (prefill, the encoder) with the sequence's
        RoPE tables (``(None, None)`` without rope). Returns (out, (k, v))."""
        w = self.w
        q, k, v = self.qkv(w, x, *rope)
        return chunked_attention(q, k, v, causal=self.causal).flatten(2) @ w["wo"], (k, v)

    def cross_kv(self, enc: Tensor) -> tuple[Tensor, Tensor]:
        """Whisper's cross-attention K/V of the encoder output (no bias, no
        rope), (B, S_enc, KV, hd) each: the decoder caches them."""
        b, s, _ = enc.shape
        kv = enc @ self.w["wqkv"][:, self.split[0]:]
        k, v = torch.split(kv, self.split[1:], dim=-1)
        return k.reshape(b, s, -1, self.hd), v.reshape(b, s, -1, self.hd)

    def cross(self, x: Tensor, k: Tensor, v: Tensor) -> Tensor:
        """Cross-attention of x's queries over precomputed encoder K/V."""
        b, s, _ = x.shape
        w = self.w
        q = x @ w["wqkv"][:, :self.split[0]]
        if self.bias:
            q = q + w["bqkv"][:self.split[0]]
        q = q.reshape(b, s, -1, self.hd)
        return chunked_attention(q, k, v, causal=False).flatten(2) @ w["wo"]

    def decode(self, x: Tensor, cache: dict[str, Tensor], step: DecodeStep) -> Tensor:
        """One token per row at the step's positions; writes this token's K/V
        into ``cache`` in place and attends over positions ``<= pos``."""
        w = self.w
        q, k, v = self.qkv(w, x, step.cos, step.sin)
        step.write_(cache["k"], k)
        step.write_(cache["v"], v)
        return decode_attention(q, cache["k"], cache["v"], step.mask).flatten(2) @ w["wo"]


class MLA(CastWeights):
    """DeepSeek-V2 multi-head latent attention.

    Prefill decompresses per-head K/V from the latent ``c_kv`` and runs the
    shared chunked attention; the cache is the COMPRESSED pair ``c_kv``
    (B, S, kv_lora) and ``k_rope`` (B, S, rope), and decode attends in the
    compressed space (W_uk absorbed into the query, W_uv applied after), as
    the JAX package's ``mla_decode`` does, in its order of operations."""

    NAMES = ("wdq", "wuq", "wdkv", "wk_rope", "wuk", "wuv", "wo")

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        m = cfg.mla
        d, h = cfg.d_model, cfg.num_heads
        pdt = dtype_of(cfg.param_dtype)
        self.nope, self.rope_dim, self.v_dim = m.nope_head_dim, m.rope_head_dim, m.v_head_dim
        self.scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
        shapes = {
            "wdq": (d, m.q_lora_rank), "wuq": (m.q_lora_rank, h, self.nope + self.rope_dim),
            "wdkv": (d, m.kv_lora_rank), "wk_rope": (d, m.rope_head_dim),
            "wuk": (m.kv_lora_rank, h, m.nope_head_dim),
            "wuv": (m.kv_lora_rank, h, m.v_head_dim), "wo": (h, m.v_head_dim, d),
        }
        for name, shape in shapes.items():
            setattr(self, name, param(shape, pdt, device))
        self.c: dict[str, Tensor] = {}

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        for name in self.NAMES[:-1]:
            dense_init_(getattr(self, name), g)
        h, v, _ = self.wo.shape
        dense_init_(self.wo, g, (h * v) ** -0.5)

    def weights(self, dtype: torch.dtype) -> dict[str, Tensor]:
        w = {name: getattr(self, name).to(dtype) for name in self.NAMES}
        w["wo"] = w["wo"].flatten(0, 1)
        return w

    def _q(self, w: dict, x: Tensor, cos: Tensor, sin: Tensor) -> tuple[Tensor, Tensor]:
        q = torch.einsum("bsr,rhk->bshk", x @ w["wdq"], w["wuq"])
        return q[..., :self.nope], rotate(q[..., self.nope:], cos, sin)

    def _k_rope(self, w: dict, x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
        return rotate((x @ w["wk_rope"])[:, :, None, :], cos, sin)

    def forward(self, x: Tensor, rope) -> tuple[Tensor, tuple[Tensor, Tensor]]:
        """Full-sequence causal MLA. Returns (out, (c_kv, k_rope))."""
        b, s, _ = x.shape
        w = self.w
        q_nope, q_rope = self._q(w, x, *rope)
        c_kv = x @ w["wdkv"]
        k_rope = self._k_rope(w, x, *rope)
        k_nope = torch.einsum("bsr,rhk->bshk", c_kv, w["wuk"])
        v = torch.einsum("bsr,rhk->bshk", c_kv, w["wuv"])
        h = k_nope.shape[2]
        q = torch.cat([q_nope, q_rope], -1)
        k = torch.cat([k_nope, k_rope.expand(b, s, h, self.rope_dim)], -1)
        # v stays v_head_dim wide: the JAX package's zero padding to the q/k
        # width adds only zero columns, sliced off after
        o = chunked_attention(q, k, v, causal=True)
        return o.flatten(2) @ w["wo"], (c_kv, k_rope[:, :, 0, :])

    def decode(self, x: Tensor, cache: dict[str, Tensor], step: DecodeStep) -> Tensor:
        """Absorbed one-token decode: scores = (q_nope W_uk) c_kv^T + q_rope
        k_rope^T over the compressed cache, written in place first."""
        w = self.w
        q_nope, q_rope = self._q(w, x, step.cos, step.sin)  # (B, 1, H, *)
        step.write_(cache["c_kv"], x @ w["wdkv"])
        step.write_(cache["k_rope"], self._k_rope(w, x, step.cos, step.sin)[:, :, 0, :])
        c_cache, r_cache = cache["c_kv"], cache["k_rope"]
        q_abs = torch.einsum("bshk,rhk->bshr", q_nope, w["wuk"])
        s_c = torch.einsum("bshr,btr->bhst", q_abs, c_cache)
        s_r = torch.einsum("bshk,btk->bhst", q_rope, r_cache)
        scores = (s_c + s_r).float() * self.scale
        p = torch.softmax(torch.where(step.mask, scores, NEG_INF), dim=-1)
        o_c = torch.einsum("bhst,btr->bshr", p.to(x.dtype), c_cache)
        o = torch.einsum("bshr,rhk->bshk", o_c, w["wuv"])
        return o.flatten(2) @ w["wo"]
