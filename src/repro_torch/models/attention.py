"""Attention of the port (the JAX package's ``repro/models/attention.py``):
GQA (the llama family, MQA at one KV head, whisper's unrotated encoder,
decoder and cross attention, the hybrid's attention layers) and MLA
(DeepSeek-V2 multi-head latent attention, with the absorbed decode that
attends over the compressed cache).

The weights keep the JAX package's layouts: wq (D, H, hd), wk and wv
(D, KV, hd), wo (H, hd, D), biases (H, hd) and (KV, hd); MLA's wdq
(D, q_lora), wuq (q_lora, H, nope + rope), wdkv (D, lora), wk_rope
(D, rope), wuk (lora, H, nope), wuv (lora, H, v), wo (H, v, D).

On ``DTensor`` inputs (the dry-run's sharded run) the attention core runs
as each device's program (``distributed.context.shard_map``), as GSPMD
partitions it: the rows split over the batch axes, the query heads over
the axes the rules shard ``wq`` (or MLA's ``wuq``) by, the KV heads as
``wk`` / ``wv`` are placed (whole on every model device for GQA, so each
device takes its query heads' groups; split with the queries for MLA,
whose per-head K/V come from the head-sharded ``wuk`` / ``wuv``).  On
plain tensors it is the one program it always was.
"""
from __future__ import annotations

import math
from functools import partial

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import context as dctx
from repro_torch.distributed.sharding import logical_constraint, logical_spec
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


def _heads_island(causal: bool, groups: int, heads, ix, q, k, v):
    """One device's attention: its query heads (block ``ix(heads)`` of the
    ``heads`` axes, or all of them) over the KV heads their groups read."""
    hl = q.shape[2]
    if k.shape[2] * groups != hl:  # the KV heads are whole, the queries split
        h0 = ix(heads) * hl
        if hl % groups == 0:
            k, v = k.narrow(2, h0 // groups, hl // groups), v.narrow(2, h0 // groups, hl // groups)
        elif groups % hl == 0:
            k, v = k.narrow(2, h0 // groups, 1), v.narrow(2, h0 // groups, 1)
        else:
            idx = torch.div(h0 + torch.arange(hl, device=q.device), groups, rounding_mode="floor")
            k, v = k.index_select(2, idx), v.index_select(2, idx)
    return (chunked_attention(q, k, v, causal=causal),)


def _qkv_island(split, hd: int, h_loc: int, heads, kv: bool, ix, x, w, bias=None):
    """One device's fused projection: its ``h_loc`` query heads (block
    ``ix(heads)``) and, with ``kv``, every KV head."""
    q0 = ix(heads) * h_loc * hd
    cols = [(q0, h_loc * hd)] + ([(split[0], split[1] + split[2])] if kv else [])
    ys = []
    for lo, n in cols:
        y = x @ w[:, lo:lo + n]
        ys.append(y if bias is None else y + bias[lo:lo + n])
    q = ys[0].unflatten(-1, (h_loc, hd))
    if not kv:
        return (q,)
    k, v = (t.unflatten(-1, (-1, hd)) for t in torch.split(ys[1], split[1:], dim=-1))
    return q, k, v


def attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool, kv_split: bool = False) -> Tensor:
    """``chunked_attention`` of q (B, S, H, hd) over k, v (B, Skv, KV, *).
    On DTensors under a mesh, each device's program (module docstring):
    ``kv_split`` says the KV heads are split with the queries (MLA's)."""
    mesh = dctx.current_mesh()
    if mesh is None or not dctx.is_dtensor(q):
        return chunked_attention(q, k, v, causal=causal)
    return attention_per_device(mesh, q, k, v, causal=causal, kv_split=kv_split)


def attention_per_device(mesh, q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                         kv_split: bool = False) -> Tensor:
    """``attention`` as each device's program of ``mesh`` (``shard_map``:
    per device on DTensors, island by island on an island mesh)."""
    qspec = logical_spec(tuple(q.shape), ("batch", None, "heads", None), mesh)
    kvspec = qspec if kv_split else (qspec[0], None, None, None)
    heads = dctx.spec_axes(qspec[2])
    body = partial(_heads_island, causal, q.shape[2] // k.shape[2], heads)
    return dctx.shard_map(body, mesh, [qspec, kvspec, kvspec], [(qspec, ())])(q, k, v)[0]


def _split_softmax(seq, scores: Tensor, mask: Tensor):
    """A device's share of a softmax over keys split along ``seq``: its
    unnormalised weights and the denominator over every device's keys
    (a generator body: the max and the sum are collectives)."""
    scores = torch.where(mask, scores, NEG_INF)
    top = yield ("pmax", seq, scores.amax(-1, keepdim=True))
    p = torch.exp(scores - top)
    denom = yield ("psum", seq, p.sum(-1, keepdim=True))
    return p, denom


def _decode_island(seq, ix, q, k, v, mask):
    """One device's decode attention over its block of the cache's
    positions: every query head, its positions' keys, the softmax and the
    weighted values summed over the devices that hold the others."""
    b, _, h, hd = q.shape
    kv = k.shape[2]
    qf = (q.float() * hd**-0.5).reshape(b, kv, h // kv, hd)
    scores = torch.einsum("bvgh,bkvh->bvgk", qf, k.float())
    p, denom = yield from _split_softmax(seq, scores, mask)
    o = yield ("psum", seq, torch.einsum("bvgk,bkvh->bvgh", p, v.float()))
    return ((o / denom).reshape(b, 1, h, hd).to(q.dtype),)


def _cache_specs(mesh, q: Tensor, cache: Tensor, mask: Tensor):
    """(query spec: every head; cache spec: its rows and positions as the
    rules place the cache; mask spec; the positions' axes)."""
    cs = logical_spec(tuple(cache.shape), ("batch", "seq_kv") + (None,) * (cache.ndim - 2), mesh)
    qs = (cs[0],) + (None,) * (q.ndim - 1)
    return qs, cs, (cs[0], None, None, cs[1]), dctx.spec_axes(cs[1])


def decode_attn(q: Tensor, k_cache: Tensor, v_cache: Tensor, mask: Tensor) -> Tensor:
    """``decode_attention``; on DTensors under a mesh, each device's
    program over its block of the cache's positions (GSPMD keeps the
    seq-sharded cache in place and splits the softmax's max and sum)."""
    mesh = dctx.current_mesh()
    if mesh is None or not dctx.is_dtensor(q):
        return decode_attention(q, k_cache, v_cache, mask)
    return decode_per_device(mesh, q, k_cache, v_cache, mask)


def decode_per_device(mesh, q: Tensor, k_cache: Tensor, v_cache: Tensor, mask: Tensor) -> Tensor:
    """``decode_attn``'s program for each device of ``mesh``."""
    qs, cs, ms, seq = _cache_specs(mesh, q, k_cache, mask)
    return dctx.shard_map(partial(_decode_island, seq), mesh, [qs, cs, cs, ms],
                          [(qs, ())])(q, k_cache, v_cache, mask)[0]


def _mla_decode_island(scale: float, seq, ix, q_abs, q_rope, c, r, mask):
    """One device's absorbed MLA decode over its block of the compressed
    cache's positions (``MLA.decode``'s order of operations)."""
    s_c = torch.einsum("bshr,btr->bhst", q_abs, c)
    s_r = torch.einsum("bshk,btk->bhst", q_rope, r)
    p, denom = yield from _split_softmax(seq, (s_c + s_r).float() * scale, mask)
    o_c = yield ("psum", seq, torch.einsum("bhst,btr->bshr", p.to(q_abs.dtype), c))
    return (o_c / denom.transpose(1, 2).to(o_c.dtype),)


def mla_decode_per_device(mesh, scale: float, q_abs: Tensor, q_rope: Tensor, c_cache: Tensor,
                          r_cache: Tensor, mask: Tensor) -> Tensor:
    """MLA's absorbed attention in the compressed space, (B, 1, H, lora), as
    each device's program of ``mesh`` over its block of the cache's
    positions."""
    qs, cs, ms, seq = _cache_specs(mesh, q_abs, c_cache, mask)
    return dctx.shard_map(partial(_mla_decode_island, scale, seq), mesh, [qs, qs, cs, cs, ms],
                          [(qs, ())])(q_abs, q_rope, c_cache, r_cache, mask)[0]


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
        mesh = dctx.current_mesh()
        if mesh is not None and dctx.is_dtensor(x):
            q, k, v = self.qkv_per_device(mesh, w, x)
        else:
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
        return attention(q, k, v, causal=self.causal).flatten(2) @ w["wo"], (k, v)

    def qkv_per_device(self, mesh, w: dict, x: Tensor, kv: bool = True):
        """The fused projection as each device's program (``shard_map``),
        as GSPMD runs the JAX package's wq (fsdp, heads, .) and wk / wv
        (fsdp, ., .): the weight gathered over fsdp, each device projecting
        its query heads and every KV head.  Returns (q, k, v), or (q,) with
        ``kv=False``."""
        b, s, _ = x.shape
        xs = logical_spec(tuple(x.shape), ("batch", None, None), mesh)
        h = self.split[0] // self.hd
        qs = logical_spec((b, s, h, self.hd), ("batch", None, "heads", None), mesh)
        heads = dctx.spec_axes(qs[2])
        h_loc = h // math.prod(mesh.shape[a] for a in heads)
        args = [x, w["wqkv"]] + ([w["bqkv"]] if self.bias else [])
        specs = [xs, (None, None)] + ([(None,)] if self.bias else [])
        kvs = qs[:2] + (None, None)
        outs = [(qs, ())] + ([(kvs, ()), (kvs, ())] if kv else [])
        body = partial(_qkv_island, self.split, self.hd, h_loc, heads, kv)
        return dctx.shard_map(body, mesh, specs, outs)(*args)

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
        mesh = dctx.current_mesh()
        if mesh is not None and dctx.is_dtensor(x):
            q = self.qkv_per_device(mesh, w, x, kv=False)[0]
        else:
            q = x @ w["wqkv"][:, :self.split[0]]
            if self.bias:
                q = q + w["bqkv"][:self.split[0]]
            q = q.reshape(b, s, -1, self.hd)
        return attention(q, k, v, causal=False).flatten(2) @ w["wo"]

    def decode(self, x: Tensor, cache: dict[str, Tensor], step: DecodeStep) -> Tensor:
        """One token per row at the step's positions; writes this token's K/V
        into ``cache`` in place and attends over positions ``<= pos``."""
        w = self.w
        q, k, v = self.qkv(w, x, step.cos, step.sin)
        step.write_(cache["k"], k)
        step.write_(cache["v"], v)
        return decode_attn(q, cache["k"], cache["v"], step.mask).flatten(2) @ w["wo"]


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
        o = attention(q, k, v, causal=True, kv_split=True)
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
        mesh = dctx.current_mesh()
        if mesh is not None and dctx.is_dtensor(x):
            o_c = mla_decode_per_device(mesh, self.scale, q_abs, q_rope, c_cache, r_cache,
                                        step.mask)
        else:
            s_c = torch.einsum("bshr,btr->bhst", q_abs, c_cache)
            s_r = torch.einsum("bshk,btk->bhst", q_rope, r_cache)
            scores = (s_c + s_r).float() * self.scale
            p = torch.softmax(torch.where(step.mask, scores, NEG_INF), dim=-1)
            o_c = torch.einsum("bhst,btr->bshr", p.to(x.dtype), c_cache)
        o = torch.einsum("bshr,rhk->bshk", o_c, w["wuv"])
        return o.flatten(2) @ w["wo"]
