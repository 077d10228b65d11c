"""Shared model layers of the port: RMSNorm and LayerNorm, RoPE and the
sinusoidal tables, the SwiGLU and GELU MLPs, prefill (online-softmax) and
decode attention, the embedding and the weight init.

Each function mirrors the JAX package's ``repro/models/layers.py`` line for
line in plain tensor ops: params are held in ``cfg.param_dtype`` (norms in
f32) and used in the compute dtype; norms, softmax and attention accumulate
in f32.  ``CastWeights`` is the base of every module whose products run in
the compute dtype: while autograd records, it casts its weights inside the
graph (the JAX package's ``.astype(cdt)``), so gradients reach the
parameters; otherwise (serving, under ``no_grad``) it reads cast copies,
made again after any parameter changed in place (an optimizer step, a
restore).  The layouts are the JAX package's (activations (B, S, D), heads
(B, S, H, hd), caches (B, S, KV, hd)), so the tests compare like with like.
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed import context as dctx
from repro_torch.distributed.sharding import logical_spec
from repro_torch.distributed.step_cost import TimeSteps

Tensor = torch.Tensor

NEG_INF = -1e30

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def param(shape, dtype: torch.dtype, device) -> nn.Parameter:
    """An uninitialised trainable parameter."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


class CastWeights(nn.Module):
    """A module computing in ``cdt`` from weights held in the param dtype.

    ``weights(dtype)`` (each subclass's) gives its compute-dtype weights as
    a function of the parameters.  ``w`` is what the products read: while
    autograd records, ``weights(cdt)`` itself, cast in the graph; otherwise
    the detached copies of ``cast`` (the parameters themselves where the
    dtypes agree), made again when a parameter's version counter shows an
    in-place change since."""

    cdt: torch.dtype | None = None
    _cast_from: tuple = ()
    _cast_at: tuple = ()

    def weights(self, dtype: torch.dtype) -> dict[str, Tensor]:
        raise NotImplementedError

    def cast(self, dtype: torch.dtype) -> None:
        self.cdt = dtype
        self.c = {n: t.detach() for n, t in self.weights(dtype).items()}
        self._cast_from = tuple(self.parameters(recurse=False))
        self._cast_at = tuple(p._version for p in self._cast_from)

    @property
    def w(self) -> dict[str, Tensor]:
        if torch.is_grad_enabled():
            return self.weights(self.cdt)
        if not self.c or self._cast_at != tuple(p._version for p in self._cast_from):
            self.cast(self.cdt)
        return self.c


def scan_steps(n: int, name: str) -> TimeSteps:
    """The trips of a time loop over ``n`` positions (the JAX package's
    ``lax.scan`` over time, named ``name`` in the dry-run's record):
    ``for t in steps`` is ``range(n)`` and ``steps.stack(ys, dim)`` is
    ``torch.stack``; under the dry-run's counter the loop runs three trips
    whose cost is folded to ``n`` and ``stack`` still gives all ``n``
    positions (``distributed.step_cost.TimeSteps``)."""
    return TimeSteps(n, name)


# ---------------------------------------------------------------------------
# init: the JAX package's distributions, drawn from an explicit generator
# ---------------------------------------------------------------------------


def dense_init_(w: Tensor, g: torch.Generator, scale: float | None = None) -> Tensor:
    """In place: N(0, 1) * scale, with ``dense_init``'s default scale
    fan_in^-0.5, fan_in = shape[-2] (shape[-1] for a vector)."""
    fan_in = w.shape[-2] if w.ndim > 1 else w.shape[-1]
    scale = scale if scale is not None else fan_in**-0.5
    return w.normal_(generator=g).mul_(scale)


def embedding_init_(w: Tensor, g: torch.Generator) -> Tensor:
    """In place: N(0, 1) * 0.02 (``init_embedding``)."""
    return w.normal_(generator=g).mul_(0.02)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    """RMSNorm in f32 with the JAX package's ``1 + scale`` weight (norm
    params start at zero)."""
    dt = x.dtype
    xf = x.float()
    nrm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (nrm * (1.0 + scale.float())).to(dt)


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor, eps: float) -> Tensor:
    """LayerNorm in f32 with the ``1 + scale`` weight and a bias (whisper)."""
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float()) + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_tables(positions: Tensor, head_dim: int, theta: float) -> tuple[Tensor, Tensor]:
    """(cos, sin) of the rotary angles at integer ``positions`` (B, S), each
    (B, S, 1, hd) with the halves laid out for ``rotate``: cos twice, and
    sin negated for the first half.  One table serves q and k of every
    layer of a step (the JAX package's ``apply_rope`` recomputes it)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    freqs = 1.0 / torch.pow(theta, exps)  # f32; a Python base needs no host copy
    ang = positions.float()[..., None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    return torch.cat([cos, cos], -1)[:, :, None, :], torch.cat([-sin, sin], -1)[:, :, None, :]


def rotate(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """RoPE with tables from ``rope_tables``: [x1 cos - x2 sin, x2 cos + x1 sin]
    in f32 (x1 * cos + x2 * (-sin) rounds as x1 * cos - x2 * sin), cast back."""
    xf = x.float()
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    return (xf * cos + torch.cat([x2, x1], -1) * sin).to(x.dtype)


def _inv_timescales(dim: int, device) -> Tensor:
    ar = torch.arange(0, dim, 2, dtype=torch.float32, device=device)
    return torch.exp(-torch.log(torch.tensor(10000.0, device=device)) * ar / dim)


def sinusoidal_positions(seq: int, dim: int, device=None) -> Tensor:
    """Whisper-style fixed sinusoidal table (seq, dim) in f32: [sin, cos]."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    ang = pos * _inv_timescales(dim, device)[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def sinusoidal_at(positions: Tensor, dim: int) -> Tensor:
    """The sinusoidal embedding at integer ``positions`` (B, S) -> (B, S, dim)."""
    ang = positions.float()[..., None] * _inv_timescales(dim, positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_swiglu(w_gate_in: Tensor, w_out: Tensor, x: Tensor) -> Tensor:
    """silu(x W_gate) * (x W_in) W_out, with W_gate and W_in side by side in
    one (D, 2F) matrix, one product for both (each output column is the same
    dot product); the weights already in x's dtype."""
    gate, inp = torch.chunk(x @ w_gate_in, 2, dim=-1)
    return (F.silu(gate) * inp) @ w_out


def mlp_gelu(w_in: Tensor, b_in: Tensor, w_out: Tensor, b_out: Tensor, x: Tensor) -> Tensor:
    """gelu(x W_in + b_in) W_out + b_out (whisper), with ``jax.nn.gelu``'s
    default tanh approximation; the weights already in x's dtype."""
    h = F.gelu(x @ w_in + b_in, approximate="tanh")
    return h @ w_out + b_out


class SwiGLU(CastWeights):
    """The SwiGLU MLP's weights in ``dtype``: W_gate and W_in side by side
    in one (D, 2F) parameter (one product for both); ``w_gate`` and ``w_in``
    are views of it in the JAX package's layout (``JAX_VIEWS``)."""

    JAX_VIEWS = {"w_gate_in": ("w_gate", "w_in")}

    def __init__(self, d: int, f: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.f = f
        self.w_gate_in = param((d, 2 * f), dtype, device)
        self.w_out = param((f, d), dtype, device)
        self.c: dict[str, Tensor] = {}

    def jax_view(self, name: str, t: Tensor) -> Tensor:
        """The JAX leaf ``name`` ("w_gate" or "w_in") of a tensor shaped
        like ``w_gate_in`` (the parameter, or its gradient)."""
        return t[:, :self.f] if name == "w_gate" else t[:, self.f:]

    w_gate = property(lambda self: self.jax_view("w_gate", self.w_gate_in))
    w_in = property(lambda self: self.jax_view("w_in", self.w_gate_in))

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        for w in (self.w_in, self.w_gate, self.w_out):
            dense_init_(w, g)

    def weights(self, dtype: torch.dtype) -> dict[str, Tensor]:
        return {"w_gate_in": self.w_gate_in.to(dtype), "w_out": self.w_out.to(dtype)}

    def forward(self, x: Tensor) -> Tensor:
        w = self.w
        mesh = dctx.current_mesh()
        if mesh is not None and dctx.is_dtensor(x):
            return swiglu_per_device(mesh, w["w_gate_in"], w["w_out"], x)
        return mlp_swiglu(w["w_gate_in"], w["w_out"], x)


def _swiglu_island(mlp, ix, x, w_gate_in, w_out):
    """One device's SwiGLU: its ``mlp`` block of W_gate's and W_in's columns
    (a block of each half of the fused weight), its rows of W_out; the
    output a partial sum over ``mlp``."""
    f, fl = w_gate_in.shape[1] // 2, w_out.shape[0]
    j = ix(mlp) * fl
    gate = x @ w_gate_in[:, j:j + fl]
    inp = x @ w_gate_in[:, f + j:f + j + fl]
    return ((F.silu(gate) * inp) @ w_out,)


def swiglu_per_device(mesh, w_gate_in: Tensor, w_out: Tensor, x: Tensor) -> Tensor:
    """The SwiGLU as each device's program (``shard_map``), as GSPMD runs
    the JAX package's W_gate / W_in (fsdp, mlp) and W_out (mlp, fsdp): the
    weights gathered over fsdp, the hidden width split over the mlp axes
    (every row of the sequence on each, its sum over them left to the
    caller's constraint)."""
    xs = logical_spec(tuple(x.shape), ("batch", None, None), mesh)
    mlp = logical_spec(tuple(w_out.shape), ("mlp", None), mesh)[0]
    axes = dctx.spec_axes(mlp)
    return dctx.shard_map(partial(_swiglu_island, axes), mesh,
                          [xs, (None, None), (mlp, None)], [(xs, axes)])(x, w_gate_in, w_out)[0]


class GeluMLP(CastWeights):
    """Whisper's GELU MLP: w_in (D, F), b_in, w_out (F, D), b_out in
    ``dtype``."""

    NAMES = ("w_in", "b_in", "w_out", "b_out")

    def __init__(self, d: int, f: int, dtype: torch.dtype, device=None):
        super().__init__()
        for name, shape in zip(self.NAMES, ((d, f), (f,), (f, d), (d,))):
            setattr(self, name, param(shape, dtype, device))
        self.c: dict[str, Tensor] = {}

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        dense_init_(self.w_in, g)
        self.b_in.zero_()
        dense_init_(self.w_out, g)
        self.b_out.zero_()

    def weights(self, dtype: torch.dtype) -> dict[str, Tensor]:
        return {n: getattr(self, n).to(dtype) for n in self.NAMES}

    def forward(self, x: Tensor) -> Tensor:
        w = self.w
        return mlp_gelu(*(w[n] for n in self.NAMES), x)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def chunked_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    causal: bool,
    q_offset: int = 0,
    kv_block: int = 1024,
) -> Tensor:
    """Online-softmax (flash-style) attention over KV blocks.

    q, k: (B, Sq|Skv, H|KV, hd); v: (B, Skv, KV, hd_v) with H % KV == 0
    (GQA groups of H / KV query heads per KV head; MLA's v is narrower than
    its q/k heads, which the JAX package pads with zeros and slices off).  The recurrence over blocks of
    ``kv_block`` keys carries (max, denominator, accumulator) in f32, as the
    JAX package's ``lax.scan`` does; ``q_offset`` is the absolute position
    of q[:, 0] for the causal mask.  Padding keys are masked, not computed.
    """
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    groups = h // kv
    scale = hd**-0.5
    qf = (q.float() * scale).reshape(b, sq, kv, groups, hd)
    kf = k.float()
    vf = v.float()
    q_pos = (q_offset + torch.arange(sq, device=q.device))[None, :, None]  # (1, Sq, 1)

    m = torch.full((b, sq, kv, groups), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros((b, sq, kv, groups), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kv, groups, v.shape[-1]), dtype=torch.float32, device=q.device)
    for lo in range(0, skv, kv_block):
        kb = kf[:, lo:lo + kv_block]
        vb = vf[:, lo:lo + kv_block]
        s = torch.einsum("bsvgh,bkvh->bsvgk", qf, kb)  # (B, Sq, KV, G, blk)
        kv_pos = (lo + torch.arange(kb.shape[1], device=q.device))[None, None, :]
        mask = kv_pos <= q_pos if causal else (kv_pos < skv).expand(1, sq, -1)
        s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        denom = denom * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bsvgk,bkvh->bsvgh", p, vb)
        m = m_new
    out = acc / torch.clamp_min(denom, 1e-30)[..., None]
    return out.reshape(b, sq, h, -1).to(q.dtype)


def decode_mask(cur_len: Tensor, s: int) -> Tensor:
    """(B, 1, 1, S) True where a position lies below its row's live length."""
    return (torch.arange(s, device=cur_len.device)[None, :] < cur_len.reshape(-1, 1))[:, None, None, :]


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor, mask: Tensor) -> Tensor:
    """One query position against a (B, S, KV, hd) cache.

    q: (B, 1, H, hd); ``mask`` (``decode_mask`` of each row's live length,
    made once for all layers of a step) drops positions past it.
    """
    b, _, h, hd = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    groups = h // kv
    qf = (q.float() * hd**-0.5).reshape(b, kv, groups, hd)
    scores = torch.einsum("bvgh,bkvh->bvgk", qf, k_cache.float())  # (B, KV, G, S)
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bvgk,bkvh->bvgh", p, v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)
