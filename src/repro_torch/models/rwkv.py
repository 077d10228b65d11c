"""RWKV-6 "Finch" block of the port (attention-free, data-dependent
per-channel decay; the JAX package's ``repro/models/rwkv.py``).

Time-mix recurrence per head (state S in R^{hd x hd}, f32):

    y_t = r_t ( S_t + (u * k_t) v_t^T )
    S_{t+1} = diag(w_t) S_t + k_t v_t^T          (w_t data-dependent)

Prefill loops over time carrying (B, H, hd, hd); decode is the same loop at
S = 1.  Token shift uses the Finch data-dependent lerp (ddlerp) with the
5-way low-rank delta.  The state is ``{"tm_shift": (B, 1, D), "tm_wkv":
(B, H, hd, hd) f32, "cm_shift": (B, 1, D)}``, the shifts in the compute
dtype: the JAX package's nested ``{"tm": {"shift", "wkv"}, "cm":
{"shift"}}`` flattened, batch on axis 0 of every leaf.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import CastWeights, dense_init_, dtype_of, param

Tensor = torch.Tensor

LORA = 32  # the ddlerp's low-rank width (fixed in the JAX package)
GN_EPS = 64e-5


def group_norm(y: Tensor, scale: Tensor, bias: Tensor, h: int, eps: float = GN_EPS) -> Tensor:
    """Per-head LayerNorm on (B, S, D) viewed as (B, S, H, hd), in f32."""
    b, s, d = y.shape
    yf = y.float().reshape(b, s, h, d // h)
    mu = yf.mean(-1, keepdim=True)
    var = ((yf - mu) ** 2).mean(-1, keepdim=True)
    yn = ((yf - mu) * torch.rsqrt(var + eps)).reshape(b, s, d)
    return (yn * (1.0 + scale.float()) + bias.float()).to(y.dtype)


def shifted(x: Tensor, prev: Tensor | None) -> Tensor:
    """Token shift: each position sees the one before it; position 0 sees
    ``prev`` (the carried state, zeros at the start)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev.to(x.dtype), x[:, :-1]], 1)


class TimeMix(CastWeights):
    """Time-mix weights: wr, wk, wv, wg, wo (D, D), lora_a (D, 5 * 32),
    lora_b (5, 32, D), wd_a (D, decay_lora), wd_b (decay_lora, D) in
    ``cfg.param_dtype``; mu_x, mu (5, D), w0, u (H, hd), ln_scale, ln_bias in
    f32."""

    CAST = ("lora_a", "lora_b", "wr", "wk", "wv", "wg", "wo", "wd_a")

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, r = cfg.d_model, cfg.rwkv
        self.h, self.hd = d // r.head_dim, r.head_dim
        pdt, f32 = dtype_of(cfg.param_dtype), torch.float32
        self.mu_x = param((d,), f32, device)
        self.mu = param((5, d), f32, device)  # r, k, v, g, w base lerp factors
        self.lora_a = param((d, 5 * LORA), pdt, device)
        self.lora_b = param((5, LORA, d), pdt, device)
        for name in ("wr", "wk", "wv", "wg", "wo"):
            setattr(self, name, param((d, d), pdt, device))
        self.w0 = param((d,), f32, device)
        self.wd_a = param((d, r.decay_lora), pdt, device)
        self.wd_b = param((r.decay_lora, d), pdt, device)
        self.u = param((self.h, self.hd), f32, device)
        self.ln_scale = param((d,), f32, device)
        self.ln_bias = param((d,), f32, device)
        self.c: dict[str, Tensor] = {}

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        self.mu_x.zero_()
        self.mu.zero_()
        dense_init_(self.lora_a, g)
        dense_init_(self.lora_b, g, LORA**-0.5)
        for name in ("wr", "wk", "wv", "wg", "wo", "wd_a"):
            dense_init_(getattr(self, name), g)
        dense_init_(self.wd_b, g, self.wd_b.shape[0] ** -0.5)
        self.w0.fill_(-5.0)  # decay bias (slow decay init)
        self.u.normal_(generator=g).mul_(0.1)
        self.ln_scale.zero_()
        self.ln_bias.zero_()

    def weights(self, dtype: torch.dtype) -> dict[str, Tensor]:
        return {n: getattr(self, n).to(dtype) for n in self.CAST}

    def _rkvgw(self, w: dict, x: Tensor, xx: Tensor):
        dt = x.dtype
        b, s, d = x.shape
        diff = xx - x
        lo = torch.tanh((x + diff * self.mu_x.to(dt)) @ w["lora_a"])
        delta = torch.einsum("bsfr,frd->bsfd", lo.reshape(b, s, 5, LORA), w["lora_b"])
        xr, xk, xv, xg, xw = (x + diff * (self.mu[i].to(dt) + delta[..., i, :]) for i in range(5))
        r = (xr @ w["wr"]).reshape(b, s, self.h, self.hd)
        k = (xk @ w["wk"]).reshape(b, s, self.h, self.hd)
        v = (xv @ w["wv"]).reshape(b, s, self.h, self.hd)
        gate = F.silu(xg @ w["wg"])
        wdec = self.w0.float() + torch.tanh(xw @ w["wd_a"]).float() @ self.wd_b.float()
        w = torch.exp(-torch.exp(wdec)).reshape(b, s, self.h, self.hd)
        return r, k, v, gate, w

    def forward(self, x: Tensor, shift: Tensor | None = None, wkv: Tensor | None = None):
        """Time-mix over x (B, S, D) from the carried (shift, wkv) state, or
        from zeros.  Returns (out, last position of x, final wkv state)."""
        b, s, d = x.shape
        wts = self.w
        r, k, v, gate, w = self._rkvgw(wts, x, shifted(x, shift))
        st = wkv if wkv is not None else torch.zeros(
            (b, self.h, self.hd, self.hd), dtype=torch.float32, device=x.device)
        r, k, v, w = r.float(), k.float(), v.float(), w.float()
        u = self.u.float()[None, :, :, None]
        ys = []
        for t in range(s):
            kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B, H, hd, hd)
            ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], st + u * kv))
            st = w[:, t, :, :, None] * st + kv
        y = torch.stack(ys, 1).reshape(b, s, d).to(x.dtype)
        y = group_norm(y, self.ln_scale, self.ln_bias, self.h) * gate
        return y @ wts["wo"], x[:, -1:], st


class ChannelMix(CastWeights):
    """Channel-mix weights: wk (D, F), wv (F, D), wr (D, D) in
    ``cfg.param_dtype``; mu_k, mu_r in f32."""

    CAST = ("wk", "wv", "wr")

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        pdt = dtype_of(cfg.param_dtype)
        self.mu_k = param((d,), torch.float32, device)
        self.mu_r = param((d,), torch.float32, device)
        self.wk = param((d, f), pdt, device)
        self.wv = param((f, d), pdt, device)
        self.wr = param((d, d), pdt, device)
        self.c: dict[str, Tensor] = {}

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        self.mu_k.zero_()
        self.mu_r.zero_()
        for name in self.CAST:
            dense_init_(getattr(self, name), g)

    def weights(self, dtype: torch.dtype) -> dict[str, Tensor]:
        return {n: getattr(self, n).to(dtype) for n in self.CAST}

    def forward(self, x: Tensor, shift: Tensor | None = None) -> tuple[Tensor, Tensor]:
        """Returns (out, last position of x)."""
        dt = x.dtype
        w = self.w
        diff = shifted(x, shift) - x
        xk = x + diff * self.mu_k.to(dt)
        xr = x + diff * self.mu_r.to(dt)
        kk = torch.square(torch.relu(xk @ w["wk"]))
        return torch.sigmoid(xr @ w["wr"]) * (kk @ w["wv"]), x[:, -1:]
