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
from repro_torch.distributed import context as dctx
from repro_torch.distributed.sharding import logical_spec
from repro_torch.models.layers import CastWeights, dense_init_, dtype_of, param, scan_steps

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


def wkv_scan(r: Tensor, k: Tensor, v: Tensor, w: Tensor, u: Tensor, st: Tensor | None):
    """The WKV recurrence over time in f32: r, k, v, w (B, S, H, hd), the
    bonus u (H, hd), the state st (B, H, hd, hd), zeros where None.  Returns
    (y (B, S, H, hd), the final state)."""
    b, _, h, hd = r.shape
    if st is None:
        st = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    u = u[None, :, :, None]
    ys, steps = [], scan_steps(r.shape[1], "rwkv wkv")
    for t in steps:
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (B, H, hd, hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], st + u * kv))
        st = w[:, t, :, :, None] * st + kv
    return steps.stack(ys, 1), st


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

    F32 = ("mu_x", "mu", "w0", "wd_b", "u", "ln_scale", "ln_bias")

    def forward(self, x: Tensor, shift: Tensor | None = None, wkv: Tensor | None = None):
        """Time-mix over x (B, S, D) from the carried (shift, wkv) state, or
        from zeros.  Returns (out, last position of x, final wkv state).
        On DTensors under a mesh, each device's program (``shard_map``):
        its rows, every head (the rules split nothing of the time mix over
        the model axis; its weights are gathered over fsdp)."""
        p = {**self.w, **{n: getattr(self, n) for n in self.F32}}
        mesh = dctx.current_mesh()
        if mesh is None or not dctx.is_dtensor(x):
            return self._mix(p, x, shift, wkv)
        return self.mix_per_device(mesh, p, x, shift, wkv)

    def mix_per_device(self, mesh, p: dict, x: Tensor, shift: Tensor | None,
                       wkv: Tensor | None):
        """``forward``'s program for each device of ``mesh``, the weights
        ``p`` by name."""
        rows = logical_spec(tuple(x.shape), ("batch", None, None), mesh)
        state = (rows[0], None, None, None)
        names = list(p)

        def body(ix, x, shift, wkv, *ts):
            return self._mix(dict(zip(names, ts)), x, shift, wkv)

        return dctx.shard_map(body, mesh, [rows, rows, state] + [None] * len(names),
                              [(rows, ()), (rows, ()), (state, ())])(x, shift, wkv, *p.values())

    def _mix(self, p: dict, x: Tensor, shift: Tensor | None, wkv: Tensor | None):
        dt = x.dtype
        b, s, d = x.shape
        diff = shifted(x, shift) - x
        lo = torch.tanh((x + diff * p["mu_x"].to(dt)) @ p["lora_a"])
        delta = torch.einsum("bsfr,frd->bsfd", lo.reshape(b, s, 5, LORA), p["lora_b"])
        xr, xk, xv, xg, xw = (x + diff * (p["mu"][i].to(dt) + delta[..., i, :]) for i in range(5))
        r = (xr @ p["wr"]).reshape(b, s, self.h, self.hd)
        k = (xk @ p["wk"]).reshape(b, s, self.h, self.hd)
        v = (xv @ p["wv"]).reshape(b, s, self.h, self.hd)
        gate = F.silu(xg @ p["wg"])
        wdec = p["w0"].float() + torch.tanh(xw @ p["wd_a"]).float() @ p["wd_b"].float()
        w = torch.exp(-torch.exp(wdec)).reshape(b, s, self.h, self.hd)
        y, st = wkv_scan(r.float(), k.float(), v.float(), w.float(), p["u"].float(), wkv)
        y = y.reshape(b, s, d).to(x.dtype)
        y = group_norm(y, p["ln_scale"], p["ln_bias"], self.h) * gate
        return y @ p["wo"], x[:, -1:], st


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
        """Returns (out, last position of x).  On DTensors under a mesh, each
        device's program (``shard_map``): its rows and its block of the
        hidden width (wk (fsdp, mlp), wv (mlp, fsdp)), the output a partial
        sum over the mlp axes (the gate r multiplies each part alike)."""
        w = self.w
        args = (x, shift, w["wk"], w["wv"], w["wr"], self.mu_k, self.mu_r)
        mesh = dctx.current_mesh()
        if mesh is None or not dctx.is_dtensor(x):
            return channel_mix(*args)
        return channel_mix_per_device(mesh, *args)


def channel_mix_per_device(mesh, x: Tensor, shift: Tensor | None, wk: Tensor, wv: Tensor,
                           wr: Tensor, mu_k: Tensor, mu_r: Tensor) -> tuple[Tensor, Tensor]:
    """``channel_mix`` as each device's program of ``mesh``."""
    rows = logical_spec(tuple(x.shape), ("batch", None, None), mesh)
    mlp = logical_spec(tuple(wk.shape), (None, "mlp"), mesh)[1]
    return dctx.shard_map(lambda ix, *a: channel_mix(*a), mesh,
                          [rows, rows, (None, mlp), (mlp, None), None, None, None],
                          [(rows, dctx.spec_axes(mlp)), (rows, ())])(
        x, shift, wk, wv, wr, mu_k, mu_r)


def channel_mix(x: Tensor, shift: Tensor | None, wk: Tensor, wv: Tensor, wr: Tensor,
                mu_k: Tensor, mu_r: Tensor) -> tuple[Tensor, Tensor]:
    """The channel mix of x (B, S, D): sigmoid(xr W_r) * (relu(xk W_k)^2 W_v).
    Returns (out, last position of x)."""
    dt = x.dtype
    diff = shifted(x, shift) - x
    xk = x + diff * mu_k.to(dt)
    xr = x + diff * mu_r.to(dt)
    kk = torch.square(torch.relu(xk @ wk))
    return torch.sigmoid(xr @ wr) * (kk @ wv), x[:, -1:]
