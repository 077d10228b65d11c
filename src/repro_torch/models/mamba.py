"""Mamba-1 selective SSM mixer of the port (Jamba's sequence-mixing layer;
the JAX package's ``repro/models/mamba.py``).

Prefill runs a loop over time that discretises INSIDE the step, carrying
only the (B, d_inner, d_state) f32 state, never the (B, S, d_inner,
d_state) tensor.  Decode carries the state ``{"conv": (B, d_conv - 1,
d_inner) in the compute dtype, "ssm": (B, d_inner, d_state) f32}``: the
conv window holds the PRE-conv input u of the last ``d_conv - 1`` positions,
left-padded with zeros when the prompt is shorter.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import context as dctx
from repro_torch.distributed.sharding import logical_constraint, logical_spec
from repro_torch.models.layers import CastWeights, dense_init_, dtype_of, param, scan_steps

Tensor = torch.Tensor


def dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    """(d_inner, d_state, d_conv, dt_rank)."""
    s = cfg.ssm
    return s.expand * cfg.d_model, s.d_state, s.d_conv, s.dt_rank or -(-cfg.d_model // 16)


def ssm_step(h: Tensor, xt: Tensor, dtt: Tensor, bt: Tensor, ct: Tensor, a: Tensor):
    """One selective-SSM step in f32: h (B, d_in, ds); x, delta (B, d_in);
    B, C (B, ds); a (d_in, ds). Returns (h', y (B, d_in))."""
    da = torch.exp(dtt[..., None] * a[None])
    dbx = (dtt * xt)[..., None] * bt[:, None, :]
    h = da * h + dbx
    return h, torch.einsum("bds,bs->bd", h, ct)


def selective_scan(uf: Tensor, delta: Tensor, b_in: Tensor, c_in: Tensor, a: Tensor):
    """The selective SSM over time from a zero state, in f32: u, delta (B,
    S, d_in); B, C (B, S, ds); a (d_in, ds).  Returns (y (B, S, d_in), the
    final state (B, d_in, ds))."""
    b, s, d_in = uf.shape
    h = torch.zeros((b, d_in, a.shape[1]), dtype=torch.float32, device=uf.device)
    ys, steps = [], scan_steps(s, "mamba scan")
    for t in steps:
        h, y = ssm_step(h, uf[:, t], delta[:, t], b_in[:, t], c_in[:, t], a)
        ys.append(y)
    return steps.stack(ys, 1), h


def selective_scan_per_device(mesh, uf: Tensor, delta: Tensor, b_in: Tensor, c_in: Tensor,
                              a: Tensor):
    """``selective_scan`` as each device's program of ``mesh``: its rows and
    its d_inner channels (the rules split in_proj's and a_log's d_inner
    over the mlp axes)."""
    ch = logical_spec(tuple(uf.shape), ("batch", None, "mlp"), mesh)
    bc = (ch[0], None, None)
    return dctx.shard_map(lambda ix, *a: selective_scan(*a), mesh,
                          [ch, ch, bc, bc, (ch[2], None)],
                          [(ch, ()), ((ch[0], ch[2], None), ())])(uf, delta, b_in, c_in, a)


class Mamba(CastWeights):
    """The mixer's weights: in_proj (D, 2 d_in), conv_w (d_conv, d_in),
    conv_b, x_proj (d_in, dt_rank + 2 ds), dt_proj (dt_rank, d_in),
    out_proj (d_in, D) in ``cfg.param_dtype``; dt_bias, a_log and d_skip in
    f32, as the JAX package holds them."""

    CAST = ("in_proj", "conv_w", "conv_b", "x_proj", "out_proj")

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        d = cfg.d_model
        d_in, ds, dc, dtr = self.dims = dims(cfg)
        pdt, f32 = dtype_of(cfg.param_dtype), torch.float32
        self.in_proj = param((d, 2 * d_in), pdt, device)
        self.conv_w = param((dc, d_in), pdt, device)
        self.conv_b = param((d_in,), pdt, device)
        self.x_proj = param((d_in, dtr + 2 * ds), pdt, device)
        self.dt_proj = param((dtr, d_in), pdt, device)
        self.dt_bias = param((d_in,), f32, device)
        self.a_log = param((d_in, ds), f32, device)
        self.d_skip = param((d_in,), f32, device)
        self.out_proj = param((d_in, d), pdt, device)
        self.c: dict[str, Tensor] = {}

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        d_in, ds, dc, dtr = self.dims
        dense_init_(self.in_proj, g)
        dense_init_(self.conv_w, g, dc**-0.5)
        self.conv_b.zero_()
        dense_init_(self.x_proj, g)
        dense_init_(self.dt_proj, g, dtr**-0.5)
        lo, hi = math.log(0.001), math.log(0.1)
        u = torch.rand(self.dt_bias.shape, generator=g, device=self.dt_bias.device)
        self.dt_bias.copy_(torch.log(torch.expm1(torch.exp(u * (hi - lo) + lo))))
        a = torch.arange(1, ds + 1, dtype=torch.float32, device=self.a_log.device)
        self.a_log.copy_(torch.log(a).expand(d_in, ds))  # S4D-real
        self.d_skip.fill_(1.0)
        dense_init_(self.out_proj, g)

    def weights(self, dtype: torch.dtype) -> dict[str, Tensor]:
        return {n: getattr(self, n).to(dtype) for n in self.CAST}

    def _ssm_inputs(self, w: dict, u: Tensor):
        """x_proj's split of the conv output: (delta f32 after softplus, B, C
        in f32)."""
        d_in, ds, _, dtr = self.dims
        # summed over d_inner where the rules split it (GSPMD's all-reduce)
        proj = logical_constraint(u @ w["x_proj"], ("batch", None, None))
        dt_in, b_in, c_in = torch.split(proj, [dtr, ds, ds], dim=-1)
        delta = F.softplus(dt_in.float() @ self.dt_proj.float() + self.dt_bias.float())
        return delta, b_in.float(), c_in.float()

    def _out(self, w: dict, y: Tensor, u: Tensor, z: Tensor) -> Tensor:
        y = y + u.float() * self.d_skip.float()
        return (y.to(z.dtype) * F.silu(z)) @ w["out_proj"]

    def forward(self, x: Tensor) -> tuple[Tensor, dict[str, Tensor]]:
        """Full-sequence mixer over x (B, S, D). Returns (out, final state)."""
        d_in, ds, dc, _ = self.dims
        b, s, _ = x.shape
        w = self.w
        xz = x @ w["in_proj"]
        u0, z = torch.chunk(xz, 2, dim=-1)  # (B, S, d_in)
        # the conv's window runs along the whole sequence on each device (the
        # identity off the dry-run's sharded run)
        u0 = logical_constraint(u0, ("batch", None, "mlp"))
        pad = F.pad(u0.transpose(1, 2), (dc - 1, 0))  # (B, d_in, S + dc - 1)
        conv = F.conv1d(pad, w["conv_w"].t()[:, None, :], groups=d_in).transpose(1, 2)
        u = F.silu(conv + w["conv_b"])
        delta, b_in, c_in = self._ssm_inputs(w, u)
        a = -torch.exp(self.a_log.float())
        uf = u.float()
        mesh = dctx.current_mesh()
        if mesh is not None and dctx.is_dtensor(x):
            ys, h = selective_scan_per_device(mesh, uf, delta, b_in, c_in, a)
        else:
            ys, h = selective_scan(uf, delta, b_in, c_in, a)
        out = self._out(w, ys, u, z)
        conv_state = u0[:, -(dc - 1):] if s >= dc - 1 else F.pad(u0, (0, 0, dc - 1 - s, 0))
        # a copy, not a view of the chunk: ``decode`` writes the state in place
        return out, {"conv": conv_state.clone(), "ssm": h}

    def decode(self, x: Tensor, state: dict[str, Tensor]) -> Tensor:
        """One-token step on x (B, 1, D); updates ``state`` in place."""
        d_in, ds, dc, _ = self.dims
        w = self.w
        xz = x[:, 0] @ w["in_proj"]
        u0, z = torch.chunk(xz, 2, dim=-1)
        window = torch.cat([state["conv"].to(x.dtype), u0[:, None, :]], 1)  # (B, dc, d_in)
        u = F.silu(torch.einsum("bwd,wd->bd", window, w["conv_w"]) + w["conv_b"])
        delta, b_in, c_in = self._ssm_inputs(w, u)
        a = -torch.exp(self.a_log.float())
        h, y = ssm_step(state["ssm"], u.float(), delta, b_in, c_in, a)
        state["conv"].copy_(window[:, 1:])
        state["ssm"].copy_(h)
        return self._out(w, y, u, z)[:, None, :]

    def init_state(self, batch: int, dtype: torch.dtype, device) -> dict[str, Tensor]:
        d_in, ds, dc, _ = self.dims
        return {"conv": torch.zeros((batch, dc - 1, d_in), dtype=dtype, device=device),
                "ssm": torch.zeros((batch, d_in, ds), dtype=torch.float32, device=device)}
