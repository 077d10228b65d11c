"""Mixture-of-Experts FFN of the port: the JAX package's
``repro/models/moe.py`` on one device (its ``mesh is None or tp == 1``
path).

Routing is a token top-k over an f32 softmax router, renormalised, with the
load-balance and router-z losses.  The experts run on fixed ``(E, C, D)``
capacity buffers: the (token, choice) assignments are stably sorted by
expert, each expert keeps its first ``C = capacity(T, k, E, factor)`` in
token-major order, and every assignment past C is dropped, one for one as
the JAX package drops it.  The expert products are batched over all E
experts (``torch.bmm``, as the JAX package's einsum); a kept assignment's
output is gathered back to its token and the k of a token are summed.

The JAX package's ``shard_map`` island, all-to-all and weight-stationary
paths exist only under a mesh with a model axis; the port has none yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import CastWeights, SwiGLU, dense_init_, dtype_of, param

Tensor = torch.Tensor


def capacity(tokens: int, top_k: int, num_experts: int, factor: float) -> int:
    """Slots per expert: ``tokens * top_k / E * factor`` + 1, rounded up to
    a multiple of 8, at least 8 (the JAX package's ``_capacity``)."""
    cap = int(tokens * top_k / num_experts * factor) + 1
    return max(8, -(-cap // 8) * 8)


def counts(idx: Tensor, n: int) -> Tensor:
    """How often each of 0..n-1 occurs in ``idx`` (int64), by a scatter-add:
    ``torch.bincount`` reads its input's maximum back to the host on the
    card, a sync per MoE layer."""
    return torch.zeros(n, dtype=torch.int64, device=idx.device).scatter_add_(
        0, idx.reshape(-1), torch.ones_like(idx.reshape(-1)))


def route(x2d: Tensor, router: Tensor, top_k: int):
    """Token top-k routing in f32. Returns (top_e (T, k) int64, top_p (T, k)
    f32 renormalised, {"router_aux", "router_z"})."""
    logits = x2d.float() @ router.float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, top_k, dim=-1)
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    e = router.shape[1]
    f_e = counts(top_e, e).float()
    f_e = f_e / torch.clamp_min(f_e.sum(), 1.0)
    aux = e * torch.sum(f_e * probs.mean(dim=0))
    z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return top_e, top_p, {"router_aux": aux, "router_z": z}


def dispatch(top_e: Tensor, num_experts: int, cap: int) -> tuple[Tensor, Tensor, Tensor]:
    """The capacity buffers' assignment: (slot_tok (E, C) token of each
    slot, valid (E, C) slot holds a kept assignment, row (T*k,) the slot
    e*C + c each assignment landed in, or -1 where it was dropped).

    Assignments are stably sorted by expert (ties in token-major order), so
    expert e's slots hold its first C assignments in that order."""
    t, k = top_e.shape
    flat_e = top_e.reshape(-1)
    sort_idx = torch.argsort(flat_e, stable=True)
    n_e = counts(flat_e, num_experts)
    seg_start = torch.cumsum(n_e, 0) - n_e  # (E,)
    slot_pos = seg_start[:, None] + torch.arange(cap, device=top_e.device)[None, :]
    valid = slot_pos < (seg_start + n_e)[:, None]
    slot_tok = sort_idx[slot_pos.clamp(max=t * k - 1)] // k
    rank = torch.empty_like(sort_idx)
    rank[sort_idx] = torch.arange(t * k, device=top_e.device)
    c = rank - seg_start[flat_e]  # position within the expert's run
    row = torch.where(c < cap, flat_e * cap + c, -1)
    return slot_tok, valid, row


class MoE(CastWeights):
    """Routed experts (E, D, F) and (E, F, D) in ``cfg.param_dtype``, an f32
    router (D, E) and, for deepseek-v2, ``num_shared`` always-on experts as
    one SwiGLU of width ``num_shared * d_ff_expert`` (``shared``)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        m = cfg.moe
        d, e, f = cfg.d_model, m.num_experts, m.d_ff_expert
        pdt = dtype_of(cfg.param_dtype)
        self.m = m
        self.router = param((d, e), torch.float32, device)
        self.w_in = param((e, d, f), pdt, device)
        self.w_gate = param((e, d, f), pdt, device)
        self.w_out = param((e, f, d), pdt, device)
        self.shared = SwiGLU(d, m.num_shared * f, pdt, device) if m.num_shared else None
        self.c: dict[str, Tensor] = {}

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        dense_init_(self.router, g, self.router.shape[0] ** -0.5)
        for w in (self.w_in, self.w_gate, self.w_out):
            dense_init_(w, g)
        if self.shared is not None:
            self.shared.init_(g)

    def weights(self, dtype: torch.dtype) -> dict[str, Tensor]:
        return {n: getattr(self, n).to(dtype) for n in ("w_in", "w_gate", "w_out")}

    def cast(self, dtype: torch.dtype) -> None:
        super().cast(dtype)
        if self.shared is not None:
            self.shared.cast(dtype)

    def forward(self, x: Tensor) -> tuple[Tensor, dict[str, Tensor]]:
        """MoE FFN over x (B, S, D). Returns (out, router losses)."""
        m = self.m
        b, s, d = x.shape
        x2d = x.reshape(b * s, d)
        top_e, top_p, aux = route(x2d, self.router, m.top_k)
        cap = capacity(b * s, m.top_k, m.num_experts, m.capacity_factor)
        slot_tok, valid, row = dispatch(top_e, m.num_experts, cap)
        w = self.w
        xb = x2d[slot_tok] * valid[..., None].to(x.dtype)  # (E, C, D)
        h = F.silu(torch.bmm(xb, w["w_gate"])) * torch.bmm(xb, w["w_in"])
        y = torch.bmm(h, w["w_out"]).reshape(-1, d)  # (E*C, D)
        kept = row >= 0
        gate = torch.where(kept, top_p.reshape(-1), 0.0).to(x.dtype)
        contrib = y[row.clamp(min=0)] * gate[:, None]  # (T*k, D)
        out = contrib.reshape(b * s, m.top_k, d).sum(1)
        if self.shared is not None:
            out = out + self.shared(x2d)
        return out.reshape(b, s, d), aux

