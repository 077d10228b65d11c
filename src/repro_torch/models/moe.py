"""Mixture-of-Experts FFN of the port: the JAX package's
``repro/models/moe.py``, on one device and on a mesh's islands.

Routing is a token top-k over an f32 softmax router, renormalised, with the
load-balance and router-z losses, over all tokens on the caller's device.
The experts run on fixed ``(E, C, D)`` capacity buffers: the (token,
choice) assignments are stably sorted by expert, each expert keeps its
first ``C = capacity(T, k, E, factor)`` in token-major order, and every
assignment past C is dropped, one for one as the JAX package drops it.  The
expert products are batched over the experts (``torch.bmm``, as the JAX
package's einsum); a kept assignment's output is gathered back to its token
and the k of a token are summed.

With no mesh, or a model axis of size 1, all E experts run on one device.
Under a mesh with a model axis of tp > 1 (``distributed.context.use_mesh``)
the experts run on its islands, E / tp a model index, as the JAX package's
``shard_map`` island does (``expert_parallel``): the weight-stationary
decode path, the token-sharded psum path and the all-to-all path, chosen by
the JAX package's rules.  Each path is one island's program, written once
(``_ws_island``, ``_ts_island``, ``_a2a_island``) and run by
``distributed.context.shard_map``: on an island mesh every island in turn
(islands on one device one after another on its stream), on the dry-run's
``DTensor``s as one device's program with torch's functional collectives.
Autograd runs through every path.

    with use_mesh(Mesh(["cpu"] * 4, shape=(2, 2), axis_names=("data", "model"))):
        out, aux = moe(x)

One deliberate difference: the JAX package's all-to-all path sums the
shared experts' outputs of different cells' tokens over the model axis; the
port runs each cell's shared experts on its own tokens, which is what the
single-device layer computes.
"""
from __future__ import annotations

import math
from functools import partial

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import context as dctx
from repro_torch.distributed.sharding import LOGICAL_AXES
from repro_torch.models.layers import CastWeights, SwiGLU, dense_init_, dtype_of, param

Tensor = torch.Tensor
MODEL = dctx.MODEL_AXIS


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


def dispatch_keys(key: Tensor, n: int, cap: int, k: int) -> tuple[Tensor, Tensor, Tensor]:
    """Capacity buffers of ``n`` experts over the (T*k,) assignment keys
    ``key`` (an expert in [0, n), or ``n`` for an assignment no buffer
    takes): (slot_tok (n, C) token of each slot, valid (n, C) slot holds a
    kept assignment, row (T*k,) the slot e*C + c each assignment landed in,
    or -1 where it was dropped or has key n).

    Assignments are stably sorted by key (ties in token-major order), so
    expert e's slots hold its first C assignments in that order."""
    tk = key.shape[0]
    sort_idx = torch.argsort(key, stable=True)
    n_e = counts(key, n + 1)
    seg_start = (torch.cumsum(n_e, 0) - n_e)[:n]  # (n,)
    n_e = n_e[:n]
    slot_pos = seg_start[:, None] + torch.arange(cap, device=key.device)[None, :]
    valid = slot_pos < (seg_start + n_e)[:, None]
    slot_tok = sort_idx[slot_pos.clamp(max=tk - 1)] // k
    rank = torch.empty_like(sort_idx)
    rank[sort_idx] = torch.arange(tk, device=key.device)
    keyc = key.clamp(max=n - 1)
    c = rank - seg_start[keyc]  # position within the expert's run
    row = torch.where((key < n) & (c < cap), keyc * cap + c, -1)
    return slot_tok, valid, row


def dispatch(top_e: Tensor, num_experts: int, cap: int) -> tuple[Tensor, Tensor, Tensor]:
    """``dispatch_keys`` over the experts of ``top_e`` (T, k)."""
    return dispatch_keys(top_e.reshape(-1), num_experts, cap, top_e.shape[1])


def local_dispatch(top_e: Tensor, e_start: int, e_loc: int, cap: int):
    """``dispatch`` over the experts [e_start, e_start + e_loc) only (the
    JAX package's ``_dispatch_compute``: other experts' assignments sort to
    a tail bucket no buffer takes)."""
    local_id = top_e.reshape(-1) - e_start
    key = torch.where((local_id >= 0) & (local_id < e_loc), local_id, e_loc)
    return dispatch_keys(key, e_loc, cap, top_e.shape[1])


def experts_ffn(xb: Tensor, w_gate: Tensor, w_in: Tensor, w_out: Tensor) -> Tensor:
    """The batched expert SwiGLU over capacity buffers (E, C, D)."""
    return torch.bmm(F.silu(torch.bmm(xb, w_gate)) * torch.bmm(xb, w_in), w_out)


def combine(y: Tensor, row: Tensor, top_p: Tensor) -> Tensor:
    """Each token's sum over its k choices of the kept slots' outputs ``y``
    (n*C, D) weighted by their gates; a dropped or foreign choice adds 0."""
    t, k = top_p.shape
    gate = torch.where(row >= 0, top_p.reshape(-1), 0.0).to(y.dtype)
    return (y[row.clamp(min=0)] * gate[:, None]).reshape(t, k, -1).sum(1)


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
        self.a2a = cfg.moe_a2a
        self.router = param((d, e), torch.float32, device)
        self.w_in = param((e, d, f), pdt, device)
        self.w_gate = param((e, d, f), pdt, device)
        self.w_out = param((e, f, d), pdt, device)
        self.shared = SwiGLU(d, m.num_shared * f, pdt, device) if m.num_shared else None
        self.c: dict[str, Tensor] = {}
        self._counts: tuple = (0, 0)  # the last forward's (assignments, kept)

    @torch.no_grad()
    def init_(self, g: torch.Generator) -> None:
        dense_init_(self.router, g, self.router.shape[0] ** -0.5)
        for w in (self.w_in, self.w_gate, self.w_out):
            dense_init_(w, g)
        if self.shared is not None:
            self.shared.init_(g)

    @property
    def dropped(self):
        """The assignments the last forward dropped (a tensor)."""
        n, kept = self._counts
        return n - kept

    def weights(self, dtype: torch.dtype) -> dict[str, Tensor]:
        return {n: getattr(self, n).to(dtype) for n in ("w_in", "w_gate", "w_out")}

    def cast(self, dtype: torch.dtype) -> None:
        super().cast(dtype)
        if self.shared is not None:
            self.shared.cast(dtype)

    def forward(self, x: Tensor) -> tuple[Tensor, dict[str, Tensor]]:
        """MoE FFN over x (B, S, D). Returns (out, router losses).  Under a
        mesh with a model axis of tp > 1 the experts run on its islands
        (``expert_parallel``)."""
        m = self.m
        b, s, d = x.shape
        x2d = x.reshape(b * s, d)
        top_e, top_p, aux = route(x2d, self.router, m.top_k)
        mesh = dctx.current_mesh()
        tp = dctx.model_axis_size(mesh)
        if m.num_experts % tp:
            raise ValueError(f"{m.num_experts} experts not divisible by tp={tp}")
        w = self.w
        if mesh is not None and tp > 1:
            sh = None
            if self.shared is not None:
                gi, f_s = self.shared.w["w_gate_in"], self.shared.f
                sh = {"w_gate": gi[:, :f_s], "w_in": gi[:, f_s:], "w_out": self.shared.w["w_out"]}
            out, kept = expert_parallel(mesh, m, self.a2a, x2d, top_e, top_p, w, sh)
            self._counts = (b * s * m.top_k, kept)
            return out.reshape(b, s, d), aux
        cap = capacity(b * s, m.top_k, m.num_experts, m.capacity_factor)
        slot_tok, valid, row = dispatch(top_e, m.num_experts, cap)
        xb = x2d[slot_tok] * valid[..., None].to(x.dtype)  # (E, C, D)
        y = experts_ffn(xb, w["w_gate"], w["w_in"], w["w_out"]).reshape(-1, d)
        out = combine(y, row, top_p)
        self._counts = (row.numel(), (row >= 0).sum())
        if self.shared is not None:
            out = out + self.shared(x2d)
        return out.reshape(b, s, d), aux


# ---------------------------------------------------------------------------
# expert-parallel islands
# ---------------------------------------------------------------------------


def _shared_ffn(x: Tensor, sh: dict[str, Tensor]) -> Tensor:
    return (F.silu(x @ sh["w_gate"]) * (x @ sh["w_in"])) @ sh["w_out"]


def _ws_island(cap, e_loc, fsdp, ix, x, te, tpr, wg, wi, wo, sg=None, si=None, so=None):
    """Weight-stationary decode: all T tokens, this island's experts on its
    D-slice; the partial (E_loc, C, F) products are summed over fsdp before
    the nonlinearity and the output's D-slices gathered."""
    d_loc = wg.shape[1]
    lo = ix(fsdp) * d_loc
    xs = x[:, lo:lo + d_loc]
    slot_tok, valid, row = local_dispatch(te, ix((MODEL,)) * e_loc, e_loc, cap)
    xb = xs[slot_tok] * valid[..., None].to(xs.dtype)
    h_gate = yield ("psum", fsdp, torch.bmm(xb, wg))
    h_in = yield ("psum", fsdp, torch.bmm(xb, wi))
    o = combine(torch.bmm(F.silu(h_gate) * h_in, wo).reshape(-1, d_loc), row, tpr)
    if sg is not None:
        hs_gate = yield ("psum", fsdp, xs @ sg)
        hs_in = yield ("psum", fsdp, xs @ si)
        o = o + (F.silu(hs_gate) * hs_in) @ so
    o = yield ("all_gather", fsdp, o, 1)
    return o, (row >= 0).sum()


def _ts_island(cap, e_loc, ix, x, te, tpr, wg, wi, wo, sg=None, si=None, so=None):
    """Token-sharded: this island's tokens (all T when they do not split)
    through its experts, whole; the caller sums the model islands."""
    slot_tok, valid, row = local_dispatch(te, ix((MODEL,)) * e_loc, e_loc, cap)
    xb = x[slot_tok] * valid[..., None].to(x.dtype)
    o = combine(experts_ffn(xb, wg, wi, wo).reshape(-1, x.shape[1]), row, tpr)
    if sg is not None:
        o = o + _shared_ffn(x, {"w_gate": sg, "w_in": si, "w_out": so})
    return o, (row >= 0).sum()


def _a2a_island(cap, tp, ix, x, te, tpr, wg, wi, wo, sg=None, si=None, so=None):
    """All-to-all: this cell's tokens slotted into (E, C) send buffers by
    global expert, exchanged over the model axis, through this island's
    experts and back; the shared experts on the cell's own tokens."""
    e_loc, d = wg.shape[0], x.shape[1]
    slot_tok, valid, row = dispatch(te, e_loc * tp, cap)
    xb = (x[slot_tok] * valid[..., None].to(x.dtype)).reshape(tp, e_loc, cap, d)
    xr = yield ("all_to_all", (MODEL,), xb)  # (tp sources, E_loc, C, D)
    y = experts_ffn(xr.transpose(0, 1).reshape(e_loc, tp * cap, d), wg, wi, wo)
    yr = yield ("all_to_all", (MODEL,), y.reshape(e_loc, tp, cap, d).transpose(0, 1))
    o = combine(yr.reshape(-1, d), row, tpr)
    if sg is not None:
        o = o + _shared_ffn(x, {"w_gate": sg, "w_in": si, "w_out": so})
    return o, (row >= 0).sum()


def expert_parallel(mesh, m, a2a: bool, x2d: Tensor, top_e: Tensor, top_p: Tensor,
                    w: dict[str, Tensor], sh: dict[str, Tensor] | None):
    """The JAX package's expert-parallel ``shard_map`` island on the mesh
    (``distributed.context.shard_map``): (T, D) out, the count of
    assignments kept in a buffer.

    Island (.., model=j) holds experts [j*E_loc, (j+1)*E_loc) and the shared
    experts' F-slice j; the path is chosen by the JAX package's rules
    (``_path``):

    * weight-stationary, whenever an fsdp axis is in the mesh (even of
      size 1) and T*k <= 4,096: the island holds its D-slice (fsdp index i)
      of both and contracts it (``_ws_island``);
    * all-to-all, with ``moe_a2a``, batch axes and T % (batch shards * tp)
      == 0: a (batch, model) cell per island (``_a2a_island``);
    * token-sharded otherwise: the tokens split over the batch axes (when
      T divides) and the model islands' partial outputs, routed and shared,
      summed (``_ts_island``).

    The last two hand each island its experts with their D-slices gathered
    over fsdp, and the a2a path the shared experts whole.  Capacity,
    dispatch order and drops are the JAX package's; autograd runs through
    every path."""
    t, k = top_e.shape
    e = m.num_experts
    tp = mesh.shape[MODEL]
    e_loc = e // tp
    path, batch, fsdp, token_sharded = _path(mesh, m, a2a, t)
    if MODEL in fsdp:
        raise ValueError("the MoE islands need the fsdp rule off the model axis")
    shw = () if sh is None else (sh["w_gate"], sh["w_in"], sh["w_out"])
    args = (x2d, top_e, top_p, w["w_gate"], w["w_in"], w["w_out"], *shw)
    rows = (None, None)
    if path == "ws":
        body = partial(_ws_island, capacity(t, k, e, m.capacity_factor), e_loc, fsdp)
        specs = [rows] * 3 + [(MODEL, fsdp, None)] * 2 + [(MODEL, None, fsdp)] \
            + [(fsdp, MODEL)] * 2 + [(MODEL, fsdp)]
        outs = [(rows, (MODEL,)), ((), (MODEL,))]
    elif path == "a2a":
        cells = batch + (MODEL,)
        n_cells = math.prod(mesh.shape[a] for a in cells)
        body = partial(_a2a_island, capacity(t // n_cells, k, e, m.capacity_factor), tp)
        specs = [(cells, None)] * 3 + [(MODEL, None, None)] * 3 + [None] * 3
        outs = [((cells, None), ()), ((), cells)]
    else:
        n_batch = math.prod(mesh.shape[a] for a in batch)
        t_loc = t // n_batch if token_sharded else t
        body = partial(_ts_island, capacity(t_loc, k, e, m.capacity_factor), e_loc)
        x_spec = (batch if token_sharded else None, None)
        specs = [x_spec] * 3 + [(MODEL, None, None)] * 3 + [(None, MODEL)] * 2 + [(MODEL, None)]
        work = (batch if token_sharded else ()) + (MODEL,)
        outs = [(x_spec, (MODEL,)), ((), work)]
    return dctx.shard_map(body, mesh, specs[:len(args)], outs)(*args)


def _path(mesh, m, a2a: bool, t: int):
    """The JAX package's path selection: ("ws" | "a2a" | "ts", batch axes,
    fsdp axes, token-sharded)."""
    batch = dctx.batch_axes(mesh)
    fsdp = tuple(a for a in LOGICAL_AXES.get("fsdp", ()) if a in mesh.axis_names)
    n_batch = math.prod(mesh.shape[a] for a in batch)
    tp = mesh.shape[MODEL]
    if fsdp and t * m.top_k <= 4096:
        return "ws", batch, fsdp, False
    if a2a and batch and t % (n_batch * tp) == 0:
        return "a2a", batch, fsdp, True
    return "ts", batch, fsdp, bool(batch) and t % n_batch == 0
