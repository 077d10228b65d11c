"""Optimizers of the port (the JAX package's ``repro/optim/optimizer.py``):
pure init/update pairs over trees of tensors, in the JAX package's
arithmetic and with its defaults.

* adamw     - f32 moments; small and medium models.
* adafactor - factored second moment (row and column statistics over the
              last two axes), no first moment; the choice of the 200B+
              configurations.

The train step hands them the JAX package's param tree
(``models.convert.jax_tree``: each leaf in the JAX layout, a scanned
stage's layers stacked on axis 0), so Adafactor factors and clips each JAX
leaf as one, and the state is the JAX package's tree: ``{"mu", "nu",
"step"}`` and ``{"v": {... {"vr", "vc"} | {"v"}}, "step"}``, its leaves f32
and ``step`` an int32 scalar.  ``init`` reads only each leaf's ``shape`` and
``device``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Tensor = torch.Tensor
PyTree = Any


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree, Tensor], tuple[PyTree, PyTree]]
    # update(grads, state, params, lr) -> (new_params, new_state)


def _zeros(shape, p) -> Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=p.device)


def _step0(params: PyTree) -> Tensor:
    first = tree_leaves(params)[0]
    return torch.zeros((), dtype=torch.int32, device=first.device)


def clip_by_global_norm(grads: PyTree, max_norm: float) -> tuple[PyTree, Tensor]:
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {
            "mu": tree_map(lambda p: _zeros(p.shape, p), params),
            "nu": tree_map(lambda p: _zeros(p.shape, p), params),
            "step": _step0(params),
        }

    def update(grads, state, params, lr):
        step = state["step"] + 1
        t = step.float()
        c1 = 1.0 - b1**t
        c2 = 1.0 - b2**t

        def upd(g, m, v, p):
            gf = g.float()
            m = b1 * m + (1 - b1) * gf
            v = b2 * v + (1 - b2) * gf * gf
            mh = m / c1
            vh = v / c2
            delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype), m, v

        out = [upd(*xs) for xs in zip(tree_leaves(grads), tree_leaves(state["mu"]),
                                      tree_leaves(state["nu"]), tree_leaves(params))]
        new_p, new_m, new_v = (tree_unflatten(params, col) for col in zip(*out))
        return new_p, {"mu": new_m, "nu": new_v, "step": step}

    return Optimizer(init, update)


def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8, weight_decay: float = 0.0) -> Optimizer:
    """Factored Adafactor (Shazeer & Stern 2018), no momentum."""

    def _factored(shape) -> bool:
        return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1

    def init(params):
        def leaf(p):
            shape = tuple(p.shape)
            if _factored(shape):
                return {"vr": _zeros(shape[:-1], p), "vc": _zeros(shape[:-2] + shape[-1:], p)}
            return {"v": _zeros(shape, p)}

        return {"v": tree_map(leaf, params), "step": _step0(params)}

    def update(grads, state, params, lr):
        step = state["step"] + 1
        t = step.float()
        beta = 1.0 - t**-decay

        def upd(g, v, p):
            gf = g.float()
            g2 = gf * gf + eps
            if _factored(p.shape):
                vr = beta * v["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * v["vc"] + (1 - beta) * g2.mean(dim=-2)
                rfac = (vr / torch.clamp_min(vr.mean(dim=-1, keepdim=True), eps))[..., None]
                u = gf * torch.rsqrt(torch.clamp_min(rfac * vc[..., None, :], eps))
                nv = {"vr": vr, "vc": vc}
            else:
                vv = beta * v["v"] + (1 - beta) * g2
                u = gf * torch.rsqrt(torch.clamp_min(vv, eps))
                nv = {"v": vv}
            # update clipping (RMS <= clip_threshold)
            rms = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            pf = p.float()
            if weight_decay:
                u = u + weight_decay * pf
            return (pf - lr * u).to(p.dtype), nv

        out = [upd(*xs) for xs in zip(tree_leaves(grads), tree_leaves(state["v"], upto=params),
                                      tree_leaves(params))]
        new_p, new_v = (tree_unflatten(params, col) for col in zip(*out))
        return new_p, {"v": new_v, "step": step}

    return Optimizer(init, update)


def get_optimizer(name: str) -> Optimizer:
    if name == "adamw":
        return adamw()
    if name == "adafactor":
        return adafactor()
    raise ValueError(f"unknown optimizer {name!r}")
