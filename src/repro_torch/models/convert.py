"""Carry the JAX package's LM weights across to the port.

``params_from_jax(tree, cfg)`` takes the param pytree of
``repro.models.model.Model.init`` as numpy arrays (a test makes it with
``jax.tree.map(np.asarray, model.init(key))``; this module imports no JAX)
and returns the port's ``Model`` holding the same numbers.  The JAX stages
hold each layer weight with a leading layer axis when the stage is scanned
(``stack_init``) and as a list of per-layer trees when it is not; both are
unstacked here into the per-layer modules.  The layouts themselves match
(wq (D, H, hd), wo (H, hd, D), ...), so every array is copied as it is.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model

_ATTN = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
_MLP = ("w_in", "w_gate", "w_out")


def _layer_trees(stage_tree, n: int) -> list[dict]:
    """Per-layer ``{"u0": ...}`` trees of one stage, scanned or not."""
    if isinstance(stage_tree, (list, tuple)):
        return list(stage_tree)

    def take(t, i):
        if isinstance(t, dict):
            return {k: take(v, i) for k, v in t.items()}
        return np.asarray(t)[i]

    return [take(stage_tree, i) for i in range(n)]


def _copy(dst: torch.Tensor, src, name: str) -> None:
    a = np.array(src, np.float32)  # a writable copy
    if tuple(a.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: JAX shape {a.shape} does not fit {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(a))


@torch.no_grad()
def params_from_jax(tree: dict, cfg: ModelConfig, *, device=None) -> Model:
    """The port's ``Model`` of ``cfg`` on ``device`` (``cuda`` unless named)
    holding the weights of the JAX param tree ``tree`` (numpy leaves)."""
    model = Model(cfg, device=device, seed=None)
    _copy(model.embed, tree["embed"], "embed")
    _copy(model.final_norm, tree["final_norm"], "final_norm")
    if model.lm_head is not None:
        _copy(model.lm_head, tree["lm_head"], "lm_head")
    layers = []
    for stage, st_tree in zip(model.stages, tree["stages"]):
        layers += [t["u0"] for t in _layer_trees(st_tree, stage.n)]
    if len(layers) != len(model.layers):
        raise ValueError(f"JAX tree has {len(layers)} layers, config {len(model.layers)}")
    for i, (dst, src) in enumerate(zip(model.layers, layers)):
        _copy(dst.ln1, src["ln1"], f"layer {i} ln1")
        _copy(dst.ln2, src["ln2"], f"layer {i} ln2")
        for name in _ATTN:
            if name in src["attn"]:
                _copy(getattr(dst.attn, name), src["attn"][name], f"layer {i} attn.{name}")
        for name in _MLP:
            _copy(getattr(dst, name), src["mlp"][name], f"layer {i} mlp.{name}")
    model.cast_weights()
    return model
