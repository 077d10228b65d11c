"""Carry the JAX package's LM weights across to the port.

``params_from_jax(tree, cfg)`` takes the param pytree of
``repro.models.model.Model.init`` as numpy arrays (a test makes it with
``jax.tree.map(np.asarray, model.init(key))``; this module imports no JAX)
and returns the port's ``Model`` holding the same numbers.  The JAX stages
hold each sub-layer weight with a leading repeat axis when the stage is
scanned (``stack_init``) and as a list of per-unit trees when it is not;
each unit is a dict ``{"u0": ..., "u<j>": ...}`` of its sub-layers (Jamba's
unit has eight).  Both are unstacked here, unit by unit, into the port's
per-sub-layer modules, whose attribute paths are the JAX tree's key paths
(``attn.wq``, ``moe.shared.w_in``, ``tm.lora_b``, ...).  The layouts match,
so every array is copied as it is, into the parameter's own dtype (a bf16
array widened to f32 on the way is exact).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model, num_params
from repro_torch.models.transformer import Stage, encoder_stage

_TOP = ("embed", "final_norm", "lm_head", "final_norm_bias", "frame_proj", "enc_norm",
        "enc_norm_bias", "patch_proj")


def _sublayer_trees(stage: Stage, stage_tree) -> list[dict]:
    """The per-sub-layer trees of one stage, in the port's layer order."""
    if isinstance(stage_tree, (list, tuple)):
        units = list(stage_tree)
    else:
        def take(t, i):
            if isinstance(t, dict):
                return {k: take(v, i) for k, v in t.items()}
            return np.asarray(t)[i]

        units = [take(stage_tree, i) for i in range(stage.n)]
    return [u[f"u{j}"] for u in units for j in range(len(stage.unit))]


def _copy(dst: torch.Tensor, src, name: str) -> int:
    a = np.array(src, np.float32)  # a writable copy
    if tuple(a.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: JAX shape {a.shape} does not fit {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(a))
    return a.size


def _load(module, tree: dict, name: str) -> int:
    """Copy every leaf of ``tree`` into ``module`` at the same key path."""
    n = 0
    for key, val in tree.items():
        if isinstance(val, dict):
            n += _load(getattr(module, key), val, f"{name}.{key}")
        else:
            n += _copy(getattr(module, key), val, f"{name}.{key}")
    return n


@torch.no_grad()
def params_from_jax(tree: dict, cfg: ModelConfig, *, device=None) -> Model:
    """The port's ``Model`` of ``cfg`` on ``device`` (``cuda`` unless named)
    holding the weights of the JAX param tree ``tree`` (numpy leaves)."""
    model = Model(cfg, device=device, seed=None)
    n = sum(_copy(getattr(model, k), tree[k], k) for k in _TOP if k in tree)
    for layers, stages, trees in (
        (model.layers, model.stages, tree["stages"]),
        (getattr(model, "enc", []), [encoder_stage(cfg)], [tree.get("enc")]),
    ):
        subs = [s for st, t in zip(stages, trees) if t is not None
                for s in _sublayer_trees(st, t)]
        if len(subs) != len(layers):
            raise ValueError(f"JAX tree has {len(subs)} sub-layers, config {len(layers)}")
        n += sum(_load(dst, src, f"layer {i}") for i, (dst, src) in enumerate(zip(layers, subs)))
    if n != num_params(model):
        raise ValueError(f"JAX tree filled {n} of the port's {num_params(model)} parameters")
    model.cast_weights()
    return model
