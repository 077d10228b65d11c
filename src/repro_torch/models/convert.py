"""Carry LM weights between the JAX package's param tree and the port.

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

The other way, ``jax_tree(model)`` is the JAX param tree's structure with a
``Leaf`` at each leaf: the JAX leaf as views of the port's parameters (the
unfused ``wq``/``wk``/``wv`` of ``wqkv``, ``w_gate``/``w_in`` of
``w_gate_in``), one view a layer, stacked on a new axis 0 where the stage
is scanned.  The optimizer and the checkpoint work on that tree, so
Adafactor factors and clips each JAX leaf as the JAX package does, and a
checkpoint names the JAX package's leaves.  ``params_to_jax(model)`` is its
numpy tree, the inverse of ``params_from_jax``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model, num_params
from repro_torch.models.transformer import Stage, encoder_stage
from repro_torch.tree import tree_map

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


@torch.no_grad()
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


# ---------------------------------------------------------------------------
# the port's parameters as the JAX package's leaves
# ---------------------------------------------------------------------------


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t


class Leaf:
    """One leaf of the JAX param tree as views of the port's parameters:
    ``parts`` holds a (parameter, view) pair per layer, ``view(t)`` the JAX
    leaf's slice of a tensor shaped like that parameter (the parameter
    itself, or its gradient); a scanned stage's leaf stacks its layers'
    views on a new axis 0."""

    def __init__(self, parts: list[tuple[nn.Parameter, Callable]], stacked: bool):
        self.parts = parts
        self.stacked = stacked

    @property
    def shape(self) -> tuple[int, ...]:
        p, view = self.parts[0]
        one = tuple(view(p).shape)
        return (len(self.parts),) + one if self.stacked else one

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0][0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0][0].device

    def value(self, of: dict | None = None) -> torch.Tensor:
        """The JAX leaf of the parameters, or of ``of`` (parameter -> a tensor
        shaped like it, such as its gradient).  An unstacked leaf is a view."""
        ts = [view(p.detach() if of is None else of[p]) for p, view in self.parts]
        return torch.stack(ts) if self.stacked else ts[0]

    @torch.no_grad()
    def assign_(self, value: torch.Tensor) -> None:
        """Write the JAX leaf ``value`` into the parameters, in place."""
        value = torch.as_tensor(value).to(self.device, self.dtype)
        if tuple(value.shape) != self.shape:
            raise ValueError(f"leaf of shape {self.shape} given {tuple(value.shape)}")
        for (p, view), v in zip(self.parts, value if self.stacked else [value]):
            view(p).copy_(v)


def _module_tree(mod: nn.Module) -> dict:
    """A sub-layer module's JAX subtree: its own parameters (fused ones
    split by ``JAX_VIEWS``) and its children's subtrees."""
    views = getattr(mod, "JAX_VIEWS", {})
    tree: dict = {}
    for name, p in mod.named_parameters(recurse=False):
        for jname in views.get(name, (name,)):
            view = (lambda t, m=mod, n=jname: m.jax_view(n, t)) if name in views else _whole
            tree[jname] = Leaf([(p, view)], False)
    for name, child in mod.named_children():
        tree[name] = _module_tree(child)
    return tree


def _stack(units: list):
    """Leaf trees of one shape, one a repeat, merged into one tree of
    stacked leaves."""
    first = units[0]
    if isinstance(first, dict):
        return {k: _stack([u[k] for u in units]) for k in first}
    return Leaf([part for u in units for part in u.parts], True)


def _stage_tree(stage: Stage, layers: list):
    width = len(stage.unit)
    units = [{f"u{j}": _module_tree(layers[r * width + j]) for j in range(width)}
             for r in range(stage.n)]
    return _stack(units) if stage.scan else units


def jax_tree(model: Model) -> dict:
    """The JAX package's param tree of ``model``'s configuration with a
    ``Leaf`` at every leaf (the module docstring)."""
    tree = {k: Leaf([(getattr(model, k), _whole)], False)
            for k in _TOP if getattr(model, k, None) is not None}
    layers, stages = list(model.layers), []
    for st in model.stages:
        stages.append(_stage_tree(st, layers[:st.n * len(st.unit)]))
        layers = layers[st.n * len(st.unit):]
    tree["stages"] = stages
    if model.cfg.family == "encdec":
        tree["enc"] = _stage_tree(encoder_stage(model.cfg), list(model.enc))
    return tree


def _cache_unit(lane: dict) -> dict:
    """One sub-layer's flat cache dict in the JAX package's nesting (RWKV's
    ``tm_shift`` is ``{"tm": {"shift"}}``)."""
    out: dict = {}
    for name, t in lane.items():
        head, _, rest = name.partition("_")
        if head in ("tm", "cm") and rest:
            out.setdefault(head, {})[rest] = t
        else:
            out[name] = t
    return out


def jax_cache_tree(model: Model, cache: list) -> list:
    """The JAX package's decode-cache tree of ``model``'s cache (one flat
    dict a sub-layer): a list over stages, a scanned stage's unit
    ``{"u<j>": ...}`` with its repeats stacked on a new axis 0 (leaves
    ``CacheLeaf``), an unscanned stage a list of units."""
    out, lanes = [], list(cache)
    for st in model.stages:
        width = len(st.unit)
        units = [{f"u{j}": _cache_unit(lanes[r * width + j]) for j in range(width)}
                 for r in range(st.n)]
        lanes = lanes[st.n * width:]
        out.append(_stack_cache(units) if st.scan else units)
    return out


class CacheLeaf:
    """A scanned stage's cache leaf: its layers' tensors (``parts``) seen
    as one stacked array (``shape``, ``dtype``) without stacking them."""

    def __init__(self, parts: list):
        self.parts = parts

    @property
    def shape(self) -> tuple[int, ...]:
        return (len(self.parts),) + tuple(self.parts[0].shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype


def _stack_cache(units: list):
    first = units[0]
    if isinstance(first, dict):
        return {k: _stack_cache([u[k] for u in units]) for k in first}
    return CacheLeaf(units)


def params_to_jax(model: Model) -> dict:
    """``model``'s weights as the JAX package's param tree of numpy arrays
    (bf16 widened to f32, exactly): ``params_from_jax``'s input."""
    return tree_map(lambda leaf: leaf.value().float().cpu().numpy(), jax_tree(model))
