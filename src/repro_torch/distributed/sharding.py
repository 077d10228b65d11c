"""Logical-axis sharding rules (MaxText-style) for params and activations:
the port of the JAX package's ``repro/distributed/sharding.py``.

A single rule table maps *logical* axis names onto mesh axes; every rule is
guarded by a divisibility check so small architectures (9 heads, 14 heads,
kv=1, ...) degrade gracefully to replication on that dimension.  Parameter
specs are resolved from the parameter tree by path-pattern matching and
left-padded with None for scan-stacked leading axes, so the same table
serves all ten architectures.

A spec is a tuple with one entry per dimension, as a JAX ``PartitionSpec``
holds them: ``None`` (replicated), a mesh-axis name, or a tuple of names.
The trees are the JAX package's: ``param_shardings`` walks a
``models.convert.jax_tree``-shaped tree (the port's fused ``wqkv`` and
``w_gate_in`` appear as the JAX leaves ``wq``/``wk``/``wv`` and
``w_gate``/``w_in``), the optimizer state over it, or the decode cache of
``cache_tree``; a leaf is anything with a ``shape``.

``logical_constraint`` is the identity on plain tensors (there is no GSPMD
to constrain), as the JAX one is without a mesh; on a ``DTensor`` under an
active mesh (the dry-run's sharded run) it redistributes to the spec.

Physical axes:
  'pod'   — inter-pod data parallelism (multi-pod mesh only)
  'data'  — intra-pod data parallel / FSDP
  'model' — tensor / expert / vocab parallelism
"""
from __future__ import annotations

import math
import re
from typing import Any

from repro_torch.distributed import context as dctx
from repro_torch.tree import tree_flatten_with_path, tree_unflatten

Spec = tuple  # one entry per dim: None | axis name | tuple of axis names

# logical axis -> tuple of physical mesh axes
LOGICAL_AXES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),
    "seq": (),           # optionally ('model',) via seq_shard_activations
    "seq_kv": ("model",),  # decode KV caches: shard context length
    "embed": (),
    "vocab": ("model",),
    "heads": ("model",),
    "mlp": ("model",),
    "expert": ("model",),
    "tensor": ("model",),
    "none": (),
}

# parameter path pattern -> logical spec (rightmost dims; left-padded w/ None)
_PARAM_RULES: list[tuple[str, tuple[str, ...]]] = [
    (r"embed$", ("vocab", "fsdp")),
    (r"pos_embed$", ("none", "fsdp")),
    (r"lm_head$", ("fsdp", "vocab")),
    (r"patch_proj$", ("none", "fsdp")),
    (r"frame_proj$", ("none", "fsdp")),
    # attention (gqa + whisper)
    (r"(attn|cross)/wq$", ("fsdp", "heads", "none")),
    (r"(attn|cross)/w[kv]$", ("fsdp", "none", "none")),
    (r"(attn|cross)/wo$", ("heads", "none", "fsdp")),
    (r"(attn|cross)/b[qkv]$", ("none", "none")),
    # MLA
    (r"attn/wdq$", ("fsdp", "none")),
    (r"attn/wuq$", ("none", "heads", "none")),
    (r"attn/wdkv$", ("fsdp", "none")),
    (r"attn/wk_rope$", ("fsdp", "none")),
    (r"attn/wu[kv]$", ("none", "heads", "none")),
    # dense MLPs (swiglu + gelu)
    (r"mlp/w_(in|gate)$", ("fsdp", "mlp")),
    (r"mlp/w_out$", ("mlp", "fsdp")),
    (r"mlp/b_in$", ("mlp",)),
    (r"mlp/b_out$", ("none",)),
    # MoE
    (r"moe/router$", ("fsdp", "none")),
    (r"moe/w_(in|gate)$", ("expert", "fsdp", "none")),
    (r"moe/w_out$", ("expert", "none", "fsdp")),
    (r"moe/shared/w_(in|gate)$", ("fsdp", "mlp")),
    (r"moe/shared/w_out$", ("mlp", "fsdp")),
    # Mamba
    (r"mamba/in_proj$", ("fsdp", "mlp")),
    (r"mamba/conv_w$", ("none", "mlp")),
    (r"mamba/conv_b$", ("mlp",)),
    (r"mamba/x_proj$", ("mlp", "none")),
    (r"mamba/dt_proj$", ("none", "mlp")),
    (r"mamba/dt_bias$", ("mlp",)),
    (r"mamba/a_log$", ("mlp", "none")),
    (r"mamba/d_skip$", ("mlp",)),
    (r"mamba/out_proj$", ("mlp", "fsdp")),
    # RWKV time-mix: per-head state ops -> no TP on the head structure
    (r"tm/w[rkvgo]$", ("fsdp", "none")),
    (r"tm/lora_a$", ("fsdp", "none")),
    (r"tm/wd_a$", ("fsdp", "none")),
    # RWKV channel-mix: plain MLP -> TP fine
    (r"cm/wk$", ("fsdp", "mlp")),
    (r"cm/wv$", ("mlp", "fsdp")),
    (r"cm/wr$", ("fsdp", "none")),
]


def _axes_for(logical: str, mesh) -> tuple[str, ...]:
    return tuple(a for a in LOGICAL_AXES[logical] if a in mesh.axis_names)


def _fit(axes: tuple[str, ...], dim: int, mesh) -> tuple[str, ...] | None:
    """Divisibility guard: only shard if the dim divides evenly."""
    if not axes:
        return None
    total = math.prod(mesh.shape[a] for a in axes)
    if total <= 1 or dim % total != 0:
        return None
    return axes


def _entry(axes: tuple[str, ...]):
    return axes if len(axes) > 1 else axes[0]


def _raw_spec(path: str, ndim: int) -> list[str]:
    """Logical names per dim (left-padded for scan-stacked leading axes)."""
    # adafactor factored stats: inherit the parent rule minus the reduced dim
    if path.endswith("/vr"):
        return _raw_spec(path[:-3], ndim + 1)[:-1]
    if path.endswith("/vc"):
        parent = _raw_spec(path[:-3], ndim + 1)
        return parent[:-2] + parent[-1:]
    for pat, logical in _PARAM_RULES:
        if re.search(pat, path):
            spec = list(logical)
            break
    else:
        spec = []
    spec = spec[-ndim:] if len(spec) > ndim else spec
    return ["none"] * (ndim - len(spec)) + spec


def spec_for_param(path: str, shape: tuple[int, ...], mesh) -> Spec:
    out = []
    used: set[str] = set()
    for dim, name in zip(shape, _raw_spec(path, len(shape))):
        # a mesh axis may shard at most one dim; later dims drop the
        # already-used axes (rule overlays like zero3+vocab need this)
        cand = tuple(a for a in _axes_for(name, mesh) if a not in used)
        axes = _fit(cand, dim, mesh)
        if axes is None:
            out.append(None)
        else:
            used.update(axes)
            out.append(_entry(axes))
    return tuple(out)


# decode-cache path pattern -> logical spec (rightmost dims)
_CACHE_RULES: list[tuple[str, tuple[str, ...]]] = [
    (r"/(k|v)$", ("batch", "seq_kv", "none", "none")),
    (r"/(ck|cv)$", ("batch", "none", "none", "none")),  # whisper cross (S=1500)
    (r"/c_kv$", ("batch", "seq_kv", "none")),
    (r"/k_rope$", ("batch", "seq_kv", "none")),
    (r"/conv$", ("batch", "none", "mlp")),
    (r"/ssm$", ("batch", "mlp", "none")),
    (r"/wkv$", ("batch", "none", "none", "none")),
    (r"/shift$", ("batch", "none", "none")),
]


def spec_for_cache(path: str, shape: tuple[int, ...], mesh) -> Spec:
    for pat, logical in _CACHE_RULES:
        if re.search(pat, path):
            spec = list(logical)
            break
    else:
        spec = []
    spec = spec[-len(shape):] if len(spec) > len(shape) else spec
    spec = ["none"] * (len(shape) - len(spec)) + spec
    out = []
    for dim, name in zip(shape, spec):
        axes = _fit(_axes_for(name, mesh), dim, mesh)
        out.append(None if axes is None else _entry(axes))
    return tuple(out)


def _path_str(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _map_with_path(fn, tree: Any) -> Any:
    pairs = tree_flatten_with_path(tree)
    return tree_unflatten(tree, [fn(_path_str(p), leaf) for p, leaf in pairs])


def param_shardings(params_shape: Any, mesh) -> Any:
    """A spec tree for a parameter tree (or an optimizer state over one)."""
    return _map_with_path(lambda p, x: spec_for_param(p, tuple(x.shape), mesh), params_shape)


def cache_shardings(cache_shape: Any, mesh) -> Any:
    return _map_with_path(lambda p, x: spec_for_cache(p, tuple(x.shape), mesh), cache_shape)


def logical_spec(shape: tuple[int, ...], logical: tuple[str | None, ...], mesh) -> Spec:
    """The spec ``logical_constraint`` pins: each named dim on its axes
    where they divide it, a mesh axis on at most one dim
    (first-come-first-served)."""
    out = []
    used: set[str] = set()
    for dim, name in zip(shape, logical):
        if name is None:
            out.append(None)
            continue
        axes = _fit(_axes_for(name, mesh), dim, mesh)
        if axes is not None and any(a in used for a in axes):
            axes = None
        if axes is None:
            out.append(None)
        else:
            used.update(axes)
            out.append(_entry(axes))
    return tuple(out)


def placements(spec: Spec, dim_names: tuple[str, ...]) -> list:
    """A spec as ``DTensor`` placements, one per dim of a torch
    ``DeviceMesh`` named ``dim_names``: ``Shard(d)`` where tensor dim d names
    the mesh axis, ``Replicate()`` elsewhere.  A mesh dim may stand for
    adjacent mesh axes merged row-major ("pod+data"); a spec names all of
    them or none."""
    from torch.distributed.tensor import Replicate, Shard

    owner = {a: i for i, n in enumerate(dim_names) for a in n.split("+")}
    out = [Replicate() for _ in dim_names]
    for d, entry in enumerate(spec):
        for a in (() if entry is None else entry if isinstance(entry, tuple) else (entry,)):
            out[owner[a]] = Shard(d)
    return out


def logical_constraint(x, logical: tuple[str | None, ...]):
    """Pin ``x`` to its logical layout: the identity on a plain tensor or
    without a mesh; a ``DTensor`` is redistributed to the spec."""
    mesh = dctx.current_mesh()
    if mesh is None or not hasattr(x, "device_mesh"):
        return x
    spec = logical_spec(tuple(x.shape), logical, mesh)
    pl = placements(spec, x.device_mesh.mesh_dim_names)
    return x if list(x.placements) == pl else x.redistribute(x.device_mesh, pl)


def batch_spec(mesh, shape: tuple[int, ...]) -> Spec:
    """Inputs: shard dim 0 over the batch axes (when divisible)."""
    if not shape:
        return ()
    axes = _fit(dctx.batch_axes(mesh), shape[0], mesh)
    return (None if axes is None else _entry(axes),) + (None,) * (len(shape) - 1)


def set_rule(logical: str, axes: tuple[str, ...]) -> None:
    """Override a logical-axis rule (e.g. sequence-sharded activations)."""
    LOGICAL_AXES[logical] = axes
