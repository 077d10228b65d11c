"""Analytic per-device HBM-traffic model for the roofline memory term, and
the routing tier's wire-byte rule: the port of the JAX package's
``repro/distributed/estimator.py``.

The dry-run's measured byte count (``step_cost.analyze_step``: operand and
result bytes of every op the per-device program runs) counts tensor traffic
at every op boundary, with no fusion, so it is a pessimistic upper bound.
The roofline memory term instead uses this explicit traffic model (every
term is a real, nameable transfer), and the record keeps the measured
number beside it as the bound.

Model (per device, per step):
  train:   3x local param reads (fwd + remat-fwd + bwd) + grad write/read
           + 2x optimizer-state read/write + scan-boundary activation
           save/restore + K_ACT passes over the per-layer activation
           working set + logits/loss traffic
  prefill: 1x params + K_ACT/3 activation passes + cache write
  decode:  1x params (every weight read per token!) + cache read + write
           + datastore scan (the paper's retrieval feature)
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.step_cost import COLLECTIVE_FACTORS
from repro_torch.tree import tree_leaves

K_ACT_TRAIN = 12.0  # activation passes per layer (fwd+remat+bwd, incl. norms)
K_ACT_FWD = 4.0

# per-device traffic of a ring all-gather ~ factor * result bytes
ALLGATHER_FACTOR = COLLECTIVE_FACTORS["all-gather"]


def estimate_allgather_bytes(payload_bytes: float, participants: torch.Tensor) -> torch.Tensor:
    """Cross-host wire bytes of a ring all-gather of ``payload_bytes`` per
    participant over ``participants`` hosts (a tensor: the router prices on
    the device): ``ALLGATHER_FACTOR * payload * (H - 1)``, floored at 0, as
    f32 on the tensor's device."""
    h = participants.to(torch.float32)
    return ALLGATHER_FACTOR * payload_bytes * torch.clamp_min(h - 1.0, 0.0)


def _shard_count(spec, mesh) -> int:
    n = 1
    for axes in spec:
        if axes is None:
            continue
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            n *= mesh.shape[a]
    return n


def _local_bytes(tree_shape: Any, specs: Any, mesh) -> int:
    """Exact per-device bytes of a sharded tree (leaf size / shard count):
    ``specs`` is ``sharding.param_shardings`` / ``cache_shardings`` of it."""
    total = 0
    for leaf, spec in zip(tree_leaves(tree_shape), tree_leaves(specs, upto=tree_shape)):
        size = math.prod(leaf.shape) * leaf.dtype.itemsize
        total += size // max(_shard_count(spec, mesh), 1)
    return total


def estimate_memory_bytes(
    cfg: ModelConfig,
    shape: ShapeConfig,
    mesh,
    *,
    params_local: int,
    opt_local: int = 0,
    cache_local: int = 0,
    datastore_local: int = 0,
) -> dict[str, float]:
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    batch_shards = math.prod(mesh.shape[a] for a in axes) if axes else 1
    model_shards = mesh.shape.get("model", 1)
    act_dt = 2  # bf16 activations
    b_loc = max(shape.global_batch // batch_shards, 1)
    seq_div = model_shards if cfg.seq_shard_activations else 1

    if shape.kind == "train":
        t_loc = b_loc * shape.seq_len
        n_units = cfg.num_layers
        boundary = n_units * (t_loc // seq_div) * cfg.d_model * act_dt * 2
        layer_ws = cfg.num_layers * (t_loc // max(cfg.grad_accum, 1)) \
            * cfg.d_model * act_dt * K_ACT_TRAIN
        logits = 3 * (t_loc // max(cfg.grad_accum, 1)) * (cfg.padded_vocab // model_shards) * 4
        params_traffic = 3 * params_local + 2 * params_local  # + grads w/r
        opt_traffic = 2 * opt_local
        total = params_traffic + opt_traffic + boundary + layer_ws + logits
        parts = {
            "params": params_traffic, "optimizer": opt_traffic,
            "scan_boundaries": boundary, "layer_working_set": layer_ws,
            "logits": logits,
        }
    elif shape.kind == "prefill":
        t_loc = b_loc * shape.seq_len
        layer_ws = cfg.num_layers * t_loc * cfg.d_model * act_dt * K_ACT_FWD
        cache_w = cache_local
        total = params_local + layer_ws + cache_w
        parts = {"params": params_local, "layer_working_set": layer_ws,
                 "cache_write": cache_w}
    else:  # decode
        total = params_local + cache_local + datastore_local \
            + cfg.num_layers * b_loc * cfg.d_model * act_dt * K_ACT_FWD
        parts = {
            "params": params_local, "cache": cache_local,
            "datastore": datastore_local,
            "activations": cfg.num_layers * b_loc * cfg.d_model * act_dt * K_ACT_FWD,
        }
    parts["total"] = float(total)
    return parts
