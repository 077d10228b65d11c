"""kNN-LM retrieval at the LM head, flat datastores (the port of the flat
part of the JAX package's ``repro/serve/retrieval.py``).

The datastore holds (key, next-token) pairs.  At each decode step the
hidden state queries it and the neighbour distribution is interpolated with
the model's:

    p(y) = lam * p_knn(y) + (1 - lam) * p_lm(y)
    p_knn(y)  proportional to  sum_{(k_i, v_i) in top-k, v_i = y} exp(-d_i / T)

Two flat variants, both exact scans of the rows on one device:

* f32 keys: the fused distance + top-k kernel K6 (``ops.knn_topk``);
* int8 keys with per-row scales: the int8 distance kernel K7
  (``ops.pairwise_sq_l2_int8``) and then a stable selection of the k
  nearest (ties to the lower row, ``lax.top_k``'s order).

The forest datastore (``ForestDatastore``, ``forest_knn``, ``ingest_keys``)
comes with the streaming slice, the sharded scan with the distributed one.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_smallest

Tensor = torch.Tensor


@dataclass
class Datastore:
    keys: Tensor  # (N, Dk) f32, or int8 when quantized
    values: Tensor  # (N,) i32 token ids
    scale: Tensor | None = None  # (N,) f32 per-row int8 scales
    proj: Tensor | None = None  # (D, Dk) optional query down-projection


def build_flat_datastore(keys, values, *, quantized: bool = False, device=None) -> Datastore:
    """A flat datastore of ``keys`` (N, Dk) and token ``values`` (N,) on
    ``device`` (``cuda`` unless named), f32 or int8 through the port's
    ``quantize_datastore`` (bit-equal to the JAX package's).  Tensors
    already on the device are used without a host round trip."""
    dev = resolve_device(device)
    k = keys if torch.is_tensor(keys) else torch.from_numpy(np.asarray(keys))
    v = values if torch.is_tensor(values) else torch.from_numpy(np.asarray(values))
    k = k.to(device=dev, dtype=torch.float32)
    v = v.to(device=dev, dtype=torch.int32)
    if quantized:
        kq, scale = ops.quantize_datastore(k)
        return Datastore(keys=kq, values=v, scale=scale)
    return Datastore(keys=k, values=v)


def _local_topk(q: Tensor, ds: Datastore, k: int) -> tuple[Tensor, Tensor]:
    """(d2 (B, k) ascending, row ids (B, k)) of the k nearest rows."""
    if ds.scale is not None:
        d2 = ops.pairwise_sq_l2_int8(q, ds.keys, ds.scale)
        return topk_smallest(d2, k)
    return ops.knn_topk(q, ds.keys, k=k)


def knn_logits(hidden: Tensor, ds: Datastore, cfg: ModelConfig) -> Tensor:
    """p_knn over the padded vocab from the datastore neighbours of
    ``hidden`` (B, D): softmax of -sqrt(d2) / T over the k neighbours,
    accumulated per token (two neighbours with one token add up)."""
    r = cfg.retrieval
    q = hidden.float()
    if ds.proj is not None:
        q = q @ ds.proj.float()
    d2, idx = _local_topk(q, ds, r.k)
    # an id of -1 (fewer than k rows) reads the last value, as JAX's
    # wrapping gather does; its weight exp(-inf) is 0
    vals = ds.values[idx.long()]
    w = torch.softmax(-torch.sqrt(torch.clamp_min(d2, 0.0)) / r.temperature, dim=-1)
    p_knn = torch.zeros((hidden.shape[0], cfg.padded_vocab), dtype=torch.float32,
                        device=hidden.device)
    return p_knn.scatter_add_(1, vals.long(), w)


def knn_interpolate(logits: Tensor, hidden: Tensor, ds: Datastore, cfg: ModelConfig) -> Tensor:
    """log of lam * p_knn + (1 - lam) * softmax(logits)."""
    lam = cfg.retrieval.lam
    p_lm = torch.softmax(logits, dim=-1)
    p_knn = knn_logits(hidden, ds, cfg)
    return torch.log(torch.clamp_min((1.0 - lam) * p_lm + lam * p_knn, 1e-20))
