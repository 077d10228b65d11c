"""kNN-LM retrieval at the LM head (the port of the JAX package's
``repro/serve/retrieval.py``, single device).

The datastore holds (key, next-token) pairs.  At each decode step the
hidden state queries it and the neighbour distribution is interpolated with
the model's:

    p(y) = lam * p_knn(y) + (1 - lam) * p_lm(y)
    p_knn(y)  proportional to  sum_{(k_i, v_i) in top-k, v_i = y} exp(-d_i / T)

Datastore variants:

* flat f32 keys: the fused distance + top-k kernel K6 (``ops.knn_topk``);
* flat int8 keys with per-row scales: the int8 distance kernel K7
  (``ops.pairwise_sq_l2_int8``) and then a stable selection of the k
  nearest (ties to the lower row, ``lax.top_k``'s order);
* forest (``ForestDatastore``): the paper's overlap forest over the keys,
  searched by Alg. 2 (routing and bounds on K2, the bounded scan on K1),
  with streaming delta buffers that ``ingest_keys`` appends to at serve
  time.

The sharded scan comes with the distributed slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.knn import knn_search_impl
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import topk_smallest
from repro_torch.stream.ingest import alloc_delta, delta_view, ingest_impl

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


@dataclass
class ForestDatastore:
    """The paper's overlap forest as a kNN-LM datastore: a query runs Alg. 2's
    pruned bucket scan (``core.knn``) instead of a flat scan.

    ``delta`` (a ``stream.ingest.DeltaBuffer``, present when the datastore
    streams) holds (key, token) pairs appended at serve time; the search
    scans it as the second K1 phase.  ``n_main`` is the build-time row
    count; streamed rows take global ids from there upward, indexing the
    preallocated tail of ``values``.  ``next_id`` is the id high-water mark,
    kept on the datastore so every ingest path shares one id space and no
    id is handed out twice or past the values tail.
    """

    forest: Any  # core.knn.DeviceForest
    values: Tensor  # (N_objects + stream capacity,) i32, by global object id
    delta: Any = None  # stream.ingest.DeltaBuffer | None
    n_main: int = 0
    next_id: int = 0


def datastore_from_index(
    ix, values, *, stream_capacity: int = 0, quantized: bool | None = None
) -> ForestDatastore:
    """Wrap a built ``repro_torch.api.OverlapIndex`` as a serving datastore,
    on the index's device (the implementation of ``OverlapIndex.to_datastore``).

    ``values[i]`` pairs with object id ``i`` (one per ``ix.n_total`` object,
    streamed members included).  The index's live delta buffers ride along,
    so pairs already streamed stay retrievable.  ``stream_capacity > 0``
    preallocates a values tail for that many future serve-side inserts
    (``ingest_keys`` hands out no id past its end) and, when the index has
    no delta yet, per-index buffers of ``2 * stream_capacity / n_indexes``
    slots (floor 32): 2x headroom for routing skew without multiplying the
    memory by the index count.
    """
    values = np.asarray(values)
    if len(values) != ix.n_total:
        raise ValueError(
            f"need one value per indexed object: got {len(values)} values "
            f"for {ix.n_total} objects"
        )
    dev = ix.backend.device
    device = (
        ix.device if quantized is None
        else ix.backend.upload_forest(ix.forest, quantize=quantized)
    )
    delta = ix.device_delta
    vals = torch.as_tensor(values.astype(np.int32), device=dev)
    if stream_capacity > 0:
        if delta is None:
            capd = min(stream_capacity, -(-2 * stream_capacity // ix.forest.n_indexes))
            delta = ix.backend.place_delta(alloc_delta(ix.forest, max(32, capd), device=dev))
        vals = torch.cat([vals, torch.zeros((stream_capacity,), dtype=torch.int32, device=dev)])
    return ForestDatastore(forest=device, values=vals, delta=delta, n_main=ix.n_total,
                           next_id=ix.n_total)


def eps_heuristic(keys: np.ndarray, *, sample: int = 2048, chunk: int = 16) -> float:
    """The k-dist style eps of ``build_forest_datastore``: twice the median
    nearest-neighbour distance within a seeded sample of the keys.  The
    (S, S) squared distances go a block of ``chunk`` rows at a time; each
    element is the same sum over the last axis as in one (S, S, D) array,
    so the value is bit-equal to the JAX package's without that array."""
    g = np.random.default_rng(0)
    pts = keys[g.choice(len(keys), min(sample, len(keys)), replace=False)]
    nn = np.empty(len(pts), pts.dtype)
    for lo in range(0, len(pts), chunk):
        d2 = ((pts[lo:lo + chunk, None, :] - pts[None, :, :]) ** 2).sum(-1)
        rows = np.arange(lo, lo + len(d2))
        d2[rows - lo, rows] = np.inf
        nn[lo:lo + len(d2)] = d2.min(axis=1)
    return 2.0 * float(np.sqrt(np.median(nn)))


def build_forest_datastore(
    keys,
    values,
    *,
    method: str = "vbm",
    eps: float | None = None,
    min_pts: int = 16,
    quantized: bool = False,
    stream_capacity: int = 0,
    device=None,
) -> ForestDatastore:
    """Build the paper's index over the datastore keys on ``device``
    (``cuda`` unless named) and wrap it for serving:
    ``OverlapIndex.build(keys, ...).to_datastore(values, ...)``, with eps
    from ``eps_heuristic`` unless given."""
    from repro_torch.api import Config, IndexConfig, OverlapIndex, SearchConfig

    dev = resolve_device(device)
    keys = keys.cpu().numpy() if torch.is_tensor(keys) else np.asarray(keys, np.float32)
    values = values.cpu().numpy() if torch.is_tensor(values) else np.asarray(values)
    if eps is None:
        eps = eps_heuristic(keys)
    ix = OverlapIndex.build(keys, Config(
        index=IndexConfig(method=method, eps=eps, min_pts=min_pts, dbscan_block=2048),
        search=SearchConfig(quantize=quantized),
    ), device=dev)
    return ix.to_datastore(values, stream_capacity=stream_capacity)


def ingest_keys(ds: ForestDatastore, keys, values) -> tuple[ForestDatastore, int]:
    """Stream (key, token) pairs into a forest datastore's delta buffers.

    Routes and appends through ``stream.ingest`` (K2 routing on the card)
    and writes the tokens at the assigned global ids.  Two phases, so the id
    space never leaks: a probe ingest (its result thrown away) learns which
    pairs the buffers accept, then ids from ``ds.next_id`` go to exactly
    those pairs (clamped to the room left in the values tail) and are
    committed.  A rejected or refused pair burns no id and may be submitted
    again.  Returns the new datastore (``ds`` itself is unchanged) and the
    number of accepted pairs; the serving tier reports rejects to the client
    rather than block the decode loop on a rebuild.
    """
    if ds.delta is None:
        raise ValueError("datastore built without stream_capacity")
    next_id = int(ds.next_id)
    room = ds.values.shape[0] - next_id
    if room <= 0:
        return ds, 0
    dev = ds.values.device
    kt = torch.as_tensor(keys, dtype=torch.float32, device=dev)
    centers = ds.forest.index_centers
    # probe: the same state and the same routing give the same acceptance
    _, acc = ingest_impl(centers, ds.delta, kt,
                         torch.full((kt.shape[0],), -1, dtype=torch.int32, device=dev))
    # dropping rejected rows cannot demote an accepted one: within each
    # destination run the kept rows' slot ranks only shrink
    take = np.flatnonzero(acc.cpu().numpy())[:room]
    if take.size == 0:
        return ds, 0
    ids = torch.arange(next_id, next_id + take.size, dtype=torch.int32, device=dev)
    tk = torch.from_numpy(take).to(dev)
    new_delta, _ = ingest_impl(centers, ds.delta, kt[tk], ids)
    new_values = ds.values.clone()
    new_values[ids.long()] = torch.as_tensor(values, device=dev)[tk].to(torch.int32)
    return (
        dataclasses.replace(ds, values=new_values, delta=new_delta,
                            next_id=next_id + int(take.size)),
        int(take.size),
    )


def forest_knn(hidden: Tensor, ds: ForestDatastore, k: int, *,
               kernel: bool = True) -> tuple[Tensor, Tensor]:
    """(squared distances (B, k), token values (B, k)) by the paper's Alg. 2
    search over the forest, then its delta buffers.  ``kernel`` selects the
    ``kernels.ops`` dispatch (K1/K2 on the card) or the plain versions."""
    delta = None if ds.delta is None else delta_view(ds.delta)
    d, ids, _ = knn_search_impl(ds.forest, hidden.float(), k=k, mode="forest",
                                kernel=kernel, delta=delta)
    vals = ds.values[ids.long().clamp(0, ds.values.shape[0] - 1)]
    vals = torch.where(ids >= 0, vals, 0)
    d = torch.where(ids >= 0, d, float("inf"))
    return d * d, vals  # squared distances, as the flat path returns


def _local_topk(q: Tensor, ds: Datastore, k: int) -> tuple[Tensor, Tensor]:
    """(d2 (B, k) ascending, row ids (B, k)) of the k nearest rows."""
    if ds.scale is not None:
        d2 = ops.pairwise_sq_l2_int8(q, ds.keys, ds.scale)
        return topk_smallest(d2, k)
    return ops.knn_topk(q, ds.keys, k=k)


def knn_logits(hidden: Tensor, ds: Datastore | ForestDatastore, cfg: ModelConfig) -> Tensor:
    """p_knn over the padded vocab from the datastore neighbours of
    ``hidden`` (B, D): softmax of -sqrt(d2) / T over the k neighbours,
    accumulated per token (two neighbours with one token add up)."""
    r = cfg.retrieval
    if isinstance(ds, ForestDatastore):
        d2, vals = forest_knn(hidden, ds, r.k, kernel=r.kernel)
        w = torch.softmax(-torch.sqrt(torch.clamp_min(d2, 0.0)) / r.temperature, dim=-1)
        p_knn = torch.zeros((hidden.shape[0], cfg.padded_vocab), dtype=torch.float32,
                            device=hidden.device)
        return p_knn.scatter_add_(1, vals.long(), w)
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


def knn_interpolate(logits: Tensor, hidden: Tensor, ds: Datastore | ForestDatastore,
                    cfg: ModelConfig) -> Tensor:
    """log of lam * p_knn + (1 - lam) * softmax(logits)."""
    lam = cfg.retrieval.lam
    p_lm = torch.softmax(logits, dim=-1)
    p_knn = knn_logits(hidden, ds, cfg)
    return torch.log(torch.clamp_min((1.0 - lam) * p_lm + lam * p_knn, 1e-20))
