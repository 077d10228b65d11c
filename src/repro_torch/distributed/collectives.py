"""Collective helpers over islands: the port of the JAX package's
``repro/distributed/collectives.py``.

There, each helper runs inside a ``shard_map`` island and names a mesh
axis; here the islands along that axis are a list, one tensor per island
on its own device, and each helper returns one tensor per island, on that
island's device, holding what the JAX helper gives that shard:

* ``compressed_psum`` — cast-to-bf16 before the wire, restore after
  (gradient compression for cross-pod reductions);
* ``ring_allgather_pipelined`` — all-gather in ``chunks`` slices (the JAX
  package's overlap opportunity for its scheduler; here the slices run in
  turn), re-interleaved to the plain tiled gather;
* ``topk_allgather_merge`` — the k-per-shard merge pattern used by
  distributed kNN (Alg. 2 step 3): O(k * shards) wire bytes instead of
  gathering the candidate pools.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def compressed_psum(xs: list[Tensor], *, wire_dtype=torch.bfloat16) -> list[Tensor]:
    """psum with reduced wire precision (halves DP/pod all-reduce bytes):
    every island's value rounded to ``wire_dtype``, summed in f32 and
    rounded once to ``wire_dtype`` (the islands may sum in another order
    than XLA's), returned in each island's input dtype."""
    wire = [x.to(wire_dtype) for x in xs]
    dev0 = xs[0].device
    total = sum(w.to(dev0, torch.float32) for w in wire).to(wire_dtype)
    return [total.to(x.device, x.dtype) for x in xs]


def ring_allgather_pipelined(xs: list[Tensor], *, chunks: int = 4) -> list[Tensor]:
    """All-gather along axis 0 (tiled: island s's rows at [s*n, (s+1)*n)),
    split into ``chunks`` slices of every island's rows; without
    ``x.shape[0] % chunks == 0`` one plain gather."""
    n_rows = xs[0].shape[0]
    dev0 = xs[0].device
    if n_rows % chunks:
        out = torch.cat([x.to(dev0) for x in xs], dim=0)
    else:
        chunk = n_rows // chunks
        # gathered[c] holds slice c of every island, island-major
        gathered = [torch.stack([x[c * chunk:(c + 1) * chunk].to(dev0) for x in xs])
                    for c in range(chunks)]
        out = torch.cat(gathered, dim=1).reshape(len(xs) * n_rows, *xs[0].shape[1:])
    return [out.to(x.device) for x in xs]


def topk_allgather_merge(vals: list[Tensor], payload: list[Tensor], *,
                         k: int) -> tuple[list[Tensor], list[Tensor]]:
    """Merge per-island top-k (ascending ``vals`` (B, k) + aligned payload)
    into the global top-k: the k smallest of the gathered (B, S*k) values,
    ties to the lower island and position (``lax.top_k``'s order)."""
    dev0 = vals[0].device
    v_all = torch.cat([v.to(dev0) for v in vals], dim=1)
    p_all = torch.cat([p.to(dev0) for p in payload], dim=1)
    v_top, pos = torch.sort(v_all, dim=1, stable=True)
    v_top, pos = v_top[:, :k], pos[:, :k]
    p_top = torch.gather(p_all, 1, pos)
    return ([v_top.to(v.device) for v in vals], [p_top.to(p.device) for p in payload])
