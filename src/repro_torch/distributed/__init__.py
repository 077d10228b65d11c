"""Sharded and routed layouts of the kNN forest: the island mesh
(``context``), the shard islands (``knn_island``), the routing tier
(``router``) and the router's wire-byte rule (``estimator``).

One process drives every island, as ``shard_map`` does in the JAX package:
each island holds its slice of the bucket and delta rows on its own device
and runs the single-device executor body there, and the islands' top-k
carries merge on island 0's device.
"""
from repro_torch.distributed import context
from repro_torch.distributed.context import Mesh, current_mesh, model_axis_size, use_mesh

__all__ = ["context", "Mesh", "current_mesh", "model_axis_size", "use_mesh"]
