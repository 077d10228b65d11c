"""The distribution substrate of the port: the island mesh (``context``),
the sharded and routed layouts of the kNN forest (``knn_island``, the
routing tier ``router``), the launch tooling's elastic plans
(``elastic``), logical-axis sharding rules (``sharding``), island
collectives (``collectives``), the memory estimator (``estimator``) and
the dry-run's per-device step cost and roofline (``step_cost``,
``roofline``).

One process drives every island, as ``shard_map`` does in the JAX package:
each island holds its slice of the rows (or of the experts) on its own
device, and the islands' results combine on island 0's device.
"""
from repro_torch.distributed import context
from repro_torch.distributed.context import Mesh, current_mesh, model_axis_size, use_mesh

__all__ = ["context", "Mesh", "current_mesh", "model_axis_size", "use_mesh"]
