"""Device-layout executor backend — the seam between the facade and devices.

``SingleDeviceBackend`` keeps the whole forest and its delta buffers on one
torch device and owns the forest upload (``upload_forest``, quantized per
config), the delta placement (``place_delta`` / ``logical_delta``), the
executor bodies (``search_body`` and ``explain_body``, which ``api/plan.py``
caches per option tuple, and ``ingest_body``), the per-island telemetry view
(``islands``) and the rebuild swap's ``barrier``.  The sharded and routed
layouts of the JAX package come with a later slice.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.forest import ForestArrays
from repro_torch.core.knn import (
    DeviceForest,
    device_forest,
    knn_search_explain_impl,
    knn_search_impl,
)
from repro_torch.stream.ingest import DeltaBuffer, ingest_impl


class IslandStats(NamedTuple):
    """Per-executor-island node-access counters (leading dim = islands), as
    host numpy: the bucket visits and distances broken down by the island
    that did the work.  The single layout has one island, whose row is the
    search's own per-query counters."""

    buckets_visited: np.ndarray  # (S, Q) i32
    distances: np.ndarray  # (S, Q) i32
    bound_distances: np.ndarray  # (S, Q) i32


class SingleDeviceBackend:
    """The default layout: whole forest on one device.  Bodies are the core
    executors verbatim."""

    kind = "single"
    shards = 1

    def __init__(self, device: torch.device) -> None:
        self.device = torch.device(device)

    def upload_forest(self, forest: ForestArrays, *, quantize: bool) -> DeviceForest:
        return device_forest(forest, device=self.device, quantize=quantize)

    def place_delta(self, delta: DeltaBuffer) -> DeltaBuffer:
        return delta

    def logical_delta(self, delta: DeltaBuffer, n_indexes: int) -> DeltaBuffer:
        return delta

    def search_body(self, key):
        def body(forest, q, delta):
            return knn_search_impl(
                forest, q, k=key.k, mode=key.mode, beam=key.beam,
                kernel=key.kernel, delta=delta,
            )

        return body

    def explain_body(self, key):
        def body(forest, q, delta):
            return knn_search_explain_impl(
                forest, q, k=key.k, mode=key.mode, beam=key.beam,
                kernel=key.kernel, delta=delta,
            )

        return body

    def islands(self, stats: dict[str, Any]) -> IslandStats:
        """The per-island view of a search's host stats: one island, so a
        leading singleton dim on the counters already on the host (no
        device read)."""
        return IslandStats(
            buckets_visited=stats["buckets_visited"][None],
            distances=stats["distances"][None],
            bound_distances=stats["bound_distances"][None],
        )

    def ingest_body(self):
        return ingest_impl

    def search_operands(self, device_forest: DeviceForest) -> DeviceForest:
        """First operand the plan executor is called with (the bare forest on
        this layout)."""
        return device_forest

    def barrier(self, *trees) -> None:
        # one device: the facade's swap assignment is already atomic
        return None
