"""Streaming ingestion and overlap-driven online maintenance.

``ingest.py`` appends batches into per-index delta buffers on the device;
the search scans them as a second K1 phase.  ``maintenance.py``
re-evaluates the paper's overlap heuristic on the updated geometry and
rebuilds the indexes it flags.  The facade runs the lifecycle
(``OverlapIndex.ingest`` / ``check`` / ``maintain``).
"""
from repro_torch.stream.ingest import (
    DeltaBuffer,
    alloc_delta,
    append_routed,
    delta_view,
    ingest_impl,
    main_index_sums,
    pull_delta_meta,
    route_batch_host,
    updated_geometry,
)
from repro_torch.stream.maintenance import (
    DriftReport,
    MaintenanceConfig,
    OverlapMonitor,
    object_assignment,
    rebuild_indexes,
)

__all__ = [
    "DeltaBuffer", "alloc_delta", "append_routed", "delta_view", "ingest_impl",
    "main_index_sums", "pull_delta_meta", "route_batch_host", "updated_geometry",
    "DriftReport", "MaintenanceConfig", "OverlapMonitor", "object_assignment",
    "rebuild_indexes",
]
