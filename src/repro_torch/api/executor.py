"""Device-layout executor backends — the seam between the facade and devices.

A backend resolved from ``cfg.layout`` (``make_backend``) owns

  * the forest upload  — ``upload_forest``, quantized per config (the
                         sharded backend splits the bucket rows over its
                         islands, ``distributed/knn_island.place_forest``);
  * the delta placement — ``place_delta`` / ``logical_delta`` /
                         ``delta_view``: the facade's monitor, persistence
                         and introspection see the logical unpadded buffers,
                         search and ingest the placed (padded, split) ones;
  * the executor bodies — ``search_body`` / ``explain_body``, which
                         ``api/plan.py`` caches per option tuple, and
                         ``ingest_body``.  A search body returns ``(dists,
                         ids, SearchStats)``, an explain body appends
                         ``core.knn.VisitRows``; the sharded bodies append
                         their telemetry after that (``IslandStats`` rows,
                         and ``RouterStats`` on the routed layout);
  * the telemetry       — ``pack_telemetry`` turns that tail into integer
                         tensors that ride in the search's one copy to the
                         host, ``unpack_telemetry`` reads them back as the
                         per-island rows (and the router's stats);
  * the swap barrier    — ``barrier``: the sharded layout waits until every
                         island's device has finished the new arrays before
                         a maintenance rebuild swaps them in.

Quantization order matters for exactness: the sharded upload quantizes the
unpadded members first (per-member int8 scales equal the single path's) and
only then pads, so int8 searches stay bitwise equal across layouts.
"""
from __future__ import annotations

import warnings
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.api.config import ConfigError, LayoutConfig
from repro_torch.core.forest import ForestArrays
from repro_torch.core.knn import (
    DeviceForest,
    device_forest,
    knn_search_explain_impl,
    knn_search_impl,
)
from repro_torch.device import resolve_device
from repro_torch.stream.ingest import DeltaBuffer, delta_view, ingest_impl


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
        self.devices = (self.device,)

    def upload_forest(self, forest: ForestArrays, *, quantize: bool) -> DeviceForest:
        return device_forest(forest, device=self.device, quantize=quantize)

    def place_delta(self, delta: DeltaBuffer) -> DeltaBuffer:
        return delta

    def logical_delta(self, delta: DeltaBuffer, n_indexes: int) -> DeltaBuffer:
        return delta

    def delta_view(self, delta: DeltaBuffer):
        """The search-facing view of the placed delta buffers."""
        return delta_view(delta)

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

    def pack_telemetry(self, tail) -> list[torch.Tensor]:
        """Integer tensors of a body's telemetry tail, for the search's one
        copy to the host (none on this layout)."""
        return []

    def unpack_telemetry(self, stats: dict[str, Any], arrays) -> tuple[IslandStats, Any]:
        """(IslandStats, router stats or None) from ``pack_telemetry``'s
        arrays, on the host."""
        return self.islands(stats), None

    def ingest_body(self):
        return ingest_impl

    def search_operands(self, device_forest: DeviceForest) -> DeviceForest:
        """First operand the plan executor is called with (the bare forest on
        this layout)."""
        return device_forest

    def barrier(self, *trees) -> None:
        # one device: the facade's swap assignment is already atomic
        return None


class ShardedBackend:
    """Bucket rows and delta buffers split over ``shards`` islands, one torch
    device each (a device may repeat); the executor bodies are the islands
    of ``distributed/knn_island.py``."""

    kind = "sharded"

    def __init__(self, shards: int, axis: str = "model", *, devices=None) -> None:
        from repro_torch.distributed import knn_island

        self.shards = int(shards)
        self.axis = axis
        self._island = knn_island
        self.mesh = knn_island.default_mesh(self.shards, axis, devices)
        self.devices = self.mesh.devices
        self.device = self.devices[0]

    # -- placement -----------------------------------------------------------
    def upload_forest(self, forest: ForestArrays, *, quantize: bool):
        return self._island.place_forest(self.mesh, forest, quantize=quantize)

    def place_delta(self, delta: DeltaBuffer):
        return self._island.place_delta(self.mesh, delta)

    def logical_delta(self, delta, n_indexes: int) -> DeltaBuffer:
        return self._island.logical_delta(delta, n_indexes)

    def delta_view(self, delta):
        return self._island.island_delta_view(delta)

    # -- executor bodies -----------------------------------------------------
    def search_body(self, key):
        def body(forest, q, delta):
            return self._island.sharded_search(
                self.mesh, forest, q, delta, k=key.k, mode=key.mode, beam=key.beam,
                kernel=key.kernel, per_island=True,
            )

        return body

    def explain_body(self, key):
        def body(forest, q, delta):
            return self._island.sharded_search(
                self.mesh, forest, q, delta, k=key.k, mode=key.mode, beam=key.beam,
                kernel=key.kernel, explain=True,
            )

        return body

    def ingest_body(self):
        def body(centers, delta, xb, ids, valid=None):
            return self._island.sharded_ingest(self.mesh, centers, delta, xb, ids, valid)

        return body

    def search_operands(self, device_forest):
        return device_forest

    # -- telemetry -----------------------------------------------------------
    def pack_telemetry(self, tail) -> list[torch.Tensor]:
        isl = tail[0]
        return [isl.buckets_visited, isl.distances, isl.bound_distances]

    def unpack_telemetry(self, stats: dict[str, Any], arrays) -> tuple[IslandStats, Any]:
        return IslandStats(*arrays[:3]), None

    def barrier(self, *trees) -> None:
        """Wait until every island's device has finished the given trees'
        work: called right before a maintenance rebuild's hot swap, so a
        query can never see a half-placed forest or delta."""
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


class RoutedBackend(ShardedBackend):
    """The sharded layout plus the routing tier (``distributed/router/``): a
    ``RoutingTable`` on island 0's device, rebuilt at every forest upload
    (build, load, and the maintenance rebuild swap all go through
    ``upload_forest``), and bodies that run ``routed_search``.  Search
    bodies append ``RouterStats`` to the island tuple."""

    kind = "routed"

    def __init__(self, shards: int, axis: str = "model", *, routing=None, devices=None):
        from repro_torch.api.config import RoutingConfig
        from repro_torch.distributed import router

        super().__init__(shards, axis, devices=devices)
        self.routing = routing if routing is not None else RoutingConfig()
        self._router = router
        self.table = None  # RoutingTable on island 0's device

    def upload_forest(self, forest: ForestArrays, *, quantize: bool):
        dev = super().upload_forest(forest, quantize=quantize)
        self.refresh_table(forest, quantize=quantize)
        return dev

    def refresh_table(self, forest: ForestArrays, *, quantize: bool = False) -> None:
        """(Re)build the routing table from the logical forest.  Runs on every
        swap that can move bucket ownership: a stale table must never
        mis-route.  An int8 layout (``quantize``) gets covers around the
        dequantized members, the distances its scans compute."""
        self.table = self._router.build_routing_table(
            forest, self.shards, method=self.routing.overlap_method,
            quantize=quantize, device=self.device,
        )

    def search_operands(self, device_forest):
        return (device_forest, self.table)

    def search_body(self, key):
        fanout = key.fanout or self.routing.fanout

        def body(operands, q, delta):
            forest, table = operands
            return self._router.routed_search(
                self.mesh, forest, q, delta, table, k=key.k, mode=key.mode,
                beam=key.beam, kernel=key.kernel, fanout=fanout, per_island=True,
            )

        return body

    def explain_body(self, key):
        fanout = key.fanout or self.routing.fanout

        def body(operands, q, delta):
            forest, table = operands
            return self._router.routed_search(
                self.mesh, forest, q, delta, table, k=key.k, mode=key.mode,
                beam=key.beam, kernel=key.kernel, fanout=fanout, explain=True,
            )

        return body

    def pack_telemetry(self, tail) -> list[torch.Tensor]:
        r = tail[1]
        costs = torch.stack([r.wire_targeted, r.wire_fanall, r.cost_targeted,
                             r.cost_fanall]).to(torch.float32)
        return super().pack_telemetry(tail) + [
            r.eligible_hosts, r.pruned_hosts, r.targeted.reshape(1),
            costs.view(torch.int32),  # bit for bit through the integer copy
        ]

    def unpack_telemetry(self, stats: dict[str, Any], arrays) -> tuple[IslandStats, Any]:
        eligible, pruned, targeted, costs = arrays[3:7]
        wire_t, wire_a, cost_t, cost_a = costs.view(np.float32)
        router = self._router.RouterStats(
            eligible_hosts=eligible, pruned_hosts=pruned, targeted=bool(targeted[0]),
            wire_targeted=wire_t, wire_fanall=wire_a, cost_targeted=cost_t,
            cost_fanall=cost_a,
        )
        return IslandStats(*arrays[:3]), router


def _device_list(devices) -> list[torch.device] | None:
    """``device=`` of an entry point as a list of islands' devices: None (the
    cards), one device (one island) or a list (one device per island)."""
    if devices is None:
        return None
    if isinstance(devices, (list, tuple)):
        if not devices:
            raise ConfigError("device=[] names no device; pass one device per island")
        return [resolve_device(d) for d in devices]
    return [resolve_device(devices)]


def make_backend(layout: LayoutConfig, *, clamp: bool = False, devices=None):
    """Resolve a ``cfg.layout`` into a backend on ``devices``.

    ``devices`` is what the entry point's ``device=`` named: None (``cuda``,
    and for the sharded layouts one island per visible card), one device,
    or a list of one device per island (a device may repeat:
    ``["cuda:0"] * 4`` is four islands on one card, ``["cpu"] * 4`` four on
    the host).  A single layout runs on the first of them.

    ``clamp=True`` (the ``load`` path) drops an unsatisfiable island count
    to the devices there are, with a warning, instead of failing: a
    snapshot saved on a four-card host still loads on one card.  Builds
    stay strict.  One effective island collapses to the single layout
    (routing over one host prunes nothing).
    """
    devs = _device_list(devices)
    if layout.kind == "single":
        return SingleDeviceBackend(resolve_device(None if devs is None else devs[0]))
    if devs is None:
        resolve_device(None)  # no CUDA and no device named: an error, never the CPU
        avail = torch.cuda.device_count()
    else:
        avail = len(devs)
    shards = layout.shards or avail
    if shards > avail:
        where = ("visible CUDA device(s)" if devs is None
                 else "device(s) given by device=")
        if not clamp:
            raise ConfigError(
                f"LayoutConfig.shards={shards} exceeds the {avail} {where}; pass "
                "device=[...] with one device per island (a device may repeat: "
                "device=['cuda:0'] * 4 on one card, ['cpu'] * 4 on the host) or "
                "lower shards"
            )
        warnings.warn(
            f"snapshot asked for {shards} shards but there are only {avail} "
            f"{where}; re-sharding to {avail}",
            stacklevel=2,
        )
        shards = avail
    if shards == 1:
        return SingleDeviceBackend(resolve_device(None if devs is None else devs[0]))
    if layout.kind == "routed":
        return RoutedBackend(shards, layout.axis, routing=layout.routing, devices=devs)
    return ShardedBackend(shards, layout.axis, devices=devs)
