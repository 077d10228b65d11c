"""Device-layout executor backend — the seam between the facade and devices.

``SingleDeviceBackend`` keeps the whole forest on one torch device and owns
the forest upload (``upload_forest``, quantized per config) and the executor
bodies (``search_body``) that ``api/plan.py`` caches per option tuple.  The
sharded and routed layouts of the JAX package come with a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.forest import ForestArrays
from repro_torch.core.knn import DeviceForest, device_forest, knn_search_impl


class SingleDeviceBackend:
    """The default layout: whole forest on one device.  Bodies are the core
    executor verbatim."""

    kind = "single"
    shards = 1

    def __init__(self, device: torch.device) -> None:
        self.device = torch.device(device)

    def upload_forest(self, forest: ForestArrays, *, quantize: bool) -> DeviceForest:
        return device_forest(forest, device=self.device, quantize=quantize)

    def search_body(self, key):
        def body(forest, q, delta):
            return knn_search_impl(
                forest, q, k=key.k, mode=key.mode, beam=key.beam,
                kernel=key.kernel, delta=delta,
            )

        return body

    def search_operands(self, device_forest: DeviceForest) -> DeviceForest:
        """First operand the plan executor is called with (the bare forest on
        this layout)."""
        return device_forest
