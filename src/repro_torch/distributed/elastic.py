"""Elastic scaling: re-mesh on a changed device count (the port of the JAX
package's ``repro/distributed/elastic.py``).

Checkpoints store logical (unsharded) arrays (``checkpoint/``), so scaling
is: pick the best mesh for the surviving device count, recompute the specs
from the same logical rules, reload.  ``plan_mesh`` chooses the (data,
model) factorization: model parallelism keeps its degree as long as the
device count allows (the TP degree is dictated by model size, not fleet
size); data parallelism absorbs the change.  ``launch/train.py --mesh
auto`` runs under ``plan_mesh(torch.cuda.device_count()).build()``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.distributed.context import Mesh


def local_cards(n: int) -> list[torch.device]:
    """``cuda:0 ... cuda:n-1``; without CUDA, or with fewer cards, an error
    (never a quiet fall back to the CPU)."""
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if avail == 0:
        raise RuntimeError(
            "no CUDA device is available; repro_torch runs on the card by default — "
            "pass devices=[...] (a device may repeat, e.g. ['cpu'] * 4) to lay the "
            "islands out on the host")
    if n > avail:
        raise RuntimeError(f"a mesh of {n} islands needs {n} CUDA devices; this host "
                           f"has {avail}")
    return [torch.device("cuda", i) for i in range(n)]


@dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]

    def build(self, devices=None) -> Mesh:
        """The plan as a mesh of islands over ``devices`` (one a island,
        row-major; a device may repeat), or over the local cards."""
        n = 1
        for d in self.shape:
            n *= d
        devs = list(devices) if devices is not None else local_cards(n)
        return Mesh(devs, shape=self.shape, axis_names=self.axes)


def plan_mesh(n_devices: int, *, preferred_model: int = 16) -> MeshPlan:
    """Largest power-of-two model axis <= preferred that divides n_devices."""
    model = 1
    m = preferred_model
    while m > 1:
        if n_devices % m == 0:
            model = m
            break
        m //= 2
    data = n_devices // model
    if model == 1:
        return MeshPlan((data,), ("data",))
    return MeshPlan((data, model), ("data", "model"))


def rescale_batch(global_batch: int, old_devices: int, new_devices: int) -> int:
    """Keep per-device batch constant under rescale (linear-scaling rule);
    round to keep divisibility."""
    per_dev = max(global_batch // old_devices, 1)
    return per_dev * new_devices
