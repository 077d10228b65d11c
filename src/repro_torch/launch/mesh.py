"""Production mesh construction (the port of the JAX package's
``repro/launch/mesh.py``).

Single pod: (data=16, model=16) — 256 devices.
Multi-pod:  (pod=2, data=16, model=16) — 512 devices; the 'pod' axis
carries pure data parallelism across the slowest interconnect, 'data' is
FSDP, 'model' is tensor/expert parallelism.  The shapes are the JAX
package's; ``distributed/roofline.py`` says which H100 link each axis
crosses.

``make_production_mesh`` returns the abstract mesh (shape and names, no
devices): the sharding rules and the dry-run read only that.
``executable(mesh)`` lays it out over the local cards and refuses, naming
the count, where there are fewer.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.context import Mesh
from repro_torch.distributed.elastic import local_cards


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape=shape, axis_names=axes)


def executable(mesh: Mesh) -> Mesh:
    """``mesh`` with one local CUDA card per island; with fewer cards than
    islands an error naming the count."""
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if avail < mesh.size:
        raise RuntimeError(
            f"the mesh {tuple(mesh.shape.values())} {mesh.axis_names} needs {mesh.size} "
            f"devices, this host has {avail} CUDA device(s); check the layout without "
            "them with python -m repro_torch.launch.dryrun")
    return Mesh(local_cards(mesh.size), shape=tuple(mesh.shape.values()),
                axis_names=mesh.axis_names)


def make_host_mesh(device=None) -> Mesh:
    """A ``(n,)`` "data" mesh over the local cards (n = their count), or over
    ``device`` (one device, or a list of them: a device may repeat); without
    CUDA and without ``device`` an error."""
    if device is None:
        devs = local_cards(max(torch.cuda.device_count(), 1))
    elif isinstance(device, (list, tuple)):
        devs = list(device)
    else:
        devs = [device]
    return Mesh(devs, shape=(len(devs),), axis_names=("data",))
