"""Ambient mesh context: the islands a sharded computation runs on.

The JAX package's mesh is a ``jax.sharding.Mesh`` that one process drives
through ``shard_map``.  Here a ``Mesh`` is the same single-controller idea
in plain torch: one torch device per island along one named axis.  A
device may repeat (``["cuda:0"] * 4`` is four islands on one card, as a
forced host platform count gives the JAX package four islands on one CPU),
and islands run one after another on their device's current stream.

Code that wants the sharded path looks the active mesh up here
(``serve.retrieval.knn_logits`` splits a flat datastore over it); with no
mesh it runs on one device.
"""
from __future__ import annotations

import contextlib
from collections.abc import Iterator, Sequence

import torch

MODEL_AXIS = "model"


class Mesh:
    """One-axis island mesh: ``devices[s]`` is island ``s``'s torch device.

    ``shape[axis]`` is the island count, as on a ``jax.sharding.Mesh``.
    """

    def __init__(self, devices: Sequence, axis: str = MODEL_AXIS) -> None:
        if len(devices) < 1:
            raise ValueError("a Mesh needs at least one device")
        self.devices: tuple[torch.device, ...] = tuple(torch.device(d) for d in devices)
        self.axis = axis

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (self.axis,)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


_ACTIVE: list[Mesh | None] = [None]


def current_mesh() -> Mesh | None:
    return _ACTIVE[0]


@contextlib.contextmanager
def use_mesh(mesh: Mesh | None) -> Iterator[None]:
    prev = _ACTIVE[0]
    _ACTIVE[0] = mesh
    try:
        yield
    finally:
        _ACTIVE[0] = prev


def model_axis_size(mesh: Mesh | None = None) -> int:
    mesh = mesh or current_mesh()
    if mesh is None or MODEL_AXIS not in mesh.axis_names:
        return 1
    return mesh.shape[MODEL_AXIS]
