"""Decision-making stage (paper §4.3).  This slice carries only the
``Partition`` record that ``forest.build_forest`` consumes; the overlap-driven
``decide`` (merge / extract / move) comes with the overlap build."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Partition:
    """A partition group emitted by the decision stage."""

    members: np.ndarray  # (m,) int64 object ids into the dataset
    pivot: np.ndarray  # (D,)
    radius: float
    neighbors: list[int] = field(default_factory=list)  # group-level links
    is_overlap_index: bool = False
