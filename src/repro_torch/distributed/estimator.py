"""The routing tier's wire-byte rule (the port of
``repro/distributed/estimator.py::estimate_allgather_bytes``).

The rest of the JAX package's estimator serves the LM dry-run and is not
part of the port yet.
"""
from __future__ import annotations

import torch

# per-device traffic of a ring all-gather ~ factor * result bytes; the JAX
# package's hlo_cost.COLLECTIVE_FACTORS["all-gather"]
ALLGATHER_FACTOR = 1.0


def estimate_allgather_bytes(payload_bytes: float, participants: torch.Tensor) -> torch.Tensor:
    """Cross-host wire bytes of a ring all-gather of ``payload_bytes`` per
    participant over ``participants`` hosts (a tensor: the router prices on
    the device): ``ALLGATHER_FACTOR * payload * (H - 1)``, floored at 0, as
    f32 on the tensor's device."""
    h = participants.to(torch.float32)
    return ALLGATHER_FACTOR * payload_bytes * torch.clamp_min(h - 1.0, 0.0)
