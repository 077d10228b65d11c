"""The roofline arithmetic, frozen: ``chip_smoke.py``'s ``bound()`` with the
H100 SXM data-sheet rates (dense, without sparsity, at the full 700 W)."""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time in ms for ``nbytes`` moved and ``flops`` f32 operations,
    and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scan_work(distances: int, dim: int) -> float:
    """f32 operations of the bucket scan: 4 D a scored (query, row) pair, as
    ``chip_smoke.py`` counts K1 (difference, square and add through the
    expansion's FMAs, and the top-k compare)."""
    return 4.0 * dim * distances


def scan_bytes(*, slots: int, dim: int, queries: int, k: int) -> float:
    """Bytes a search's scan moves at least: the forest's member rows (f32)
    and ids (i32) read once, the queries read once, the (distance, id)
    answers written once."""
    return slots * (dim * 4 + 4) + queries * dim * 4 + queries * k * 8
