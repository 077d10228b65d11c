"""K6's launch planner (``repro_torch.kernels.topk.plan``), pure Python.

The kernel (``csrc/knn_topk.cu``) runs only on the card; what decides its
grid runs here: the row ranges its blocks own, the block shape chosen by Q,
the shared memory each shape asks for, and the grid at the edges of N.
The card tests (``test_torch_cuda.py``) hold the planner's shared-memory
bytes to the kernel's own and its ranges to the in-kernel merge's tie order.
"""
import re
from pathlib import Path

import pytest

from repro_torch.kernels import topk
from repro_torch.kernels.topk import (
    MAX_K,
    SHAPES,
    SMEM_PER_BLOCK,
    STREAM_MAX_Q,
    STREAM_SHAPES,
    TILED_SHAPE,
    plan,
)

SMS = 132  # an H100 SXM
CSRC = Path(topk.__file__).resolve().parent.parent / "csrc" / "knn_topk.cu"


@pytest.mark.parametrize("nq", [1, 8, 9, 32, 33, 1024])
@pytest.mark.parametrize("nx", [1, 7, 255, 257, 65_536, 70_001, 1 << 20])
@pytest.mark.parametrize("k", [1, 8, 64])
def test_ranges_cover_every_row_once(nq, nx, k):
    """Contiguous, ascending, non-empty ranges from row 0 to N: each row
    belongs to exactly one block of a query tile, in index order."""
    p = plan(nq, nx, k, SMS)
    spans = [p.row_range(b, nx) for b in range(p.ranges)]
    assert spans[0][0] == 0 and spans[-1][1] == nx
    for (lo, hi), (lo2, _) in zip(spans, spans[1:]):
        assert lo < hi == lo2
    assert spans[-1][0] < spans[-1][1]
    # a range never falls below a tile while there are tiles to spare
    assert p.ranges <= -(-nx // p.shape.block_rows)


@pytest.mark.parametrize("nq", [1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 40, 64, 65, 1030])
def test_regime_is_chosen_by_q(nq):
    p = plan(nq, 1 << 20, 8, SMS)
    if nq <= STREAM_MAX_Q:
        assert p.regime == "stream" and p.shape in STREAM_SHAPES
        # the smallest stream shape that holds every query
        assert p.shape.block_queries >= nq and p.q_tiles == 1
        assert all(s.block_queries < nq for s in STREAM_SHAPES if s.index < p.shape.index)
    else:
        assert p.regime == "tiled" and p.shape == TILED_SHAPE
        assert p.q_tiles == -(-nq // TILED_SHAPE.block_queries)


@pytest.mark.parametrize("k", [1, 2, 7, 8, 16, 33, 63, MAX_K])
def test_shared_memory_fits_a_block(k):
    for shape in SHAPES:
        assert 0 < shape.smem_bytes(k) <= SMEM_PER_BLOCK
        assert shape.smem_bytes(k) % 16 == 0


@pytest.mark.parametrize("nx_of_k", ["1", "k-1", "2^20", "2^31-2"])
@pytest.mark.parametrize("k", [1, 2, 8, 64])
@pytest.mark.parametrize("nq", [1, 8, 32, 33, 1030])
def test_grid_is_at_least_one_block(nx_of_k, k, nq):
    nx = {"1": 1, "k-1": max(1, k - 1), "2^20": 1 << 20, "2^31-2": 2**31 - 2}[nx_of_k]
    p = plan(nq, nx, k, SMS)
    assert p.q_tiles >= 1 and 1 <= p.ranges <= 65_535 and p.blocks_per_sm >= 1
    assert p.q_tiles * p.shape.block_queries >= nq
    lo, hi = p.row_range(p.ranges - 1, nx)
    assert hi == nx and lo < hi


def test_decode_grid_is_about_one_block_an_sm():
    """Stream: one range per resident block."""
    p = plan(8, 1 << 20, 8, SMS)
    assert p.regime == "stream" and p.ranges == SMS * p.blocks_per_sm


@pytest.mark.parametrize("nq", [33, 64, 256, 1024, 1030, 4096])
def test_tiled_grid_fills_its_waves(nq):
    """Tiled: at least two waves of resident blocks, the last one at least
    as full as the ceiling of two waves' would be (every block does the
    same work, so a part-filled last wave costs a whole one)."""
    p = plan(nq, 1 << 20, 8, SMS)
    resident = SMS * p.blocks_per_sm
    blocks = p.q_tiles * p.ranges
    assert p.regime == "tiled" and blocks >= 2 * resident
    lo = -(-2 * resident // p.q_tiles)
    waves = -(-blocks // resident)
    assert waves / p.ranges <= -(-p.q_tiles * lo // resident) / lo + 1e-12
    assert blocks / (waves * resident) >= 0.95


def test_shapes_mirror_the_kernel_table():
    """``SHAPES`` is the ``Shape<...>`` table of knn_topk.cu, in its order,
    and every shape's threads make whole warps."""
    src = CSRC.read_text()
    table = re.findall(r"using (\w+) = Shape<(\d+), (\d+), (\d+), (\d+), (\d+), (\d+)>;", src)
    assert [tuple(int(v) for v in row[1:]) for row in table] == [
        (s.block_queries, s.thread_queries, s.block_rows, s.thread_rows, s.stages, s.min_blocks)
        for s in SHAPES]
    cases = re.findall(r"case (\d+): return launch_as\((\w+)\{\}\);", src)
    assert [(int(i), name) for i, name in cases] == [(s.index, row[0])
                                                     for s, row in zip(SHAPES, table)]
    for s in SHAPES:
        assert s.threads % 32 == 0 and s.threads <= 1024


@pytest.mark.parametrize("bad", [(0, 5, 8), (5, 0, 8), (5, 5, 0), (5, 5, MAX_K + 1)])
def test_plan_refuses_empty_or_bad_k(bad):
    with pytest.raises(ValueError):
        plan(*bad, SMS)
