"""K6: fused squared-L2 distance + per-query top-k on the card
(``csrc/knn_topk.cu``).

Replaces ``repro/kernels/topk.py::knn_topk_pallas``.  The plain version it
is held against is ``ref.knn_topk_ref`` (imported below); the source's
header says what bounds the kernel and what its design does about it.

One wrapper call is one kernel launch on the current stream, without
synchronising, counted on the wrapper (``.launches``).  ``plan`` (pure
Python) picks the block shape by Q and sizes the grid; the card tests and
``chip_smoke.py`` read its numbers.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import knn_topk_ref  # noqa: F401  (plain version)

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int

MAX_K = 64  # the kernel keeps each running top-k in one warp's shared lists
STREAM_MAX_Q = 32  # the largest Q a stream block holds whole
SMEM_PER_BLOCK = 232_448  # dynamic shared memory a block may use on an H100
SMEM_PER_SM = 233_472  # shared memory of an SM, with 1 KB reserved per block
MAX_RANGES = 65_535  # grid.y


@dataclass(frozen=True)
class Shape:
    """A block shape of the kernel (``knn_topk.cu``'s ``Shape`` table): a tile
    of ``block_queries`` x ``block_rows``, each thread ``thread_queries`` x
    ``thread_rows``, a ring of ``stages`` buffers of 32 features, at least
    ``min_blocks`` resident an SM (its register budget)."""

    index: int
    block_queries: int
    thread_queries: int
    block_rows: int
    thread_rows: int
    stages: int
    min_blocks: int

    @property
    def threads(self) -> int:
        return (self.block_queries // self.thread_queries) * (self.block_rows // self.thread_rows)

    def smem_bytes(self, k: int) -> int:
        """Dynamic shared memory at ``k``: the ring ((rows + queries) x 36
        floats a stage), the d2 tile (rows + 16 floats a query), the row and
        query norms, the running lists (k values and ids a query), a word of
        chunk marks a query, a flag."""
        bq, br = self.block_queries, self.block_rows
        return 4 * (self.stages * (br + bq) * 36 + bq * (br + 16) + br + 2 * bq + 2 * bq * k) + 16


STREAM_SHAPES = (Shape(0, 8, 8, 256, 1, 2, 2), Shape(1, 16, 16, 256, 1, 4, 1),
                 Shape(2, 32, 32, 256, 1, 4, 1))
TILED_SHAPE = Shape(3, 32, 4, 128, 8, 2, 2)
SHAPES = STREAM_SHAPES + (TILED_SHAPE,)


@dataclass(frozen=True)
class Plan:
    """One launch: ``regime`` "stream" (Q <= 32) or "tiled", its block shape,
    the grid (``q_tiles``, ``ranges``) and the dynamic shared memory."""

    regime: str
    shape: Shape
    q_tiles: int
    ranges: int
    smem_bytes: int
    blocks_per_sm: int

    def row_range(self, b: int, nx: int) -> tuple[int, int]:
        """Rows [lo, hi) of range ``b``, as the kernel splits them."""
        return b * nx // self.ranges, (b + 1) * nx // self.ranges


def _tiled_ranges(q_tiles: int, resident: int, row_tiles: int) -> int:
    """Ranges for the tiled grid: at least two waves of ``resident`` blocks,
    and of the counts up to four times that many, the one with the fewest
    waves per unit of work (every block of the grid does the same work, so
    a part-filled last wave costs a whole one).  Ties go to fewer ranges
    (less to merge)."""
    lo = -(-2 * resident // q_tiles)
    counts = {min(r, row_tiles, MAX_RANGES) for r in range(lo, 4 * lo + 1)}
    return min(counts, key=lambda r: (-(-q_tiles * r // resident) / r, r))


@functools.lru_cache(maxsize=256)
def plan(nq: int, nx: int, k: int, sms: int) -> Plan:
    """The launch for ``nq`` queries against ``nx`` rows on a card of ``sms``
    SMs.  Stream: the smallest stream shape that holds all the queries, one
    range per resident block (two an SM at Q <= 8, one above).  Tiled: query
    tiles of 32 and the ranges of ``_tiled_ranges``.  A range holds at least
    one tile."""
    if nq < 1 or nx < 1 or not 1 <= k <= MAX_K:
        raise ValueError(f"plan: nq={nq}, nx={nx}, k={k}")
    if nq <= STREAM_MAX_Q:
        regime, shape = "stream", next(s for s in STREAM_SHAPES if s.block_queries >= nq)
    else:
        regime, shape = "tiled", TILED_SHAPE
    smem = shape.smem_bytes(k)
    per_sm = max(1, min(shape.min_blocks, SMEM_PER_SM // (smem + 1024)))
    q_tiles = -(-nq // shape.block_queries)
    row_tiles = -(-nx // shape.block_rows)
    resident = sms * per_sm
    if regime == "stream":
        ranges = max(1, min(resident, row_tiles))
    else:
        ranges = _tiled_ranges(q_tiles, resident, row_tiles)
    return Plan(regime, shape, q_tiles, ranges, smem, per_sm)


def _lib() -> ctypes.CDLL:
    lib = _build.library("knn_topk")
    fn = lib.knn_topk_f32
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
        lib.knn_topk_smem.argtypes = [_I, _I]
        lib.knn_topk_smem.restype = _I
    return lib


# Ticket counters per (device, stream): zero between calls (the kernel's
# merging block resets its own), so only calls on one stream, which run one
# after another, share them.
_TICKETS: dict[tuple[int, int], Tensor] = {}


def _tickets(device: torch.device, stream: int, n: int) -> Tensor:
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros((max(n, 64),), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def knn_topk_cuda(q: Tensor, x: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """(Q, D) queries against (N, D) rows -> the k nearest per query by the
    K6 kernel: (Q, k) f32 squared distances ascending and (Q, k) i32 row
    indices, ties to the lower row, (+inf, -1) past the end when N < k.

    Both operands must lie on one CUDA device; they are cast to f32 and made
    contiguous.  ``1 <= k <= 64``.
    """
    if not (q.is_cuda and x.is_cuda) or q.device != x.device:
        raise ValueError(
            f"knn_topk_cuda needs q and x on one CUDA device, got {q.device} and {x.device}"
        )
    if q.ndim != 2 or x.ndim != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(
            f"knn_topk_cuda takes q (Q, D) and x (N, D), got {tuple(q.shape)} and "
            f"{tuple(x.shape)}"
        )
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn_topk_cuda: k={k} must lie in [1, {MAX_K}]")
    if x.shape[0] >= 2**31 - 1 or q.shape[0] >= 2**31 - 1:
        raise ValueError("knn_topk_cuda: row counts must fit int32 indices")
    q = q.to(torch.float32).contiguous()
    x = x.to(torch.float32).contiguous()
    nq, dim = q.shape
    nx = x.shape[0]
    if nq == 0 or nx == 0:
        return (torch.full((nq, k), float("inf"), dtype=torch.float32, device=q.device),
                torch.full((nq, k), -1, dtype=torch.int32, device=q.device))
    out_val = torch.empty((nq, k), dtype=torch.float32, device=q.device)
    out_idx = torch.empty((nq, k), dtype=torch.int32, device=q.device)
    p = plan(nq, nx, k, torch.cuda.get_device_properties(q.device).multi_processor_count)
    part_val = torch.empty((nq, p.ranges, k), dtype=torch.float32, device=q.device)
    part_idx = torch.empty((nq, p.ranges, k), dtype=torch.int32, device=q.device)
    vec = int(dim % 4 == 0 and x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        tickets = _tickets(q.device, stream, p.q_tiles)
        err = lib.knn_topk_f32(
            q.data_ptr(), x.data_ptr(), part_val.data_ptr(), part_idx.data_ptr(),
            tickets.data_ptr(), out_val.data_ptr(), out_idx.data_ptr(), nq, nx, dim, k,
            p.shape.index, p.ranges, vec, stream,
        )
    _build.check(lib, err, "knn_topk")
    knn_topk_cuda.launches += 1
    return out_val, out_idx


knn_topk_cuda.launches = 0  # kernel launches since the last reset
