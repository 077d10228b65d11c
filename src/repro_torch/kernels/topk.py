"""K6: fused squared-L2 distance + per-query top-k on the card
(``csrc/knn_topk.cu``).

Replaces ``repro/kernels/topk.py::knn_topk_pallas``.  The plain version it
is held against is ``ref.knn_topk_ref`` (imported below); the source's
header says what bounds the kernel and what its design does about it.

One wrapper call launches the kernel's three passes (the query norms, the
per-chunk partial top-k, the per-query merge) on the current stream,
without synchronising, and counts them as one launch on itself
(``.launches``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import knn_topk_ref  # noqa: F401  (plain version)

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int

MAX_K = 64  # the kernel keeps each running top-k in one warp's shared lists
_QUERIES_PER_BLOCK = 8
_ROWS_PER_TILE = 256
_BLOCKS_PER_SM = 5  # ~42 KB of shared memory per block of 256 threads


def _lib() -> ctypes.CDLL:
    lib = _build.library("knn_topk")
    fn = lib.knn_topk_f32
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
    return lib


def chunking(nq: int, nx: int, sms: int) -> tuple[int, int]:
    """(chunk_rows, n_chunks): split N so the grid holds about two waves of
    resident blocks however few queries there are, in whole 256-row tiles."""
    q_tiles = -(-nq // _QUERIES_PER_BLOCK)
    tiles = -(-nx // _ROWS_PER_TILE)
    want = max(1, min(tiles, -(-2 * _BLOCKS_PER_SM * sms // q_tiles)))
    chunk_rows = -(-tiles // want) * _ROWS_PER_TILE
    return chunk_rows, -(-nx // chunk_rows)


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
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunk_rows, n_chunks = chunking(nq, nx, sms)
    qnorm = torch.empty((nq,), dtype=torch.float32, device=q.device)
    part_val = torch.empty((nq, n_chunks, k), dtype=torch.float32, device=q.device)
    part_idx = torch.empty((nq, n_chunks, k), dtype=torch.int32, device=q.device)
    vec = int(dim % 4 == 0 and x.data_ptr() % 16 == 0)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.knn_topk_f32(
            q.data_ptr(), x.data_ptr(), qnorm.data_ptr(), part_val.data_ptr(),
            part_idx.data_ptr(), out_val.data_ptr(), out_idx.data_ptr(), nq, nx, dim, k,
            chunk_rows, n_chunks, vec, stream,
        )
    _build.check(lib, err, "knn_topk")
    knn_topk_cuda.launches += 1
    return out_val, out_idx


knn_topk_cuda.launches = 0  # kernel launches (three passes each) since the last reset
