"""K2: tiled squared-L2 distance matrix on the card (``csrc/pairwise_l2.cu``).

Replaces ``repro/kernels/pairwise_l2.py::pairwise_sq_l2_pallas``.  The plain
version it is held against is ``ref.pairwise_sq_l2_ref`` (imported below);
the source's header says what bounds the kernel and what its design does
about it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import pairwise_sq_l2_ref  # noqa: F401  (plain version)

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = _build.library("pairwise_l2")
    fn = lib.pairwise_sq_l2_f32
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _I, _I, _I, _P]
        fn.restype = _I
    return lib


def pairwise_sq_l2_cuda(q: Tensor, x: Tensor) -> Tensor:
    """(Q, D) x (N, D) -> (Q, N) f32 squared L2 distances, by the K2 kernel.

    Both operands must lie on the same CUDA device; they are cast to f32 and
    made contiguous (the kernel reads row-major f32).  Launches on the current
    stream and does not synchronise.
    """
    if not (q.is_cuda and x.is_cuda) or q.device != x.device:
        raise ValueError(
            f"pairwise_sq_l2_cuda needs both operands on one CUDA device, got "
            f"{q.device} and {x.device}"
        )
    if q.ndim != 2 or x.ndim != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(
            f"pairwise_sq_l2_cuda takes (Q, D) and (N, D), got {tuple(q.shape)} "
            f"and {tuple(x.shape)}"
        )
    q = q.to(torch.float32).contiguous()
    x = x.to(torch.float32).contiguous()
    nq, dim = q.shape
    nx = x.shape[0]
    out = torch.empty((nq, nx), dtype=torch.float32, device=q.device)
    if nq == 0 or nx == 0:
        return out
    if dim == 0:
        return out.zero_()
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pairwise_sq_l2_f32(
            q.data_ptr(), x.data_ptr(), out.data_ptr(), nq, nx, dim, stream
        )
    _build.check(lib, err, "pairwise_sq_l2")
    pairwise_sq_l2_cuda.launches += 1
    return out


pairwise_sq_l2_cuda.launches = 0  # kernel launches since the last reset
