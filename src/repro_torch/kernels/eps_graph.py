"""K3-K5: the DBSCAN eps-graph passes on the card (``csrc/eps_graph.cu``).

Replaces ``repro/kernels/pairwise_l2.py::eps_count_pallas``,
``eps_min_label_pallas`` and ``eps_nearest_core_pallas``.  The plain versions
they are held against are ``ref.eps_count_ref``, ``ref.eps_min_label_ref``
and ``ref.eps_nearest_core_ref`` (imported below); the source's header says
what bounds the kernels and what their design does about it.

Each wrapper launches its kernel once over all queries, on the current
stream, without synchronising, and counts the launch on itself
(``.launches``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (  # noqa: F401  (plain versions)
    eps_count_ref,
    eps_min_label_ref,
    eps_nearest_core_ref,
)

Tensor = torch.Tensor

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.library("eps_graph")
    if lib.eps_count_f32.argtypes is None:
        lib.eps_count_f32.argtypes = [_P, _P, _F, _P, _I, _I, _I, _P]
        lib.eps_min_label_f32.argtypes = [_P, _P, _P, _P, _F, _P, _I, _I, _I, _P]
        lib.eps_nearest_core_f32.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]
        for fn in (lib.eps_count_f32, lib.eps_min_label_f32, lib.eps_nearest_core_f32):
            fn.restype = _I
    return lib


def _rows(name: str, q: Tensor, x: Tensor) -> tuple[Tensor, Tensor]:
    if not (q.is_cuda and x.is_cuda) or q.device != x.device:
        raise ValueError(
            f"{name} needs q and x on one CUDA device, got {q.device} and {x.device}"
        )
    if q.ndim != 2 or x.ndim != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(
            f"{name} takes q (Q, D) and x (N, D), got {tuple(q.shape)} and "
            f"{tuple(x.shape)}"
        )
    if x.shape[0] >= 2**31 - 1 or q.shape[0] >= 2**31 - 1:
        raise ValueError(f"{name}: row counts must fit int32 indices")
    return q.to(torch.float32).contiguous(), x.to(torch.float32).contiguous()


def _graph(name: str, x: Tensor, labels: Tensor, core: Tensor) -> tuple[Tensor, Tensor]:
    n = x.shape[0]
    if labels.shape != (n,) or core.shape != (n,):
        raise ValueError(
            f"{name}: labels and core must be (N,) = ({n},), got "
            f"{tuple(labels.shape)} and {tuple(core.shape)}"
        )
    if labels.device != x.device or core.device != x.device:
        raise ValueError(f"{name}: labels and core must lie on {x.device}")
    labels = labels.to(torch.int32).contiguous()
    core = (core != 0).contiguous().view(torch.uint8)
    return labels, core


def _eps_f32(eps_sq) -> float:
    """The threshold as the f32 value both versions compare against."""
    return float(np.float32(float(eps_sq)))


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def eps_count_cuda(q: Tensor, x: Tensor, eps_sq) -> Tensor:
    """(Q,) i32: per query, the number of rows of x with d2 <= eps_sq (K3)."""
    q, x = _rows("eps_count_cuda", q, x)
    out = torch.empty((q.shape[0],), dtype=torch.int32, device=q.device)
    if q.shape[0] == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.eps_count_f32(
            q.data_ptr(), x.data_ptr(), _eps_f32(eps_sq), out.data_ptr(),
            q.shape[0], x.shape[0], q.shape[1], _stream(q.device),
        )
    _build.check(lib, err, "eps_count")
    eps_count_cuda.launches += 1
    return out


def eps_min_label_cuda(q: Tensor, x: Tensor, labels: Tensor, core: Tensor, eps_sq) -> Tensor:
    """(Q,) i32: per query, the min label over the core rows within eps; N
    (= len(x)) when there is none (K4)."""
    q, x = _rows("eps_min_label_cuda", q, x)
    labels, core = _graph("eps_min_label_cuda", x, labels, core)
    out = torch.empty((q.shape[0],), dtype=torch.int32, device=q.device)
    if q.shape[0] == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.eps_min_label_f32(
            q.data_ptr(), x.data_ptr(), labels.data_ptr(), core.data_ptr(),
            _eps_f32(eps_sq), out.data_ptr(), q.shape[0], x.shape[0], q.shape[1],
            _stream(q.device),
        )
    _build.check(lib, err, "eps_min_label")
    eps_min_label_cuda.launches += 1
    return out


def eps_nearest_core_cuda(
    q: Tensor, x: Tensor, labels: Tensor, core: Tensor
) -> tuple[Tensor, Tensor]:
    """Per query: (f32 d2 to the nearest core row, its i32 label), the first
    index winning a tie; (+inf, N) when x has no core row (K5)."""
    q, x = _rows("eps_nearest_core_cuda", q, x)
    labels, core = _graph("eps_nearest_core_cuda", x, labels, core)
    out_d = torch.empty((q.shape[0],), dtype=torch.float32, device=q.device)
    out_l = torch.empty((q.shape[0],), dtype=torch.int32, device=q.device)
    if q.shape[0] == 0:
        return out_d, out_l
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.eps_nearest_core_f32(
            q.data_ptr(), x.data_ptr(), labels.data_ptr(), core.data_ptr(),
            out_d.data_ptr(), out_l.data_ptr(), q.shape[0], x.shape[0], q.shape[1],
            _stream(q.device),
        )
    _build.check(lib, err, "eps_nearest_core")
    eps_nearest_core_cuda.launches += 1
    return out_d, out_l


eps_count_cuda.launches = 0  # kernel launches since the last reset
eps_min_label_cuda.launches = 0
eps_nearest_core_cuda.launches = 0
