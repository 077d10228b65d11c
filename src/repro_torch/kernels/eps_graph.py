"""K3-K5: the DBSCAN eps-graph passes on the card (``csrc/eps_graph.cu``).

Replaces ``repro/kernels/pairwise_l2.py::eps_count_pallas``,
``eps_min_label_pallas`` and ``eps_nearest_core_pallas``.  The plain versions
they are held against are ``ref.eps_count_ref``, ``ref.eps_min_label_ref``
and ``ref.eps_nearest_core_ref`` (imported below); the source's header says
what bounds the kernels and what their design does about it.

All three run one design: the columns (all N rows for K3; for K4 and K5
only the core rows, which the wrapper compacts with ``compact_core``) are
packed once per call, split into chunks of ``CHUNK`` over the grid, and the
chunks merge by an atomic: K3 adds its counts, K4 takes the min label, K5 the
min of ``pack_nearest``'s key, which the wrapper maps back with
``unpack_nearest``.  These helpers are plain torch, so the CPU tests emulate
the chunked merge with them.

Each wrapper launches its kernel once over all queries (a pack of the
columns, then the main kernel), on the current stream, counts the launch on
itself (``.launches``) and keeps the launch grid the kernel chose, (query
tiles, column chunks), on itself (``.grid``).  K3 does not synchronise;
K4/K5's compaction reads the number of core rows back to the host.
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
_GRID = ctypes.c_int * 2  # the (x, y) launch grid a K3-K5 launch reports

CHUNK = 4096  # packed columns per block of K3-K5 (the grid's y axis)
NO_KEY = 2**63 - 1  # K5's merge key before any core column is seen


def _lib() -> ctypes.CDLL:
    lib = _build.library("eps_graph")
    if lib.eps_count_f32.argtypes is None:
        lib.eps_count_f32.argtypes = [_P, _P, _P, _F, _P, _I, _I, _I, _I, _GRID, _P]
        core_args = [_P, _P, _P, _P, _F, _P, _I, _I, _I, _I, _I, _GRID, _P]
        lib.eps_min_label_f32.argtypes = core_args
        lib.eps_nearest_core_f32.argtypes = core_args[:4] + core_args[5:]
        for fn in (lib.eps_count_f32, lib.eps_min_label_f32, lib.eps_nearest_core_f32,
                   lib.eps_packed_width):
            fn.restype = _I
        lib.eps_packed_width.argtypes = [_I]
    return lib


# --- the wrapper logic of K4/K5, plain torch (the CPU tests reach it) -------


def compact_core(x: Tensor, labels: Tensor, core: Tensor) -> tuple[Tensor, Tensor]:
    """The core rows of ``x`` in ascending index order, and their labels:
    the only columns K4 and K5 compute.  Ascending order keeps K5's
    first-index rule: compact index order is row order."""
    idx = torch.nonzero(core != 0).squeeze(1)
    return x.index_select(0, idx), labels.index_select(0, idx)


def pack_nearest(d2: Tensor, j: Tensor) -> Tensor:
    """(Q,) int64 keys ``(bits of d2) << 32 | j`` that order as (d2, j)
    lexicographically (d2 >= +0, j < 2^31); ``NO_KEY`` where d2 is +inf
    (no core column).  K5 merges its column chunks by the min of these."""
    key = (d2.contiguous().view(torch.int32).to(torch.int64) << 32) | j.to(torch.int64)
    return torch.where(torch.isinf(d2), NO_KEY, key)


def unpack_nearest(key: Tensor, lab_core: Tensor, n: int) -> tuple[Tensor, Tensor]:
    """K5's merged keys back to (f32 d2, i32 label of compact column j);
    ``NO_KEY`` to (+inf, N), the plain version's answer without a core row."""
    none = key == NO_KEY
    d2 = (key >> 32).to(torch.int32).view(torch.float32)
    j = torch.where(none, lab_core.shape[0], key & 0xFFFFFFFF)
    ext = torch.cat([lab_core.to(torch.int32), lab_core.new_full((1,), n, dtype=torch.int32)])
    return torch.where(none, float("inf"), d2), ext[j]


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


def _packed(name: str, q: Tensor, n_cols: int) -> Tensor:
    """Scratch for ``n_cols`` packed rows at q's width."""
    if -(-n_cols // CHUNK) > 65535:
        raise ValueError(f"{name}: {n_cols} columns exceed the grid's column chunks")
    width = _lib().eps_packed_width(q.shape[1])
    return torch.empty((n_cols, width), dtype=torch.float32, device=q.device)


def eps_count_cuda(q: Tensor, x: Tensor, eps_sq) -> Tensor:
    """(Q,) i32: per query, the number of rows of x with d2 <= eps_sq (K3)."""
    q, x = _rows("eps_count_cuda", q, x)
    packed = _packed("eps_count_cuda", q, x.shape[0])
    out = torch.zeros((q.shape[0],), dtype=torch.int32, device=q.device)
    if q.shape[0] == 0:
        return out
    lib = _lib()
    grid = _GRID()
    with torch.cuda.device(q.device):
        err = lib.eps_count_f32(
            q.data_ptr(), x.data_ptr(), packed.data_ptr(), _eps_f32(eps_sq), out.data_ptr(),
            q.shape[0], x.shape[0], q.shape[1], CHUNK, grid, _stream(q.device),
        )
    _build.check(lib, err, "eps_count")
    eps_count_cuda.launches += 1
    eps_count_cuda.grid = tuple(grid)
    return out


def _core_operands(name: str, q: Tensor, x: Tensor, labels: Tensor, core: Tensor):
    """Checked operands of K4/K5, the compacted core columns and the packed
    rows' scratch."""
    q, x = _rows(name, q, x)
    labels, core = _graph(name, x, labels, core)
    x_core, lab_core = compact_core(x, labels, core)
    packed = _packed(name, q, x_core.shape[0])
    return q, x, x_core, lab_core, packed


def eps_min_label_cuda(q: Tensor, x: Tensor, labels: Tensor, core: Tensor, eps_sq) -> Tensor:
    """(Q,) i32: per query, the min label over the core rows within eps; N
    (= len(x)) when there is none (K4)."""
    q, x, x_core, lab_core, packed = _core_operands("eps_min_label_cuda", q, x, labels, core)
    out = torch.full((q.shape[0],), x.shape[0], dtype=torch.int32, device=q.device)
    if q.shape[0] == 0:
        return out
    lib = _lib()
    grid = _GRID()
    with torch.cuda.device(q.device):
        err = lib.eps_min_label_f32(
            q.data_ptr(), x_core.data_ptr(), lab_core.data_ptr(), packed.data_ptr(),
            _eps_f32(eps_sq), out.data_ptr(), q.shape[0], x.shape[0], x_core.shape[0],
            q.shape[1], CHUNK, grid, _stream(q.device),
        )
    _build.check(lib, err, "eps_min_label")
    eps_min_label_cuda.launches += 1
    eps_min_label_cuda.grid = tuple(grid)
    return out


def eps_nearest_core_cuda(
    q: Tensor, x: Tensor, labels: Tensor, core: Tensor
) -> tuple[Tensor, Tensor]:
    """Per query: (f32 d2 to the nearest core row, its i32 label), the first
    index winning a tie; (+inf, N) when x has no core row (K5)."""
    q, x, x_core, lab_core, packed = _core_operands("eps_nearest_core_cuda", q, x, labels, core)
    keys = torch.full((q.shape[0],), NO_KEY, dtype=torch.int64, device=q.device)
    if q.shape[0] == 0:
        return unpack_nearest(keys, lab_core, x.shape[0])
    lib = _lib()
    grid = _GRID()
    with torch.cuda.device(q.device):
        err = lib.eps_nearest_core_f32(
            q.data_ptr(), x_core.data_ptr(), lab_core.data_ptr(), packed.data_ptr(),
            keys.data_ptr(), q.shape[0], x.shape[0], x_core.shape[0], q.shape[1], CHUNK,
            grid, _stream(q.device),
        )
    _build.check(lib, err, "eps_nearest_core")
    eps_nearest_core_cuda.launches += 1
    eps_nearest_core_cuda.grid = tuple(grid)
    return unpack_nearest(keys, lab_core, x.shape[0])


eps_count_cuda.launches = 0  # kernel launches since the last reset
eps_min_label_cuda.launches = 0
eps_nearest_core_cuda.launches = 0
eps_count_cuda.grid = None  # (query tiles, column chunks) of the last launch
eps_min_label_cuda.grid = None
eps_nearest_core_cuda.grid = None
